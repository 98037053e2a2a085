"""The port's ResNet and XCiT backbones (`sgdm_tpu_torch/models/resnet.py`,
`models/xcit.py`) and the rest of the backbone table
(`selfsup/ssl_backbone.py`) against the JAX package's on the CPU, float32.

  * ResNet at reduced depth (stage sizes (1, 1, 1, 1) and (2, 1, 3, 1)) and
    XCiT at reduced depth and width (patch 8 and 16, ``tokens_norm`` on and
    off, every output), one seeded flax param tree carried across by
    `resnet_from_flax` / `xcit_from_flax`: outputs within MODEL_TOL = 2e-5
    relative to max(1, max|JAX|) (the JAX package folds BN; the port
    applies it unfolded).
  * Each torch-format loader on a random written state dict (pl_bolts
    SimCLR with ``encoder.`` and a projection head; a torchvision state
    dict with ``fc``; VISSL consolidated and SwAV-style; XCiT under
    facebookresearch's and timm's names, and with a BN eps of 0.5, which
    moves the output well beyond MODEL_TOL) against
    the JAX loader of the same file: the same features within MODEL_TOL;
    a missing key fails both (the port's strict load, the JAX mapper's
    KeyError).
  * Every non-ViT name of `get_ssl_backbone` at full width (ResNet-50 /
    101, XCiT-M24/8) from a checkpoint written in its loader's format and
    found by name under ``SGDM_SSL_CKPT_DIR``: ``feat_dim`` and the features
    of two 32-px images equal to the JAX backbone's within FEAT_TOL = 1e-4
    relative; the tokens and attention of XCiT too; ``SGDM_FEAT_DTYPE=
    bfloat16`` gives XCiT bfloat16 layers and float32 features; a
    ``timm_*`` name fails naming timm in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgdm_tpu.models import resnet as jax_resnet
from sgdm_tpu.models import xcit as jax_xcit
from sgdm_tpu.selfsup import ssl_backbone as jax_sb
from sgdm_tpu_torch.models import resnet, xcit
from sgdm_tpu_torch.models.convert import resnet_from_flax, xcit_from_flax
from sgdm_tpu_torch.selfsup import ssl_backbone as sb
from torch_port_common import perturbed_flat, unflatten

MODEL_TOL = 2e-5
FEAT_TOL = 1e-4
XCIT_TINY = dict(embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0, cls_attn_layers=2, eta=1.0)


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("stages", [(1, 1, 1, 1), (2, 1, 3, 1)])
def test_resnet_matches_jax(stages):
    jm = jax_resnet.ResNet50(stage_sizes=stages)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = perturbed_flat(shapes, seed=sum(stages))
    tm = resnet.ResNet50(stages)
    tm.load_state_dict(resnet_from_flax(flat, tm), strict=True)
    x = np.random.default_rng(1).standard_normal((2, 3, 40, 48)).astype(np.float32)
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x))
    _close(ours, jm.apply({"params": unflatten(flat)}, _nhwc(x)), MODEL_TOL)


@pytest.mark.parametrize("patch", [8, 16])
@pytest.mark.parametrize("tokens_norm", [True, False])
def test_xcit_matches_jax(patch, tokens_norm):
    kw = dict(XCIT_TINY, patch_size=patch, tokens_norm=tokens_norm)
    jm = jax_xcit.XCiT(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = perturbed_flat(shapes, seed=patch + tokens_norm)
    tm = xcit.XCiT(**kw)
    tm.load_state_dict(xcit_from_flax(flat, tm), strict=True)
    x = np.random.default_rng(2).standard_normal((2, 3, 48, 64)).astype(np.float32)
    for out in ("cls", "tokens", "attn_last"):
        with torch.no_grad():
            ours = tm.eval()(torch.from_numpy(x), out=out)
        _close(ours, jm.apply({"params": unflatten(flat)}, _nhwc(x), out=out), MODEL_TOL)


def _randomize(model: torch.nn.Module, seed: int) -> dict:
    """A state dict of ``model`` with every entry random (BN statistics too)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif v.ndim >= 2 and k != "cls_token":
            sd[k] = torch.randn(v.shape, generator=g) / float(np.sqrt(np.prod(v.shape[1:])))
        else:
            sd[k] = 1.0 * (v.ndim and k.endswith("weight")) + 0.1 * torch.randn(v.shape, generator=g)
    return sd


def _resnet_file(tmp_path, fmt: str, stages, seed: int = 0, drop: str | None = None):
    sd = _randomize(resnet.ResNet50(stages), seed)
    if drop:
        del sd[drop]
    if fmt == "simclr":
        obj = {"state_dict": {**{f"encoder.{k}": v for k, v in sd.items()},
                              "projection.model.0.weight": torch.zeros(4, 2048)}}
    elif fmt == "torchvision":
        obj = {**sd, "fc.weight": torch.zeros(10, 2048), "fc.bias": torch.zeros(10)}
    elif fmt == "vissl":
        obj = {"classy_state_dict": {"base_model": {"model": {
            "trunk": {f"_feature_blocks.{k}": v for k, v in sd.items()}}}}}
    else:                                                     # swav
        obj = {**{f"module.{k}": v for k, v in sd.items()},
               "module.projection_head.0.weight": torch.zeros(2, 2048),
               "module.prototypes.weight": torch.zeros(3, 2)}
    path = tmp_path / f"{fmt}.pth"
    torch.save(obj, path)
    return path


RESNET_LOADERS = {"simclr": "load_simclr_torch_weights", "torchvision": "load_simclr_torch_weights",
                  "vissl": "load_vissl_torch_weights", "swav": "load_vissl_torch_weights"}


@pytest.mark.parametrize("fmt", sorted(RESNET_LOADERS))
def test_resnet_loaders_match_jax(fmt, tmp_path):
    stages = (1, 2, 1, 1)
    path = _resnet_file(tmp_path, fmt, stages, seed=len(fmt))
    loader = RESNET_LOADERS[fmt]
    tm = resnet.ResNet50(stages)
    tm.load_state_dict(getattr(resnet, loader)(str(path)), strict=True)
    params = getattr(jax_resnet, loader)(str(path))
    x = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x))
    _close(ours, jax_resnet.ResNet50(stage_sizes=stages).apply({"params": params}, _nhwc(x)),
           MODEL_TOL)
    (tmp_path / "bad").mkdir()
    bad = _resnet_file(tmp_path / "bad", fmt, stages, drop="layer2.1.bn2.running_var")
    with pytest.raises(KeyError):
        getattr(jax_resnet, loader)(str(bad))
    with pytest.raises(RuntimeError, match="running_var"):
        resnet.ResNet50(stages).load_state_dict(getattr(resnet, loader)(str(bad)), strict=True)


@pytest.mark.parametrize("variant", ["facebookresearch", "timm", "eps"])
def test_xcit_loader_matches_jax(variant, tmp_path):
    kw = dict(XCIT_TINY, patch_size=8)
    sd = _randomize(xcit.XCiT(**kw), 5)
    if variant == "timm":
        sd = {k.replace("pos_embeder.", "pos_embed."): v for k, v in sd.items()}
        sd["head.weight"] = torch.zeros(3, 32)
    path = tmp_path / "xcit.pth"
    torch.save(sd, path)
    # an eps on the scale of the variances ([0.5, 1.5]), so that a loader
    # ignoring it moves the output by far more than MODEL_TOL
    eps = 0.5 if variant == "eps" else 1e-5
    tm = xcit.XCiT(**kw)
    tm.load_state_dict(xcit.load_xcit_torch_weights(str(path), eps=eps), strict=True)
    params = jax_xcit.load_xcit_torch_weights(str(path), eps=eps)
    x = np.random.default_rng(4).standard_normal((2, 3, 32, 40)).astype(np.float32)
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x))
    ref = jax_xcit.XCiT(**kw).apply({"params": params}, _nhwc(x))
    _close(ours, ref, MODEL_TOL)
    if variant == "eps":
        default = xcit.XCiT(**kw)
        default.load_state_dict(xcit.load_xcit_torch_weights(str(path)), strict=True)
        with torch.no_grad():
            moved = np.abs(default.eval()(torch.from_numpy(x)).numpy() - np.asarray(ref)).max()
        assert moved > 10 * MODEL_TOL * max(1.0, np.abs(np.asarray(ref)).max()), moved
    del sd["blocks.0.attn.temperature"]
    torch.save(sd, path)
    with pytest.raises(KeyError):
        jax_xcit.load_xcit_torch_weights(str(path))
    with pytest.raises(RuntimeError, match="temperature"):
        xcit.XCiT(**kw).load_state_dict(xcit.load_xcit_torch_weights(str(path)), strict=True)


# name -> (file name the table finds, format, stage sizes or "xcit")
FULL = {"rn50": ("torchvision", (3, 4, 6, 3)), "simclr_rn50": ("simclr", (3, 4, 6, 3)),
        "vissl_jigsaw": ("vissl", (3, 4, 6, 3)), "vissl_deepclusterv2": ("swav", (3, 4, 6, 3)),
        "vissl_simclr": ("vissl", (3, 4, 23, 3)), "dino_xcit_m24_p8": ("xcit", None)}


def _write_named(tmp_path, name):
    fmt, stages = FULL[name]
    if fmt == "xcit":
        sd = _randomize(xcit.xcit_medium_24_p8(), 9)
        torch.save(sd, tmp_path / sb._CKPT_NAMES[name])
    else:
        _resnet_file(tmp_path, fmt, stages, seed=len(name)).rename(tmp_path / sb._CKPT_NAMES[name])


@pytest.mark.parametrize("name", sorted(FULL))
def test_every_backbone_name_matches_jax(name, tmp_path, monkeypatch):
    assert sb._CKPT_NAMES[name] == jax_sb._CKPT_NAMES[name]
    _write_named(tmp_path, name)
    monkeypatch.setenv("SGDM_SSL_CKPT_DIR", str(tmp_path))
    ours = sb.get_ssl_backbone(name, image_size=32, device="cpu")
    ref = jax_sb.get_ssl_backbone(name, image_size=32)
    assert ours.feat_dim == ref.feat_dim == (512 if "xcit" in name else 2048)
    imgs = np.random.default_rng(7).integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
    x = ours.transform_batch(imgs)
    feat = ours.batch_encode_feat(x)
    assert feat.dtype == np.float32
    _close(feat, ref.batch_encode_feat(ref.transform_batch(imgs)), FEAT_TOL)
    if name == "dino_xcit_m24_p8":
        jx = ref.transform_batch(imgs)
        _close(ours.batch_encode_tokens(x, resampled_size=2),
               ref.batch_encode_tokens(jx, resampled_size=2), FEAT_TOL)
        _close(ours.batch_encode_cls_attention(x), ref.batch_encode_cls_attention(jx), FEAT_TOL)
    else:
        for fn in ("batch_encode_tokens", "batch_encode_cls_attention"):
            with pytest.raises(TypeError):
                getattr(ref, fn)(ref.transform_batch(imgs))
            with pytest.raises(TypeError):
                getattr(ours, fn)(x)


def test_xcit_feat_dtype_knob(monkeypatch):
    monkeypatch.setenv("SGDM_FEAT_DTYPE", "bfloat16")
    bb = sb.get_ssl_backbone("dino_xcit_m24_p8", image_size=32, device="cpu")
    assert bb.model.dtype == torch.bfloat16 and bb.feat_dim == 512
    feat = bb.batch_encode_feat(bb.transform_batch(np.zeros((1, 32, 32, 3), np.uint8)))
    assert feat.dtype == np.float32 and np.isfinite(feat).all()


def test_timm_names_fail_naming_timm_in_both_packages():
    for get in (jax_sb.get_ssl_backbone, lambda n: sb.get_ssl_backbone(n, device="cpu")):
        with pytest.raises(ImportError, match="timm"):
            get("timm_resnet50")


def test_unknown_names_fail_in_both_packages():
    with pytest.raises(ValueError, match="unknown ssl backbone"):
        jax_sb.get_ssl_backbone("nope")
    with pytest.raises(ValueError, match="unknown ssl backbone"):
        sb.get_ssl_backbone("nope", device="cpu")
