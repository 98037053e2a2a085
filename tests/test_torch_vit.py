"""The port's ViT (`models/vit.py`), its weights and `utils/resize.py`
against the JAX package on the CPU, float32.

  * Every ``out`` mode of `VisionTransformer` on the 32-px pretrain grid
    and off it (48 px: the position embedding resampled with JAX's cubic),
    against `sgdm_tpu.models.vit.VisionTransformer.apply` with the same
    weights carried across by `vit_from_flax` (atol 2e-5).
  * One DINO-format checkpoint (``torch.save``, plain and wrapped in
    ``state_dict`` with ``module.`` prefixes) loads through both packages'
    loaders and gives equal CLS features; `verify_dino_load` checks a
    sidecar golden, and warns and skips without one.
  * `utils/resize.py`: its weight matrices against JAX's
    ``compute_weight_mat`` run eagerly (atol 2e-7); whole resizes against
    ``jax.image.resize`` for linear and cubic, up and down, at atol
    2e-5 · max(1, max|x|).  That bound is JAX's own error: jitted on the
    CPU, XLA computes the weights' renormalising division inexactly
    (measured on the CPU: the jitted weights of 300 → 224 sum to 1 ± 7.6e-6 per
    output, the eager ones and the port's to 1 ± 1.2e-7), and two resized
    axes double it.  `SSLBackbone.transform_batch` at 64 → 224 and
    300 → 224 against the JAX backbone's: the same bound on the 0-1 scale,
    divided by the smallest ImageNet std after normalisation.
  * The backbone table: every ViT name builds the JAX package's
    architecture; what the port still refuses raises, naming it (a
    ``.msgpack`` encoder, ``timm_*`` without timm), and so do the outputs a
    ResNet or an XCiT does not have (`tests/test_torch_backbones.py` holds
    the other names against JAX).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgdm_tpu.models import vit as jax_vit
from sgdm_tpu.selfsup import ssl_backbone as jax_sb
from sgdm_tpu_torch.models.convert import load_dino_torch_weights, vit_from_flax
from sgdm_tpu_torch.models.vit import VisionTransformer, interpolate_pos_embed
from sgdm_tpu_torch.selfsup import ssl_backbone as sb
from sgdm_tpu_torch.utils import weight_verify
from sgdm_tpu_torch.utils.resize import resize, resize_weights
from torch_port_common import perturbed_flat, unflatten

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
ATOL = 2e-5
RESIZE_TOL = 2e-5      # JAX's jitted resize on the CPU: see the module docstring


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model) with the same seeded weights."""
    jm = jax_vit.VisionTransformer(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = perturbed_flat(shapes, seed=3)
    tm = VisionTransformer(**TINY)
    tm.load_state_dict(vit_from_flax(flat, tm), strict=True)
    return jm, unflatten(flat), tm.eval()


def _leaves(x):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(x)]


def _torch_leaves(x):
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [a for item in x for a in _torch_leaves(item)]


@pytest.mark.parametrize("size", [32, 48], ids=["on_grid", "off_grid"])
@pytest.mark.parametrize("out", ["cls", "tokens", "tokens_pair", "qkv_last", "attn_last"])
def test_out_modes_match_jax(tiny, out, size):
    jm, jp, tm = tiny
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = _leaves(jm.apply({"params": jp}, jnp.asarray(x), out=out))
    with torch.no_grad():
        got = _torch_leaves(tm(torch.from_numpy(x).permute(0, 3, 1, 2), out=out))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("grid", [(6, 6), (3, 3), (6, 9)], ids=["up", "down", "oblong"])
def test_pos_embed_interpolation_matches_jax(grid):
    pos = np.random.default_rng(1).normal(0, 0.02, (1, 17, 32)).astype(np.float32)
    want = np.asarray(jax_vit.interpolate_pos_embed(jnp.asarray(pos), grid))
    got = interpolate_pos_embed(torch.from_numpy(pos), grid).numpy()
    assert got.shape == want.shape == (1, 1 + grid[0] * grid[1], 32)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(pos).max(), rtol=0)


RESIZES = [((2, 64, 64, 3), (2, 224, 224, 3), "bilinear"),
           ((2, 300, 300, 3), (2, 224, 224, 3), "bilinear"),
           ((3, 6, 6, 16), (3, 14, 14, 16), "linear"),
           ((3, 28, 28, 16), (3, 14, 14, 16), "linear"),
           ((1, 4, 4, 8), (1, 6, 6, 8), "cubic"),
           ((1, 14, 14, 32), (1, 6, 9, 32), "cubic")]


@pytest.mark.parametrize("scale", ["image", "features"])
@pytest.mark.parametrize("shape,out,method", RESIZES,
                         ids=["bilinear_64_224", "bilinear_300_224", "linear_up", "linear_down",
                              "cubic_up", "cubic_down"])
def test_resize_matches_jax(shape, out, method, scale):
    rng = np.random.default_rng(7)
    x = (rng.random(shape) if scale == "image" else 3 * rng.standard_normal(shape))
    x = x.astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method=method))
    got = resize(torch.from_numpy(x), out, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL * max(1.0, np.abs(x).max()), rtol=0)


@pytest.mark.parametrize("n_in,n_out,method", [(300, 224, "linear"), (64, 224, "linear"),
                                               (28, 14, "linear"), (14, 6, "cubic"),
                                               (4, 6, "cubic")])
def test_resize_weights_match_jax_eager(n_in, n_out, method):
    from jax._src.image import scale

    kernel = {"linear": scale._fill_triangle_kernel, "cubic": scale._fill_keys_cubic_kernel}[method]
    with jax.disable_jit():
        want = np.asarray(scale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, kernel, True))
    np.testing.assert_allclose(resize_weights(n_in, n_out, method).numpy(), want, atol=2e-7, rtol=0)


def test_resize_weights_sum_to_one_inside():
    for n_in, n_out, m in [(300, 224, "linear"), (64, 224, "linear"), (14, 6, "cubic")]:
        w = resize_weights(n_in, n_out, m).numpy()
        np.testing.assert_allclose(w.sum(0), 1.0, atol=2e-7)
    with pytest.raises(ValueError, match="linear and cubic"):
        resize_weights(4, 8, "lanczos3")


@pytest.mark.parametrize("size", [64, 300])
def test_transform_batch_matches_jax(tiny, size):
    jm, jp, tm = tiny
    imgs = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    want = np.asarray(jax_sb.SSLBackbone("tiny", jm, jp, image_size=224).transform_batch(imgs))
    got = sb.SSLBackbone("tiny", tm, image_size=224, device="cpu").transform_batch(imgs)
    assert tuple(got.shape) == (2, 3, 224, 224)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=RESIZE_TOL / float(sb.IMAGENET_STD.min()), rtol=0)


def _dino_state(wrapped: bool) -> dict:
    state = sb.random_vit_state(VisionTransformer(**TINY), seed=5)
    state["pos_embed"] = state["pos_embed"] * 25       # a position embedding that matters
    if wrapped:
        return {"state_dict": {f"module.{k}": v for k, v in state.items()}}
    return state


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "state_dict"])
def test_dino_checkpoint_loads_in_both_packages(tmp_path, wrapped):
    path = tmp_path / "dino_tiny.pth"
    torch.save(_dino_state(wrapped), path)
    jm = jax_vit.VisionTransformer(**TINY)
    jp = jax_vit.load_dino_torch_weights(str(path))
    tm = VisionTransformer(**TINY)
    tm.load_state_dict(load_dino_torch_weights(str(path)), strict=True)
    x = np.random.default_rng(2).standard_normal((3, 48, 48, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x), out="cls"))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), out="cls").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_vit_from_flax_must_cover_the_model(tiny):
    jm, jp, tm = tiny
    from flax import traverse_util

    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, jp), sep="/")
    del flat["blocks_1/mlp/fc2/bias"]
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        vit_from_flax(flat, tm)


@pytest.mark.parametrize("sidecar", ["none", "right", "wrong"])
def test_verify_dino_load(tmp_path, tiny, sidecar):
    _, _, tm = tiny
    ckpt = tmp_path / "dino.pth"
    torch.save(tm.state_dict(), ckpt)
    x = torch.from_numpy(weight_verify._fixed_input((1, 3, 32, 32)))
    with torch.no_grad():
        cls = tm(x, out="cls").numpy()
    if sidecar == "none":
        assert weight_verify.verify_dino_load(ckpt, tm) is False
        return
    np.savez(str(ckpt) + ".golden.npz", cls=cls if sidecar == "right" else cls + 0.01)
    if sidecar == "right":
        assert weight_verify.verify_dino_load(ckpt, tm) is True
    else:
        with pytest.raises(RuntimeError, match="verification FAILED"):
            weight_verify.verify_dino_load(ckpt, tm)


@pytest.mark.parametrize("name", sorted(sb._VITS))
def test_vit_names_build_the_jax_architecture(name):
    build, patch = sb._VITS[name]
    jm = {"dino_vits16": lambda: jax_vit.vit_small(16), "dino_vits8": lambda: jax_vit.vit_small(8),
          "dino_vitb16": lambda: jax_vit.vit_base(16), "dino_vitb8": lambda: jax_vit.vit_base(8),
          "mae_vitb16": lambda: jax_vit.vit_base(16), "msn_vits16": lambda: jax_vit.vit_small(16),
          "msn_vitb16": lambda: jax_vit.vit_base(16)}[name]()
    with torch.device("meta"):
        tm = build(patch)
    for field in ("patch_size", "embed_dim", "depth", "num_heads", "pretrain_img_size"):
        assert getattr(tm, field) == getattr(jm, field), field


@pytest.mark.parametrize("name", ["dino_xcit_m24_p8", "vissl_simclr", "rn50", "simclr_rn50",
                                  "timm_resnet50", "msgpack"])
def test_unported_backbones_raise(name, tmp_path):
    if name == "msgpack":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sb.get_ssl_backbone("dino_vits16", device="cpu",
                                ckpt_path=str(tmp_path / "enc.msgpack"))
    elif name.startswith("timm_"):
        with pytest.raises(ImportError, match="timm"):
            sb.get_ssl_backbone(name, device="cpu")
    else:
        # the ResNets have no token / attention outputs (TypeError, as the JAX
        # package's); the XCiT no output beyond cls / tokens / attn_last
        bb = sb.get_ssl_backbone(name, image_size=32, device="cpu")
        x = bb.transform_batch(np.zeros((1, 32, 32, 3), np.uint8))
        if name == "dino_xcit_m24_p8":
            with pytest.raises(ValueError, match="unknown out"):
                bb.encode(x, "qkv_last")
        else:
            with pytest.raises(TypeError, match="ResNet"):
                bb.batch_encode_tokens(x)
            with pytest.raises(TypeError, match="ResNet"):
                bb.batch_encode_cls_attention(x)


def test_feat_dtype_env_selects_bfloat16(monkeypatch):
    monkeypatch.setenv("SGDM_FEAT_DTYPE", "bfloat16")
    bb = sb.get_ssl_backbone("dino_vits16", device="cpu")
    assert bb.model.dtype == torch.bfloat16 and bb.feat_dim == 384
    x = bb.transform_batch(np.zeros((1, 64, 64, 3), np.uint8))
    assert bb.batch_encode_feat(x).dtype == np.float32


@pytest.mark.parametrize("what", ["drop_path", "patch_keep_ids", "odd_size"])
def test_unported_options_raise(tiny, what):
    _, _, tm = tiny
    if what == "drop_path":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            VisionTransformer(**TINY, drop_path_rate=0.1)
    elif what == "patch_keep_ids":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm(torch.zeros(1, 3, 32, 32), patch_keep_ids=torch.zeros(1, 4, dtype=torch.long))
    else:
        with pytest.raises(ValueError, match="multiple of the patch"):
            tm(torch.zeros(1, 3, 36, 32))


def test_checkpoint_found_by_name_or_refused_by_path(tmp_path, monkeypatch):
    with torch.device("meta"):
        shapes = VisionTransformer(patch_size=16, embed_dim=384, depth=12, num_heads=6)
    state = sb.random_vit_state(shapes, seed=9)
    torch.save(state, tmp_path / "dino_deitsmall16_pretrain.pth")
    monkeypatch.setenv("SGDM_SSL_CKPT_DIR", str(tmp_path))
    bb = sb.get_ssl_backbone("dino_vits16", device="cpu")
    got = bb.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in state.items())
    with pytest.raises(FileNotFoundError, match="not found"):
        sb.get_ssl_backbone("dino_vits16", ckpt_path=str(tmp_path / "missing.pth"), device="cpu")


def test_tencrop_matches_jax():
    imgs = np.random.default_rng(3).integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    want = jax_sb.tencrop_batch(imgs)
    got = sb.tencrop_batch(imgs)
    assert got.shape == want.shape == (2, 10, 35, 42, 3)
    np.testing.assert_array_equal(got, want)
