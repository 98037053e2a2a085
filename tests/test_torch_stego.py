"""The port's STEGO inference (`sgdm_tpu_torch/selfsup/stego.py`) against
the JAX package's (`sgdm_tpu/selfsup/stego.py`) on the CPU, float32.

One tiny DINO trunk (patch 8, width 32, depth 2, pretrain grid 32 px) under
a 6-wide code head with 5 cluster centres, seeded with numpy and carried
across by `stego_from_flax`; both packages' ``vit_small`` are patched to it
where a checkpoint is read.

  * `DinoFeaturizer` on a square (32 px) and a non-square (48×40 px: the
    position embedding resampled to a 6×5 grid) image: codes within
    CODE_TOL = 2e-5 (JAX's jitted cubic resize of the position embedding
    is inexact by ~1e-5, see `tests/test_torch_vit.py`).
  * `cluster_probe_log_probs` within 2e-6.
  * `predict_mask` on images whose sides are not multiples of 8, with and
    without the CRF: the log-probs within LP_TOL = 5e-6; the masks equal
    except at pixels whose top-2 gap (JAX's CRF probabilities, or its
    log-probs without the CRF) is below GAP_TOL = 1e-3, counted and held
    to at most 1 % of the pixels (measured on the CPU: log-probs within
    9.5e-7, at most 9 near-ties in 2,240 pixels, and no pixel differs).
  * `_load_ckpt` on a written ``LitUnsupervisedSegmenter`` checkpoint: both
    packages read it to the same network and centres (masks as above).
  * The CLIs on a dir of PNG and JPEG images with that checkpoint: the
    port's 8-bit grey mask PNGs against the JAX CLI's, pixel for pixel up
    to the counted near-ties; with ``--no_crf`` against JAX
    ``predict_mask(use_crf=False)``, since the JAX CLI ignores the flag.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from sgdm_tpu.models.vit import VisionTransformer as JaxViT
from sgdm_tpu.native import dense_crf as jax_dense_crf
from sgdm_tpu.selfsup import stego as jax_stego
from sgdm_tpu.selfsup.ssl_backbone import IMAGENET_MEAN, IMAGENET_STD
from sgdm_tpu_torch.models.convert import stego_from_flax
from sgdm_tpu_torch.models.vit import VisionTransformer
from sgdm_tpu_torch.selfsup import stego
from sgdm_tpu_torch.utils.png import read_png
from torch_port_common import perturbed_flat, unflatten

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
DIM, N_CLASSES = 6, 5
CODE_TOL = 2e-5
LP_TOL = 5e-6
GAP_TOL = 1e-3
TIE_SHARE = 0.01
JPEG = "tests/fixtures/jpeg/odd_37x23_420.jpg"


@pytest.fixture(scope="module")
def nets():
    """(JAX featurizer, its params, JAX centres, port featurizer, port centres)."""
    jm = jax_stego.DinoFeaturizer(dim=DIM, backbone=JaxViT(**TINY))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = perturbed_flat(shapes, seed=21)
    clusters = np.random.default_rng(22).standard_normal((N_CLASSES, DIM)).astype(np.float32)
    tm = stego.DinoFeaturizer(dim=DIM, backbone=VisionTransformer(**TINY))
    tm.load_state_dict(stego_from_flax(flat, tm), strict=True)
    return jm, unflatten(flat), jnp.asarray(clusters), tm.eval(), torch.from_numpy(clusters)


def _jax_inference(jm, params, clusters):
    st = jax_stego.StegoInference.__new__(jax_stego.StegoInference)
    st.model, st.params, st.clusters, st.n_classes = jm, params, clusters, N_CLASSES
    st._code = jax.jit(lambda p, x: jm.apply({"params": p}, x))
    return st


def _jax_log_probs(st, img):
    """JAX `predict_mask`'s log-probs [C, h, w], step by step as it computes them."""
    p = 8
    h, w = (img.shape[0] // p) * p or p, (img.shape[1] // p) * p or p
    x = (jnp.asarray(img[:h, :w], dtype=jnp.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    x = x[None]
    code = (st._code(st.params, x) + st._code(st.params, x[:, :, ::-1])[:, :, ::-1]) / 2.0
    code = jax.image.resize(code, (1, h, w, code.shape[-1]), method="bilinear")
    lp = jax_stego.cluster_probe_log_probs(code, st.clusters)
    return np.asarray(lp[0]).transpose(2, 0, 1)


def _images():
    rng = np.random.default_rng(5)
    smooth = lambda h, w: np.clip(                                     # noqa: E731
        np.cumsum(np.cumsum(rng.integers(-9, 10, (h, w, 3)), 0), 1) // 4 + 128, 0, 255
    ).astype(np.uint8)
    return {"a_45x38.png": smooth(45, 38), "b_40x56.png": smooth(40, 56),
            "c_33x33.png": smooth(33, 33)}


def _near_ties(ref_scores: np.ndarray) -> np.ndarray:
    top2 = np.sort(ref_scores, axis=0)[-2:]
    return (top2[1] - top2[0]) < GAP_TOL


def _masks_agree(ours: np.ndarray, ref: np.ndarray, ref_scores: np.ndarray) -> int:
    """Masks equal outside the near-ties; returns the count of near-ties."""
    h, w = ref_scores.shape[1:]
    ties = _near_ties(ref_scores)
    differ = ours[:h, :w] != ref[:h, :w]
    assert not (differ & ~ties).any(), int((differ & ~ties).sum())
    assert ties.mean() <= TIE_SHARE, ties.mean()
    return int(ties.sum())


@pytest.mark.parametrize("hw", [(32, 32), (48, 40)])
def test_featurizer_square_and_non_square(nets, hw):
    jm, params, _, tm, _ = nets
    x = np.random.default_rng(hw[0]).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == ref.shape == (2, hw[0] // 8, hw[1] // 8, DIM)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=CODE_TOL)


def test_cluster_probe_log_probs():
    rng = np.random.default_rng(3)
    code = rng.standard_normal((2, 5, 7, DIM)).astype(np.float32)
    cl = rng.standard_normal((N_CLASSES, DIM)).astype(np.float32)
    for alpha in (2.0, 0.5):
        ref = np.asarray(jax_stego.cluster_probe_log_probs(jnp.asarray(code), jnp.asarray(cl),
                                                           alpha))
        ours = stego.cluster_probe_log_probs(torch.from_numpy(code), torch.from_numpy(cl),
                                             alpha).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", sorted(_images()))
@pytest.mark.parametrize("use_crf", [True, False])
def test_predict_mask(nets, name, use_crf):
    jm, params, jc, tm, tc = nets
    img = _images()[name]
    jst = _jax_inference(jm, params, jc)
    tst = stego.StegoInference.from_trained(tm, tc, device="cpu")
    ref_lp, ours_lp = _jax_log_probs(jst, img), tst.log_probs(img)
    np.testing.assert_allclose(ours_lp, ref_lp, rtol=0, atol=LP_TOL)
    h, w = ref_lp.shape[1:]
    scores = jax_dense_crf(ref_lp, np.ascontiguousarray(img[:h, :w])) if use_crf else ref_lp
    ref, ours = jst.predict_mask(img, use_crf), tst.predict_mask(img, use_crf)
    assert ours.shape == img.shape[:2] and ours.dtype == np.uint8
    _masks_agree(ours, ref, scores)
    # the pad back to the original size repeats the last row / column
    assert np.array_equal(ours[h:], np.repeat(ours[h - 1:h], img.shape[0] - h, 0))
    assert np.array_equal(ours[:, w:], np.repeat(ours[:, w - 1:w], img.shape[1] - w, 1))


@pytest.fixture
def ckpt(nets, tmp_path, monkeypatch):
    """A LitUnsupervisedSegmenter checkpoint of the tiny network, and both
    packages' ``vit_small`` patched to the tiny trunk."""
    _, _, _, tm, tc = nets
    path = tmp_path / "stego.ckpt"
    stego.StegoInference.from_trained(tm, tc, device="cpu").save_ckpt(path)
    monkeypatch.setattr(jax_stego, "vit_small", lambda p: JaxViT(**TINY))
    monkeypatch.setattr(stego, "vit_small", lambda p: VisionTransformer(**TINY))
    return path


def test_load_ckpt(nets, ckpt):
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    assert "net.model.blocks.0.attn.qkv.weight" in sd and "net.cluster2.2.bias" in sd
    assert tuple(sd["cluster_probe.clusters"].shape) == (N_CLASSES, DIM)
    jst = jax_stego.StegoInference(n_classes=N_CLASSES, dim=DIM, ckpt_path=str(ckpt))
    tst = stego.StegoInference(n_classes=N_CLASSES, dim=DIM, ckpt_path=str(ckpt), device="cpu")
    _, _, _, tm, tc = nets
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in tst.model.state_dict().items())
    assert torch.equal(tst.clusters, tc)
    img = _images()["a_45x38.png"]
    ref_lp = _jax_log_probs(jst, img)
    np.testing.assert_allclose(tst.log_probs(img), ref_lp, rtol=0, atol=LP_TOL)
    _masks_agree(tst.predict_mask(img, False), jst.predict_mask(img, False), ref_lp)


def test_without_a_checkpoint_the_head_is_seeded(monkeypatch):
    monkeypatch.setattr(stego, "vit_small", lambda p: VisionTransformer(**TINY))
    a = stego.StegoInference(n_classes=N_CLASSES, dim=DIM, seed=3, device="cpu")
    b = stego.StegoInference(n_classes=N_CLASSES, dim=DIM, seed=3, device="cpu")
    c = stego.StegoInference(n_classes=N_CLASSES, dim=DIM, seed=4, device="cpu")
    img = _images()["c_33x33.png"]
    assert np.array_equal(a.log_probs(img), b.log_probs(img))
    assert not np.array_equal(a.log_probs(img), c.log_probs(img))


def _image_dir(tmp_path):
    """A dir of PNG images (one in a sub dir) and a JPEG; returns (dir, {name: image})."""
    img_dir = tmp_path / "images"
    (img_dir / "sub").mkdir(parents=True)
    imgs = _images()
    for name, img in imgs.items():
        Image.fromarray(img).save(img_dir / ("sub" if name.startswith("b") else "") / name)
    (img_dir / "d_odd.jpg").write_bytes(open(JPEG, "rb").read())
    imgs["d_odd.jpg"] = np.asarray(Image.open(JPEG).convert("RGB"))
    return img_dir, imgs


def test_cli_masks_equal_the_jax_cli(nets, ckpt, tmp_path, monkeypatch):
    img_dir, imgs = _image_dir(tmp_path)
    flags = ["--image_dir", str(img_dir), "--ckpt", str(ckpt), "--n_classes", str(N_CLASSES),
             "--dim", str(DIM)]
    monkeypatch.setattr(sys, "argv", ["prog", *flags, "--out_dir", str(tmp_path / "jax")])
    jax_stego.main()
    stego.main([*flags, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jst = jax_stego.StegoInference(n_classes=N_CLASSES, dim=DIM, ckpt_path=str(ckpt))
    ties = 0
    for name, img in imgs.items():
        stem = name.rsplit(".", 1)[0]
        ref = np.asarray(Image.open(tmp_path / "jax" / f"{stem}.png"))
        ours = read_png(tmp_path / "port" / f"{stem}.png", samples=True)
        assert ours.dtype == np.uint8 and ours.shape == img.shape[:2] == ref.shape
        lp = _jax_log_probs(jst, img)
        h, w = lp.shape[1:]
        ties += _masks_agree(ours, ref, jax_dense_crf(lp, np.ascontiguousarray(img[:h, :w])))
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


def test_cli_no_crf_masks_equal_jax_predict_mask(nets, ckpt, tmp_path, monkeypatch):
    """The port's ``--no_crf`` skips the CRF; the JAX CLI parses the flag and
    still runs it (`generate_mask_dir` calls `predict_mask` with its default
    ``use_crf=True``), so the port is held against JAX ``predict_mask(use_crf=False)``."""
    img_dir, imgs = _image_dir(tmp_path)
    flags = ["--image_dir", str(img_dir), "--ckpt", str(ckpt), "--n_classes", str(N_CLASSES),
             "--dim", str(DIM), "--no_crf"]
    monkeypatch.setattr(sys, "argv", ["prog", *flags, "--out_dir", str(tmp_path / "jax")])
    jax_stego.main()
    stego.main([*flags, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jst = jax_stego.StegoInference(n_classes=N_CLASSES, dim=DIM, ckpt_path=str(ckpt))
    crf_differs = False
    for name, img in imgs.items():
        stem = name.rsplit(".", 1)[0]
        ours = read_png(tmp_path / "port" / f"{stem}.png", samples=True)
        _masks_agree(ours, jst.predict_mask(img, False), _jax_log_probs(jst, img))
        jax_cli = np.asarray(Image.open(tmp_path / "jax" / f"{stem}.png"))
        with_crf = jst.predict_mask(img, True)
        assert np.array_equal(jax_cli, with_crf)              # the reference's fault
        crf_differs |= not np.array_equal(with_crf, jst.predict_mask(img, False))
    assert crf_differs                                        # the flag is observable here
