"""The port's dense CRF (`sgdm_tpu_torch/native/densecrf.cpp`, `native.
dense_crf` / `permutohedral_filter`) against the JAX package's
(`sgdm_tpu/native`) on the CPU.

  * The same source, built with the port's flags (``-fopenmp`` added; the
    source has no pragma): the refined probabilities and the lattice filter
    are equal bit for bit (found: equal; the bound stated is 0), and two
    runs of each are equal bit for bit (the lattice's hash map is read by
    key, so its iteration order does not leak).
  * Both against the exact Gaussians on at most 400 points: the lattice
    filter's correlation with the brute-force Gaussian (features spread
    over [0, 4), as `tests/test_native_crf.py`) above 0.98 for 2 and 3
    feature dimensions and above 0.96 for 5, the bilateral kernel's
    (measured 0.9975, 0.9967, 0.9701); the CRF against `dense_crf_plain`
    (the same mean field with exact kernels, float64) on noisy two-region
    images of 400 and 384 pixels: the lattice approximates the one-pixel
    positional kernel coarsely, so the probabilities correlate at 0.772 and
    0.781 and 83.5 % / 84.4 % of the argmaxes agree (measured); held above
    0.7 and 0.8, and each CRF must clean the noisy unary (the exact one to
    above 0.97 of the truth).
"""

import numpy as np
import pytest

from sgdm_tpu import native as jax_native
from sgdm_tpu_torch import native

CRF_BOUND = 0.0        # max |port − JAX|: the same source and -O3


def _inputs(seed: int, c: int, h: int, w: int, structured: bool):
    rng = np.random.default_rng(seed)
    if structured:
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = [200, 30, 30]
        img[:, w // 2:] = [30, 30, 200]
        img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
        true = np.zeros((h, w), int)
        true[:, w // 2:] = 1
        noisy = np.where(rng.random((h, w)) < 0.2, 1 - true, true)
        logits = np.stack([(noisy == k) * 2.0 - 1.0 for k in range(c)]).astype(np.float32)
        logits += 0.3 * rng.standard_normal(logits.shape).astype(np.float32)
    else:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        logits = rng.standard_normal((c, h, w)).astype(np.float32)
    return logits, img


CASES = [(0, 5, 20, 18, False), (1, 27, 17, 23, False), (2, 2, 48, 48, True),
         (3, 3, 33, 40, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}x{c[2]}x{c[3]}")
@pytest.mark.parametrize("iters", [1, 10])
def test_dense_crf_equals_jax(case, iters):
    seed, c, h, w, structured = case
    logits, img = _inputs(seed, c, h, w, structured)
    kw = dict(iters=iters)
    ours = native.dense_crf(logits, img, **kw)
    ref = jax_native.dense_crf(logits, img, **kw)
    assert ours.shape == (c, h, w) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= CRF_BOUND
    again = native.dense_crf(logits, img, **kw)
    assert np.array_equal(ours, again)
    np.testing.assert_allclose(ours.sum(0), 1.0, rtol=1e-4)


def test_dense_crf_parameters_reach_the_library():
    logits, img = _inputs(4, 4, 16, 16, False)
    kw = dict(iters=3, pos_w=2.0, pos_xy_std=2.0, bi_w=5.0, bi_xy_std=30.0, bi_rgb_std=10.0)
    ours = native.dense_crf(logits, img, **kw)
    assert np.array_equal(ours, jax_native.dense_crf(logits, img, **kw))
    assert not np.array_equal(ours, native.dense_crf(logits, img, iters=3))


@pytest.mark.parametrize("fd,vd,min_corr", [(2, 1, 0.98), (3, 2, 0.98), (5, 4, 0.96)])
def test_permutohedral_filter_equals_jax_and_the_exact_gaussian(fd, vd, min_corr):
    rng = np.random.default_rng(fd)
    n = 300
    feats = (rng.random((n, fd)) * 4).astype(np.float32)
    vals = rng.random((n, vd)).astype(np.float32)
    ours = native.permutohedral_filter(feats, vals)
    assert np.array_equal(ours, jax_native.permutohedral_filter(feats, vals))
    assert np.array_equal(ours, native.permutohedral_filter(feats, vals))
    gold = np.exp(-((feats[:, None] - feats[None]) ** 2).sum(-1) / 2) @ vals
    corr = np.corrcoef((ours / ours.sum(0)).ravel(), (gold / gold.sum(0)).ravel())[0, 1]
    assert corr > min_corr, corr


@pytest.mark.parametrize("seed,h,w", [(5, 20, 20), (6, 16, 24)])
def test_dense_crf_tracks_the_exact_mean_field(seed, h, w):
    logits, img = _inputs(seed, 2, h, w, True)
    true = np.zeros((h, w), int)
    true[:, w // 2:] = 1
    unary_acc = (logits.argmax(0) == true).mean()
    plain = native.dense_crf_plain(logits, img)
    assert (plain.argmax(0) == true).mean() > 0.97
    for crf in (native.dense_crf, jax_native.dense_crf):
        q = crf(logits, img)
        corr = np.corrcoef(q.ravel(), plain.ravel())[0, 1]
        agree = (q.argmax(0) == plain.argmax(0)).mean()
        assert corr > 0.7 and agree > 0.8, (corr, agree)
        assert (q.argmax(0) == true).mean() > unary_acc


def test_dense_crf_plain_cleans_a_noisy_mask():
    logits, img = _inputs(7, 2, 20, 20, True)
    true = np.zeros((20, 20), int)
    true[:, 10:] = 1
    before = (logits.argmax(0) == true).mean()
    after = (native.dense_crf_plain(logits, img).argmax(0) == true).mean()
    assert after > before and after > 0.97


def test_dense_crf_refuses_a_mismatched_image():
    logits, img = _inputs(8, 3, 8, 8, False)
    with pytest.raises(ValueError, match="uint8"):
        native.dense_crf(logits, img[:4])
    with pytest.raises(ValueError, match="uint8"):
        native.dense_crf(logits, img.astype(np.float32))
