"""The port's FID metric math (`sgdm_tpu_torch/eval/metrics.py`) against
`sgdm_tpu/eval/metrics.py` on the same seeded numpy inputs at small
dimensions: both are numpy float64, so each case is held to 1e-12 relative
(FeatureStats, Fréchet distance, IS) or to equality (PRDC, whose values are
counts)."""

import numpy as np
import pytest
import torch

import sgdm_tpu.eval.metrics as jm
import sgdm_tpu_torch.eval.metrics as pm

RTOL = 1e-12


def _feats(seed, n=40, d=12, shift=0.0):
    return np.random.default_rng(seed).standard_normal((n, d)) + shift


def _stats(mod, seed):
    st = mod.FeatureStats(capture_all=True, max_items=50)
    for part in np.array_split(_feats(seed, n=64), 3):
        st.append(part)
    other = mod.FeatureStats()
    other.append(_feats(seed + 1, n=9))
    st.merge(other)
    mu, cov = st.mean_cov()
    return [np.array([st.n]), mu, cov, st.raw]


def _frechet(mod, seed):
    a, b = _feats(seed), _feats(seed + 1, shift=0.5)
    return [np.array([mod.frechet_distance(a.mean(0), np.cov(a.T), b.mean(0), np.cov(b.T))])]


def _frechet_singular(mod, seed):
    a, b = _feats(seed, n=6), _feats(seed + 1, n=6, shift=0.3)   # rank 5 of 12: the eps path
    return [np.array([mod.frechet_distance(a.mean(0), np.cov(a.T), b.mean(0), np.cov(b.T))])]


def _inception_score(mod, seed):
    logits = _feats(seed, n=50, d=20) * 3
    return [np.array(mod.inception_score(logits, splits=s)) for s in (1, 10, 7)]


def _prdc(mod, seed):
    real, fake = _feats(seed, n=30), _feats(seed + 1, n=25, shift=0.4)
    return [np.array(list(mod.compute_prdc(real, fake, nearest_k=k).values())) for k in (3, 5)]


CASES = {"feature_stats": _stats, "frechet": _frechet, "frechet_singular": _frechet_singular,
         "inception_score": _inception_score, "prdc": _prdc}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_metric_matches_jax_package(case, seed):
    got, want = CASES[case](pm, seed), CASES[case](jm, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.all(np.isfinite(g))
        if case == "prdc":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * np.abs(w).max())


def test_reduce_is_the_identity_in_one_process_and_refuses_a_world(monkeypatch):
    """One process: the identity.  A world of two (its collective stood in
    for by a second rank holding the same rows; the real two-rank reduce,
    an empty rank included, is tests/test_torch_parallel.py's): every sum
    doubles, so μ stays; an accumulator with no rows joins with zeros of
    width ``dim`` (the reduce no longer refuses a world: it sums across it)."""
    from sgdm_tpu_torch.parallel import mesh

    st = pm.FeatureStats()
    st.append(_feats(0))
    mu, cov = st.mean_cov()
    assert st.reduce_across_processes() is st
    np.testing.assert_array_equal(st.mean_cov()[1], cov)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    sent = []
    monkeypatch.setattr(mesh, "all_reduce_array", lambda a, group=None: sent.append(a) or 2 * a)
    n, total = st.n, st._sum.copy()
    assert st.reduce_across_processes() is st
    assert st.n == 2 * n and sent[0].dtype == np.float64
    np.testing.assert_array_equal(st._sum, 2 * total)
    np.testing.assert_allclose(st.mean_cov()[0], mu, rtol=1e-12)
    empty = pm.FeatureStats().reduce_across_processes(dim=5)
    assert empty.n == 0 and empty._outer.shape == (5, 5) and sent[1].shape == (1 + 5 + 25,)
