"""The port's k-means, kNN (`ops/kmeans.py`, `ops/knn.py`) and cluster
metrics (`selfsup/cluster.py cal_cluster_metric`) against the JAX package
(and sklearn) on the CPU.

  * `run_kmeans` on separated blobs (the natural k, and k above it): equal
    labels, centroids within rtol 1e-5, ``feat_train`` normalised in place
    to the JAX package's bits; with a subsample (n > k · max points): the
    same draws, the same result.
  * Empty clusters (duplicated points, k above the distinct count): the
    first iteration's split draws as JAX's (the donors and directions:
    centroids within rtol 1e-5); later iterations meet points that sit
    exactly between a split pair, where rounding decides, so a whole run
    is held to its invariants (every label < k, finite centroids).
  * On random data, one Lloyd step from equal centroids: the assignment
    agrees wherever JAX's top-2 gap exceeds 1e-5, and the clusters whose
    members agree have equal counts and sums within 1e-5.
  * `knn_search` / `run_nns` against JAX with duplicated rows, where the
    tie rule (``lax.top_k``: lower index first) decides which copy is the
    dropped "self"; a split of the query chunk changes nothing; ties at
    the k-th place take the lowest indices.
  * `cal_cluster_metric` against sklearn (rtol 1e-10), ``labels_pred_num``
    counting the ground-truth labels as the reference does.
"""

import numpy as np
import pytest
import torch
from sklearn import metrics as skm

import jax
import jax.numpy as jnp

from sgdm_tpu.ops import kmeans as jax_kmeans
from sgdm_tpu.ops import knn as jax_knn
from sgdm_tpu_torch.ops import kmeans, knn
from sgdm_tpu_torch.selfsup.cluster import cal_cluster_metric


def blobs(n_per, k, d, seed, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 10
    return np.concatenate([c + noise * rng.standard_normal((n_per, d)) for c in centers]
                          ).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k_nat,k,n_per,d", [(4, 4, 100, 8), (5, 5, 400, 32), (3, 12, 30, 8)],
                         ids=["k4", "k5_d32", "k12_over_3"])
def test_run_kmeans_on_separated_blobs(seed, k_nat, k, n_per, d):
    x = blobs(n_per, k_nat, d, seed)
    xj, xt = x.copy(), x.copy()
    lj, cj = jax_kmeans.run_kmeans(xj, x.copy(), k, niter=10, chunk=256)
    lt, ct = kmeans.run_kmeans(xt, x.copy(), k, niter=10, chunk=256, device="cpu")
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(xt, xj)                   # normalised in place, same bits
    np.testing.assert_allclose(np.linalg.norm(xt, axis=1), 1.0, rtol=1e-6)


def test_run_kmeans_subsample_draws_as_jax():
    x = blobs(100, 4, 8, seed=3)               # 400 points > 4 · 16
    lj, cj = jax_kmeans.run_kmeans(x.copy(), x.copy(), 4, niter=8, max_points_per_centroid=16)
    lt, ct = kmeans.run_kmeans(x.copy(), x.copy(), 4, niter=8, max_points_per_centroid=16,
                               device="cpu")
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-7)


def _duplicated(seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, 8)) * 10
    base = np.concatenate([c + rng.standard_normal((4, 8)) for c in centers])
    return np.repeat(base, 10, axis=0).astype(np.float32)     # 12 points, each 10 times


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_empty_clusters_split_as_jax(seed):
    x = _duplicated(seed)
    reports = []
    _, cj = jax_kmeans.run_kmeans(x.copy(), x.copy(), 10, niter=1, chunk=64)
    _, ct = kmeans.run_kmeans(x.copy(), x.copy(), 10, niter=1, chunk=64, device="cpu",
                              report=reports.append)
    assert "warning" in reports[0], "120 points for 10 centroids: below min points"
    assert reports[1]["split"] > 0, "the fixture must empty a cluster"
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-7)
    labels, cents = kmeans.run_kmeans(x.copy(), x.copy(), 10, niter=8, chunk=64, device="cpu")
    assert labels.max() < 10 and labels.min() >= 0 and np.isfinite(cents).all()


def test_one_lloyd_step_agrees_away_from_ties():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = x[rng.permutation(4000)[:50]].copy()
    sj, nj, oj = (np.asarray(a) for a in jax_kmeans._lloyd_iter(
        jnp.asarray(x), jnp.asarray(c), k=50, chunk=1024))
    st, nt, ot = (a.numpy() for a in kmeans.lloyd_iteration(
        torch.from_numpy(x), torch.from_numpy(c), 1024))
    lj, _ = jax_kmeans.kmeans_assign(x, c, chunk=1024)
    lt, dt = kmeans.kmeans_assign(x, c, chunk=1024, device="cpu")
    d2 = np.sort(((x[:, None].astype(np.float64) - c[None]) ** 2).sum(-1), axis=1)
    clear = d2[:, 1] - d2[:, 0] > 1e-5
    np.testing.assert_array_equal(lt[clear], lj[clear])
    agree = np.setdiff1d(np.arange(50), np.union1d(lt[lt != lj], lj[lt != lj]))
    np.testing.assert_array_equal(nt[agree], nj[agree])
    np.testing.assert_allclose(st[agree], sj[agree], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ot, oj, rtol=1e-5)
    np.testing.assert_allclose(dt, d2[:, 0], atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 1000, 65536])
def test_kmeans_assign_matches_jax(chunk):
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((1500, 16))).astype(np.float32)
    c = (3 * rng.standard_normal((40, 16))).astype(np.float32)
    lj, dj = jax_kmeans.kmeans_assign(x, c, chunk=chunk)
    lt, dt = kmeans.kmeans_assign(x, c, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(dt, dj, atol=1e-4, rtol=1e-5)
    assert lt.dtype == np.int64 and dt.dtype == np.float32


def _dup_index(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    x[100:200] = x[0:100]          # 100 rows duplicated after their originals
    x[300] = x[450]                # one duplicated before its original
    return x, np.concatenate([x, rng.standard_normal((50, 16)).astype(np.float32)])


@pytest.mark.parametrize("chunk,max_bytes", [(4, knn.MAX_BYTES), (64, knn.MAX_BYTES),
                                             (8192, knn.MAX_BYTES), (8192, 4 * 500 * 7)],
                         ids=["chunk4", "chunk64", "chunk8192", "rows_split"])
def test_knn_search_matches_jax_with_duplicates(chunk, max_bytes, monkeypatch):
    monkeypatch.setattr(knn, "MAX_BYTES", max_bytes)     # rows_split: 7 query rows a split
    x, q = _dup_index(6)
    dj, ij = jax_knn.knn_search(x, q, 6, chunk=chunk)
    dt, it = knn.knn_search(x, q, 6, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=2e-5, rtol=0)


def test_run_nns_drops_the_jax_self():
    x, q = _dup_index(7)
    nj, rj = jax_knn.run_nns(x, q, k_nn=5)
    nt, rt = knn.run_nns(x, q, k_nn=5, device="cpu")
    np.testing.assert_array_equal(nt, nj)
    # radii are square roots: near 0 an f32 error of 1e-5 in d² is 3e-3 in r
    np.testing.assert_allclose(rt ** 2, rj ** 2, atol=2e-5, rtol=0)
    assert nt.dtype == np.int64 and rt.dtype == np.float32
    # a row and its copy tie at 0: the lower index goes as "self", the other stays
    np.testing.assert_array_equal(nt[0:100, 0], np.arange(100, 200))
    np.testing.assert_array_equal(nt[100:200, 0], np.arange(100, 200))


@pytest.mark.parametrize("pattern", ["all_equal", "tie_at_k", "ties_inside", "tie_after_k",
                                     "width_k"])
def test_topk_breaks_ties_as_lax(pattern):
    rng = np.random.default_rng(8)
    d2 = rng.integers(0, 50, (64, 300)).astype(np.float32)
    if pattern == "all_equal":
        d2[:] = 1.0
    elif pattern == "tie_at_k":
        d2[:, ::7] = 0.0                      # 43 zeros a row: the k-th place ties
    elif pattern == "tie_after_k":
        d2 += 6.0                             # the k smallest distinct, from the (k+1)-th on ties
        d2[:, ::7] = 5.0
        d2[:, [3, 100, 200, 250, 299]] = np.arange(5, dtype=np.float32)
    elif pattern == "width_k":
        d2 = d2[:, :5].copy()                 # no (k+1)-th column
    want_v, want_i = jax.lax.top_k(-jnp.asarray(d2), 5)
    got_v, got_i = knn._topk_lowest_index(torch.from_numpy(d2), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), -np.asarray(want_v))


LABELS = {
    "partial": (1000, 10, 12, 0.6),
    "many_clusters": (4000, 50, 200, 0.6),
    "three": (300, 3, 3, 0.5),
    "more_classes": (2000, 1000, 50, 0.6),
    "independent": (1500, 8, 9, 0.0),
}


@pytest.mark.parametrize("case", sorted(LABELS))
def test_cluster_metrics_match_sklearn(case):
    n, kt, kp, agree = LABELS[case]
    rng = np.random.default_rng(9)
    gt = rng.integers(0, kt, n)
    pred = np.where(rng.random(n) < agree, gt % kp, rng.integers(0, kp, n)) + 3
    got = cal_cluster_metric(gt, pred)
    assert got["labels_pred_num"] == len(np.unique(gt))
    np.testing.assert_allclose(got["nmi"], skm.normalized_mutual_info_score(gt, pred), rtol=1e-10)
    np.testing.assert_allclose(got["ami"], skm.adjusted_mutual_info_score(gt, pred), rtol=1e-10)
    np.testing.assert_allclose(got["ari"], skm.adjusted_rand_score(gt, pred), rtol=1e-10)


@pytest.mark.parametrize("pred", ["same", "one_cluster", "relabelled"])
def test_cluster_metrics_limit_cases(pred):
    gt = np.repeat(np.arange(4), 25)
    p = {"same": gt, "one_cluster": np.zeros(100, int), "relabelled": (gt + 1) % 4 * 7}[pred]
    got = cal_cluster_metric(gt, p)
    assert got["nmi"] == skm.normalized_mutual_info_score(gt, p)
    assert got["ami"] == skm.adjusted_mutual_info_score(gt, p)
    assert got["ari"] == skm.adjusted_rand_score(gt, p)
