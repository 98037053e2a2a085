"""The port's PCA-view and ensemble clustering (`sgdm_tpu_torch/selfsup/
cluster_pca.py`) against the JAX package's (`sgdm_tpu/selfsup/
cluster_pca.py`, whose PCA is sklearn's) on the CPU.

  * `pca_fit` against ``sklearn.decomposition.PCA(svd_solver="full")``:
    mean and components within 1e-6 (the same scipy SVD, the same sign
    rule), float32 and float64 input;
  * `run_pca_views` against JAX's with and without ``pca_shuffle``, with
    and without the 100,000-row subsample (shrunk to 200 rows here): each
    view within PCA_TOL = 1e-5 · max(1, max|view|) in value and sign;
  * `clustering_pca` (4 views) and `clustering_ensemble` (3 members): the
    port's files, read back by h5py, hold the JAX files' [N, views] int64
    ``train`` / ``val`` matrices exactly, the same attributes and the same
    file name up to its time stamp.
"""

import re

import h5py
import numpy as np
import pytest
from sklearn.decomposition import PCA

from sgdm_tpu.selfsup import cluster_pca as jax_cp
from sgdm_tpu_torch.selfsup import cluster_pca as cp

PCA_TOL = 1e-5


def _feats(n: int, d: int, seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    # a spectrum that falls off, so the components are well separated
    return (rng.standard_normal((n, d)) * np.geomspace(3.0, 0.1, d) + rng.standard_normal(d)
            ).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pca_fit_is_sklearns(dtype):
    x = _feats(300, 16, 0, dtype)
    ref = PCA(n_components=16, svd_solver="full").fit(x)
    mean, comps = cp.pca_fit(x)
    assert mean.dtype == comps.dtype == dtype
    np.testing.assert_allclose(mean, ref.mean_, rtol=0, atol=1e-6)
    np.testing.assert_allclose(comps, ref.components_, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.sign(comps[np.arange(16), np.abs(comps).argmax(1)]), 1.0)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("downsample", [100_000, 200])
def test_run_pca_views_match_jax(shuffle, downsample):
    train = _feats(300, 16, 1)
    trainval = np.concatenate([train, _feats(80, 16, 2)])
    kw = dict(total_view=4, downsample_num=downsample, pca_shuffle=shuffle, seed=3)
    ref = jax_cp.run_pca_views(train, trainval, **kw)
    ours = cp.run_pca_views(train, trainval, **kw)
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert o.shape == r.shape == (380, 4) and o.dtype == np.float32
        np.testing.assert_allclose(o, r, rtol=0, atol=PCA_TOL * max(1.0, np.abs(r).max()))


@pytest.fixture
def feat_h5(tmp_path):
    path = tmp_path / "feat.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=_feats(400, 16, 4))
        f.create_dataset("val", data=_feats(100, 16, 5))
        d = f.create_dataset("all_attributes", (1,))
        d.attrs["dataset_name"] = "in64p"
        d.attrs["feat_from"] = "dino_vitb16"
        d.attrs["feat_dim"] = 16
    return path


def _read(path):
    with h5py.File(path) as f:
        a = f["all_attributes"].attrs
        return (f["train"][:], f["val"][:],
                {k: (a[k] if isinstance(a[k], str) else int(a[k])) for k in a})


def _same_file(ours, ref, views: int, k: int):
    assert re.sub(r"_\d{4}-\d\d-\d\dT\d\d_", "_T_", ours.name) == \
        re.sub(r"_\d{4}-\d\d-\d\dT\d\d_", "_T_", ref.name)
    (t1, v1, a1), (t2, v2, a2) = _read(ours), _read(ref)
    assert t1.dtype == v1.dtype == np.int64 and t1.shape == (400, views) and v1.shape == (100, views)
    assert np.array_equal(t1, t2) and np.array_equal(v1, v2)
    assert ((t1 >= 0) & (t1 < k)).all() and ((v1 >= 0) & (v1 < k)).all()
    assert a1 == a2 == dict(dataset_name="in64p", feat_from="dino_vitb16", cluster_k=k,
                            feat_dim=16, is_grey=0)


@pytest.mark.parametrize("shuffle", [False, True])
def test_clustering_pca_file_equals_jax(feat_h5, tmp_path, shuffle):
    kw = dict(cluster_k=5, niter=6, minp=2, pca_group=4, pca_shuffle=shuffle)
    ref = jax_cp.clustering_pca(str(feat_h5), cluster_h5_root=str(tmp_path / "jax"), **kw)
    seen = []
    ours = cp.clustering_pca(str(feat_h5), cluster_h5_root=str(tmp_path / "port"),
                             report=seen.append, device="cpu", **kw)
    assert "pca_seconds" in seen[0] and [r["view"] for r in seen[1:]] == [0, 1, 2, 3]
    _same_file(ours, ref, 4, 5)


def test_clustering_ensemble_file_equals_jax(feat_h5, tmp_path):
    kw = dict(cluster_k=5, niter=6, minp=2, ensemble_num=3)
    ref = jax_cp.clustering_ensemble(str(feat_h5), cluster_h5_root=str(tmp_path / "jax"), **kw)
    ours = cp.clustering_ensemble(str(feat_h5), cluster_h5_root=str(tmp_path / "port"),
                                  device="cpu", **kw)
    _same_file(ours, ref, 3, 5)
    train, _, _ = _read(ours)
    assert len({tuple(c) for c in train.T}) > 1        # the members' seeds differ
