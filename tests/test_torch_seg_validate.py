"""The port's segmentation metrics, config checks and cluster statistics
(`eval/seg_metrics.py`, `conditioning/validate.py`,
`conditioning/clustering_vis.py`) against the JAX package's on the same
numpy inputs, drawn from a seed.  Requirement: exact (equal dicts, equal
arrays, the same exceptions)."""


import numpy as np
import pytest

from sgdm_tpu.conditioning import clustering_vis as jax_cv
from sgdm_tpu.conditioning import validate as jax_val
from sgdm_tpu.eval import seg_metrics as jax_seg
from sgdm_tpu_torch.conditioning import clustering_vis as cv
from sgdm_tpu_torch.conditioning import validate as val
from sgdm_tpu_torch.eval import seg_metrics as seg


@pytest.mark.parametrize("n_clusters,n_classes,ignore", [(5, 5, 255), (8, 4, 255), (3, 6, 0)])
def test_seg_metrics_equal_jax(n_clusters, n_classes, ignore):
    rng = np.random.default_rng(n_clusters * 10 + n_classes)
    preds = rng.integers(0, n_clusters, (2, 16, 16))
    gts = rng.integers(0, n_classes, (2, 16, 16))
    gts[0, :3] = ignore
    assert seg.unsupervised_seg_metrics(preds, gts, n_clusters, n_classes, ignore) == \
        jax_seg.unsupervised_seg_metrics(preds, gts, n_clusters, n_classes, ignore)


HPARAMS = [
    {"condition_method": None, "cond_dim": 0, "cond_scale": 0, "cond_drop_prob": 1.0},
    {"condition_method": None, "cond_dim": 10},
    {"condition_method": "feat", "condition": {"feat": {"feat_from": "dino"}},
     "data": {"h5_file": "/x/dino_feats.h5"}},
    {"condition_method": "feat", "condition": {"feat": {"feat_from": "simclr"}},
     "data": {"h5_file": "/x/dino_feats.h5"}},
    {"condition_method": "cluster", "data": {"h5_file": "/x/c.h5"}},
    {"condition_method": "cluster", "data": {}},
    {"condition_method": "layout", "data": {"h5_file": "/x/c.h5"}},
    {"condition_method": "layout", "data": {}},
    {"condition_method": "label"},
    {"condition_method": "knn_feat", "data": {"h5_file": "/x/k.h5"}},
    {"condition_method": "nonsense"},
    {"condition_method": "label", "parameterization": "v"},
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:   # the kind and the message
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("i", range(len(HPARAMS)))
def test_assert_check_equals_jax(i):
    assert _outcome(val.assert_check, HPARAMS[i]) == _outcome(jax_val.assert_check, HPARAMS[i])


def test_assert_image_dir_and_default_config_equal_jax(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "ref" / "a.png").write_bytes(b"")
    good = {"fid_train_image_dir": str(tmp_path / "ref"), "fid_val_image_dir": None}
    bad = {"fid_train_image_dir": str(tmp_path / "missing")}
    for cfg in (good, bad):
        assert _outcome(val.assert_image_dir, cfg) == _outcome(jax_val.assert_image_dir, cfg)
    hp = {"cond_scale": 2.0, "condition_method": "cluster", "ddim_eta": 0.5,
          "data": dict(good, name="in64", image_size=64, fid_debug_dir="~/dbg"),
          "model": {"sampling": "ddim", "num_timesteps": 50}}
    assert val.get_default_config(hp) == jax_val.get_default_config(hp)


class _Tracker:
    def __init__(self):
        self.logs = []

    def log(self, metrics, step=None):
        self.logs.append((dict(metrics), step))


def test_log_range_equals_jax():
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
             "cluster": np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)],
             "scalar": np.float32(3.0)}
    a, b = _Tracker(), _Tracker()
    val.log_range(a, batch, step=7)
    jax_val.log_range(b, batch, step=7)
    assert a.logs == b.logs


def _loader(seed, with_labels=True, batches=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        cid = rng.integers(0, 6, 8)
        b = {"image": rng.uniform(-1, 1, (8, 4, 4, 3)).astype(np.float32),
             "cluster": np.eye(6, dtype=np.float32)[cid], "cluster_id": cid,
             "cluster_random": np.eye(6, dtype=np.float32)[rng.integers(0, 6, 8)]}
        if with_labels:
            b["label_id"] = rng.integers(0, 3, 8)
        out.append(b)
    return out


def test_clustering_vis_equals_jax():
    loader = _loader(0)
    cfg = {"cluster": {"random": True}}
    a, b = cv.prepare_cluster(loader[0], cfg), jax_cv.prepare_cluster(loader[0], cfg)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert np.array_equal(a["cluster"], loader[0]["cluster_random"])
    assert cv.prepare_cluster(loader[0], None) is loader[0]
    got = cv.kmeans_vis(loader, np.array([0, 2, 5]), per_cluster=3)
    want = jax_cv.kmeans_vis(loader, np.array([0, 2, 5]), per_cluster=3)
    assert got.keys() == want.keys()
    assert all(len(got[k]) == len(want[k]) and all(np.array_equal(x, y) for x, y in
                                                   zip(got[k], want[k])) for k in got)
    ta, tb = _Tracker(), _Tracker()
    m_port = cv.vis_cluster_statistics(loader, ta, step=3)
    m_jax = jax_cv.vis_cluster_statistics(loader, tb, step=3)
    assert m_port == pytest.approx(m_jax, rel=0, abs=1e-12)
    assert [s for _, s in ta.logs] == [3] and ta.logs[0][0].keys() == tb.logs[0][0].keys()
    assert cv.vis_cluster_statistics(_loader(1, with_labels=False)) == {} == \
        jax_cv.vis_cluster_statistics(_loader(1, with_labels=False))
