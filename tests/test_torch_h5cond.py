"""`sgdm_tpu_torch/data/h5cond.py` against `sgdm_tpu/data/h5cond.py`.

The h5 files are written here by h5py, in the layouts the JAX package's
self-annotation writes (cluster, feat, patch, kNN and LOST files, with the
sibling ``.json`` of ``name2id``).  For every method of
``ConditionLookup.get``, the JAX lookup and the port's give equal keys,
dtypes and values over every index, under label lists that are 0-based,
1-based, a subset without class 0 and noised.  ``knn_feat`` draws its
neighbour per access in both packages: the port's pick lies among the row's
first ``knn_k`` neighbours, and ``knn_feat_random`` is equal.  `LostLookup`
boxes and cluster ids match.
"""

import json

import h5py
import numpy as np
import pytest

from sgdm_tpu.data.h5cond import ConditionLookup as JaxLookup
from sgdm_tpu.data.h5cond import LostLookup as JaxLost
from sgdm_tpu_torch.data.h5cond import (ConditionLookup, LostLookup, ds_has_label_info,
                                        normalize_feat, skip_id2name)

N_TRAIN, N_VAL, K, K2, D, P, NUM_CLASSES, NNS = 40, 12, 9, 5, 6, 4, 7, 5


def _name(i):
    return f"{i}.jpg"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5cond")
    rng = np.random.default_rng(0)
    # h5 row order differs from the dataset's: name2id is a permutation
    perm = {split: rng.permutation(n) for split, n in (("train", N_TRAIN), ("val", N_VAL))}

    def cluster_file(path, k, seed):
        r = np.random.default_rng(seed)
        with h5py.File(path, "w") as f:
            for split, n in (("train", N_TRAIN), ("val", N_VAL)):
                f.create_dataset(split, data=r.integers(0, k, n))
                f.create_dataset(f"{split}_nns", data=np.stack(
                    [r.permutation(N_TRAIN)[:NNS] for _ in range(n)]))
            f.create_dataset("centroids", data=r.standard_normal((k, D)).astype(np.float32))
            f.create_dataset("train_feat", data=r.standard_normal((N_TRAIN, D)).astype(np.float32))
            d = f.create_dataset("all_attributes", (1,))
            d.attrs["cluster_k"] = k
            d.attrs["dataset_name"] = "inp"       # string attributes: present, never read
            d.attrs["feat_from"] = "dino_vitb16"
        # one name2id for both splits' names, as the cluster writer keeps it
        path.with_suffix(".json").write_text(json.dumps(
            {"name2id": {_name(i): int(perm["train"][i]) for i in range(N_TRAIN)}}))
        return path

    out = {"cluster": cluster_file(root / "cluster.h5", K, 1),
           "cluster2": cluster_file(root / "cluster2.h5", K2, 2)}
    with h5py.File(root / "feat.h5", "w") as f:
        for split, n in (("train", N_TRAIN), ("val", N_VAL)):
            f.create_dataset(split, data=rng.standard_normal((n, D)).astype(np.float32))
    (root / "feat.json").write_text(json.dumps(
        {"name2id": {_name(i): int(perm["train"][i]) for i in range(N_TRAIN)}}))
    out["feat"] = root / "feat.h5"
    with h5py.File(root / "patch.h5", "w") as f:
        for split, n in (("train", N_TRAIN), ("val", N_VAL)):
            f.create_dataset(split, data=rng.standard_normal((n, P, D)).astype(np.float32))
    (root / "patch.json").write_text((root / "feat.json").read_text())
    out["patch"] = root / "patch.h5"
    with h5py.File(root / "patchcluster.h5", "w") as f:
        for split, n in (("train", N_TRAIN), ("val", N_VAL)):
            f.create_dataset(split, data=rng.integers(0, K, (n, P)))
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = K
    (root / "patchcluster.json").write_text((root / "feat.json").read_text())
    out["patchcluster"] = root / "patchcluster.h5"
    with h5py.File(root / "lost.h5", "w") as f:
        for i in range(N_TRAIN):
            f.create_dataset(f"{_name(i)}_bbox", data=rng.integers(0, 64, 4))
            f.create_dataset(f"{_name(i)}_clusterid", data=np.int64(rng.integers(0, K)))
        f.attrs["cluster_k"] = K
    out["lost"] = root / "lost.h5"
    return out


FILE_OF = {"feat": "feat", "patchfeat": "patch", "cluster": "cluster",
           "clusterrandom": "cluster", "clusterlayout": "cluster", "labelcluster": "cluster",
           "centroid": "cluster", "labelcentroid": "cluster", "patchcluster": "patchcluster",
           "clustermix": "cluster", "knn_feat": "cluster"}
METHODS = [None, "attr", "label", "layout", "stegoclusterlayout", "cluster_lookup",
           *FILE_OF]


def _labels(kind):
    rng = np.random.default_rng(5)
    if kind == "0-based":
        return rng.integers(0, NUM_CLASSES, N_TRAIN)
    if kind == "1-based":   # every class present: shifted down
        return np.concatenate([np.arange(1, NUM_CLASSES + 1),
                               rng.integers(1, NUM_CLASSES + 1, N_TRAIN - NUM_CLASSES)])
    if kind == "subset":    # no class 0 and not 1-based: left alone
        return rng.integers(1, NUM_CLASSES - 1, N_TRAIN)
    return None


def _pair(files, method, dataset_name="inp", labels="0-based", noise=0.0, seed=0):
    kw = dict(label_list=_labels(labels), num_classes=NUM_CLASSES, seed=seed,
              condition_cfg={"label": {"noise_ratio": noise}, "knn_feat": {"knn_k": 3}},
              id2name=_name)
    if method in FILE_OF:
        kw["h5_file"] = str(files[FILE_OF[method]])
    else:
        kw["h5_file"] = None
    if method == "clustermix":
        kw["h5_file2"] = str(files["cluster2"])
    return (JaxLookup(method, split_name="train", dataset_name=dataset_name, **kw),
            ConditionLookup(method, split_name="train", dataset_name=dataset_name, **kw))


def _assert_equal_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# the label-concatenating methods need a label list (a KeyError in both without)
CASES = [(m, lab) for m in METHODS for lab in ("0-based", "1-based", "subset", "noised", "none")
         if not (m in ("labelcluster", "labelcentroid") and lab == "none")]


@pytest.mark.parametrize("method,labels", CASES, ids=lambda v: str(v))
def test_every_method_matches_jax(files, method, labels):
    jax_l, port_l = _pair(files, method, labels="0-based" if labels == "noised" else labels,
                          noise=0.3 if labels == "noised" else 0.0)
    if port_l.label_list is not None:
        np.testing.assert_array_equal(port_l.label_list, jax_l.label_list)
        np.testing.assert_array_equal(port_l.label_list_random, jax_l.label_list_random)
    for i in range(N_TRAIN):
        want, got = jax_l.get(i), port_l.get(i)
        if method == "knn_feat":
            row = int(json.loads(files["cluster"].with_suffix(".json").read_text())
                      ["name2id"][_name(i)])
            with h5py.File(files["cluster"]) as f:
                nns, feats = f["train_nns"][row], f["train_feat"][...]
            picks = [normalize_feat(feats[j]) for j in nns[:3]]
            assert any(np.array_equal(got["knn_feat"], p) for p in picks)
            assert got["knn_feat"].dtype == np.float32
            got["knn_feat"] = want["knn_feat"]   # random per access in both packages
        _assert_equal_dicts(got, want)


def test_label_kinds_shift_as_jax_does(files):
    """The fixture's three label lists exercise the three branches."""
    _, one = _pair(files, "label", labels="1-based")
    assert one.label_list.min() == 0 and one.label_list.max() == NUM_CLASSES - 1
    _, sub = _pair(files, "label", labels="subset")
    np.testing.assert_array_equal(sub.label_list, _labels("subset"))
    _, noised = _pair(files, "label", noise=0.3)
    assert (noised.label_list != _labels("0-based")).any()


@pytest.mark.parametrize("method", ["cluster", "centroid", "feat", "clustermix"])
def test_positional_rows_without_label_info(files, method):
    """ffhq: no label info, the h5 rows taken by index (no name2id)."""
    jax_l, port_l = _pair(files, method, dataset_name="ffhq64", labels="none", seed=11)
    assert port_l.name2id is None
    for i in range(N_TRAIN):
        _assert_equal_dicts(port_l.get(i), jax_l.get(i))


def test_lost_lookup_matches_jax(files):
    jax_l, port_l = JaxLost(str(files["lost"])), LostLookup(str(files["lost"]))
    assert port_l.cluster_k == jax_l.cluster_k == K
    for i in range(N_TRAIN):
        got, want = port_l.get_bbox(_name(i)), jax_l.get_bbox(_name(i))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert port_l.get_clusterid(_name(i)) == jax_l.get_clusterid(_name(i))


def test_dataset_name_rules():
    for name in ("inp", "cifar10", "coco64", "voc64", "ffhq64", "cs64"):
        from sgdm_tpu.data.h5cond import ds_has_label_info as jax_has, skip_id2name as jax_skip

        assert ds_has_label_info(name) == jax_has(name)
        assert skip_id2name(name) == jax_skip(name)
