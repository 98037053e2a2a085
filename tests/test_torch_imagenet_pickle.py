"""`sgdm_tpu_torch/data/imagenet_pickle.py` against `sgdm_tpu`'s, bit for bit.

Chrabaszcz-format pickles (ten ``train_data_batch_*`` and ``val_data``,
labels 1..C) are written here at 32 and 64 px with a cluster h5 and its
``name2id``.  Both packages' ``ImageNetPickle`` give equal ``__getitem__``
and ``get_batch`` dicts (keys, dtypes, values) on the pickles, on the
``in64pickle.h5`` pack each package wrote (the JAX-written pack read by the
port, the port-written one by the JAX class), under each ablation
(``data_ratio``, ``corruption``, ``subgroup``), ``debug`` and a
``size4cluster`` resize.  The port's ``get_batch`` equals collating its
``__getitem__``, and its native gather equals its numpy version.
"""

import json
import pickle
import shutil

import h5py
import numpy as np
import pytest

from sgdm_tpu.data.imagenet_pickle import ImageNetPickle as JaxPickle
from sgdm_tpu_torch.data.imagenet_pickle import ImageNetPickle
from sgdm_tpu_torch.data.loader import _collate
from sgdm_tpu_torch.native import (gather_image_batch, gather_image_batch_plain, gather_rows,
                                   gather_rows_plain)

PER_BATCH, N_VAL, NUM_CLASSES, K = 6, 10, 8, 11


def _write_tree(root, size, seed):
    rng = np.random.default_rng(seed)
    d = root / f"size{size}"
    d.mkdir(parents=True)
    for i in range(1, 11):
        with open(d / f"train_data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (PER_BATCH, 3 * size * size), np.uint8),
                         "labels": [int(v) for v in rng.integers(1, NUM_CLASSES + 1, PER_BATCH)],
                         "mean": np.zeros(3 * size * size)}, f)
    with open(d / "val_data", "wb") as f:
        pickle.dump({"data": rng.integers(0, 256, (N_VAL, 3 * size * size), np.uint8),
                     "labels": [int(v) for v in rng.integers(1, NUM_CLASSES + 1, N_VAL)]}, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("inp")
    for size in (32, 64):
        _write_tree(base / "pickles", size, size)
    # the JAX-written pack beside a copy of the pickles, and the port's
    for who in ("jaxpack", "portpack"):
        shutil.copytree(base / "pickles", base / who)
    JaxPickle.pickle_to_h5(str(base / "jaxpack"), 64)
    ImageNetPickle.pickle_to_h5(str(base / "portpack"), 64)
    rng = np.random.default_rng(9)
    n_train = 10 * PER_BATCH
    with h5py.File(base / "cluster.h5", "w") as f:
        f.create_dataset("train", data=rng.integers(0, K, n_train))
        f.create_dataset("val", data=rng.integers(0, K, n_train))
        f.create_dataset("centroids", data=rng.standard_normal((K, 5)).astype(np.float32))
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = K
    (base / "cluster.json").write_text(json.dumps(
        {"name2id": {f"{i}.jpg": int(j) for i, j in enumerate(rng.permutation(n_train))}}))
    return base


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _pair(tree, where="pickles", jax_where=None, **kw):
    kw = dict(dict(image_size=64, h5_file=str(tree / "cluster.h5"), condition_method="cluster",
                   num_classes=NUM_CLASSES), **kw)
    return (JaxPickle(str(tree / (jax_where or where)), **kw),
            ImageNetPickle(str(tree / where), **kw))


def _check(jax_ds, port_ds, batch=7):
    assert len(port_ds) == len(jax_ds)
    np.testing.assert_array_equal(port_ds.label_list, jax_ds.label_list)
    for i in range(len(jax_ds)):
        _same(port_ds[i], jax_ds[i])
    idx = np.random.default_rng(len(jax_ds)).permutation(len(jax_ds))[:batch]
    got = port_ds.get_batch(idx)
    _same(got, jax_ds.get_batch(idx))
    _same(got, _collate([port_ds[int(i)] for i in idx]))
    assert port_ds.id2name(3) == jax_ds.id2name(3) == "3.jpg"


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("size", [32, 64])
def test_pickles_match(tree, size, train):
    _check(*_pair(tree, image_size=size, train=train))


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("pack", ["jaxpack", "portpack"])
def test_packs_read_across_packages(tree, pack, train):
    """Each package reads the pack the other wrote, and it equals the pickles."""
    other = "portpack" if pack == "jaxpack" else "jaxpack"
    jax_ds, port_ds = _pair(tree, where=pack, jax_where=other, train=train)
    assert isinstance(port_ds.data, np.ndarray) and not port_ds.data.flags.writeable
    assert not isinstance(jax_ds.data, np.ndarray)   # h5py's dataset: the pack was read
    _check(jax_ds, port_ds)
    _, from_pickles = _pair(tree, train=train)
    _same(port_ds.get_batch(np.arange(5)), from_pickles.get_batch(np.arange(5)))


def test_packs_are_alike(tree):
    with h5py.File(tree / "jaxpack" / "size64" / "in64pickle.h5") as a, \
            h5py.File(tree / "portpack" / "size64" / "in64pickle.h5") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k][...], b[k][...])


@pytest.mark.parametrize("ablation", [
    dict(data_ratio=0.5), dict(corruption=0.3),
    dict(subgroup=3, condition_method="label", h5_file=None)], ids=lambda d: next(iter(d)))
@pytest.mark.parametrize("where", ["pickles", "portpack"])
def test_ablations_match(tree, ablation, where):
    jax_ds, port_ds = _pair(tree, where=where, **ablation)
    assert port_ds.label_num == jax_ds.label_num
    _check(jax_ds, port_ds)


def test_ablations_refuse_combinations(tree):
    with pytest.raises(AssertionError, match="mutually exclusive"):
        _pair(tree, data_ratio=0.5, corruption=0.3)


@pytest.mark.parametrize("size", [32, 64])
def test_debug_matches(tree, size):
    """At 64 px, debug reads only the first training batch."""
    jax_ds, port_ds = _pair(tree, image_size=size, debug=True)
    assert len(port_ds) == (PER_BATCH if size == 64 else 10 * PER_BATCH)
    _check(jax_ds, port_ds)


@pytest.mark.parametrize("s4c", [64, 48])
def test_size4cluster_matches(tree, s4c):
    """img4unsup at the extractor's size: PIL's bilinear in JAX, the port's own."""
    jax_ds, port_ds = _pair(tree, image_size=32, size4cluster=s4c, condition_method="label",
                            h5_file=None)
    _check(jax_ds, port_ds)
    assert port_ds[0]["img4unsup"].shape == (s4c, s4c, 3)


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_native_gather_equals_numpy(layout):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (50, 3 * 16 * 16), np.uint8)
    data.flags.writeable = False       # as the memory-mapped pack is
    idx = rng.integers(0, 50, 128)
    got, got_u8 = gather_image_batch(data, idx, 16, layout=layout)
    want, want_u8 = gather_image_batch_plain(data, idx, 16, layout=layout)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got_u8, want_u8)
    # every uint8 value: (v / 255) * 2 - 1 in float32, in that order
    every = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3 * 16 * 16, axis=1)
    v, _ = gather_image_batch(every, np.arange(256), 16)
    ref = (np.arange(256, dtype=np.float32) / np.float32(255) * np.float32(2) - np.float32(1))
    np.testing.assert_array_equal(v[:, 0, 0, 0].view(np.uint32), ref.view(np.uint32))
    rows = rng.standard_normal((50, 9)).astype(np.float32)
    np.testing.assert_array_equal(gather_rows(rows, idx), gather_rows_plain(rows, idx))
    with pytest.raises(IndexError):
        gather_image_batch(data, np.array([50]), 16)


def test_cpu_fit_on_pickles_and_a_cluster_h5(tmp_path):
    """The headline config (`configs/fit_in64p_cluster5000.json`) through the
    port's CLI on the host: 32-px pickles (the reader's smallest size), a
    cluster h5 and its name2id written by the port, a tiny model, one
    train step and one val batch; the loss is finite."""
    from pathlib import Path

    from sgdm_tpu_torch import main as port_main
    from sgdm_tpu_torch.utils import h5

    _write_tree(tmp_path / "data", 32, 5)
    k, n_train = 9, 10 * PER_BATCH
    rng = np.random.default_rng(6)
    with h5.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("train", data=rng.integers(0, k, n_train))
        f.create_dataset("val", data=rng.integers(0, k, N_VAL))
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = k
    (tmp_path / "c.json").write_text(json.dumps(
        {"name2id": {f"{i}.jpg": i for i in range(n_train)}}))
    config = Path(__file__).resolve().parents[1] / "sgdm_tpu_torch" / "configs" / \
        "fit_in64p_cluster5000.json"
    log_dir = tmp_path / "run"
    trainer = port_main.main([
        "--config", str(config), "--device", "cpu", f"data.root={tmp_path / 'data'}",
        f"data.h5_file={tmp_path / 'c.h5'}", "data.image_size=32", f"sg.params.cond_dim={k}",
        "data.params.batch_size=4", "data.params.num_workers=1",
        "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1,2]",
        "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[2]",
        "dynamic.params.num_heads=2", "pl.trainer.limit_train_batches=1",
        "pl.trainer.limit_val_batches=1", "pl.trainer.log_every_n_steps=1",
        "data.fid_train_image_dir=null", "data.fid_val_image_dir=null",
        "data.vis_every_iter=1000000000", "data.trainer.max_epochs=0", f"log_dir={log_dir}"])
    recs = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r[key] for r in recs for key in ("train/loss", "val/loss") if key in r]
    assert len(losses) == 2 and all(np.isfinite(losses)), recs
    assert trainer.global_step == 1
    ds = trainer.datamodule.datasets["train"]
    assert isinstance(ds, ImageNetPickle) and ds.cond.cluster_k == k
