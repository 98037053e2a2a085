"""The port's data loading (`sgdm_tpu_torch/data/loader.py`, `datamodule.py`,
the synthetic datasets' ``get_batch``) against the JAX package's.

  * `DataLoader` yields the same batches in the same order as
    `sgdm_tpu/data/loader.py`'s over two epochs, shuffled or not, with and
    without ``drop_last``, per-sample and through ``get_batch``: exactly;
  * an early break stops the producer thread;
  * `SyntheticImages.get_batch` / `SyntheticSegImages.get_batch` equal
    collating `__getitem__` (and the JAX dataset's samples) exactly;
  * `DataModuleFromConfig` from the repo's ``sgdm_tpu.…`` targets;
    `prefetch_to_device` on the host.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sgdm_tpu.data.loader import DataLoader as JDataLoader
from sgdm_tpu.data.synthetic import SyntheticImages as JSyntheticImages
from sgdm_tpu_torch.data.datamodule import DataModuleFromConfig
from sgdm_tpu_torch.data.loader import DataLoader, prefetch_to_device
from sgdm_tpu_torch.data.synthetic import SyntheticImages, SyntheticSegImages, collate


class PerSample:
    """SyntheticImages without get_batch: the loader's per-sample path."""

    def __init__(self, **kw):
        self.ds = SyntheticImages(**kw)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def _epochs(dl, n=2):
    return [list(dl) for _ in range(n)]


@pytest.mark.parametrize("shuffle,drop_last,batch_level",
                         [(True, True, True), (True, True, False), (False, False, True),
                          (True, False, False)],
                         ids=["shuffle-drop-batch", "shuffle-drop-samples", "ordered-keep-batch",
                              "shuffle-keep-samples"])
def test_same_batches_and_order_as_jax(shuffle, drop_last, batch_level):
    kw = dict(size=8, num_classes=4, length=30, seed=2, cond_key="cluster")
    ds = SyntheticImages(**kw) if batch_level else PerSample(**kw)
    jds = JSyntheticImages(**kw)
    got = _epochs(DataLoader(ds, 8, shuffle=shuffle, drop_last=drop_last, num_workers=3, seed=5))
    ref = _epochs(JDataLoader(jds, 8, shuffle=shuffle, drop_last=drop_last, num_workers=3,
                              seed=5))
    assert [len(e) for e in got] == [len(e) for e in ref] == [3 if drop_last else 4] * 2
    for eg, er in zip(got, ref):
        for bg, br in zip(eg, er):
            assert bg.keys() == br.keys()
            for k in br:
                assert bg[k].dtype == br[k].dtype, k
                np.testing.assert_array_equal(bg[k], br[k], err_msg=k)
    if shuffle:
        assert not np.array_equal(got[0][0]["id"], got[1][0]["id"])  # reshuffled per epoch


def test_set_epoch_and_len():
    dl = DataLoader(SyntheticImages(size=8, length=30), 8, shuffle=True, seed=1)
    assert len(dl) == 3 and len(DataLoader(SyntheticImages(size=8, length=30), 8,
                                           drop_last=False)) == 4
    first = [b["id"] for b in dl]
    dl.set_epoch(0)
    np.testing.assert_array_equal(np.concatenate(first), np.concatenate([b["id"] for b in dl]))


def test_early_break_stops_the_producer():
    before = threading.active_count()
    dl = DataLoader(PerSample(size=8, length=400), 4, num_workers=2, prefetch_batches=1)
    for i, _ in enumerate(dl):
        if i == 1:
            break
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_worker_error_reaches_the_consumer():
    class Bad:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoader(Bad(), 4))


@pytest.mark.parametrize("size,classes", [(8, 4), (16, 10), (64, 1000)])
def test_synthetic_get_batch_equals_samples(size, classes):
    ds = SyntheticImages(size=size, num_classes=classes, length=256, seed=3, cond_key="cluster")
    jds = JSyntheticImages(size=size, num_classes=classes, length=256, seed=3, cond_key="cluster")
    idx = np.random.default_rng(0).permutation(256)[:24]
    got = ds.get_batch(idx)
    for ref in (collate([ds[int(i)] for i in idx]), collate([jds[int(i)] for i in idx])):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_seg_get_batch_keeps_every_key():
    ds = SyntheticSegImages(size=16, num_classes=4, length=16, onehot_on_device=True)
    got = ds.get_batch([3, 1, 7])
    ref = collate([ds[3], ds[1], ds[7]])
    assert got.keys() == ref.keys() and "stegomask" in got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_datamodule_from_repo_targets():
    ds = {"target": "sgdm_tpu.data.synthetic.SyntheticImages",
          "params": dict(size=8, num_classes=4, length=20)}
    dm = DataModuleFromConfig(batch_size=4, train=ds, validation=ds, num_workers=2)
    dm.setup()
    assert isinstance(dm.datasets["train"], SyntheticImages)
    tr, va = dm.train_dataloader(), dm.val_dataloader()
    assert tr.shuffle and not va.shuffle and tr.drop_last and len(tr) == 5
    with pytest.raises(KeyError, match="test"):
        dm.test_dataloader()


def test_prefetch_to_device_on_the_host():
    dl = DataLoader(SyntheticImages(size=8, length=16), 4)
    out = list(prefetch_to_device(iter(dl), size=2, device="cpu"))
    ref = list(DataLoader(SyntheticImages(size=8, length=16), 4))
    assert len(out) == 4
    for o, r in zip(out, ref):
        assert all(isinstance(v, torch.Tensor) for v in o.values())
        np.testing.assert_array_equal(o["image"].numpy(), r["image"])
