"""`sgdm_tpu_torch/data/cifar10.py` and `data/ffhq.py` against the JAX
package's, item for item (keys, dtypes, values equal).

CIFAR-10/100 python pickles and an FFHQ folder of PNGs (RGB, grey, RGBA and
palette images at sizes that resize up and down) are written here.  FFHQ's
resize is PIL's bilinear in JAX and `transforms.resize_bilinear` in the
port; a folder holding JPEGs is read as JAX reads it (the port's decoder).
"""

import pickle

import h5py
import numpy as np
import pytest
from PIL import Image

from sgdm_tpu.data.cifar10 import CIFAR10 as JaxCIFAR10
from sgdm_tpu.data.cifar10 import CIFAR100 as JaxCIFAR100
from sgdm_tpu.data.ffhq import FFHQ as JaxFFHQ
from sgdm_tpu_torch.data import CIFAR10, CIFAR100, FFHQ


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(0)
    c10 = root / "cifar-10-batches-py"
    c10.mkdir()
    for name, n in [(f"data_batch_{i}", 4) for i in range(1, 6)] + [("test_batch", 6)]:
        with open(c10 / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": [int(v) for v in rng.integers(0, 10, n)]}, f)
    c100 = root / "cifar-100-python"
    c100.mkdir()
    for name, n in (("train", 9), ("test", 5)):
        with open(c100 / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"fine_labels": [int(v) for v in rng.integers(0, 100, n)],
                         b"coarse_labels": [int(v) for v in rng.integers(0, 20, n)]}, f)
    return root


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("cls", ["cifar10", "cifar100"])
@pytest.mark.parametrize("method", ["label", None])
def test_cifar_matches_jax(cifar_root, cls, train, method):
    jax_cls, port_cls = {"cifar10": (JaxCIFAR10, CIFAR10), "cifar100": (JaxCIFAR100, CIFAR100)}[cls]
    kw = dict(root=str(cifar_root), train=train, condition_method=method)
    jax_ds, port_ds = jax_cls(**kw), port_cls(**kw)
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        _same(port_ds[i], jax_ds[i])
    assert port_ds.id2name(2) == jax_ds.id2name(2)


def test_cifar_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        CIFAR10(str(tmp_path))


@pytest.fixture(scope="module")
def ffhq_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffhq")
    rng = np.random.default_rng(1)
    (root / "sub").mkdir()
    specs = [("RGB", 96), ("RGB", 64), ("L", 80), ("RGBA", 50), ("P", 128), ("RGB", 200),
             ("RGB", 33), ("L", 64)]
    for i, (mode, s) in enumerate(specs):
        arr = rng.integers(0, 256, (s, s, 3), np.uint8)
        img = Image.fromarray(arr)
        if mode == "L":
            img = img.convert("L")
        elif mode == "RGBA":
            img = Image.fromarray(np.dstack([arr, rng.integers(0, 256, (s, s), np.uint8)]))
        elif mode == "P":
            img = img.quantize(64)
        img.save(root / ("sub" if i % 3 == 0 else ".") / f"{i:05d}.png")
    with h5py.File(root.parent / "ffhq_cluster.h5", "w") as f:
        for split in ("train", "val"):
            f.create_dataset(split, data=rng.integers(0, 6, len(specs)))
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = 6
    return root


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("sizes", [(64, 224), (32, 48)], ids=["64-224", "32-48"])
def test_ffhq_matches_jax(ffhq_root, sizes, train):
    kw = dict(root=str(ffhq_root), train=train, image_size=sizes[0], size4cluster=sizes[1],
              condition_method="cluster", h5_file=str(ffhq_root.parent / "ffhq_cluster.h5"),
              val_fraction=0.25)
    jax_ds, port_ds = JaxFFHQ(**kw), FFHQ(**kw)
    assert [p.name for p in port_ds.files] == [p.name for p in jax_ds.files]
    assert len(port_ds) == (6 if train else 2)
    for i in range(len(jax_ds)):
        _same(port_ds[i], jax_ds[i])


def test_ffhq_jpeg_raises_naming_the_roadmap_item(tmp_path):
    """Before the JPEG decoder a folder with a JPEG raised naming ROADMAP
    item 7b; now it is read as JAX reads it, and an empty folder raises."""
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (30, 20, 3), np.uint8)).save(tmp_path / "b.jpg")
    Image.fromarray(rng.integers(0, 256, (17, 9), np.uint8)).save(tmp_path / "c.jpeg",
                                                                  format="JPEG")
    kw = dict(root=str(tmp_path), train=True, image_size=16, size4cluster=12, val_fraction=0.01)
    jax_ds, port_ds = JaxFFHQ(**kw), FFHQ(**kw)
    assert [p.name for p in port_ds.files] == [p.name for p in jax_ds.files] == ["a.png", "b.jpg"]
    for i in range(len(jax_ds)):
        _same(port_ds[i], jax_ds[i])
    val = FFHQ(**dict(kw, train=False))
    _same(val[0], JaxFFHQ(**dict(kw, train=False))[0])
    with pytest.raises(FileNotFoundError):
        FFHQ(str(tmp_path / "empty"))
