"""`sgdm_tpu_torch/utils/h5.py` against h5py, in both directions.

  * The port reads what h5py writes by default: every integer and float
    type at ranks 0-3, an unallocated dataset (zeros), 300 datasets in one
    group (a B-tree of more than one level), 24 attributes (a header
    continued in a second block), string attributes that are present but
    not read, and a LOST-style file of two datasets an image.
  * h5py reads back what the port writes, values and dtypes equal.
  * A chunked or gzip dataset, a string attribute when read, and a type
    the writer does not take raise `NotImplementedError`.
"""

import struct

import h5py
import numpy as np
import pytest

from sgdm_tpu_torch.utils import h5

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float32", "float64"]
SHAPES = [(), (7,), (3, 5), (2, 3, 4)]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt, endpoint=True)


def _assert_same(got, want):
    assert isinstance(got, np.ndarray) == isinstance(want, np.ndarray) or np.ndim(want) == 0
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"rank{len(s)}")
@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_what_h5py_writes(tmp_path, dtype, shape):
    want = _array(dtype, shape)
    with h5py.File(tmp_path / "a.h5", "w") as f:
        f.create_dataset("x", data=want)
        f["x"].attrs["a"] = want
        f.attrs["b"] = want
    f = h5.File(tmp_path / "a.h5")
    d = f["x"]
    assert d.shape == shape and d.dtype == want.dtype
    _assert_same(d[()], want)
    _assert_same(f["x"].attrs["a"], want)
    _assert_same(f.attrs["b"], want)
    if shape:
        assert len(d) == shape[0]
        _assert_same(d[1], want[1])
        _assert_same(d[np.array([0, shape[0] - 1, 0])], want[[0, shape[0] - 1, 0]])
        assert not d.mapped.flags.writeable


@pytest.mark.parametrize("dtype", ["float32", "int64", "uint8"])
def test_unallocated_dataset_reads_as_zeros(tmp_path, dtype):
    with h5py.File(tmp_path / "u.h5", "w") as f:
        d = f.create_dataset("all_attributes", (1,), dtype=dtype)
        d.attrs["cluster_k"] = 5000
        f.create_dataset("big", (4, 6), dtype=dtype)
    raw = (tmp_path / "u.h5").read_bytes()
    assert b"\xff" * 8 in raw  # the undefined data address
    f = h5.File(tmp_path / "u.h5")
    _assert_same(f["all_attributes"][...], np.zeros(1, dtype))
    _assert_same(f["big"][...], np.zeros((4, 6), dtype))
    assert f["all_attributes"].attrs["cluster_k"] == 5000
    assert type(f["all_attributes"].attrs["cluster_k"]) is np.int64


def test_many_datasets_walk_a_deeper_btree(tmp_path):
    names = [f"{i}.jpg_bbox" for i in range(150)] + [f"{i}.jpg_clusterid" for i in range(150)]
    rng = np.random.default_rng(1)
    boxes = rng.integers(0, 64, (150, 4))
    with h5py.File(tmp_path / "lost.h5", "w") as f:
        for i in range(150):
            f.create_dataset(f"{i}.jpg_bbox", data=boxes[i])
            f.create_dataset(f"{i}.jpg_clusterid", data=np.int64(i % 7))
        f.attrs["cluster_k"] = 7
    levels = []
    raw = (tmp_path / "lost.h5").read_bytes()
    pos = raw.find(b"TREE")
    while pos >= 0:
        levels.append(raw[pos + 5])
        pos = raw.find(b"TREE", pos + 1)
    assert max(levels) >= 1, "the fixture must need a B-tree of more than one level"
    f = h5.File(tmp_path / "lost.h5")
    assert sorted(f) == sorted(names) and len(f) == 300
    for i in range(150):
        _assert_same(np.asarray(f[f"{i}.jpg_bbox"]), boxes[i])
        assert int(np.asarray(f[f"{i}.jpg_clusterid"]).item()) == i % 7
    assert f.attrs["cluster_k"] == 7 and "0.jpg_bbox" in f and "nope" not in f


def test_continued_header_and_string_attributes(tmp_path):
    with h5py.File(tmp_path / "c.h5", "w") as f:
        d = f.create_dataset("train", data=np.arange(10))
        for i in range(24):
            d.attrs[f"attr_{i:02d}"] = np.float32(i) / 3
            f.attrs[f"root_{i:02d}"] = np.arange(i + 1, dtype=np.int32)
        f.attrs["dataset_name"] = "in64"            # variable-length string
        f.attrs["feat_from"] = np.bytes_(b"dino")   # fixed-length string
    f = h5.File(tmp_path / "c.h5")
    hdr = h5._Header(f._buf, struct.unpack_from("<Q", f._buf, 64)[0])
    assert any(k == 0x10 for k, _, _ in hdr.messages), "the fixture must continue the header"
    assert len(f["train"].attrs) == 24 and len(f.attrs) == 26
    for i in range(24):
        _assert_same(f["train"].attrs[f"attr_{i:02d}"], np.float32(i) / 3)
        _assert_same(f.attrs[f"root_{i:02d}"], np.arange(i + 1, dtype=np.int32))
    _assert_same(f["train"][...], np.arange(10))
    assert "dataset_name" in f.attrs
    with pytest.raises(NotImplementedError, match="variable-length"):
        f.attrs["dataset_name"]
    with pytest.raises(NotImplementedError, match="string"):
        f.attrs["feat_from"]


@pytest.mark.parametrize("kind", ["chunked", "gzip"])
def test_chunked_and_filtered_datasets_raise(tmp_path, kind):
    with h5py.File(tmp_path / "k.h5", "w") as f:
        kw = dict(chunks=(4,)) if kind == "chunked" else dict(compression="gzip")
        f.create_dataset("x", data=np.arange(16, dtype=np.float32), **kw)
        f.create_dataset("ok", data=np.arange(3))
    f = h5.File(tmp_path / "k.h5")
    _assert_same(f["ok"][...], np.arange(3))
    assert f["x"].shape == (16,)
    with pytest.raises(NotImplementedError, match="chunked|filtered"):
        f["x"][...]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"rank{len(s)}")
@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_what_the_port_writes(tmp_path, dtype, shape):
    want = _array(dtype, shape, seed=2)
    with h5.File(tmp_path / "p.h5", "w") as f:
        f.create_dataset("x", data=want)
        f["x"].attrs["a"] = want
        f.attrs["b"] = want
    with h5py.File(tmp_path / "p.h5", "r") as f:
        _assert_same(f["x"][()], want)
        _assert_same(f["x"].attrs["a"], want)
        _assert_same(f.attrs["b"], want)
    f = h5.File(tmp_path / "p.h5")   # and the port reads it back
    _assert_same(f["x"][()], want)


def test_h5py_reads_a_port_cluster_file(tmp_path):
    """The layout `selfsup/cluster.py` writes: splits, centroids, an
    unallocated ``all_attributes`` carrying ``cluster_k``; 300 more
    datasets so that one symbol node holds more than h5py's 8."""
    rng = np.random.default_rng(3)
    train, val = rng.integers(0, 50, 40), rng.integers(0, 50, 9)
    cents = rng.standard_normal((50, 16)).astype(np.float32)
    with h5.File(tmp_path / "cl.h5", "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("val", data=val)
        f.create_dataset("centroids", data=cents)
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = 50
        f.attrs["niter"] = 30
        for i in range(300):
            f.create_dataset(f"extra_{i}", data=np.full(3, i, np.int16))
    with h5py.File(tmp_path / "cl.h5", "r") as f:
        assert len(f) == 304
        _assert_same(f["train"][...], train)
        _assert_same(f["val"][...], val)
        _assert_same(f["centroids"][...], cents)
        _assert_same(f["all_attributes"][...], np.zeros(1, np.float32))
        assert f["all_attributes"].attrs["cluster_k"] == 50
        assert f["all_attributes"].id.get_storage_size() == 0   # unallocated
        assert f.attrs["niter"] == 30
        for i in range(300):
            _assert_same(f[f"extra_{i}"][...], np.full(3, i, np.int16))
    f = h5.File(tmp_path / "cl.h5")
    _assert_same(f["centroids"][7], cents[7])
    assert f["all_attributes"].attrs["cluster_k"] == 50


def test_writer_refuses_what_it_does_not_write(tmp_path):
    f = h5.File(tmp_path / "r.h5", "w")
    with pytest.raises(NotImplementedError, match="dtype"):
        f.create_dataset("s", data=np.array(["a", "b"]))
    with pytest.raises(NotImplementedError, match="dtype"):
        f.create_dataset("c", data=np.zeros(2, np.complex64))
    with pytest.raises(NotImplementedError, match="root group"):
        f.create_dataset("g/x", data=np.zeros(2))
    f.attrs["name"] = "text"
    with pytest.raises(NotImplementedError, match="attribute 'name'"):
        f.close()
    with pytest.raises(ValueError, match="mode"):
        h5.File(tmp_path / "r.h5", "a")
