"""`sgdm_tpu_torch/utils/h5.py` against h5py, in both directions.

  * The port reads what h5py writes by default: every integer and float
    type at ranks 0-3, an unallocated dataset (zeros), 300 datasets in one
    group (a B-tree of more than one level), 24 attributes (a header
    continued in a second block), variable-length string attributes (read
    as `str`), a fixed-length string attribute that is present but not
    read, and a LOST-style file of two datasets an image.
  * h5py reads back what the port writes, values and dtypes equal: string
    attributes, rows written batch by batch into a dataset created with a
    shape, column writes, a LOST-style file of 10,582 names.
  * A chunked or gzip dataset, a fixed-length string attribute when read,
    and a type the writer does not take raise `NotImplementedError`.
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
    assert f.attrs["dataset_name"] == "in64" and type(f.attrs["dataset_name"]) is str
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
    f.attrs["name"] = np.zeros(2, np.complex64)
    with pytest.raises(NotImplementedError, match="attribute 'name'"):
        f.close()
    with pytest.raises(ValueError, match="mode"):
        h5.File(tmp_path / "r.h5", "a")


STRINGS = ["in64p", "dino_vitb16", "v4", "", "héllo wörld", "x" * 5000]


@pytest.mark.parametrize("text", STRINGS, ids=["in64p", "feat", "v4", "empty", "utf8", "long"])
def test_string_attributes_both_ways(tmp_path, text):
    """h5py 3's ``attrs[k] = "..."`` (variable-length UTF-8 in a global heap
    collection) read by the port, and the port's read by h5py: on the root
    and on a dataset, beside numeric attributes."""
    with h5py.File(tmp_path / "h.h5", "w") as f:
        d = f.create_dataset("all_attributes", (1,))
        d.attrs["dataset_name"], d.attrs["feat_dim"] = text, 768
        f.attrs["version"] = text
    f = h5.File(tmp_path / "h.h5")
    assert f["all_attributes"].attrs["dataset_name"] == text == f.attrs["version"]
    assert f["all_attributes"].attrs["feat_dim"] == 768
    with h5.File(tmp_path / "p.h5", "w") as f:
        d = f.create_dataset("all_attributes", (1,))
        d.attrs["dataset_name"], d.attrs["feat_from"], d.attrs["feat_dim"] = text, "dino", 768
        f.attrs["version"] = text
    with h5py.File(tmp_path / "p.h5", "r") as f:
        a = f["all_attributes"].attrs
        assert a["dataset_name"] == text and a["feat_from"] == "dino" and a["feat_dim"] == 768
        assert f.attrs["version"] == text
        assert f["all_attributes"].id.get_storage_size() == 0
    assert h5.File(tmp_path / "p.h5")["all_attributes"].attrs["dataset_name"] == text


@pytest.mark.parametrize("dtype,row", [("float32", (197, 12)), ("float32", (6,)),
                                       ("int64", ()), ("float64", (2, 3))],
                         ids=["tokens", "cls", "labels", "f64"])
def test_rows_written_batch_by_batch(tmp_path, dtype, row):
    """`extract_feat`'s writes: a dataset created with a shape, filled in
    uneven batches (``ds[a:b] = rows``, one row by an int), each on disk as
    it comes; h5py and the port read every row back; a column write
    (``ds[:, j] = ...``, the patch clusterer's) lands too."""
    n = 45
    want = _array(dtype, (n,) + row, seed=5)
    with h5.File(tmp_path / "r.h5", "w") as f:
        ds = f.create_dataset("train", (n,) + row, dtype=dtype)
        starts = [0, 16, 32, 40, 44]
        for a, b in zip(starts, starts[1:] + [n]):
            if b - a == 1:
                ds[a] = want[a]
            else:
                ds[a:b] = want[a:b]
            assert (tmp_path / "r.h5").stat().st_size >= ds.addr + b * want[0].nbytes
        np.testing.assert_array_equal(ds[3:9], want[3:9])   # read back while writing
        if row:
            col = _array(dtype, (n,) + row[1:], seed=6)
            f.create_dataset("cols", data=np.zeros((n,) + row, dtype))[:, 0] = col
    with h5py.File(tmp_path / "r.h5", "r") as f:
        _assert_same(f["train"][...], want)
        if row:
            _assert_same(f["cols"][:, 0], col)
            _assert_same(f["cols"][:, 1:], np.zeros((n, row[0] - 1) + row[1:], dtype))
    _assert_same(h5.File(tmp_path / "r.h5")["train"][...], want)


def test_h5py_row_writes_read_by_the_port(tmp_path):
    """The other way round: h5py fills a created dataset batch by batch
    (its contiguous layout, allocated at the first write), the port reads."""
    want = _array("float32", (30, 5, 4), seed=7)
    with h5py.File(tmp_path / "h.h5", "w") as f:
        ds = f.create_dataset("train", (30, 5, 4), dtype="f4")
        for a in range(0, 30, 8):
            ds[a:a + 8] = want[a:a + 8]
        f.create_dataset("train_labels", (30,), dtype="i8")[:] = np.arange(30)
    f = h5.File(tmp_path / "h.h5")
    _assert_same(f["train"][...], want)
    _assert_same(f["train_labels"][...], np.arange(30, dtype=np.int64))


def test_lost_file_of_train_aug_size(tmp_path):
    """`write_lost_h5`'s layout at VOC train_aug's 10,582 names: a root
    ``cluster_k`` and 21,164 datasets in one group, read by h5py and by
    the port (`LostLookup`'s reads)."""
    rng = np.random.default_rng(8)
    names = [f"2008_{i:06d}.jpg" for i in range(10582)]
    boxes = rng.integers(0, 500, (len(names), 4))
    ids = rng.integers(0, 100, len(names))
    with h5.File(tmp_path / "lost.h5", "w") as f:
        f.attrs["cluster_k"] = 100
        for n, b, c in zip(names, boxes, ids):
            f.create_dataset(f"{n}_bbox", data=b.astype(np.int64))
            f.create_dataset(f"{n}_clusterid", data=np.int64(c))
    with h5py.File(tmp_path / "lost.h5", "r") as f:
        assert len(f) == 2 * len(names) and f.attrs["cluster_k"] == 100
        for i in (0, 5291, 10581):
            _assert_same(f[f"{names[i]}_bbox"][()], boxes[i].astype(np.int64))
            assert f[f"{names[i]}_clusterid"][()] == ids[i]
    f = h5.File(tmp_path / "lost.h5")
    assert len(f) == 2 * len(names) and f.attrs["cluster_k"] == 100
    for i in range(0, len(names), 997):
        _assert_same(f[f"{names[i]}_bbox"][()], boxes[i].astype(np.int64))
