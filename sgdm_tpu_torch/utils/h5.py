"""The HDF5 files the data layer reads and writes, without h5py.

The port's counterpart of the ``h5py.File`` calls of the JAX package's
condition lookups, ImageNet pack, feature extractor, cluster and LOST
writers.  It covers the subset of the format that h5py writes by default
(little-endian, 8-byte offsets and lengths):

* superblock version 0 (or 1), the root group stored as a symbol table: a
  version-1 B-tree of group nodes, walked to any depth, ``SNOD`` symbol
  nodes and a local heap of names;
* version-1 object headers, messages aligned to 8 bytes, continued in
  further blocks;
* dataspaces (versions 1 and 2, scalar and simple), fixed-point (signed or
  unsigned, 1/2/4/8 bytes) and IEEE float (4/8 bytes) datatypes, data
  layout version 3 (contiguous or compact; an unallocated dataset, at the
  undefined address, reads as zeros), attributes (versions 1-3) of those
  types and variable-length strings (what h5py 3 writes for
  ``attrs[k] = "text"``: the bytes in a global heap collection, ``GCOL``),
  read as `str`.

``File(path, "r")`` maps the file once (``np.memmap``); a contiguous
dataset is a read-only view of that mapping at its data address, so a pack
larger than memory is read row by row.  Anything else raises
`NotImplementedError` naming what it met: a chunked or filtered dataset,
another datatype (fixed-length strings among them) when it is read,
new-style (link message) groups, groups below the root.

``File(path, "w")`` writes the same subset as data comes: a dataset given
``data`` is written at once at the end of the file; one created with a
shape is unallocated (h5py's late allocation) until its first write,
which lays down its block; ``ds[a:b] = rows`` writes the rows where they
belong (any other numpy index goes through a memory map of the block), so
a file larger than memory is written batch by batch.  `close` appends the
metadata (the root symbol table, whose leaf K lets one symbol node hold
every entry, the dataset headers with numeric and string attributes, one
global heap collection) and writes the superblock at offset 0.  h5py reads
back what it writes.

    with File("c.h5", "w") as f:
        f.create_dataset("train", data=ids)
        feats = f.create_dataset("feat", (n, 768), dtype="f4")
        feats[0:256] = batch
        f.create_dataset("all_attributes", (1,)).attrs["dataset_name"] = "in64p"
    f = File("c.h5")
    f["train"][17], f["all_attributes"].attrs["dataset_name"]
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any, Iterator, Mapping

import numpy as np

__all__ = ["File", "Dataset", "Attributes", "Writer"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0x1, 0x2, 0x3, 0x5
_LAYOUT, _FILTERS, _ATTRIBUTE = 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
_TYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 9: "variable-length (string)", 10: "array"}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------

def _dataspace(b: bytes) -> tuple[int, ...] | None:
    """Shape of a dataspace message; None for a null dataspace."""
    version, rank, flags = b[0], b[1], b[2]
    if version == 1:
        off = 8
    elif version == 2:
        if b[3] == 2:
            return None
        off = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", b, off)) if rank else ()


_VLEN_STR = "variable-length string"


def _datatype(b: bytes) -> np.dtype | str:
    """numpy dtype of a datatype message, `_VLEN_STR` for a variable-length
    string, or a description of a type that is not read (raised when the
    data is accessed)."""
    cls, bits, size = b[0] & 0x0F, b[1] | b[2] << 8 | b[3] << 16, struct.unpack_from("<I", b, 4)[0]
    if cls == 9 and bits & 0x0F == 1:
        return _VLEN_STR
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", b, 8)
        if size in (1, 2, 4, 8) and offset == 0 and precision == 8 * size:
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        return f"fixed-point type of {size} bytes at bit offset {offset}, precision {precision}"
    if cls == 1:
        ieee = {4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}
        props = struct.unpack_from("<HHBBBBI", b, 8)
        if bits & 0x40 == 0 and size in ieee and props == (0, *ieee[size]):
            return np.dtype(f"{order}f{size}")
        return f"floating-point type of {size} bytes with properties {props}"
    return f"datatype class {cls} ({_TYPE_CLASSES.get(cls, 'unknown')})"


class _Header:
    """The messages of a version-1 object header, continuation blocks
    followed: ``messages`` is a list of (type, flags, body)."""

    def __init__(self, buf: np.ndarray, addr: int):
        if bytes(buf[addr:addr + 4]) == b"OHDR":
            raise NotImplementedError("HDF5 version-2 object headers (files written with "
                                      "libver='latest')")
        version, _, nmsgs, _, size = struct.unpack_from("<BBHII", buf, addr)
        if version != 1:
            raise NotImplementedError(f"HDF5 object header version {version}")
        self.messages: list[tuple[int, int, bytes]] = []
        chunks = [(addr + 16, size)]
        while chunks and len(self.messages) < nmsgs:
            pos, length = chunks.pop(0)
            end = pos + length
            while pos + 8 <= end and len(self.messages) < nmsgs:
                kind, msize, flags = struct.unpack_from("<HHB", buf, pos)
                body = bytes(buf[pos + 8:pos + 8 + msize])
                if kind == _CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", body))
                self.messages.append((kind, flags, body))
                pos += 8 + msize

    def find(self, kind: int) -> tuple[int, bytes] | None:
        for k, flags, body in self.messages:
            if k == kind:
                if flags & 0x02:
                    raise NotImplementedError(f"shared HDF5 object header message (type {kind:#x})")
                return flags, body
        return None

    def has(self, kind: int) -> bool:
        return any(k == kind for k, _, _ in self.messages)


def _global_heap_object(buf: np.ndarray, addr: int, index: int) -> bytes:
    """Object ``index`` of the global heap collection at ``addr``."""
    if bytes(buf[addr:addr + 4]) != b"GCOL":
        raise ValueError(f"no global heap collection at {addr}")
    end = addr + struct.unpack_from("<Q", buf, addr + 8)[0]
    pos = addr + 16
    while pos + 16 <= end:
        idx, _, size = struct.unpack_from("<HH4xQ", buf, pos)
        if idx == 0:     # the free space: the last object
            break
        if idx == index:
            return bytes(buf[pos + 16:pos + 16 + size])
        pos += 16 + _pad8(size)
    raise ValueError(f"no object {index} in the global heap collection at {addr}")


class Attributes(Mapping):
    """Attributes of an object, decoded when read: numeric scalars as numpy
    scalars, arrays as arrays, variable-length strings as `str` (arrays of
    them as object arrays, as h5py); any other type raises
    `NotImplementedError` when read, not when present."""

    def __init__(self, header: _Header, buf: np.ndarray):
        self._buf = buf
        self._raw: dict[str, tuple[bytes, bytes, bytes]] = {}
        for kind, _, body in header.messages:
            if kind == _ATTRIBUTE:
                name, parts = self._split(body)
                self._raw[name] = parts

    @staticmethod
    def _split(b: bytes) -> tuple[str, tuple[bytes, bytes, bytes]]:
        version, flags, nsize, tsize, ssize = struct.unpack_from("<BBHHH", b)
        if version == 1:
            pad, off = _pad8, 8
        elif version in (2, 3):
            pad, off = (lambda n: n), 8 if version == 2 else 9
        else:
            raise NotImplementedError(f"HDF5 attribute message version {version}")
        name = b[off:off + nsize].rstrip(b"\0").decode("utf-8")
        off += pad(nsize)
        dt = b"shared" if flags & 0x01 else b[off:off + tsize]
        off += pad(tsize)
        ds = b"shared" if flags & 0x02 else b[off:off + ssize]
        off += pad(ssize)
        return name, (dt, ds, b[off:])

    def __getitem__(self, name: str) -> Any:
        dt, ds, data = self._raw[name]
        if dt == b"shared" or ds == b"shared":
            raise NotImplementedError(f"attribute {name!r}: shared datatype or dataspace")
        dtype, shape = _datatype(dt), _dataspace(ds)
        if dtype == _VLEN_STR and shape is not None:
            n = int(np.prod(shape, dtype=np.int64))
            refs = [struct.unpack_from("<IQI", data, 16 * i) for i in range(n)]
            strs = [_global_heap_object(self._buf, addr, idx)[:length].decode("utf-8")
                    for length, addr, idx in refs]
            return strs[0] if shape == () else np.array(strs, dtype=object).reshape(shape)
        if not isinstance(dtype, np.dtype) or shape is None:
            raise NotImplementedError(f"attribute {name!r}: "
                                      f"{dtype if shape is not None else 'null dataspace'}")
        n = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(data, dtype, n).reshape(shape)
        return arr[()] if shape == () else arr.copy()

    def __contains__(self, name: object) -> bool:
        return name in self._raw

    def __iter__(self) -> Iterator[str]:
        return iter(self._raw)

    def __len__(self) -> int:
        return len(self._raw)


class Dataset:
    """A dataset of a file opened for reading."""

    def __init__(self, file: "File", name: str, header: _Header):
        self.name = name
        self._file = file
        self.attrs = Attributes(header, file._buf)
        space = header.find(_DATASPACE)
        dtype = header.find(_DATATYPE)
        layout = header.find(_LAYOUT)
        if space is None or dtype is None or layout is None:
            raise ValueError(f"{name}: not a dataset (no dataspace, datatype or layout message)")
        shape = _dataspace(space[1])
        if shape is None:
            raise NotImplementedError(f"{name}: null dataspace")
        self.shape: tuple[int, ...] = shape
        self._dtype = _datatype(dtype[1])
        self._filtered = header.has(_FILTERS)
        self._layout = layout[1]
        self._mapped: np.ndarray | None = None

    @property
    def dtype(self) -> np.dtype:
        if not isinstance(self._dtype, np.dtype):
            raise NotImplementedError(f"{self.name}: {self._dtype}")
        return self._dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError(f"{self.name}: a scalar dataset has no len()")
        return self.shape[0]

    @property
    def mapped(self) -> np.ndarray:
        """The whole dataset as a read-only array, without a copy: a view of
        the file's one mapping (contiguous), of the header (compact), or a
        broadcast zero (unallocated)."""
        if self._mapped is not None:
            return self._mapped
        dtype = self.dtype
        if self._filtered:
            raise NotImplementedError(f"{self.name}: filtered (compressed) datasets")
        b = self._layout
        version, cls = b[0], b[1]
        if version not in (3, 4) or cls not in (0, 1):
            kind = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}") if version in (3, 4) \
                else f"version {version}"
            raise NotImplementedError(f"{self.name}: {kind} data layout (only contiguous and "
                                      "compact datasets are read)")
        nbytes = self.size * dtype.itemsize
        if cls == 0:
            (size,) = struct.unpack_from("<H", b, 2)
            arr = np.frombuffer(b[4:4 + size], dtype, self.size).reshape(self.shape)
        else:
            addr, size = struct.unpack_from("<QQ", b, 2)
            if addr == _UNDEF:
                arr = np.broadcast_to(np.zeros((), dtype), self.shape)
            else:
                if size < nbytes or addr + nbytes > len(self._file._buf):
                    raise ValueError(f"{self.name}: data at {addr} ({size} bytes) does not hold "
                                     f"{self.shape} {dtype} inside the file")
                arr = np.ndarray(self.shape, dtype, buffer=self._file._buf, offset=addr)
        self._mapped = arr
        return arr

    def __getitem__(self, key: Any) -> Any:
        """As h5py: a copy of the selection (a numpy scalar for one element)."""
        out = self.mapped[key]
        return out.copy() if isinstance(out, np.ndarray) else out

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        out = np.array(self.mapped)
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self._dtype}>"


class File(Mapping):
    """An HDF5 file.  ``File(path)`` / ``File(path, "r")`` reads it (see the
    module docstring): ``f[name]`` is a `Dataset` of the root group, which
    must be a symbol table; ``File(path, "w")`` returns a `Writer`."""

    def __new__(cls, path: str | Path, mode: str = "r"):
        if mode == "w":
            return Writer(path)
        if mode != "r":
            raise ValueError(f"mode {mode!r}: only 'r' and 'w'")
        return super().__new__(cls)

    def __init__(self, path: str | Path, mode: str = "r"):
        self.filename = str(path)
        self._buf = np.memmap(path, dtype=np.uint8, mode="r")
        b = self._buf
        if bytes(b[:8]) != _SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file (or a user block precedes it)")
        version, offsets, lengths = b[8], b[13], b[14]
        if version not in (0, 1):
            raise NotImplementedError(f"{path}: HDF5 superblock version {version} (only 0 and 1)")
        if offsets != 8 or lengths != 8:
            raise NotImplementedError(f"{path}: {offsets}-byte offsets, {lengths}-byte lengths")
        pos = 24 + (4 if version == 1 else 0)
        base = struct.unpack_from("<Q", b, pos)[0]
        if base != 0:
            raise NotImplementedError(f"{path}: base address {base}")
        root = _Header(b, struct.unpack_from("<Q", b, pos + 40)[0])  # the root entry's header
        self.attrs = Attributes(root, b)
        stab = root.find(_SYMBOL_TABLE)
        if stab is None:
            raise NotImplementedError(f"{path}: a root group stored in link messages (new-style "
                                      "groups; only symbol-table groups are read)")
        self._links = self._symbol_table(*struct.unpack_from("<QQ", stab[1]))
        self._datasets: dict[str, Dataset] = {}

    def __getitem__(self, name: str) -> Dataset:
        name = name.strip("/")
        ds = self._datasets.get(name)
        if ds is None:
            if name not in self._links:
                raise KeyError(f"{name!r} is not in {self.filename}")
            header = _Header(self._buf, self._links[name])
            if header.has(_SYMBOL_TABLE) or header.has(_LINK_INFO):
                raise NotImplementedError(f"{name}: groups below the root are not read")
            ds = self._datasets[name] = Dataset(self, name, header)
        return ds

    def __iter__(self) -> Iterator[str]:
        return iter(self._links)

    def __len__(self) -> int:
        return len(self._links)

    def __contains__(self, name: object) -> bool:
        return isinstance(name, str) and name.strip("/") in self._links

    def _symbol_table(self, btree: int, heap: int) -> dict[str, int]:
        """name → object header address of a symbol-table group."""
        b = self._buf
        if bytes(b[heap:heap + 4]) != b"HEAP":
            raise ValueError(f"no local heap at {heap}")
        heap_data = struct.unpack_from("<Q", b, heap + 24)[0]

        def name(offset: int) -> str:
            start = heap_data + offset
            end = start
            while b[end]:
                end += 1
            return bytes(b[start:end]).decode("utf-8")

        links: dict[str, int] = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop()
            if bytes(b[node:node + 4]) != b"TREE":
                raise ValueError(f"no B-tree node at {node}")
            kind, level, used = struct.unpack_from("<BBH", b, node + 4)
            if kind != 0:
                raise ValueError(f"B-tree node of type {kind} in a group")
            # keys and children alternate after the 24-byte node header
            children = [struct.unpack_from("<Q", b, node + 24 + 16 * i + 8)[0] for i in range(used)]
            if level > 0:
                nodes.extend(children)
                continue
            for snod in children:
                if bytes(b[snod:snod + 4]) != b"SNOD":
                    raise ValueError(f"no symbol node at {snod}")
                (count,) = struct.unpack_from("<H", b, snod + 6)
                for j in range(count):
                    off, obj = struct.unpack_from("<QQ", b, snod + 8 + 40 * j)
                    links[name(off)] = obj
        return dict(sorted(links.items()))

    def close(self) -> None:
        """Drops this object's mapping; arrays read from it keep theirs alive."""
        self._datasets.clear()
        self._buf = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"<HDF5 file {self.filename!r} ({len(self)} members)>"


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------

_WRITABLE = {np.dtype(f"<{k}{n}") for k in "iu" for n in (1, 2, 4, 8)} | \
    {np.dtype("<f4"), np.dtype("<f8")}
_ALIGN = 64       # data blocks start on 64-byte boundaries


def _writable(dtype: Any, what: str) -> np.dtype:
    dt = np.dtype(dtype).newbyteorder("<")
    if dt not in _WRITABLE:
        raise NotImplementedError(f"{what}: dtype {np.dtype(dtype)} (only little-endian "
                                  "integers of 1-8 bytes, float32 and float64 are written)")
    return dt


def _datatype_msg(dt: np.dtype) -> bytes:
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, dt.itemsize,
                           0, 8 * dt.itemsize)
    exp_loc, exp_size, mant, bias = (23, 8, 23, 127) if dt.itemsize == 4 else (52, 11, 52, 1023)
    return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * dt.itemsize - 1, 0, dt.itemsize,
                       0, 8 * dt.itemsize, exp_loc, exp_size, 0, mant, bias)


# h5py's variable-length UTF-8 string: class 9 version 1, type string,
# null-terminated padding, UTF-8; 16 bytes an element (length, collection
# address, object index); base type one unsigned byte
_VLEN_STR_MSG = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0x00, 16) + \
    struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)


def _dataspace_msg(shape: tuple[int, ...]) -> bytes:
    """Version 1; a simple dataspace carries its max dims (= dims), as h5py's do."""
    if not shape:
        return struct.pack("<BBBB4x", 1, 0, 0, 0)
    return struct.pack(f"<BBBB4x{2 * len(shape)}Q", 1, len(shape), 1, 0, *shape, *shape)


def _message(kind: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", kind, len(body), flags) + body


def _attribute_msg(name: str, value: Any, strings: dict[str, int], gcol: int) -> bytes:
    """A version-1 attribute message; a `str` value refers to its object in
    the global heap collection at ``gcol`` (``strings``: text → index)."""
    if isinstance(value, str):
        data = struct.pack("<IQI", len(value.encode("utf-8")), gcol, strings[value])
        dt, ds = _VLEN_STR_MSG, _dataspace_msg(())
    else:
        arr = np.asarray(value)
        arr = np.asarray(arr, _writable(arr.dtype, f"attribute {name!r}"), order="C")
        data, dt, ds = arr.tobytes(), _datatype_msg(arr.dtype), _dataspace_msg(arr.shape)
    nb = name.encode("utf-8") + b"\0"
    pad = lambda x: x + b"\0" * (_pad8(len(x)) - len(x))
    return _message(_ATTRIBUTE, struct.pack("<BBHHH", 1, 0, len(nb), len(dt), len(ds))
                    + pad(nb) + pad(dt) + pad(ds) + data)


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _global_heap(strings: dict[str, int]) -> bytes:
    """One collection holding ``strings`` (objects 1..n, unreferenced as
    h5py leaves them), the rest free space (object 0); at least 4 KiB."""
    objs = b""
    for text, index in strings.items():
        raw = text.encode("utf-8")
        objs += struct.pack("<HH4xQ", index, 0, len(raw)) + raw + b"\0" * (_pad8(len(raw)) - len(raw))
    size = max(4096, 16 + len(objs) + 16)
    free = size - 16 - len(objs)
    return (b"GCOL" + struct.pack("<B3xQ", 1, size) + objs
            + struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16))


def _row_range(key: Any, n: int) -> tuple[int, int] | None:
    """(start, stop) when ``key`` selects whole rows start..stop-1 of a
    dataset of ``n`` rows, in order (an int, a step-1 slice, ``...``);
    None for any other index."""
    if key is Ellipsis:
        return 0, n
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        i = int(key) + (n if key < 0 else 0)
        return (i, i + 1) if 0 <= i < n else None
    if isinstance(key, slice) and key.step in (None, 1):
        start, stop, _ = key.indices(n)
        return start, max(start, stop)
    return None


class _WriteDataset:
    """A dataset of a `Writer`: its shape, dtype and ``attrs`` (written into
    its header when the file closes) and its data block (``addr`` None until
    the first write)."""

    def __init__(self, writer: "Writer", name: str, shape: tuple[int, ...], dtype: np.dtype):
        self._writer = writer
        self.name, self.shape, self.dtype = name, shape, dtype
        self.attrs: dict[str, Any] = {}
        self.addr: int | None = None
        self._map: np.memmap | None = None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def _allocate(self) -> int:
        if self.addr is None:
            self.addr = self._writer._allocate(self.nbytes)
        return self.addr

    def _view(self) -> np.ndarray:
        """The block as a writable memory map of the file."""
        if self._map is None:
            self._map = np.memmap(self._writer.filename, self.dtype, "r+",
                                  offset=self._allocate(), shape=self.shape)
        return self._map

    def __setitem__(self, key: Any, value: Any) -> None:
        """As h5py's: ``value`` broadcast to the selection and cast to the
        dtype.  Whole rows in order are written straight to the file."""
        if not self.nbytes:
            np.empty(self.shape, self.dtype)[key] = value   # h5py's errors, nothing to write
            return
        rows = _row_range(key, self.shape[0]) if self.shape and self._map is None else None
        if rows is None:
            self._view()[key] = value
            return
        start, stop = rows
        row_shape = (stop - start,) + self.shape[1:]
        sel_shape = row_shape[1:] if isinstance(key, (int, np.integer)) else row_shape
        block = np.ascontiguousarray(np.broadcast_to(np.asarray(value, self.dtype), sel_shape))
        row_bytes = self.nbytes // self.shape[0]
        self._writer._pwrite(block, self._allocate() + start * row_bytes)

    def __getitem__(self, key: Any) -> Any:
        """A copy of the selection, as h5py: zeros before the first write."""
        if self.addr is None or not self.nbytes:
            out = np.zeros(self.shape, self.dtype)[key]
        else:
            self._writer._flush_maps()
            out = np.memmap(self._writer.filename, self.dtype, "r", offset=self.addr,
                            shape=self.shape)[key]
        return np.array(out) if isinstance(out, np.ndarray) else out

    def __repr__(self) -> str:
        return f"<HDF5 dataset {self.name!r} (writing): shape {self.shape}, type {self.dtype}>"


class Writer:
    """``File(path, "w")``: data written as it comes, the metadata and the
    superblock by `close` (or the end of a ``with`` block)."""

    _FILL = b"\x02\x02\x02\x01\x00\x00\x00\x00"  # v2: late allocation, default fill (zeros)
    _SUPERBLOCK = 96

    def __init__(self, path: str | Path):
        self.filename = str(path)
        self.attrs: dict[str, Any] = {}
        self._datasets: dict[str, _WriteDataset] = {}
        self._fd = os.open(self.filename, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o666)
        self._eof = self._SUPERBLOCK   # the superblock's room; written last
        os.ftruncate(self._fd, self._eof)

    def _allocate(self, nbytes: int) -> int:
        addr = (self._eof + _ALIGN - 1) & ~(_ALIGN - 1)
        self._eof = addr + nbytes
        os.ftruncate(self._fd, self._eof)
        return addr

    def _pwrite(self, arr: np.ndarray, offset: int) -> None:
        mv = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        while mv:
            n = os.pwrite(self._fd, mv, offset)
            mv, offset = mv[n:], offset + n

    def _flush_maps(self) -> None:
        for ds in self._datasets.values():
            if ds._map is not None:
                ds._map.flush()

    def create_dataset(self, name: str, shape: Any = None, dtype: Any = None,
                       data: Any = None) -> _WriteDataset:
        """From ``data`` (cast to ``dtype`` if given; written now), or
        unallocated with ``shape`` and ``dtype`` (float32 by default, as
        h5py's)."""
        if self._fd is None:
            raise ValueError(f"{self.filename} is closed")
        if "/" in name.strip("/") or not name.strip("/"):
            raise NotImplementedError(f"{name!r}: only datasets in the root group are written")
        name = name.strip("/")
        if name in self._datasets:
            raise ValueError(f"dataset {name!r} exists")
        if shape is not None:
            shape = (int(shape),) if np.ndim(shape) == 0 else tuple(int(n) for n in shape)
        if data is not None:
            arr = np.asarray(data) if dtype is None else np.asarray(data, dtype)
            arr = np.asarray(arr, _writable(arr.dtype, name), order="C")
            if shape is not None and shape != arr.shape:
                raise ValueError(f"{name}: shape {shape} differs from the data's {arr.shape}")
            ds = _WriteDataset(self, name, arr.shape, arr.dtype)
            if ds.nbytes:
                self._pwrite(arr, ds._allocate())
        elif shape is None:
            raise ValueError(f"{name}: give data or a shape")
        else:
            ds = _WriteDataset(self, name, shape, _writable(dtype or "<f4", name))
        self._datasets[name] = ds
        return ds

    def __getitem__(self, name: str) -> _WriteDataset:
        return self._datasets[name.strip("/")]

    def close(self) -> None:
        if self._fd is None:
            return
        try:
            for ds in self._datasets.values():
                if ds._map is not None:
                    ds._map.flush()
                    ds._map = None
            self._write_metadata()
        finally:
            os.close(self._fd)
            self._fd = None

    def _write_metadata(self) -> None:
        names = sorted(self._datasets, key=lambda n: n.encode("utf-8"))
        # local heap: "" at offset 0, then each name NUL-terminated, 8-aligned
        heap = bytearray(8)
        name_off = {}
        for n in names:
            name_off[n] = len(heap)
            nb = n.encode("utf-8") + b"\0"
            heap += nb + b"\0" * (_pad8(len(nb)) - len(nb))
        leaf_k = max(4, -(-len(names) // 2))  # one symbol node holds every entry
        node_k = 16
        if leaf_k > 0xFFFF:
            raise NotImplementedError(f"{len(names)} datasets in one group")
        all_attrs = [self.attrs] + [self._datasets[n].attrs for n in names]
        strings: dict[str, int] = {}
        for attrs in all_attrs:
            for v in attrs.values():
                if isinstance(v, str) and v not in strings:
                    strings[v] = len(strings) + 1
        gheap = _global_heap(strings) if strings else b""

        def headers(btree: int, heap_addr: int, gcol: int, data_at) -> list[bytes]:
            root = [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))]
            root += [_attribute_msg(k, v, strings, gcol) for k, v in self.attrs.items()]
            return [_object_header(root)] + [self._dataset_header(self._datasets[n], data_at(n),
                                                                  strings, gcol) for n in names]

        # the sizes do not depend on the addresses: lay out once, then fill in
        sizes = [len(h) for h in headers(0, 0, 0, lambda n: 0)]
        root_addr = _pad8(self._eof)
        heap_addr = root_addr + sizes[0]
        heap_data_addr = heap_addr + 32
        btree_addr = heap_data_addr + len(heap)
        btree_size = 24 + (2 * node_k + 1) * 8 + 2 * node_k * 8
        snod_addr = btree_addr + btree_size
        snod_size = 8 + 2 * leaf_k * 40 if names else 0
        pos = snod_addr + snod_size
        header_at = {}
        for n, size in zip(names, sizes[1:]):
            header_at[n] = pos
            pos += size
        gcol_addr = pos
        eof = pos + len(gheap)

        addr_of = lambda n: _UNDEF if self._datasets[n].addr is None else self._datasets[n].addr
        hdrs = headers(btree_addr, heap_addr, gcol_addr, addr_of)
        heap_hdr = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data_addr)
        btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0, _UNDEF, _UNDEF)
        if names:
            btree += struct.pack("<QQQ", 0, snod_addr, name_off[names[-1]])
        btree += b"\0" * (btree_size - len(btree))
        snod = b""
        if names:
            snod = b"SNOD" + struct.pack("<BxH", 1, len(names))
            for n in names:
                snod += struct.pack("<QQI4x16x", name_off[n], header_at[n], 0)
            snod += b"\0" * (snod_size - len(snod))
        meta = hdrs[0] + heap_hdr + bytes(heap) + btree + snod + b"".join(hdrs[1:]) + gheap
        assert root_addr + len(meta) == eof
        self._pwrite(np.frombuffer(meta, np.uint8), root_addr)
        sb = _SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k, node_k, 0)
        sb += struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, root_addr, 1, btree_addr, heap_addr)
        assert len(sb) == self._SUPERBLOCK
        self._pwrite(np.frombuffer(sb, np.uint8), 0)
        os.ftruncate(self._fd, eof)

    def _dataset_header(self, ds: _WriteDataset, addr: int, strings: dict[str, int],
                        gcol: int) -> bytes:
        msgs = [_message(_DATASPACE, _dataspace_msg(ds.shape)),
                _message(_DATATYPE, _datatype_msg(ds.dtype), flags=1),
                _message(_FILL, self._FILL, flags=1),
                _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, ds.nbytes))]
        msgs += [_attribute_msg(k, v, strings, gcol) for k, v in ds.attrs.items()]
        return _object_header(msgs)

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
