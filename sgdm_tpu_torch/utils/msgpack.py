"""The msgpack subset of flax's checkpoints, without the msgpack package.

`flax.serialization.to_bytes(params)` packs a tree of dicts with str keys
whose leaves are numpy arrays: each dict a msgpack map, each key a str,
each array the ext type 1 (``_MsgpackExtType.ndarray``) whose payload is
itself packed, the array ``[shape, dtype name, C-order bytes]``.  `packb`
writes those bytes for such a tree (keys in the tree's order: the JAX CLI
hands flax a tree that `jax.tree.map` rebuilt, every dict sorted by key,
which `pack_params` does too); `unpackb` reads them back.  Anything else
(other ext types, floats, lists at the top, flax's chunked arrays of more
than 2**30 - 1 bytes) raises.

    msgpack.pack_params(tree) == flax.serialization.to_bytes(jax.tree.map(np.asarray, tree))
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

__all__ = ["packb", "unpackb", "pack_params", "unpack_params", "flatten", "unflatten"]

NDARRAY_EXT = 1
MAX_CHUNK_SIZE = 2 ** 30 - 1   # flax chunks arrays above this; the subset does not


def _uint(n: int, fix_max: int, fix_tag: int, tags: tuple[int, int, int]) -> bytes:
    """A length or count: its fix form below ``fix_max``, else 8/16/32 bits (tags)."""
    if n < fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} beyond msgpack's 32 bits")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if n <= top:
                out += bytes([tag]) + struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} beyond 64 bits")
    else:
        for tag, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                             (0xD2, ">i", -0x80000000), (0xD3, ">q", -2 ** 63)):
            if n >= lo:
                out += bytes([tag]) + struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} beyond 64 bits")


def _pack_str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    out += _uint(len(b), 32, 0xA0, (0xD9, 0xDA, 0xDB)) + b


def _pack_bin(b: bytes, out: bytearray) -> None:
    out += _uint(len(b), 0, 0, (0xC4, 0xC5, 0xC6)) + b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out += bytes([fixed[len(data)], code])
    else:
        out += _uint(len(data), 0, 0, (0xC7, 0xC8, 0xC9)) + bytes([code])
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype.name, tobytes('C')))``."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not serialized")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes: flax would chunk it")
    out = bytearray([0x93])
    out += _uint(len(arr.shape), 16, 0x90, (None, 0xDC, 0xDD))
    for n in arr.shape:
        _pack_int(int(n), out)
    _pack_str(arr.dtype.name, out)
    _pack_bin(arr.tobytes("C"), out)
    return bytes(out)


def _pack(node: Any, out: bytearray) -> None:
    if isinstance(node, Mapping):
        out += _uint(len(node), 16, 0x80, (None, 0xDE, 0xDF))
        for key, value in node.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {type(key).__name__}")
            _pack_str(key, out)
            _pack(value, out)
    elif isinstance(node, np.ndarray):
        _pack_ext(NDARRAY_EXT, _ndarray_payload(node), out)
    else:
        raise TypeError(f"{type(node).__name__} is outside the subset (str-keyed maps of "
                        f"numpy arrays)")


def packb(tree: Mapping[str, Any]) -> bytes:
    """The bytes of a tree of str-keyed maps whose leaves are numpy arrays,
    keys in the tree's own order."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if tag in sized:
            return self.str(self.uint(sized[tag]))
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if tag in sized:
            return bytes(self.take(self.uint(sized[tag])))
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                0xD2: ">i", 0xD3: ">q"}
        if tag in ints:
            return self.uint(ints[tag])
        if tag in (0xDC, 0xDD):
            return [self.read() for _ in range(self.uint(">H" if tag == 0xDC else ">I"))]
        if tag in (0xDE, 0xDF):
            return self.map(self.uint(">H" if tag == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixed:
            return self.ext(fixed[tag])
        if tag in (0xC7, 0xC8, 0xC9):
            return self.ext(self.uint({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[tag]))
        raise ValueError(f"msgpack type 0x{tag:02x} is outside the subset")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            out[key] = self.read()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.take(1)[0]
        payload = bytes(self.take(n))
        if code != NDARRAY_EXT:
            raise ValueError(f"msgpack ext type {code} is outside the subset (ndarray: 1)")
        inner = _Reader(payload)
        shape, dtype, buf = inner.read()
        if inner.pos != len(payload):
            raise ValueError("trailing bytes in an ndarray payload")
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """The tree `packb` (or flax's ``to_bytes``) wrote: dicts and numpy arrays."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def unflatten(flat: Mapping[str, np.ndarray], sep: str = "/") -> dict:
    """``{"a/b/kernel": x}`` → ``{"a": {"b": {"kernel": x}}}``, every level sorted by key."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    def sort(node):
        return {k: sort(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return sort(tree)


def flatten(tree: Mapping[str, Any], sep: str = "/", prefix: str = "") -> dict[str, np.ndarray]:
    """The inverse of `unflatten`."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{sep}{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(flatten(value, sep, path))
        else:
            out[path] = value
    return out


def pack_params(flat: Mapping[str, np.ndarray]) -> bytes:
    """A ``/``-flattened flax param tree → the bytes the JAX package's
    ``to_bytes(jax.tree.map(np.asarray, params))`` writes."""
    return packb(unflatten({k: np.ascontiguousarray(v) for k, v in flat.items()}))


def unpack_params(data: bytes) -> dict[str, np.ndarray]:
    """`pack_params` read back (or a flax ``to_bytes`` of a param tree): ``/``-flattened."""
    tree = unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("a param checkpoint is a map at the top")
    return flatten(tree)
