"""Host C++ of the data path, loaded with ctypes.

Every source here is compiled with one set of flags, ``g++`` + `CXX_FLAGS`,
at first use, into ``build/native/<hash of source and flags>/lib<stem>.so``
at the root of the checkout, never beside the source; a failed build
raises.  `load_library` builds and opens one; ctypes releases the
interpreter lock for the length of every call.

  * ``batchgather.cpp``, the port's copy of the batch gather of
    `sgdm_tpu/native/` that `data/imagenet_pickle.py ImageNetPickle.get_batch`
    calls: `gather_image_batch` (rows → NHWC f32 in [-1, 1] plus the uint8
    copy) and `gather_rows` (f32 rows); `gather_image_batch_plain` and
    `gather_rows_plain` are the plain numpy versions the tests hold the
    native ones against, bit for bit;
  * ``jpeg.cpp``, the JPEG decoder of `utils/jpeg.py`;
  * ``resample.cpp``, PIL's resamplers of `data/transforms.py` and the PNG
    row unfilters of `utils/png.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["load_library", "load_batchgather", "gather_image_batch", "gather_rows",
           "gather_image_batch_plain", "gather_rows_plain"]

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _build(stem: str) -> Path:
    src = _SRC_DIR / f"{stem}.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    so = _BUILD_ROOT / h / f"lib{stem}.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".lib{stem}.{os.getpid()}.{threading.get_ident()}.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {src.name} failed ({' '.join(cmd)}):\n{out.stderr}")
    os.replace(tmp, so)
    return so


def load_library(stem: str) -> ctypes.CDLL:
    """``lib<stem>.so`` of ``<stem>.cpp`` with its functions' argument
    types set, built at the first call."""
    with _lock:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(_build(stem)))
            _DECLARE[stem](lib)
            _LIBS[stem] = lib
    return lib


def _declare_batchgather(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c64 = ctypes.c_int64
    for name in ("gather_chw_to_nhwc", "gather_hwc_to_nhwc"):
        # the rows by address: ndpointer refuses a read-only memory map
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, i64p, c64, c64, f32p, ctypes.c_void_p]
        fn.restype = None
    lib.gather_rows_f32.argtypes = [f32p, i64p, c64, c64, f32p]
    lib.gather_rows_f32.restype = None


def _declare_jpeg(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_char_p, i]
    lib.jpeg_header.restype = i
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, p, i, ctypes.c_char_p, i]
    lib.jpeg_decode.restype = i


def _declare_resample(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.resample_u8.argtypes = [p, i64, i, i, i, p, i, i, i, i, i, i, i]
    lib.resample_u8.restype = i
    lib.scale_crop_resize.argtypes = [p, i64, i, i, i, i, i, i, i, i, i, p, i, p]
    lib.scale_crop_resize.restype = i
    lib.png_unfilter.argtypes = [p, i64, i64, i, p]
    lib.png_unfilter.restype = i64
    lib.encode_mask.argtypes = [p, i64, p, p, i, i, p, i, p, p, p]
    lib.encode_mask.restype = i64


_DECLARE = {"batchgather": _declare_batchgather, "jpeg": _declare_jpeg,
            "resample": _declare_resample}


def load_batchgather() -> ctypes.CDLL:
    """The compiled gather, built at the first call."""
    return load_library("batchgather")


def _check_idx(idx: np.ndarray, n: int) -> None:
    """Bounds check before the C gather: an index out of range would read
    past the rows, where numpy indexing raises IndexError."""
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"gather indices out of range [0, {n}): min={idx.min()} max={idx.max()}")


def _rows(data: np.ndarray, size: int) -> np.ndarray:
    flat = data.reshape(len(data), -1)
    if flat.shape[1] != 3 * size * size:
        raise ValueError(f"rows of {flat.shape[1]} bytes are not {size}x{size}x3 images")
    if flat.dtype != np.uint8:
        raise TypeError(f"image rows must be uint8, got {flat.dtype}")
    return flat if flat.flags["C_CONTIGUOUS"] else np.ascontiguousarray(flat)


def gather_image_batch(data: np.ndarray, indices: np.ndarray, size: int, layout: str = "chw",
                       want_uint8: bool = True) -> tuple[np.ndarray, np.ndarray | None]:
    """One native call: gather rows ([N, 3·S·S] uint8, CHW or HWC; a
    read-only memory map is fine), to HWC, to f32 in [-1, 1], and the uint8
    copy.  Returns (images [B, S, S, 3] f32, uint8 [B, S, S, 3] | None)."""
    lib = load_batchgather()
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    _check_idx(idx, len(data))
    flat = _rows(data, size)
    b = len(idx)
    out = np.empty((b, size, size, 3), dtype=np.float32)
    u8 = np.empty((b, size, size, 3), dtype=np.uint8) if want_uint8 else None
    fn = lib.gather_chw_to_nhwc if layout == "chw" else lib.gather_hwc_to_nhwc
    fn(flat.ctypes.data_as(ctypes.c_void_p), idx, b, size, out,
       u8.ctypes.data_as(ctypes.c_void_p) if u8 is not None else None)
    return out, u8


def gather_image_batch_plain(data: np.ndarray, indices: np.ndarray, size: int,
                             layout: str = "chw") -> tuple[np.ndarray, np.ndarray]:
    """`gather_image_batch` in numpy: ``(v / 255) * 2 - 1`` in float32."""
    idx = np.asarray(indices, dtype=np.int64)
    rows = _rows(data, size)[idx]
    if layout == "chw":
        u8 = rows.reshape(-1, 3, size, size).transpose(0, 2, 3, 1)
    else:
        u8 = rows.reshape(-1, size, size, 3)
    u8 = np.ascontiguousarray(u8)
    return u8.astype(np.float32) / np.float32(255.0) * np.float32(2.0) - np.float32(1.0), u8


def gather_rows(rows: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Native f32 row gather ([N, D] → [B, D])."""
    lib = load_batchgather()
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    _check_idx(idx, len(rows))
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    out = np.empty((len(idx), rows.shape[1]), dtype=np.float32)
    lib.gather_rows_f32(rows, idx, len(idx), rows.shape[1], out)
    return out


def gather_rows_plain(rows: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """`gather_rows` in numpy."""
    return np.asarray(rows, dtype=np.float32)[np.asarray(indices, dtype=np.int64)]
