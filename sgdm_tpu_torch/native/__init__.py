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
    row unfilters of `utils/png.py`;
  * ``polygon.cpp``, PIL's filled polygon (``ImageDraw.polygon(xy,
    fill=v)`` on an 8-bit image, bit for bit): `fill_polygons`, the COCO
    2014 instance masks of `data/coco14.py`;
  * ``densecrf.cpp``, the port's copy of the JAX package's dense CRF
    (permutohedral lattice + mean field, the pydensecrf replacement STEGO's
    masks are refined with): `dense_crf` and `permutohedral_filter`, with the
    JAX package's defaults; `dense_crf_plain` is the same mean field in numpy
    with exact dense Gaussian kernels, O(N²), the yardstick of the lattice's
    approximation on small images.
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
           "gather_image_batch_plain", "gather_rows_plain", "dense_crf", "dense_crf_plain",
           "permutohedral_filter", "fill_polygons"]

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


def _declare_densecrf(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i, f = ctypes.c_int, ctypes.c_float
    lib.dense_crf_inference.argtypes = [f32p, u8p, i, i, i, i, f, f, f, f, f, f32p]
    lib.dense_crf_inference.restype = None
    lib.permutohedral_filter.argtypes = [f32p, f32p, i, i, i, f32p]
    lib.permutohedral_filter.restype = None


def _declare_polygon(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.fill_polygons.argtypes = [p, ctypes.c_int, ctypes.c_int, p, p, ctypes.c_int64, p]
    lib.fill_polygons.restype = ctypes.c_int64


_DECLARE = {"batchgather": _declare_batchgather, "jpeg": _declare_jpeg,
            "resample": _declare_resample, "densecrf": _declare_densecrf,
            "polygon": _declare_polygon}


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


def dense_crf(unary_logits: np.ndarray, rgb: np.ndarray, iters: int = 10, pos_w: float = 3.0,
              pos_xy_std: float = 1.0, bi_w: float = 4.0, bi_xy_std: float = 67.0,
              bi_rgb_std: float = 3.0) -> np.ndarray:
    """Refined probabilities [C, H, W] float32 of unary logits [C, H, W] on
    an image [H, W, 3] uint8: a Gaussian (``pos_*``) and a bilateral
    (``bi_*``) kernel, ``iters`` mean-field iterations.  The defaults are
    STEGO's CRF (MAX_ITER 10, POS_W 3, POS_XY_STD 1, Bi_W 4, Bi_XY_STD 67,
    Bi_RGB_STD 3)."""
    lib = load_library("densecrf")
    c, h, w = unary_logits.shape
    if rgb.shape != (h, w, 3) or rgb.dtype != np.uint8:
        raise ValueError(f"rgb must be uint8 [{h}, {w}, 3], got {rgb.dtype} {rgb.shape}")
    unary = np.ascontiguousarray(unary_logits, dtype=np.float32)
    out = np.empty_like(unary)
    lib.dense_crf_inference(unary.reshape(c, -1), np.ascontiguousarray(rgb), h, w, c, iters,
                            pos_w, pos_xy_std, bi_w, bi_xy_std, bi_rgb_std, out.reshape(c, -1))
    return out


def permutohedral_filter(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Values [N, vd] filtered by a unit Gaussian in feature space [N, fd]
    (the lattice's approximation, unnormalised)."""
    lib = load_library("densecrf")
    n, fd = features.shape
    vd = values.shape[1]
    out = np.empty((n, vd), dtype=np.float32)
    lib.permutohedral_filter(np.ascontiguousarray(features, dtype=np.float32),
                             np.ascontiguousarray(values, dtype=np.float32), n, fd, vd, out)
    return out


def _softmax_rows(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def dense_crf_plain(unary_logits: np.ndarray, rgb: np.ndarray, iters: int = 10,
                    pos_w: float = 3.0, pos_xy_std: float = 1.0, bi_w: float = 4.0,
                    bi_xy_std: float = 67.0, bi_rgb_std: float = 3.0) -> np.ndarray:
    """`dense_crf`'s mean field with exact Gaussian kernels in float64:
    message_i = w · Σ_{j≠i} k_ij Q_j / Σ_j k_ij per kernel, Q = softmax(unary
    + messages).  O(N²) memory and time: small images only."""
    c, h, w = unary_logits.shape
    y, x = np.mgrid[:h, :w]
    xy = np.stack([x.ravel(), y.ravel()], 1).astype(np.float64)
    col = rgb.reshape(-1, 3).astype(np.float64)

    def kernel(f):
        d2 = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)
        k = np.exp(-0.5 * d2)
        return k, 1.0 / k.sum(1, keepdims=True)

    kernels = [(pos_w, *kernel(xy / pos_xy_std)),
               (bi_w, *kernel(np.concatenate([xy / bi_xy_std, col / bi_rgb_std], 1)))]
    unary = unary_logits.reshape(c, -1).T.astype(np.float64)        # [N, C]
    q = _softmax_rows(unary)
    for _ in range(iters):
        msg = sum(wt * (k @ q - q) * norm for wt, k, norm in kernels)
        q = _softmax_rows(unary + msg)
    return q.T.reshape(c, h, w).astype(np.float32)


def fill_polygons(mask: np.ndarray, polygons, values) -> np.ndarray:
    """Fill each polygon (a flat sequence x0, y0, x1, y1, … of numbers) with
    its value, in order, into the uint8 [H, W] ``mask`` (in place, which is
    returned): ``ImageDraw.Draw(Image.fromarray(mask)).polygon(xy, fill=v)``
    for each, bit for bit."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags["C_CONTIGUOUS"]:
        raise ValueError("mask must be a contiguous uint8 [H, W] array")
    polys = [np.asarray(p, dtype=np.float64).reshape(-1) for p in polygons]
    vals = np.ascontiguousarray(values, dtype=np.uint8)
    if len(vals) != len(polys):
        raise ValueError(f"{len(polys)} polygons but {len(vals)} values")
    if not polys:
        return mask
    coords = np.ascontiguousarray(np.concatenate(polys))
    starts = np.zeros(len(polys) + 1, np.int64)
    np.cumsum([len(p) for p in polys], out=starts[1:])
    rc = load_library("polygon").fill_polygons(mask.ctypes.data, mask.shape[0], mask.shape[1],
                                               coords.ctypes.data, starts.ctypes.data,
                                               len(polys), vals.ctypes.data)
    if rc:
        raise ValueError(f"polygon {rc - 1} has an odd count of numbers")
    return mask
