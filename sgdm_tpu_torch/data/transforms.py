"""Segmentation-mask encodings of the layout conditions.

The port's own copy of the numpy helpers of `sgdm_tpu/data/transforms.py`
that turn an id-pixel mask into what the layout-conditioned models take:
one-hot layouts [H, W, C] (255, the ignore label, is background 0), the
normalised uint8 id mask of the one-hot-on-the-device wire format, the
n-hot [C] of the classes present (`stegoclusterlayout`'s ``cond``) and
binary box masks.  ``fine_to_coarse`` relabels ids first.

`resize_bilinear` and `resize_bicubic` are ``Image.resize(..., Image.BILINEAR)``
and ``Image.BICUBIC`` of uint8 images without PIL, bit for bit (the card's
machine has no PIL): one call of ``native/resample.cpp`` each, or with
``plain=True`` the numpy version the tests hold it against.
`RandomScaleCrop` is the joint image + mask augmentation of the
segmentation datasets (`sgdm_tpu/data/transforms.py:34-79`) on numpy
arrays, drawing what the JAX one draws.
"""

from __future__ import annotations

import math
import random
from functools import lru_cache
from typing import Mapping

import numpy as np

from ..native import load_library
from ..utils.png import nearest_index, resize_nearest

__all__ = ["segmask_to_onehot", "segmask_to_ids", "mask_to_attr_nhot", "bbox_to_mask",
           "ids_to_onehot", "ids_to_nhot", "fine_to_coarse_lut", "encode_mask",
           "resize_bilinear", "resize_bicubic", "resize_window", "resize", "RESIZE_FILTERS",
           "scale_crop_resize", "RandomScaleCrop"]


def _relabel(mask: np.ndarray, fine_to_coarse: Mapping[int, int] | None) -> np.ndarray:
    if fine_to_coarse is None:
        return mask
    out = mask.copy()
    for fine in np.unique(mask):
        out[mask == fine] = fine_to_coarse[int(fine)]
    return out


def fine_to_coarse_lut(fine_to_coarse: Mapping[int, int]) -> np.ndarray:
    """A fine → coarse mapping as the int16 table over 0..255 that
    `encode_mask` takes natively (-1: no entry)."""
    lut = np.full(256, -1, np.int16)
    for f, c in fine_to_coarse.items():
        if 0 <= int(f) < 256:
            if not 0 <= int(c) < 256:
                raise ValueError(f"fine_to_coarse maps {f} to {c}, outside 0..255")
            lut[int(f)] = int(c)
    return lut


def encode_mask(m: np.ndarray, rows: np.ndarray, cols: np.ndarray, num_classes: int,
                fine_to_coarse: Mapping[int, int] | np.ndarray | None = None,
                onehot: bool = True, plain: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """A uint8 id mask's gather (``m[rows][:, cols]``: the NEAREST chain of
    `RandomScaleCrop.mask_indices`) and its encoding, as
    `segmask_to_onehot` (``onehot``) or `segmask_to_ids`, and
    `mask_to_attr_nhot`: (one-hot [h, w, C] f32 or ids [h, w] uint8, n-hot
    [C] f32).  One native call, or with ``plain`` the numpy functions.
    ``fine_to_coarse`` is a mapping or its `fine_to_coarse_lut`.  A value
    without an entry in it raises KeyError, an id past the classes
    IndexError, as the numpy functions do."""
    if num_classes > 256:
        raise ValueError(f"id masks are uint8: num_classes {num_classes} > 256")
    lut = fine_to_coarse
    if fine_to_coarse is not None and not isinstance(fine_to_coarse, np.ndarray):
        lut = fine_to_coarse_lut(fine_to_coarse)
    elif isinstance(fine_to_coarse, np.ndarray):
        fine_to_coarse = {i: int(c) for i, c in enumerate(fine_to_coarse) if c >= 0}
    if plain or m.dtype != np.uint8 or m.ndim != 2:
        ids = segmask_to_ids(m[rows[:, None], cols[None, :]], num_classes, fine_to_coarse)
        return (ids_to_onehot(ids, num_classes) if onehot else ids,
                ids_to_nhot(ids, num_classes))
    if m.strides[1] != 1:
        m = np.ascontiguousarray(m)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    h, w = len(rows), len(cols)
    out = (np.empty((h, w, num_classes), np.float32) if onehot
           else np.empty((h, w), np.uint8))
    nhot = np.empty(num_classes, np.float32)
    lut = None if lut is None else np.ascontiguousarray(lut, dtype=np.int16)
    rc = load_library("resample").encode_mask(
        m.ctypes.data, m.strides[0], rows.ctypes.data, cols.ctypes.data, h, w,
        None if lut is None else lut.ctypes.data, num_classes,
        None if onehot else out.ctypes.data, out.ctypes.data if onehot else None,
        nhot.ctypes.data)
    if rc < 0:
        raise KeyError(int(-rc - 1))
    if rc > 0:
        raise IndexError(f"segmask id {int(rc - 1)} >= num_classes {num_classes}")
    return out, nhot


def ids_to_onehot(ids: np.ndarray, num_classes: int) -> np.ndarray:
    """Normalised ids (`segmask_to_ids`) → [..., C] float32 one-hot."""
    return np.eye(num_classes, dtype=np.float32)[ids]


def ids_to_nhot(ids: np.ndarray, num_classes: int) -> np.ndarray:
    """Normalised ids → the n-hot [C] float32 of the classes present: what
    `mask_to_attr_nhot` gives on the mask the ids came from."""
    return (np.bincount(ids.ravel(), minlength=num_classes) > 0).astype(np.float32)


def segmask_to_onehot(segmask: np.ndarray, num_classes: int,
                      fine_to_coarse: Mapping[int, int] | None = None) -> np.ndarray:
    """[H, W] ids → [H, W, C] float32 one-hot; 255 is background 0."""
    return ids_to_onehot(segmask_to_ids(segmask, num_classes, fine_to_coarse), num_classes)


def segmask_to_ids(segmask: np.ndarray, num_classes: int,
                   fine_to_coarse: Mapping[int, int] | None = None) -> np.ndarray:
    """[H, W] ids → the normalised uint8 id mask (255 → 0, fine → coarse);
    an id ≥ ``num_classes`` raises `IndexError`."""
    ids = segmask.astype(np.int64).copy()
    ids[ids == 255] = 0
    ids = _relabel(ids, fine_to_coarse)
    if num_classes > 256:
        raise ValueError(f"id masks are uint8: num_classes {num_classes} > 256")
    if ids.size and int(ids.max()) >= num_classes:
        raise IndexError(f"segmask id {int(ids.max())} >= num_classes {num_classes}")
    return ids.astype(np.uint8)


def mask_to_attr_nhot(segmask: np.ndarray, num_classes: int,
                      fine_to_coarse: Mapping[int, int] | None = None) -> np.ndarray:
    """n-hot [C] float32 of the classes present in the mask (255 → 0)."""
    segmask = segmask.astype(np.int64).copy()
    segmask[segmask == 255] = 0
    nhot = np.zeros((num_classes,), dtype=np.float32)
    nhot[np.unique(_relabel(segmask, fine_to_coarse))] = 1.0
    return nhot


def bbox_to_mask(shape_hw: tuple[int, int], bbox: np.ndarray) -> np.ndarray:
    """Binary uint8 [H, W] mask of an (x0, y0, x1, y1) box."""
    m = np.zeros(shape_hw, dtype=np.uint8)
    m[int(bbox[1]):int(bbox[3]), int(bbox[0]):int(bbox[2])] = 1
    return m


_PRECISION_BITS = 32 - 8 - 2   # PIL's fixed point for 8-bit images
_FILTERS = {"bilinear": (0, 1.0), "bicubic": (1, 2.0), "box": (2, 0.5), "hamming": (3, 1.0),
            "lanczos": (4, 3.0)}   # native id, support


def _bilinear_filter(x: float) -> float:
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic_filter(x: float) -> float:
    a = -0.5   # PIL's, evaluated in its order of operations
    x = -x if x < 0.0 else x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _box_filter(x: float) -> float:
    return 1.0 if -0.5 < x <= 0.5 else 0.0


_F054, _F046 = float(np.float32(0.54)), float(np.float32(0.46))   # PIL's 0.54f, 0.46f


def _hamming_filter(x: float) -> float:
    x = -x if x < 0.0 else x
    if x == 0.0:
        return 1.0
    if x >= 1.0:
        return 0.0
    x = x * math.pi
    return math.sin(x) / x * (_F054 + _F046 * math.cos(x))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos_filter(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


_FILTER_FNS = {"bilinear": _bilinear_filter, "bicubic": _bicubic_filter, "box": _box_filter,
               "hamming": _hamming_filter, "lanczos": _lanczos_filter}


@lru_cache(maxsize=128)
def _taps(n_in: int, n_out: int, filter: str) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` (the filter's support widened by the
    downscale factor) and ``normalize_coeffs_8bpc`` (22 fraction bits, a
    negative weight rounded towards -inf by its -0.5): for each output pixel
    the input indices [n_out, ksize] and their fixed-point weights (0 past
    the pixel's window)."""
    f = _FILTER_FNS[filter]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = _FILTERS[filter][1] * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((n_out, ksize), np.int64)
    weight = np.zeros((n_out, ksize), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)      # int() truncates, as C's cast
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [f((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:   # summed in order, in double
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            weight[xx, x] = int(-0.5 + k * (1 << _PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << _PRECISION_BITS))
            index[xx, x] = x + xmin
    return index, weight


def _resample(img: np.ndarray, axis: int, n_out: int, filter: str) -> np.ndarray:
    index, weight = _taps(img.shape[axis], n_out, filter)
    taps = np.take(img.astype(np.int64), index, axis=axis)   # [..., n_out, ksize, ...]
    w = weight.reshape(weight.shape + (1,) * (img.ndim - axis - 1))
    acc = (taps * w).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_plain(img: np.ndarray, height: int, width: int, filter: str) -> np.ndarray:
    out = img
    if width != img.shape[1]:
        out = _resample(out, 1, width, filter)
    if height != img.shape[0]:
        out = _resample(out, 0, height, filter)
    return out.copy() if out is img else out


def _pixels(img: np.ndarray) -> np.ndarray:
    """``img``, or a contiguous copy unless only its rows are strided."""
    if img.strides[1] != (img.shape[2] if img.ndim == 3 else 1) or (
            img.ndim == 3 and img.strides[2] != 1):
        return np.ascontiguousarray(img)
    return img


def _check(img: np.ndarray, name: str) -> None:
    if img.dtype != np.uint8:
        raise TypeError(f"{name} takes uint8 images, got {img.dtype}")
    if img.ndim not in (2, 3) or (img.ndim == 3 and not 1 <= img.shape[2] <= 4):
        raise ValueError(f"{name} takes [H, W] or [H, W, C ≤ 4] images, got {img.shape}")


def resize_window(img: np.ndarray, height: int, width: int, filter: str,
                  window: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """One native call: the ``(y0, x0, h, w)`` window (all of it by
    default) of ``img`` resized to [height, width] with PIL's ``filter``
    ("bilinear" or "bicubic"), equal to that crop of the whole resize.
    ``img`` may be a view whose rows are strided (a crop)."""
    _check(img, "resize_window")
    img = _pixels(img)
    y0, x0, sh, sw = window or (0, 0, height, width)
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((sh, sw) + img.shape[2:], np.uint8)
    lib = load_library("resample")
    rc = lib.resample_u8(img.ctypes.data, img.strides[0], img.shape[0], img.shape[1], c,
                         out.ctypes.data, height, width, _FILTERS[filter][0], y0, x0, sh, sw)
    if rc != 0:
        raise ValueError(f"resize_window: bad sizes {img.shape} -> {(height, width)}, "
                         f"window {window}")
    return out


def resize_bilinear(img: np.ndarray, height: int, width: int, plain: bool = False) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] → [height, width(, C)], equal to
    ``np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))``:
    PIL's separable resample, horizontal pass first, each pass rounding its
    fixed-point sum and clipping to uint8."""
    _check(img, "resize_bilinear")
    if plain:
        return _resize_plain(img, height, width, "bilinear")
    return resize_window(img, height, width, "bilinear")


def resize_bicubic(img: np.ndarray, height: int, width: int, plain: bool = False) -> np.ndarray:
    """`resize_bilinear` with PIL's bicubic filter (a = -0.5, support 2),
    ``Image.BICUBIC``, which is also what ``img.resize(size)`` takes by
    default."""
    _check(img, "resize_bicubic")
    if plain:
        return _resize_plain(img, height, width, "bicubic")
    return resize_window(img, height, width, "bicubic")


RESIZE_FILTERS = ("nearest", "bilinear", "bicubic", "box", "hamming", "lanczos")


def resize(img: np.ndarray, height: int, width: int, filter: str = "bicubic",
           plain: bool = False) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] → [height, width(, C)], equal to
    ``Image.fromarray(img).resize((width, height), FILTER)`` for ``filter``
    one of `RESIZE_FILTERS` (``nearest``: `utils/png.py resize_nearest`;
    the others PIL's separable 8-bit resample, natively or, with ``plain``,
    in numpy)."""
    if filter == "nearest":
        return resize_nearest(img, height, width)
    _check(img, "resize")
    if filter not in _FILTERS:
        raise ValueError(f"filter {filter!r} not one of {RESIZE_FILTERS}")
    if plain:
        return _resize_plain(img, height, width, filter)
    return resize_window(img, height, width, filter)


def scale_crop_resize(img: np.ndarray, oh: int, ow: int, y1: int, x1: int, crop: int,
                      rs: int, unsup: int = 0, plain: bool = False
                      ) -> tuple[np.ndarray, np.ndarray | None]:
    """The image chain of `RandomScaleCrop` and of the segmentation
    datasets: bilinear to (oh, ow), the crop × crop window at (y1, x1),
    bicubic to rs × rs; with ``unsup`` also the whole image bilinear to
    unsup × unsup (``img4unsup``).  One native call (the scale computes the
    crop's pixels only), or the numpy versions with ``plain``.  Returns
    (image [rs, rs, C], img4unsup or None)."""
    _check(img, "scale_crop_resize")
    if plain:
        cropped = resize_bilinear(img, oh, ow, plain=True)[y1:y1 + crop, x1:x1 + crop]
        return (resize_bicubic(cropped, rs, rs, plain=True),
                resize_bilinear(img, unsup, unsup, plain=True) if unsup else None)
    img = _pixels(img)
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((rs, rs) + img.shape[2:], np.uint8)
    u = np.empty((unsup, unsup) + img.shape[2:], np.uint8) if unsup else None
    rc = load_library("resample").scale_crop_resize(
        img.ctypes.data, img.strides[0], img.shape[0], img.shape[1], c, oh, ow, y1, x1, crop,
        rs, out.ctypes.data, unsup, u.ctypes.data if unsup else None)
    if rc != 0:
        raise ValueError(f"scale_crop_resize: bad sizes {img.shape} -> {(oh, ow)}, crop {crop} "
                         f"at {(y1, x1)}")
    return out, u


class RandomScaleCrop:
    """The joint scale-and-crop of `sgdm_tpu/data/transforms.py:34-79` on
    numpy arrays: the short edge scaled to a draw from [1.05, 1.25]·base
    (BILINEAR for the image, NEAREST for every mask), a random base × base
    crop, then BICUBIC (the image) and NEAREST (the masks) to
    ``resize_size``.  ``rng`` is drawn as the JAX transform draws it (three
    ``randint``: the short edge, x, y), so the same seed gives the same crop.
    """

    def __init__(self, base_size: int, resize_size: int, fill: int = 0,
                 rng: random.Random | None = None):
        self.base_size = base_size
        self.crop_size = base_size
        self.resize_size = resize_size
        self.fill = fill
        # random.Random draws hold the interpreter lock: safe on the
        # loader's threads, in the order the threads draw
        self.rng = rng or random

    def draw(self, w: int, h: int) -> tuple[int, int, int, int]:
        """(scaled width, scaled height, crop x, crop y) for a w × h image."""
        short_size = self.rng.randint(int(self.base_size * 1.05), int(self.base_size * 1.25))
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        x1 = self.rng.randint(0, ow - self.crop_size)
        y1 = self.rng.randint(0, oh - self.crop_size)
        return ow, oh, x1, y1

    def mask_indices(self, shape: tuple[int, ...], ow: int, oh: int, x1: int,
                     y1: int) -> tuple[np.ndarray, np.ndarray]:
        """A mask's chain, NEAREST to (oh, ow), the crop, NEAREST to
        ``resize_size``, as the source row and column of each output pixel."""
        c, rs = self.crop_size, self.resize_size
        sel = nearest_index(c, rs)
        return (nearest_index(shape[0], oh)[y1:y1 + c][sel],
                nearest_index(shape[1], ow)[x1:x1 + c][sel])

    def mask(self, m: np.ndarray | None, ow: int, oh: int, x1: int,
             y1: int) -> np.ndarray | None:
        """A mask's chain as one gather."""
        if m is None:
            return None
        rows, cols = self.mask_indices(m.shape, ow, oh, x1, y1)
        return m[rows[:, None], cols[None, :]]

    def __call__(self, img: np.ndarray, mask: np.ndarray | None,
                 bboxmask: np.ndarray | None = None, stegomask: np.ndarray | None = None,
                 plain: bool = False):
        """(image [rs, rs, 3], mask, bboxmask, stegomask), each mask
        [rs, rs] or None."""
        h, w = img.shape[:2]
        ow, oh, x1, y1 = self.draw(w, h)
        image = scale_crop_resize(img, oh, ow, y1, x1, self.crop_size, self.resize_size,
                                  plain=plain)[0]
        return (image, *(self.mask(m, ow, oh, x1, y1) for m in (mask, bboxmask, stegomask)))
