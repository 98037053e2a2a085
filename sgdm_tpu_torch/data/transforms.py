"""Segmentation-mask encodings of the layout conditions.

The port's own copy of the numpy helpers of `sgdm_tpu/data/transforms.py`
that turn an id-pixel mask into what the layout-conditioned models take:
one-hot layouts [H, W, C] (255, the ignore label, is background 0), the
normalised uint8 id mask of the one-hot-on-the-device wire format, the
n-hot [C] of the classes present (`stegoclusterlayout`'s ``cond``) and
binary box masks.  ``fine_to_coarse`` relabels ids first.

`resize_bilinear` is ``Image.resize(..., Image.BILINEAR)`` of uint8 images
without PIL, bit for bit (the card's machine has no PIL).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Mapping

import numpy as np

__all__ = ["segmask_to_onehot", "segmask_to_ids", "mask_to_attr_nhot", "bbox_to_mask",
           "resize_bilinear"]


def _relabel(mask: np.ndarray, fine_to_coarse: Mapping[int, int] | None) -> np.ndarray:
    if fine_to_coarse is None:
        return mask
    out = mask.copy()
    for fine in np.unique(mask):
        out[mask == fine] = fine_to_coarse[int(fine)]
    return out


def segmask_to_onehot(segmask: np.ndarray, num_classes: int,
                      fine_to_coarse: Mapping[int, int] | None = None) -> np.ndarray:
    """[H, W] ids → [H, W, C] float32 one-hot; 255 is background 0."""
    return np.eye(num_classes, dtype=np.float32)[
        segmask_to_ids(segmask, num_classes, fine_to_coarse)]


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


@lru_cache(maxsize=64)
def _bilinear_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for the bilinear filter (support 1,
    widened by the downscale factor) and ``normalize_coeffs_8bpc``: for each
    output pixel the input indices [n_out, ksize] and their weights in fixed
    point with 22 fraction bits (0 past the pixel's window)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale   # the bilinear filter's support, 1.0, times the scale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((n_out, ksize), np.int64)
    weight = np.zeros((n_out, ksize), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)      # int() truncates, as C's cast
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0) for x in range(xmax)]
        ww = 0.0
        for v in w:   # summed in order, in double
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            weight[xx, x] = int(0.5 + k * (1 << _PRECISION_BITS))
            index[xx, x] = x + xmin
    return index, weight


def _resample(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    index, weight = _bilinear_taps(img.shape[axis], n_out)
    taps = np.take(img.astype(np.int64), index, axis=axis)   # [..., n_out, ksize, ...]
    w = weight.reshape(weight.shape + (1,) * (img.ndim - axis - 1))
    acc = (taps * w).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] → [height, width(, C)], equal to
    ``np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))``:
    PIL's separable resample, horizontal pass first, each pass rounding its
    fixed-point sum and clipping to uint8."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear takes uint8 images, got {img.dtype}")
    out = img
    if width != img.shape[1]:
        out = _resample(out, 1, width)
    if height != img.shape[0]:
        out = _resample(out, 0, height)
    return out.copy() if out is img else out
