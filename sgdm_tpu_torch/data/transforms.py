"""Segmentation-mask encodings of the layout conditions.

The port's own copy of the numpy helpers of `sgdm_tpu/data/transforms.py`
that turn an id-pixel mask into what the layout-conditioned models take:
one-hot layouts [H, W, C] (255, the ignore label, is background 0), the
normalised uint8 id mask of the one-hot-on-the-device wire format, the
n-hot [C] of the classes present (`stegoclusterlayout`'s ``cond``) and
binary box masks.  ``fine_to_coarse`` relabels ids first.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

__all__ = ["segmask_to_onehot", "segmask_to_ids", "mask_to_attr_nhot", "bbox_to_mask"]


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
