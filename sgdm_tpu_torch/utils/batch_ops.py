"""Batch helpers of the image logger, on numpy arrays.

The port's copy of the helpers of `sgdm_tpu/utils/batch_ops.py` that
`training/trainer.py _log_images` and the test phase's figures
(`eval/harness.py _make_vis_hooks`) call: `slerp` (spherical interpolation
of two vectors), `batch_to_samecondition` (row i takes row
i // samecondition_num), `batch_to_samecondition_v2` (the same, but one key
keeps its own rows) and `batch_interp_condition` (chains of interpolated
conditions between consecutive pairs).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

__all__ = ["slerp", "batch_to_samecondition", "batch_to_samecondition_v2",
           "batch_interp_condition"]


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Spherical interpolation of two vectors."""
    low_n = low / np.linalg.norm(low)
    high_n = high / np.linalg.norm(high)
    omega = np.arccos(np.clip(np.dot(low_n, high_n), -1, 1))
    so = np.sin(omega)
    if so == 0:
        return (1.0 - val) * low + val * high
    return np.sin((1.0 - val) * omega) / so * low + np.sin(val * omega) / so * high


def batch_to_samecondition(batch: Mapping[str, np.ndarray], samecondition_num: int = 7) -> dict:
    """Row i takes row i // samecondition_num."""
    out = {}
    for k, v in batch.items():
        idx = np.arange(len(v)) // samecondition_num
        idx = np.clip(idx, 0, len(v) - 1)
        out[k] = v[idx].copy()
    return out


def batch_to_samecondition_v2(batch: Mapping[str, np.ndarray], different_key: str,
                              samecondition_num: int = 7) -> dict:
    """Like `batch_to_samecondition`, but ``different_key`` keeps its own
    rows (same cluster with different LOST boxes, and the like)."""
    out = {}
    for k, v in batch.items():
        if k == different_key:
            out[k] = np.asarray(v).copy()
        else:
            idx = np.clip(np.arange(len(v)) // samecondition_num, 0, len(v) - 1)
            out[k] = np.asarray(v)[idx].copy()
    return out


def batch_interp_condition(cond: np.ndarray, interp_num: int, how: str = "slerp") -> np.ndarray:
    """[n_pairs * interp_num, C]: for each consecutive pair (i, i+1),
    ``interp_num`` points from cond_i to cond_{i+1}."""
    assert cond.ndim == 2
    chunks = []
    for i in range(len(cond) - 1):
        lo, hi = cond[i], cond[i + 1]
        for t in np.linspace(0.0, 1.0, interp_num):
            if how == "slerp":
                chunks.append(slerp(float(t), lo, hi))
            else:
                chunks.append((1 - t) * lo + t * hi)
    return np.stack(chunks)
