"""Synthetic labeled images for smoke runs and benchmarking.

The port's copy of `sgdm_tpu/data/synthetic.py` `SyntheticImages`: a
deterministic, procedurally generated class-conditional dataset with the
batch-dict contract of the real ones (``image`` NHWC float32 in [-1, 1],
the one-hot condition under ``cond_key``, ``id``, ``img4unsup`` uint8).
Each class draws a Gaussian blob at a class-specific grid position.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["SyntheticImages", "collate"]


class SyntheticImages:
    """Gaussian-blob class-conditional images."""

    def __init__(self, size: int = 32, channels: int = 3, num_classes: int = 10,
                 length: int = 1024, seed: int = 0, cond_key: str = "label"):
        self.size = size
        self.channels = channels
        self.num_classes = num_classes
        self.length = length
        self.seed = seed
        self.cond_key = cond_key

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        label = i % self.num_classes
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        cy = 0.2 + 0.6 * ((label % 4) / 3.0)
        cx = 0.2 + 0.6 * ((label // 4) / 3.0)
        sigma = 0.15 + 0.02 * rng.standard_normal()
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2)))
        img = np.stack([blob * (0.5 + 0.5 * ((label + c) % 3) / 2.0)
                        for c in range(self.channels)], axis=-1)
        img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
        img01 = np.clip(img, 0.0, 1.0).astype(np.float32)
        onehot = np.zeros((self.num_classes,), dtype=np.float32)
        onehot[label] = 1.0
        return {
            "image": img01 * 2.0 - 1.0,
            self.cond_key: onehot,
            "id": np.int64(i),
            "img4unsup": (img01 * 255).astype(np.uint8),
        }


def collate(items: Sequence[dict]) -> dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
