"""Synthetic labeled images for smoke runs and benchmarking.

The port's copy of `sgdm_tpu/data/synthetic.py`.  `SyntheticImages` is a
deterministic, procedurally generated class-conditional dataset with the
batch-dict contract of the real ones (``image`` NHWC float32 in [-1, 1],
the one-hot condition under ``cond_key``, ``id``, ``img4unsup`` uint8).
Each class draws a Gaussian blob at a class-specific grid position.
`SyntheticSegImages` adds segmentation layouts aligned with the blobs: the
fixture of the layout condition methods.  ``get_batch`` (which the loader
prefers) assembles a whole batch, equal to collating the samples.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["SyntheticImages", "SyntheticSegImages", "collate"]


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


    def get_batch(self, idx) -> dict[str, np.ndarray]:
        """Samples ``idx`` as one batch, equal to collating `__getitem__` of
        each, computed with whole-batch numpy operations.  The loader calls
        it from one thread (`data.loader.DataLoader`), and numpy releases
        the interpreter lock inside them: per-sample Python in loader
        threads would hold the lock the train step needs to launch its
        kernels (measured: 1.54× the bare step's time with 4 threads)."""
        idx = np.asarray(idx, dtype=np.int64)
        n, s, ch = len(idx), self.size, self.channels
        labels = idx % self.num_classes
        sigma = np.empty(n)
        noise = np.empty((n, s, s, ch), np.float32)
        for j, i in enumerate(idx.tolist()):  # the per-sample draws, in __getitem__'s order
            rng = np.random.default_rng(self.seed * 1_000_003 + i)
            sigma[j] = 0.15 + 0.02 * rng.standard_normal()
            noise[j] = rng.standard_normal((s, s, ch)).astype(np.float32)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        # per sample, Python floats meet float32 arrays: each scalar is
        # computed in float64, rounded to float32, and the operation is float32
        f32 = lambda v: np.asarray(v).astype(np.float32)
        cy = f32(0.2 + 0.6 * ((labels % 4) / 3.0))[:, None, None]
        cx = f32(0.2 + 0.6 * ((labels // 4) / 3.0))[:, None, None]
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / f32(2 * sigma ** 2)[:, None, None]))
        scale = f32(0.5 + 0.5 * ((labels[:, None] + np.arange(ch)) % 3) / 2.0)
        img = blob[..., None] * scale[:, None, None, :]
        img += 0.05 * noise
        img01 = np.clip(img, 0.0, 1.0).astype(np.float32)
        onehot = np.zeros((n, self.num_classes), dtype=np.float32)
        onehot[np.arange(n), labels] = 1.0
        return {"image": img01 * 2.0 - 1.0, self.cond_key: onehot, "id": idx,
                "img4unsup": (img01 * 255).astype(np.uint8)}


class SyntheticSegImages(SyntheticImages):
    """Blobs with aligned segmentation layouts.

    Adds every layout-conditioning key of the complex datasets: ``segmask``
    / ``stegomask`` one-hots [H, W, K], ``attr`` / ``stego_attr`` n-hots,
    ``cluster`` one-hot and ``lostbboxmask`` [H, W, 1], all from the blob's
    geometry (mask id = label + 1 where the blob exceeds 0.6 of its peak,
    box = the mask's bounding box), and the ids themselves as ``raw_mask``.
    ``onehot_on_device`` ships uint8 id masks in place of the f32 one-hots
    (`conditioning.condition.layout_to_device` expands them on the device).
    """

    def __init__(self, *, stego_k: int | None = None, cluster_k: int | None = None,
                 onehot_on_device: bool = False, **kw):
        super().__init__(**kw)
        self.stego_k = stego_k or self.num_classes + 1
        self.cluster_k = cluster_k or self.num_classes
        self.onehot_on_device = onehot_on_device

    def __getitem__(self, i: int) -> dict:
        out = super().__getitem__(i)
        label = i % self.num_classes
        s = self.size
        blob = (np.asarray(out["image"][..., 0]) + 1) / 2
        mask = np.zeros((s, s), np.int64)
        # relative threshold: the blob's amplitude in channel 0 varies by class
        mask[blob > 0.6 * blob.max()] = 1 + label % (self.stego_k - 1)
        ys, xs = np.nonzero(mask)
        if len(ys):
            bbox = np.asarray([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        else:  # degenerate sample: full-image box
            bbox = np.asarray([0, 0, s, s])
        nhot = np.zeros((self.stego_k,), np.float32)
        nhot[np.unique(mask)] = 1.0
        cl = np.zeros((self.cluster_k,), np.float32)
        cl[label % self.cluster_k] = 1.0
        lost = np.zeros((s, s, 1), np.uint8 if self.onehot_on_device else np.float32)
        lost[bbox[1]:bbox[3], bbox[0]:bbox[2], 0] = 1
        if self.onehot_on_device:
            seg = mask.astype(np.uint8)
        else:
            seg = np.eye(self.stego_k, dtype=np.float32)[mask]
        out.update(segmask=seg, stegomask=seg, raw_mask=mask, attr=nhot, stego_attr=nhot,
                   cluster=cl, lostbboxmask=lost)
        return out

    def get_batch(self, idx) -> dict[str, np.ndarray]:
        """Samples ``idx`` collated (per sample: the layouts are not vectorised)."""
        return collate([self[int(i)] for i in idx])


def collate(items: Sequence[dict]) -> dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
