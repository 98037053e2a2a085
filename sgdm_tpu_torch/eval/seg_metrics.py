"""Unsupervised segmentation metrics: Hungarian-matched mIoU + accuracy.

Port of `sgdm_tpu/eval/seg_metrics.py` (numpy and scipy, as there): build
the (clusters × classes) confusion matrix over all pixels, match cluster
ids to classes with the Hungarian algorithm (maximizing matched pixels),
report per-class IoU / mIoU / pixel accuracy, as STEGO's evaluation does.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize

__all__ = ["unsupervised_seg_metrics"]


def unsupervised_seg_metrics(
    preds: np.ndarray, gts: np.ndarray, n_clusters: int, n_classes: int,
    ignore_label: int = 255,
) -> dict:
    """preds/gts: int arrays of the same shape (any rank)."""
    preds = np.asarray(preds).ravel()
    gts = np.asarray(gts).ravel()
    keep = gts != ignore_label
    preds, gts = preds[keep], gts[keep]

    conf = np.zeros((n_clusters, n_classes), dtype=np.int64)
    np.add.at(conf, (preds, gts), 1)

    # Hungarian assignment maximizing matched pixels.  With more clusters
    # than classes only n_classes rows get matched; the leftover clusters
    # map to their confusion-row argmax (NOT to a zeros-default class 0,
    # which would skew pixel_acc and class-0 IoU arbitrarily).
    rows, cols = scipy.optimize.linear_sum_assignment(conf, maximize=True)
    mapping = conf.argmax(axis=1)
    mapping[rows] = cols
    remapped = mapping[preds]

    ious, accs = [], (remapped == gts).mean()
    for c in range(n_classes):
        tp = np.sum((remapped == c) & (gts == c))
        fp = np.sum((remapped == c) & (gts != c))
        fn = np.sum((remapped != c) & (gts == c))
        denom = tp + fp + fn
        if denom > 0:
            ious.append(tp / denom)
    return {
        "miou": float(np.mean(ious)) if ious else 0.0,
        "pixel_acc": float(accs),
        "cluster_to_class": {int(r): int(c) for r, c in zip(rows, cols)},
    }
