"""Cluster figures and statistics at the start of training.

Port of `sgdm_tpu/conditioning/clustering_vis.py` (numpy; the metrics are
`selfsup/cluster.py cal_cluster_metric`, without sklearn):

  * `prepare_cluster`: ``cluster`` swapped for ``cluster_random`` when
    ``condition.cluster.random`` (the random-guidance ablation);
  * `kmeans_vis`: up to ``per_cluster`` example images per cluster id;
  * `vis_cluster_statistics`: NMI / AMI / ARI of the first batches' cluster
    ids against their labels, logged to the tracker.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np

from ..selfsup.cluster import cal_cluster_metric
from ..utils.logging import logger

__all__ = ["prepare_cluster", "kmeans_vis", "vis_cluster_statistics"]


def prepare_cluster(
    batch: dict[str, Any], condition_cfg: Mapping[str, Any] | None
) -> dict[str, Any]:
    """Parity: dynamic_input/clustering.py:137-147."""
    cluster_cfg = (condition_cfg or {}).get("cluster") or {}
    if cluster_cfg.get("random") and "cluster_random" in batch:
        batch = dict(batch)
        batch["cluster"] = batch["cluster_random"]
    return batch


def kmeans_vis(
    loader: Iterable[dict], cluster_ids: np.ndarray, per_cluster: int = 16,
    max_batches: int = 50,
) -> dict[int, list[np.ndarray]]:
    """Collect up to `per_cluster` images for each requested cluster id."""
    wanted = {int(c): [] for c in cluster_ids}
    for bi, batch in enumerate(loader):
        if bi >= max_batches or all(len(v) >= per_cluster for v in wanted.values()):
            break
        cids = batch.get("cluster_id")
        if cids is None:
            cids = np.argmax(batch["cluster"], axis=-1)
        imgs = np.clip((np.asarray(batch["image"]) + 1) * 127.5, 0, 255).astype(np.uint8)
        for img, cid in zip(imgs, np.asarray(cids)):
            c = int(cid)
            if c in wanted and len(wanted[c]) < per_cluster:
                wanted[c].append(img)
    return wanted


def vis_cluster_statistics(
    loader: Iterable[dict], tracker=None, step: int | None = None,
    max_batches: int = 50,
) -> dict[str, float]:
    """NMI/AMI/ARI of cluster ids vs labels over the first batches."""
    preds, gts = [], []
    for bi, batch in enumerate(loader):
        if bi >= max_batches:
            break
        if "cluster_id" not in batch or ("label_id" not in batch and "label" not in batch):
            return {}
        preds.append(np.asarray(batch["cluster_id"]))
        lab = batch.get("label_id")
        if lab is None:
            lab = np.argmax(batch["label"], axis=-1)
        gts.append(np.asarray(lab))
    if not preds:
        return {}
    metrics = cal_cluster_metric(np.concatenate(gts), np.concatenate(preds))
    logger.warning(f"cluster-vs-label statistics: {metrics}")
    if tracker is not None:
        tracker.log({f"cluster_stats/{k}": v for k, v in metrics.items()},
                    step=step)
    return metrics
