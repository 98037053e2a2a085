"""LOST: self-supervised object box discovery (+ box-cluster ids).

The port's copy of `sgdm_tpu/selfsup/lost.py` (the LOST algorithm of
`side_repo/LOST/object_discovery.py`: an inverse-degree seed patch, the
seed expanded over the top-k similar patches, the box of the seed's
connected component; and the pipeline of `sg_main_lost.py`: DINO ViT key
features per image → lost() box → pooled in-box patch features → k-means
k=100 → ``lost_k100.h5`` with per-image ``{name}_bbox`` [4] int64 and
``{name}_clusterid``, root attr ``cluster_k``).

The key features come from the card: the last block's k projection
(``qkv_last``), [B, heads, 1 + N, d] → [B, N, heads·d] without the CLS
token, a batch of images at a time (`run_lost` reads the dataset in order,
one sample after another, so the datasets' random crops draw as in the
JAX package's loop).  The similarity math stays on the host in numpy
float32, as in JAX: the degree scores are integer counts ordered by a
stable argsort, so a similarity near 0 that lands on the other side of it
moves the seed.  The connected components are ``scipy.ndimage.label``.
The pooled features are clustered by the port's k-means on the card, and
the file is written through `utils.h5` (no h5py).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Iterable

import numpy as np
import scipy.ndimage
import torch

from ..device import resolve_device
from ..ops.kmeans import run_kmeans
from ..utils import h5
from ..utils.logging import logger
from .ssl_backbone import HostCopy

__all__ = ["patch_scoring", "detect_box", "lost", "extract_key_features", "run_lost",
           "write_lost_h5", "bbox_iou", "corloc", "main"]

BATCH = 64      # images whose key features `run_lost` asks of the card at a time


def patch_scoring(A: np.ndarray, threshold: float = 0.0):
    """Inverse-degree patch scores. Parity: object_discovery.py:60-78."""
    A = A.copy()
    np.fill_diagonal(A, 0.0)
    A[A < 0] = 0.0
    cent = -(A > threshold).sum(axis=1).astype(np.float32)
    sel = np.argsort(-cent, kind="stable")
    return sel, cent


def detect_box(M: np.ndarray, seed: int, dims, scales, initial_im_size=None):
    """Box of the seed's connected component. Parity: object_discovery.py:81-110."""
    w_featmap, h_featmap = dims
    correl = M.reshape(w_featmap, h_featmap)
    labeled, _ = scipy.ndimage.label(correl > 0.0)
    cc = labeled[np.unravel_index(seed, (w_featmap, h_featmap))]
    if cc == 0:
        raise ValueError("The seed is in the background component.")
    mask = np.where(labeled == cc)
    ymin, ymax = mask[0].min(), mask[0].max() + 1
    xmin, xmax = mask[1].min(), mask[1].max() + 1
    pred = [scales[1] * xmin, scales[0] * ymin, scales[1] * xmax, scales[0] * ymax]
    if initial_im_size:
        pred[2] = min(pred[2], initial_im_size[1])
        pred[3] = min(pred[3], initial_im_size[0])
    mask_map = labeled == cc
    return np.asarray(pred), mask_map


def lost(feats: np.ndarray, dims, scales, init_image_size, k_patches: int = 100):
    """LOST on per-patch features [N, D].

    Returns (pred_box [4], in_box_mask [w, h], scores, seed).
    Parity: object_discovery.py:23-57."""
    feats = np.asarray(feats, dtype=np.float32)
    A = feats @ feats.T
    sorted_patches, scores = patch_scoring(A)
    seed = int(sorted_patches[0])
    potentials = sorted_patches[:k_patches]
    similars = potentials[A[seed, potentials] > 0.0]
    M = A[similars, :].sum(axis=0)
    pred, mask_map = detect_box(M, seed, dims, scales=scales, initial_im_size=init_image_size)
    return np.asarray(pred), mask_map, scores, seed


# ----------------------------------------------------------------------

def _key_features_device(backbone, imgs_uint8) -> torch.Tensor:
    """[B, N, heads·d] float32 on the device: the last block's keys, CLS dropped."""
    x = backbone.transform_batch(imgs_uint8)
    _, (_, k, _) = backbone.encode(x, "qkv_last")
    b, h, n1, d = k.shape
    return k.float().permute(0, 2, 1, 3).reshape(b, n1, h * d)[:, 1:]


def extract_key_features(backbone, imgs_uint8: np.ndarray) -> np.ndarray:
    """Per-patch KEY features of the last attention layer, [B, N, D] float32
    (sg_main_lost.py's qkv hook, ``--which_features k``)."""
    return _key_features_device(backbone, imgs_uint8).cpu().numpy()


def _image_name(dataset, i: int) -> str:
    if hasattr(dataset, "get_imagename_by_index"):
        return dataset.get_imagename_by_index(i)
    return dataset.id2name(i) if hasattr(dataset, "id2name") else str(i)


def _batches(dataset):
    """(first index, img4unsup list): the samples read in order, up to
    ``BATCH`` consecutive ones of one size at a time."""
    batch, first = [], 0
    for i in range(len(dataset)):
        img = np.asarray(dataset[i]["img4unsup"])
        if batch and (len(batch) == BATCH or img.shape != batch[0].shape):
            yield first, batch
            batch, first = [], i
        batch.append(img)
    if batch:
        yield first, batch


def run_lost(backbone, dataset: Iterable, *, k_patches: int = 100, image_size: int = 224
             ) -> tuple[list[str], np.ndarray, np.ndarray]:
    """LOST over a dataset → (names, bboxes [N, 4] int64, pooled box feats
    [N, D]).  The key features of a batch are queued on the card with their
    copy to the host; while the card computes them the host runs LOST on
    the previous batch and reads the next."""
    patch = backbone.model.patch_size
    fm = image_size // patch
    names, boxes, pooled = [], [], []

    def finish(first, imgs, keys):
        feats_all = keys.numpy()
        for j, img in enumerate(imgs):
            h0, w0 = img.shape[:2]
            feats = feats_all[j]
            pred, mask_map, _, _ = lost(feats, dims=(fm, fm), scales=[patch, patch],
                                        init_image_size=(image_size, image_size),
                                        k_patches=k_patches)
            # pooled patch features inside the component (box-cluster signal)
            pooled.append(feats[mask_map.reshape(-1)].mean(axis=0))
            # the box from the image_size grid back to the image's size
            sy, sx = h0 / image_size, w0 / image_size
            box = np.array([pred[0] * sx, pred[1] * sy, pred[2] * sx, pred[3] * sy])
            boxes.append(np.round(box).astype(np.int64))
            names.append(_image_name(dataset, first + j))
            if len(names) % 200 == 0:
                logger.info(f"LOST: {len(names)}/{len(dataset)}")

    pending = None
    for first, imgs in _batches(dataset):
        keys = HostCopy(_key_features_device(backbone, np.stack(imgs)))
        if pending is not None:
            finish(*pending)
        pending = (first, imgs, keys)
    if pending is not None:
        finish(*pending)
    return names, np.stack(boxes), np.stack(pooled)


def write_lost_h5(out_path: str | Path, names: list[str], boxes: np.ndarray,
                  pooled_feats: np.ndarray, cluster_k: int = 100, niter: int = 30,
                  device: str | torch.device = "cuda") -> Path:
    """k-means the pooled box features and write the LOST h5 contract.

    Parity: sg_main_lost.py:414-444 (per-image ``{name}_bbox`` [4] int64 +
    ``{name}_clusterid`` int64, file attr ``cluster_k``)."""
    feats = pooled_feats.astype(np.float32).copy()
    labels, _ = run_kmeans(feats, pooled_feats.astype(np.float32),
                           cluster_k=min(cluster_k, len(names)), niter=niter, device=device)
    out_path = Path(out_path).expanduser()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with h5.File(out_path, "w") as f:
        f.attrs["cluster_k"] = cluster_k
        for name, box, lab in zip(names, boxes, labels):
            f.create_dataset(f"{name}_bbox", data=box.astype(np.int64))
            f.create_dataset(f"{name}_clusterid", data=np.int64(lab))
    logger.warning(f"saved LOST h5: {out_path}")
    return out_path


def bbox_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two (x0, y0, x1, y1) boxes. Parity: LOST datasets.bbox_iou."""
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, x1 - x0) * max(0, y1 - y0)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def corloc(pred_boxes: np.ndarray, gt_boxes_per_image: list, thr: float = 0.5) -> float:
    """Correct-localization rate: the fraction of images whose predicted box
    has IoU >= thr with ANY ground-truth box.  Parity: sg_main_lost.py:446-452."""
    hits = 0
    for pred, gts in zip(pred_boxes, gt_boxes_per_image):
        if any(bbox_iou(np.asarray(pred), np.asarray(g)) >= thr for g in gts):
            hits += 1
    return hits / max(len(gt_boxes_per_image), 1)


def main(argv: list[str] | None = None) -> Path:
    """CLI parity: `python LOST/sg_main_lost.py sample=voc12`, the JAX CLI's
    flags and ``--device``."""
    from .ssl_backbone import get_ssl_backbone

    p = argparse.ArgumentParser(description="LOST box discovery (PyTorch port)")
    p.add_argument("--ds", default="voc64", choices=["voc64", "cocostuff64", "synthetic"])
    p.add_argument("--root", default="~/data/voc12")
    p.add_argument("--split", default="train_aug")
    p.add_argument("--out", default="~/data/sg_data/lost/lost_k100.h5")
    p.add_argument("--feat", default="dino_vits16")
    p.add_argument("--cluster_k", type=int, default=100)
    p.add_argument("--k_patches", type=int, default=100)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    if a.ds == "voc64":
        from ..data.voc12 import VOCSegmentation

        ds = VOCSegmentation(root=a.root, split=a.split, image_size=64, debug=a.debug)
    elif a.ds == "cocostuff64":
        from ..data.cocostuff import CocoStuffDataset

        ds = CocoStuffDataset(root=a.root, split="train", image_size=64, debug=a.debug)
    else:
        from ..data.synthetic import SyntheticImages

        ds = SyntheticImages(size=224, length=32)
    backbone = get_ssl_backbone(a.feat, device=device)
    names, boxes, pooled = run_lost(backbone, ds, k_patches=a.k_patches)
    return write_lost_h5(a.out, names, boxes, pooled, cluster_k=a.cluster_k, device=device)


if __name__ == "__main__":
    main()
