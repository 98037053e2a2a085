"""kNN evaluation: embed generated and real images, find nearest neighbours.

Port of `sgdm_tpu/eval/knn_eval.py`: the sample dir and the reference dir
are read with `utils/image.read_image` (PNG or JPEG), embedded with the
SimCLR ResNet-50 (`selfsup.ssl_backbone.get_ssl_backbone("simclr_rn50")`;
any backbone can be handed in), searched exactly with `ops/knn.py
knn_search` on the device, and the mean nearest-neighbour distance is
reported; ``knn_grid.png`` shows queries beside their neighbours.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.knn import knn_search
from ..utils.image import read_image
from ..utils.logging import logger, make_grid
from ..utils.png import write_png

__all__ = ["embed_image_dir", "get_knn_eval_dict", "image_files"]

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def image_files(folder: str | Path, max_items: int | None = None) -> list[Path]:
    """The folder's PNG / JPEG files, sorted by name, the first ``max_items``."""
    files = sorted(p for p in Path(folder).iterdir() if p.suffix.lower() in IMAGE_SUFFIXES)
    return files[:max_items] if max_items else files


def _load_dir(folder: str | Path, max_items: int | None = None) -> np.ndarray:
    return np.stack([read_image(f, "RGB") for f in image_files(folder, max_items)])


def embed_image_dir(folder: str | Path, backbone=None, batch_size: int = 128,
                    max_items: int | None = None, device: str | torch.device = "cuda"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(features [N, D] float32, images [N, H, W, 3] uint8) of a folder."""
    if backbone is None:
        from ..selfsup.ssl_backbone import get_ssl_backbone

        backbone = get_ssl_backbone("simclr_rn50", device=device)
    imgs = _load_dir(folder, max_items)
    feats = [backbone.batch_encode_feat(backbone.transform_batch(imgs[i:i + batch_size]))
             for i in range(0, len(imgs), batch_size)]
    return np.concatenate(feats), imgs


def get_knn_eval_dict(sample_dir: str | Path, gt_dir: str | Path, knn_k: int = 5,
                      q_num: int = 10, batch_size: int = 128, backbone=None,
                      papervis_dir: str | Path | None = None, max_items: int | None = 2000,
                      device: str | torch.device = "cuda") -> dict[str, float]:
    """``knn_mean_nn_dist`` (the mean distance of each sample to its nearest
    real image) and ``knn_mean_k_dist`` (over the ``knn_k`` nearest); with
    ``papervis_dir``, ``knn_grid.png``: ``q_num`` rows of a sample and its
    neighbours."""
    if backbone is None:
        from ..selfsup.ssl_backbone import get_ssl_backbone

        backbone = get_ssl_backbone("simclr_rn50", device=device)
    q_feats, q_imgs = embed_image_dir(sample_dir, backbone, batch_size, max_items)
    g_feats, g_imgs = embed_image_dir(gt_dir, backbone, batch_size, max_items)

    d2, idx = knn_search(g_feats, q_feats, k=knn_k, device=device)
    out = {"knn_mean_nn_dist": float(np.sqrt(d2[:, 0]).mean()),
           "knn_mean_k_dist": float(np.sqrt(d2).mean())}
    logger.info(f"knn eval: {out}")

    if papervis_dir is not None:
        papervis_dir = Path(papervis_dir)
        papervis_dir.mkdir(parents=True, exist_ok=True)
        rows = []
        for qi in range(min(q_num, len(q_imgs))):
            rows.extend([q_imgs[qi]] + [g_imgs[j] for j in idx[qi]])
        write_png(papervis_dir / "knn_grid.png", make_grid(np.stack(rows), ncol=knn_k + 1))
    return out
