"""COCO 2014 instances (vq-diffusion style) at diffusion scale.

The port's copy of `sgdm_tpu/data/coco14.py Coco14Dataset`: images from
``{split}2014/``, instances from ``annotations/instances_{split}2014.json``,
categories renumbered 1..80 in id order (0 is the background), images with
no usable annotation left out.  Each sample's class-id mask is the image's
polygon annotations filled as the JAX package fills them with PIL's
``ImageDraw.polygon``, here by `native.fill_polygons` (host C++, bit for
bit): larger areas first so small objects stay on top, crowd (RLE)
annotations skipped, and polygons of fewer than 6 numbers skipped.  The
image is read by `utils/image.py read_image` (JPEG or PNG by content).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..native import fill_polygons
from ..utils.image import read_image
from ..utils.logging import logger
from .complex_base import ComplexSegDataset

__all__ = ["Coco14Dataset", "instance_mask"]


def instance_mask(h: int, w: int, anns: list, cat_to_idx: dict) -> np.ndarray:
    """uint8 [h, w] class ids of an image's annotations (coco14.py:72-87)."""
    polys, values = [], []
    for ann in sorted(anns, key=lambda a: -a.get("area", 0)):
        seg = ann.get("segmentation")
        if not isinstance(seg, list):
            continue
        cid = cat_to_idx[ann["category_id"]]
        for poly in seg:
            if len(poly) >= 6:
                polys.append(poly)
                values.append(cid)
    return fill_polygons(np.zeros((h, w), np.uint8), polys, values)


class Coco14Dataset(ComplexSegDataset):
    dataset_name = "coco64"
    label_num = 81  # 80 things + background 0

    def __init__(self, root: str, split: str = "train", debug: bool = False, **kwargs):
        super().__init__(debug=debug, **kwargs)
        self.root = Path(root).expanduser()
        self.img_dir = self.root / f"{split}2014"
        inst = self.root / "annotations" / f"instances_{split}2014.json"
        if not inst.exists():
            raise FileNotFoundError(inst)
        data = json.loads(inst.read_text())
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.cat_to_idx = {c["id"]: i + 1 for i, c in enumerate(cats)}
        by_image: dict[int, list] = {}
        for ann in data["annotations"]:
            if ann.get("iscrowd"):
                continue
            by_image.setdefault(ann["image_id"], []).append(ann)
        self.images, self.anns = [], []
        for im in data["images"]:
            anns = by_image.get(im["id"])
            if not anns:
                continue
            self.images.append(self.img_dir / im["file_name"])
            self.anns.append(anns)
        if debug:
            self.images = self.images[:200]
            self.anns = self.anns[:200]
        logger.info(f"coco14 {split}: {len(self.images)} annotated images")
        self._init_cond("train" if split.startswith("train") else "val")

    def _read_img_segmask(self, index: int):
        img = read_image(self.images[index])
        return img, instance_mask(img.shape[0], img.shape[1], self.anns[index], self.cat_to_idx)
