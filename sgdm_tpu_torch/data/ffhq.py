"""FFHQ (flat image-folder) dataset.

The port's copy of `sgdm_tpu/data/ffhq.py`: a flat folder of images, no
labels (`skip_id2name('ffhq')`, so h5 conditions are indexed by position),
the last `val_fraction` of the sorted files held out for validation, each
image resized to `image_size` and to `size4cluster` with PIL's bilinear
filter (`transforms.resize_bilinear`); batch dict {image [-1, 1],
img4unsup, id} and the conditions.  PNGs and JPEGs are read by their
content (`utils/image.py read_image`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.image import read_image
from .h5cond import ConditionLookup
from .transforms import resize_bilinear

__all__ = ["FFHQ"]


class FFHQ:
    dataset_name = "ffhq64"

    def __init__(
        self,
        root: str,
        train: bool = True,
        image_size: int = 64,
        size4cluster: int = 224,
        h5_file: str | None = None,
        condition_method: str | None = None,
        condition: dict | None = None,
        val_fraction: float = 0.01,
        debug: bool = False,
        **_unused,
    ):
        root = Path(root).expanduser()
        files = sorted(
            p for p in root.rglob("*")
            if p.suffix.lower() in (".png", ".jpg", ".jpeg")
        )
        if not files:
            raise FileNotFoundError(f"no images under {root}")
        n_val = max(int(len(files) * val_fraction), 1)
        self.files = files[:-n_val] if train else files[-n_val:]
        if debug:
            self.files = self.files[:1200]
        self.image_size = image_size
        self.size4cluster = size4cluster
        self.split_name = "train" if train else "val"
        self.cond = ConditionLookup(
            condition_method, h5_file, self.split_name, self.dataset_name,
            condition_cfg=condition,
        )

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        img = read_image(self.files[i])   # RGB, as Image.open(...).convert("RGB")
        small = resize_bilinear(img, self.image_size, self.image_size)
        unsup = resize_bilinear(img, self.size4cluster, self.size4cluster)
        out = {
            "image": small.astype(np.float32) / 127.5 - 1.0,
            "img4unsup": unsup.astype(np.uint8),
            "id": np.int64(i),
        }
        out.update(self.cond.get(i))
        return out
