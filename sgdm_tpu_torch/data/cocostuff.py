"""COCO-Stuff, 27 classes, at diffusion scale.

The port's copy of `sgdm_tpu/data/cocostuff.py CocoStuffDataset`: the
STEGO layout (``images/{split}2017/*.jpg`` and ``annotations/{split}2017/
<stem>.png`` fine id maps), 182 fine → 27 coarse classes through the
``fine_to_coarse_dict.pickle`` of the STEGO preparation (read with the
standard library's `pickle`), on `ComplexSegDataset`.
"""

from __future__ import annotations

import pickle
from pathlib import Path

from .complex_base import ComplexSegDataset

__all__ = ["CocoStuffDataset"]


class CocoStuffDataset(ComplexSegDataset):
    dataset_name = "cocostuff64"
    label_num = 27

    def __init__(self, root: str, split: str = "train", debug: bool = False, **kwargs):
        super().__init__(debug=debug, **kwargs)
        self.root = Path(root).expanduser()
        img_dir = self.root / "images" / f"{split}2017"
        ann_dir = self.root / "annotations" / f"{split}2017"
        if not img_dir.exists():
            raise FileNotFoundError(f"COCO-Stuff images not found at {img_dir}")
        self.images = sorted(img_dir.glob("*.jpg"))
        self.masks = [ann_dir / f"{p.stem}.png" for p in self.images]
        if debug:
            self.images = self.images[:200]
            self.masks = self.masks[:200]

        f2c_path = self.root / "fine_to_coarse_dict.pickle"
        if not f2c_path.exists():
            raise FileNotFoundError(
                f"{f2c_path} missing — the 182→27 mapping pickle ships with the STEGO "
                f"cocostuff preparation (reference coco17stuff27.py:76-80)")
        with open(f2c_path, "rb") as f:
            d = pickle.load(f)
        # STEGO's dict maps fine id -> coarse id (possibly nested)
        self.fine_to_coarse = d.get("fine_index_to_coarse_index", d)
        self._init_cond("train" if split.startswith("train") else "val")
