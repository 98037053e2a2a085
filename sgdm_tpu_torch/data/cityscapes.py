"""Cityscapes, 27 classes, at diffusion scale.

The port's copy of `sgdm_tpu/data/cityscapes.py CityscapesDataset`:
``leftImg8bit/{split}/<city>/*_leftImg8bit.png`` images paired with
``gtFine/{split}/<city>/*_gtFine_labelIds.png`` label maps, the 34 raw ids
collapsed to 27 classes (`_RAW_TO_27`: ids 7..33 → 0..26, the void ids
0..6 → 0), on `ComplexSegDataset`, whose reader decodes both PNGs without PIL
(`utils/png.py`: the image as RGB, the label map as its stored samples).
"""

from __future__ import annotations

from pathlib import Path

from .complex_base import ComplexSegDataset

__all__ = ["CityscapesDataset"]

_RAW_TO_27 = {i: 0 for i in range(34)}
_RAW_TO_27.update({i: i - 7 for i in range(7, 34)})


class CityscapesDataset(ComplexSegDataset):
    dataset_name = "cs64"
    label_num = 27
    fine_to_coarse = _RAW_TO_27

    def __init__(self, root: str, split: str = "train", debug: bool = False, **kwargs):
        super().__init__(debug=debug, **kwargs)
        self.root = Path(root).expanduser()
        img_root = self.root / "leftImg8bit" / split
        ann_root = self.root / "gtFine" / split
        if not img_root.exists():
            raise FileNotFoundError(img_root)
        self.images = sorted(img_root.rglob("*_leftImg8bit.png"))
        self.masks = [ann_root / p.parent.name /
                      p.name.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                      for p in self.images]
        if debug:
            self.images = self.images[:200]
            self.masks = self.masks[:200]
        self._init_cond("train" if split == "train" else "val")
