"""PASCAL VOC 2012 (augmented) segmentation at diffusion scale.

The port's copy of `sgdm_tpu/data/voc12.py VOCSegmentation`: JPEGImages +
SegmentationClassAug pairs listed by ``ImageSets/SegmentationAug/<split>.txt``
(else ``ImageSets/Segmentation/<split>.txt``), a line either a name or two
root-relative paths, 21 classes, on `ComplexSegDataset`.
"""

from __future__ import annotations

from pathlib import Path

from .complex_base import ComplexSegDataset

__all__ = ["VOCSegmentation", "VOC_CLASSES"]

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class VOCSegmentation(ComplexSegDataset):
    dataset_name = "voc64"
    label_num = 21

    def __init__(self, root: str, split: str = "train_aug", debug: bool = False, **kwargs):
        super().__init__(debug=debug, **kwargs)
        self.root = Path(root).expanduser()
        self.split = split
        list_file = self.root / "ImageSets" / "SegmentationAug" / f"{split}.txt"
        if not list_file.exists():
            list_file = self.root / "ImageSets" / "Segmentation" / f"{split}.txt"
        if not list_file.exists():
            raise FileNotFoundError(f"VOC split list not found under {self.root}/ImageSets "
                                    f"(looked for {split}.txt)")
        lines = [ln.strip() for ln in list_file.read_text().splitlines() if ln.strip()]
        for line in lines:
            if " " in line:  # aug lists carry explicit relative paths
                img_rel, mask_rel = line.split()
                self.images.append(self.root / img_rel.lstrip("/"))
                self.masks.append(self.root / mask_rel.lstrip("/"))
            else:
                self.images.append(self.root / "JPEGImages" / f"{line}.jpg")
                self.masks.append(self.root / "SegmentationClassAug" / f"{line}.png")
        if debug:
            self.images = self.images[:200]
            self.masks = self.masks[:200]
        self._init_cond("train" if split.startswith("train") else "val")
