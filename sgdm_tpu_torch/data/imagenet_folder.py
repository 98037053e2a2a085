"""ImageNet class folders (iDDPM style) for the from-224 downsampled runs.

The port's copy of `sgdm_tpu/data/imagenet_folder.py ImageNetFolder`:
``<root>/{train,val}/<class>/*.JPEG`` and ``*.jpg``, labels from the sorted
class-folder index; each image read by content (`utils/image.py
read_image`: CMYK files and PNGs named ``.JPEG`` included), its centre
square BICUBIC to `image_size` and BILINEAR to `size4cluster`
(`data/transforms.py`, PIL's filters bit for bit), ``image`` as
``x / 127.5 - 1`` in f32; the h5 conditions through `ConditionLookup`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.image import read_image
from .h5cond import ConditionLookup
from .transforms import resize_bicubic, resize_bilinear

__all__ = ["ImageNetFolder"]


class ImageNetFolder:
    dataset_name = "inp"

    def __init__(
        self,
        root: str,
        train: bool = True,
        image_size: int = 64,
        size4cluster: int = 224,
        h5_file: str | None = None,
        condition_method: str | None = None,
        condition: dict | None = None,
        num_classes: int = 1000,
        debug: bool = False,
        **_unused,
    ):
        split_dir = Path(root).expanduser() / ("train" if train else "val")
        if not split_dir.exists():
            raise FileNotFoundError(split_dir)
        class_dirs = sorted(p for p in split_dir.iterdir() if p.is_dir())
        self.files: list[Path] = []
        labels: list[int] = []
        for ci, cdir in enumerate(class_dirs):
            for f in sorted(cdir.glob("*.JPEG")) + sorted(cdir.glob("*.jpg")):
                self.files.append(f)
                labels.append(ci)
        self.label_list = np.asarray(labels, dtype=np.int64)
        if debug:
            self.files = self.files[:1200]
            self.label_list = self.label_list[:1200]
        self.image_size = image_size
        self.size4cluster = size4cluster
        self.split_name = "train" if train else "val"
        self.cond = ConditionLookup(
            condition_method, h5_file, self.split_name, self.dataset_name,
            label_list=self.label_list, num_classes=num_classes,
            condition_cfg=condition, id2name=self.id2name,
        )

    def id2name(self, index: int) -> str:
        return self.files[index].name

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        img = read_image(self.files[i])
        h, w = img.shape[:2]
        s = min(w, h)
        sq = img[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]   # PIL's crop box
        small = resize_bicubic(sq, self.image_size, self.image_size)
        unsup = resize_bilinear(sq, self.size4cluster, self.size4cluster)
        out = {
            "image": small.astype(np.float32) / 127.5 - 1.0,
            "img4unsup": unsup.astype(np.uint8),
            "id": np.int64(i),
        }
        out.update(self.cond.get(i))
        return out
