"""Shared base of the segmentation ("complex") datasets, VOC and COCO-Stuff.

The port's copy of `sgdm_tpu/data/complex_base.py ComplexSegDataset`,
reading without PIL.  Per sample:

  * the image (`utils/image.py read_image`: the JPEG decoder in host C++)
    and its id mask (`utils/png.py read_png`, the stored samples) at their
    original size;
  * `img4unsup`, the image bilinear to `size4cluster` (the offline feature
    extractor's input);
  * with ``how=stego``, the STEGO mask PNG ``stego_dir/<stem>.png``; with
    ``how=lost``, the LOST box as a binary mask at the original size;
  * the joint `RandomScaleCrop` of all four: the image's scale, crop, final
    bicubic resize and `img4unsup` in one native call (`scale_crop_resize`),
    each id mask's NEAREST chain and encoding in one more (`encode_mask`),
    the box mask's chain as one numpy gather;
  * `segmask` one-hot [H, W, C] and `attr` n-hot, `stegomask` one-hot and
    `stego_attr` n-hot, `lostbboxmask` [H, W, 1] (uint8 id masks in place
    of the one-hots under ``onehot_on_device``), `image` f32 in [-1, 1] as
    ``(x / 255) * 2 - 1``, `id`, and the h5 conditions (`ConditionLookup`).

The dict's keys, their order, dtypes and values are the JAX package's, bit
for bit; the crop draws from one `random.Random(seed)` in the order the
samples are read (on the loader's threads, the order they run).
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ..utils.image import read_image
from ..utils.png import read_png
from .h5cond import ConditionLookup, LostLookup
from .transforms import (RandomScaleCrop, bbox_to_mask, encode_mask, fine_to_coarse_lut,
                         scale_crop_resize)

__all__ = ["ComplexSegDataset"]

_LAYOUT_METHODS = ("clusterlayout", "stegoclusterlayout", "layout")


class ComplexSegDataset:
    """Subclasses set ``dataset_name``, ``label_num`` and the lists
    ``self.images`` / ``self.masks`` (paths), and call `_init_cond`."""

    dataset_name = "complex"
    label_num = 21
    fine_to_coarse: Mapping[int, int] | None = None

    def __init__(
        self,
        image_size: int = 64,
        size4cluster: int = 300,
        base_size: int = 224,
        h5_file: str | None = None,
        lost_file: str | None = None,
        stego_dir: str | None = None,
        stego_k: int = -1,
        condition_method: str | None = None,
        condition: Mapping[str, Any] | None = None,
        debug: bool = False,
        seed: int = 23,
        onehot_on_device: bool = False,
        **_unused: Any,
    ):
        self.image_size = image_size
        self.size4cluster = size4cluster
        self.condition_method = condition_method
        self.condition = condition or {}
        self.debug = debug
        self.onehot_on_device = onehot_on_device
        self.transform = RandomScaleCrop(base_size=base_size, resize_size=image_size,
                                         rng=random.Random(seed))
        self.images: list[Path] = []
        self.masks: list[Path] = []

        # stego routing: on when the method's `how` is stego
        how = None
        if condition_method in _LAYOUT_METHODS:
            how = (self.condition.get(condition_method) or {}).get("how")
        self.is_stego = bool(how == "stego" or condition_method == "stegoclusterlayout")
        if self.is_stego:
            if not stego_dir:
                raise ValueError(f"{condition_method} how=stego requires stego_dir")
            self.stego_mask_dir = Path(stego_dir).expanduser().resolve()
            self.stego_cluster_num = stego_k
        else:
            self.stego_mask_dir = None
            self.stego_cluster_num = -1

        # LOST boxes for how=lost runs
        self.lost = None
        if lost_file and condition_method in ("clusterlayout", "layout") and how == "lost":
            self.lost = LostLookup(lost_file)

        self.cond: ConditionLookup | None = None
        self._h5_file = h5_file

    def _init_cond(self, split_name: str) -> None:
        self.split_name = split_name
        # the subclass has set its fine → coarse mapping by now: as the
        # native mask encoding's table
        self._fine_to_coarse_lut = (None if self.fine_to_coarse is None
                                    else fine_to_coarse_lut(self.fine_to_coarse))
        self.cond = ConditionLookup(self.condition_method, self._h5_file, split_name,
                                    self.dataset_name, condition_cfg=self.condition,
                                    id2name=self.get_imagename_by_index)

    def __len__(self) -> int:
        return len(self.images)

    def get_imagename_by_index(self, index: int) -> str:
        return self.images[index].name

    def _read_img_segmask(self, index: int) -> tuple[np.ndarray, np.ndarray | None]:
        """uint8 RGB [H, W, 3] and the stored id mask [H, W]."""
        return read_image(self.images[index]), read_png(self.masks[index], samples=True)

    def __getitem__(self, index: int) -> dict:
        result: dict[str, Any] = {}
        image, segmask = self._read_img_segmask(index)
        h0, w0 = image.shape[:2]

        stegomask = None
        if self.is_stego:
            stem = Path(self.get_imagename_by_index(index)).stem
            stegomask = read_png(self.stego_mask_dir / f"{stem}.png", samples=True)

        lostbboxmask = None
        if self.lost is not None:
            bbox = self.lost.get_bbox(self.get_imagename_by_index(index))
            lostbboxmask = bbox_to_mask((h0, w0), bbox)

        t = self.transform
        ow, oh, x1, y1 = t.draw(w0, h0)
        img, img4unsup = scale_crop_resize(image, oh, ow, y1, x1, t.crop_size, t.resize_size,
                                           unsup=self.size4cluster)
        # each id mask gathered and encoded in one native call: 255 → 0,
        # fine → coarse, the one-hot (or ids under onehot_on_device) and the
        # n-hot; an id past the classes raises IndexError, as in JAX
        onehot = not self.onehot_on_device
        if lostbboxmask is not None:
            result["lostbboxmask"] = t.mask(lostbboxmask, ow, oh, x1, y1)[..., None].astype(
                np.uint8 if self.onehot_on_device else np.float32)
        if stegomask is not None:
            encoded, nhot = encode_mask(stegomask, *t.mask_indices(stegomask.shape, ow, oh, x1, y1),
                                        self.stego_cluster_num, onehot=onehot)
            result["stego_attr"] = nhot
            result["stegomask"] = encoded

        result["image"] = (img.astype(np.float32) / 255.0) * 2.0 - 1.0
        if segmask is not None:
            result["segmask"], result["attr"] = encode_mask(
                segmask, *t.mask_indices(segmask.shape, ow, oh, x1, y1), self.label_num,
                self._fine_to_coarse_lut, onehot=onehot)
        result["img4unsup"] = img4unsup
        result["id"] = np.int64(index)

        if self.cond is not None:
            result.update(self.cond.get(index))
        return result
