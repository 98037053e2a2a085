"""Downsampled ImageNet (32/64 px) from Chrabaszcz pickles or the h5 pack.

The port's copy of `sgdm_tpu/data/imagenet_pickle.py ImageNetPickle`, with
the same files on disk giving the same batches:

  * train = `train_data_batch_1..10` pickles, val = `val_data`, labels
    shifted to 0-based; at 64 px the single `in64pickle.h5` pack
    (`data_{split}` rows, `labels_{split}`) is read instead when present,
    through `utils/h5.py` as a read-only memory map (no h5py; a pack larger
    than memory is read row by row);
  * root layout `root/size{32,64}/...`;
  * the three mutually exclusive ablations: `data_ratio` subsample,
    `corruption` (a fraction of labels shuffled among themselves),
    `subgroup` (each class split round-robin into k pseudo-classes), all
    drawn from ``default_rng(666)``;
  * `debug` truncates to 1200 samples;
  * emits image NHWC float32 [-1, 1], `img4unsup` uint8 HWC (resized to
    `size4cluster` with `transforms.resize_bilinear`, PIL's bilinear), `id`,
    and the condition dict of the h5 lookup.

`get_batch` assembles a batch in one call of the native gather
(`native.gather_image_batch`), which raises if it cannot be built.
`pickle_to_h5` writes the pack through `utils/h5.py`.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..native import gather_image_batch
from ..utils import h5
from ..utils.logging import logger
from .h5cond import ConditionLookup
from .loader import _collate
from .transforms import resize_bilinear

__all__ = ["ImageNetPickle"]


def _unpickle(path: str | Path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


class ImageNetPickle:
    dataset_name = "inp"

    def __init__(
        self,
        root: str,
        train: bool = True,
        image_size: int = 32,
        h5_file: str | None = None,
        condition_method: str | None = None,
        condition: dict | None = None,
        num_classes: int = 1000,
        debug: bool = False,
        data_ratio: float = 1.0,
        corruption: float = 0.0,
        subgroup: int = 1,
        size4cluster: int | None = None,
        **_unused,
    ):
        self.train = train
        self.split_name = "train" if train else "val"
        self.size = image_size
        self.debug = debug
        self.label_num = num_classes
        # img4unsup at the feature extractor's resolution
        self.size4cluster = size4cluster

        root = self._sized_root(root)
        self.data, labels = self._read(root, train)
        self.label_list = np.asarray(labels)

        rng = np.random.default_rng(666)
        # the three ablation knobs are an elif chain in the reference:
        # mutually exclusive, and a combination is refused
        active = [k for k, v in (("data_ratio", data_ratio < 1),
                                 ("corruption", corruption > 0),
                                 ("subgroup", subgroup > 1)) if v]
        assert len(active) <= 1, (
            f"ablation knobs are mutually exclusive (reference elif chain), "
            f"got {active}")
        if data_ratio < 1:
            idx = rng.permutation(len(self.data))[: int(len(self.data) * data_ratio)]
            self.data = self.data[np.sort(idx)]
            self.label_list = self.label_list[np.sort(idx)]
            logger.warning(f"data_ratio={data_ratio}: {len(self.data)} samples")
        elif corruption > 0:
            # shuffle the first `corruption` fraction of labels among themselves
            assert condition_method == "cluster"
            n = int(len(self.label_list) * corruption)
            shuffled = rng.permutation(n)
            self.label_list = np.array(self.label_list)
            self.label_list[:n] = self.label_list[shuffled]
            logger.warning(f"corrupted {corruption} of labels")
        elif subgroup > 1:
            # round-robin split of each class into `subgroup` pseudo-classes
            assert condition_method == "label"
            counter = {k: 0 for k in range(num_classes)}

            def sub(label: int) -> int:
                f = counter[label]
                counter[label] = (1 + f) % subgroup
                return label + num_classes * f

            self.label_list = np.array([sub(int(l)) for l in self.label_list])
            self.label_num = num_classes * subgroup
            logger.warning(f"subgroup={subgroup}: label_num={self.label_num}")

        self.cond = ConditionLookup(
            condition_method,
            h5_file,
            self.split_name,
            self.dataset_name,
            label_list=self.label_list,
            num_classes=self.label_num,
            condition_cfg=condition,
            id2name=self.id2name,
        )

    # ------------------------------------------------------------------
    def _sized_root(self, root: str) -> Path:
        root = Path(root).expanduser().resolve()
        if self.size not in (32, 64):
            raise ValueError(self.size)
        return root / f"size{self.size}"

    def _read(self, root: Path, train: bool):
        h5_pack = root / "in64pickle.h5"
        if self.size == 64 and h5_pack.exists():
            f = h5.File(h5_pack, "r")
            return f[f"data_{self.split_name}"].mapped, f[f"labels_{self.split_name}"][...]
        if train:
            datas, labels = [], []
            for i in range(1, 11):
                d = _unpickle(root / f"train_data_batch_{i}")
                datas.append(d["data"])
                labels.extend(d["labels"])
                if self.debug and self.size == 64:
                    break  # save memory
            data = np.concatenate(datas, 0)
        else:
            d = _unpickle(root / "val_data")
            data, labels = d["data"], d["labels"]
        labels = np.array([i - 1 for i in labels])  # 0-based
        return data, labels

    @staticmethod
    def pickle_to_h5(root: str, size: int = 64) -> Path:
        """Convert the pickles into the single h5 pack (`utils/h5.py`)."""
        self = ImageNetPickle.__new__(ImageNetPickle)
        self.size = size
        self.debug = False
        self.split_name = "train"
        sized = Path(root).expanduser().resolve() / f"size{size}"
        dest = sized / "in64pickle.h5"
        train_data, train_labels = self._read(sized, True)
        self.split_name = "val"
        val_data, val_labels = self._read(sized, False)
        with h5.File(dest, "w") as f:
            f.create_dataset("data_train", data=train_data)
            f.create_dataset("labels_train", data=train_labels)
            f.create_dataset("data_val", data=val_data)
            f.create_dataset("labels_val", data=val_labels)
        return dest

    # ------------------------------------------------------------------
    def id2name(self, index: int) -> str:
        return f"{index}.jpg"

    def __len__(self) -> int:
        if self.debug:
            return min(1200, len(self.data))
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        img = np.asarray(self.data[index]).reshape(3, self.size, self.size)
        img = img.transpose(1, 2, 0)  # HWC uint8
        img4unsup = img
        if self.size4cluster and self.size4cluster != self.size:
            img4unsup = resize_bilinear(img, self.size4cluster, self.size4cluster)
        out = {
            "image": img.astype(np.float32) / 255.0 * 2.0 - 1.0,
            "img4unsup": img4unsup,
            "id": np.int64(index),
        }
        out.update(self.cond.get(index))
        return out

    def get_batch(self, indices: np.ndarray) -> dict:
        """The batch ``indices``, equal bit for bit to collating
        `__getitem__`: one native call (OpenMP over samples, the interpreter
        lock released) gathers the rows, to HWC, to f32 and the uint8 copy;
        the conditions are looked up per sample.  With a `size4cluster`
        resize it takes the per-sample path."""
        if self.size4cluster and self.size4cluster != self.size:
            return _collate([self[int(i)] for i in indices])
        idx = np.asarray(indices, dtype=np.int64)
        images, img_u8 = gather_image_batch(self.data, idx, self.size, layout="chw")
        out = {"image": images, "img4unsup": img_u8, "id": idx.astype(np.int64)}
        conds = [self.cond.get(int(i)) for i in idx]
        if conds and conds[0]:
            for key in conds[0]:
                out[key] = np.stack([np.asarray(c[key]) for c in conds], 0)
        return out
