"""CIFAR-10/100 datasets from the standard python pickle batches.

The port's copy of `sgdm_tpu/data/cifar10.py`: the `cifar-10-batches-py` /
`cifar-100-python` pickles read directly, the batch dict of the JAX
package's (image NHWC [-1, 1], the label one-hot through `ConditionLookup`,
id, img4unsup uint8).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .h5cond import ConditionLookup

__all__ = ["CIFAR10", "CIFAR100"]


class CIFAR10:
    dataset_name = "cifar10"
    num_classes = 10
    _folder = "cifar-10-batches-py"
    _train_files = [f"data_batch_{i}" for i in range(1, 6)]
    _test_files = ["test_batch"]
    _label_key = b"labels"

    def __init__(
        self,
        root: str,
        train: bool = True,
        h5_file: str | None = None,
        condition_method: str | None = None,
        condition: dict | None = None,
        debug: bool = False,
        **_unused,
    ):
        base = Path(root).expanduser() / self._folder
        files = self._train_files if train else self._test_files
        datas, labels = [], []
        for fn in files:
            path = base / fn
            if not path.exists():
                raise FileNotFoundError(
                    f"{path} not found — place the standard CIFAR python "
                    f"batches under {base} (no downloads in this image)"
                )
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(d[b"data"])
            labels.extend(d[self._label_key])
        self.data = (
            np.concatenate(datas).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        )  # NHWC uint8
        self.labels = np.asarray(labels, dtype=np.int64)
        if debug:
            self.data = self.data[:1200]
            self.labels = self.labels[:1200]
        self.train = train
        self.split_name = "train" if train else "val"
        self.cond = ConditionLookup(
            condition_method,
            h5_file,
            self.split_name,
            self.dataset_name,
            label_list=self.labels,
            num_classes=self.num_classes,
            condition_cfg=condition,
            id2name=self.id2name,
        )

    def id2name(self, index: int) -> str:
        return f"{self.split_name}_{index}"

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> dict:
        img = self.data[i]
        out = {
            "image": img.astype(np.float32) / 127.5 - 1.0,
            "img4unsup": img,
            "id": np.int64(i),
        }
        out.update(self.cond.get(i))
        return out


class CIFAR100(CIFAR10):
    dataset_name = "cifar100"
    num_classes = 100
    _folder = "cifar-100-python"
    _train_files = ["train"]
    _test_files = ["test"]
    _label_key = b"fine_labels"
