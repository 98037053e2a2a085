"""h5 condition lookups: per-sample self-supervised guidance signals.

The port's copy of `sgdm_tpu/data/h5cond.py`, reading the same h5 files
through `utils/h5.py` (no h5py):

  * cluster h5: `train`/`val` int cluster assignments, `centroids`
    [k, feat_dim], optional `train_feat` and `{split}_nns`, attrs
    `cluster_k` on `all_attributes`; sibling `.json` with `name2id`.
  * feat h5: `train`/`val` [N, feat_dim] float32.
  * LOST h5: per-image `{name}_bbox` [4] int64 (+ `{name}_clusterid`).

All outputs are numpy float32 (one-hots where the reference returns
`F.one_hot(...)`), keyed like the JAX package's batch dicts; the
init-time random tables are drawn from ``np.random.default_rng(seed)`` in
the same order, so they are equal, not just alike.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np

from ..utils import h5

__all__ = ["ds_has_label_info", "skip_id2name", "normalize_feat",
           "ConditionLookup", "LostLookup"]


def ds_has_label_info(dataset_name: str) -> bool:
    """Parity: dataset_common_utils.py:14-22."""
    return not dataset_name.startswith(("coco", "voc", "ffhq"))


def skip_id2name(dataset_name: str) -> bool:
    """Parity: dataset_common_utils.py:25-29."""
    return "ffhq" in dataset_name


def normalize_feat(feat: np.ndarray) -> np.ndarray:
    """L2-normalize a 1-D feature. Parity: dataset_common_utils.py:8-11."""
    assert feat.ndim == 1
    return feat / np.linalg.norm(feat, axis=0, keepdims=True)


def _one_hot(idx: int, k: int) -> np.ndarray:
    v = np.zeros((k,), dtype=np.float32)
    v[int(idx)] = 1.0
    return v


class ConditionLookup:
    """Attach per-sample conditions from h5 to a dataset.

    ``id2name``: index → image filename (for datasets whose h5 row order is
    keyed by name; pass None to use the index directly, like ffhq).
    """

    def __init__(
        self,
        condition_method: str | None,
        h5_file: str | None,
        split_name: str,
        dataset_name: str,
        *,
        h5_file2: str | None = None,
        label_list: np.ndarray | None = None,
        num_classes: int | None = None,
        condition_cfg: Mapping[str, Any] | None = None,
        id2name: Callable[[int], str] | None = None,
        seed: int = 0,
    ):
        self.method = condition_method
        self.split_name = split_name
        self.dataset_name = dataset_name
        self.condition_cfg = condition_cfg or {}
        self.id2name = id2name
        self.num_classes = num_classes
        self._rng = np.random.default_rng(seed)  # __init__-time tables only
        self._seed = seed
        self.name2id: dict[str, int] | None = None
        self._h5 = None
        self.cluster_k: int | None = None

        needs_h5 = condition_method in (
            "feat", "patchfeat", "cluster", "clusterrandom", "clustermix",
            "labelcluster", "clusterlayout", "labelcentroid", "centroid",
            "patchcluster", "knn_feat",
        )
        if needs_h5:
            assert h5_file, f"condition_method={condition_method} requires h5_file"
            self.h5_path = Path(h5_file).expanduser().resolve()
            self._h5 = h5.File(self.h5_path, "r")
            if not skip_id2name(dataset_name):
                json_path = str(self.h5_path).replace(".h5", ".json")
                self.name2id = json.load(open(json_path))["name2id"]

        # label noise + random labels (supervised_label.py:6-28)
        if label_list is not None:
            self.label_list = np.asarray(label_list)
            # 1-based-label detection (supervised_label.py:9-12 shifts on
            # min==1, guarded by an all-classes-present assert).  A subset
            # that merely LACKS class 0 must not be shifted: require the
            # span to actually look 1-based (all K classes present, or the
            # max hitting K — unreachable for a 0-based list).
            if self.label_list.min() == 1 and (
                len(np.unique(self.label_list)) == num_classes
                or self.label_list.max() == num_classes
            ):
                self.label_list = self.label_list - 1
            self.label_list_random = self._rng.integers(
                0, num_classes, size=self.label_list.shape
            )
            noise_ratio = (
                (self.condition_cfg.get("label") or {}).get("noise_ratio", 0)
            )
            if noise_ratio and noise_ratio > 0:
                is_noise = self._rng.uniform(size=self.label_list.shape) < noise_ratio
                self.label_list = np.where(
                    is_noise, self.label_list_random, self.label_list
                )
        else:
            self.label_list = None

        if self.method in ("cluster", "clusterrandom", "labelcluster",
                           "clusterlayout", "centroid", "labelcentroid"):
            self.cluster_k = int(self._h5["all_attributes"].attrs["cluster_k"])
            self.cluster_list = self._h5[split_name]
            self.cluster_list_random = self._rng.integers(
                0, self.cluster_k, size=self.cluster_list.shape
            )
        if self.method in ("centroid", "labelcentroid"):
            self.centroid_list = self._h5["centroids"]
        if self.method == "patchcluster":
            # per-patch cluster ids [N, patches] (unsupervised_patchcluster.py)
            self.cluster_k = int(self._h5["all_attributes"].attrs["cluster_k"])
            self.cluster_list = self._h5[split_name]
        if self.method == "clustermix":
            # two cluster h5s concatenated (unsupervised_clustermix.py)
            assert h5_file2, "clustermix requires h5_file2"
            self._h5b = h5.File(Path(h5_file2).expanduser().resolve(), "r")
            self.cluster_k = int(self._h5["all_attributes"].attrs["cluster_k"])
            self.cluster_k2 = int(self._h5b["all_attributes"].attrs["cluster_k"])
            self.cluster_list = self._h5[split_name]
            self.cluster_list2 = self._h5b[split_name]
            self.cluster_list_random = self._rng.integers(
                0, self.cluster_k, size=self.cluster_list.shape
            )
            self.cluster_list_random2 = self._rng.integers(
                0, self.cluster_k2, size=self.cluster_list2.shape
            )
        if self.method == "knn_feat":
            knn_cfg = self.condition_cfg.get("knn_feat") or {}
            self.knn_k = knn_cfg.get("knn_k")
            assert self.knn_k is not None, "knn_feat requires condition.knn_feat.knn_k"
            self.feat_list = self._h5["train_feat"]
            self.nns_list = self._h5[f"{split_name}_nns"]
            self.nns_list_random = self._rng.integers(
                0, len(self.feat_list), size=len(self.nns_list)
            )

    # ------------------------------------------------------------------
    def _thread_rng(self) -> np.random.Generator:
        """One Generator per loader-pool thread (seeded from the lookup
        seed + thread id) — safe under the DataLoader's ThreadPool."""
        import threading

        local = getattr(self, "_tls", None)
        if local is None:
            local = self._tls = threading.local()
        if not hasattr(local, "rng"):
            local.rng = np.random.default_rng(
                (self._seed, threading.get_ident()))
        return local.rng

    def _h5_row(self, index: int) -> int:
        if skip_id2name(self.dataset_name) or self.name2id is None:
            return index
        return int(self.name2id[self.id2name(index)])

    def _label_info(self, index: int) -> dict[str, np.ndarray]:
        lid = int(self.label_list[index])
        return {
            "label_id": np.int64(lid),
            "label": _one_hot(lid, self.num_classes),
            "label_random": _one_hot(
                int(self.label_list_random[index]), self.num_classes
            ),
        }

    def get(self, index: int) -> dict[str, np.ndarray]:
        """Per-sample condition dict. Parity: unsupervised_cond.py:103-191."""
        out: dict[str, np.ndarray] = {}
        if ds_has_label_info(self.dataset_name) and self.label_list is not None:
            out.update(self._label_info(index))

        m = self.method
        if m in (None, "attr", "label", "layout", "stegoclusterlayout",
                 "cluster_lookup"):
            # cluster_lookup conditions on batch['id'] via a learned table
            # inside the model (condition.py:38-39) — nothing to fetch here
            return out

        if m == "feat":
            row = self._h5_row(index)
            out["feat"] = normalize_feat(
                np.asarray(self._h5[self.split_name][row], dtype=np.float32)
            )
        elif m == "patchfeat":
            # per-patch feature rows, RAW like the reference
            # (unsupervised_patchfeat.py:6-11 returns feat_list[row]
            # unnormalized)
            row = self._h5_row(index)
            out["patchfeat"] = np.asarray(
                self._h5[self.split_name][row], dtype=np.float32
            )
        elif m in ("cluster", "clusterrandom", "clusterlayout"):
            row = self._h5_row(index)
            cid = int(np.asarray(self.cluster_list[row]).item())
            out["cluster"] = _one_hot(cid, self.cluster_k)
            out["cluster_id"] = np.int64(cid)
            out["cluster_random"] = _one_hot(
                int(np.asarray(self.cluster_list_random[row]).item()), self.cluster_k
            )
        elif m == "labelcluster":
            row = self._h5_row(index)
            cid = int(np.asarray(self.cluster_list[row]).item())
            out["labelcluster"] = np.concatenate(
                [out["label"], _one_hot(cid, self.cluster_k)]
            )
            out["cluster_id"] = np.int64(cid)
        elif m == "centroid":
            row = self._h5_row(index)
            cid = int(np.asarray(self.cluster_list[row]).item())
            out["centroid"] = np.asarray(self.centroid_list[cid], dtype=np.float32)
            out["centroid_random"] = np.asarray(
                self.centroid_list[int(self.cluster_list_random[row])],
                dtype=np.float32,
            )
            out["cluster_id"] = np.int64(cid)
        elif m == "labelcentroid":
            row = self._h5_row(index)
            cid = int(np.asarray(self.cluster_list[row]).item())
            centroid = np.asarray(self.centroid_list[cid], dtype=np.float32)
            out["labelcentroid"] = np.concatenate([out["label"], centroid])
            out["cluster_id"] = np.int64(cid)
        elif m == "patchcluster":
            row = self._h5_row(index)
            ids = np.asarray(self.cluster_list[row], dtype=np.int64)  # [patches]
            out["patchcluster"] = np.eye(self.cluster_k, dtype=np.float32)[ids]
        elif m == "clustermix":
            row = self._h5_row(index)
            a = _one_hot(int(np.asarray(self.cluster_list[row]).item()), self.cluster_k)
            b = _one_hot(int(np.asarray(self.cluster_list2[row]).item()), self.cluster_k2)
            out["clustermix"] = np.concatenate([a, b])
            out["clustermix_random"] = np.concatenate([
                _one_hot(int(self.cluster_list_random[row]), self.cluster_k),
                _one_hot(int(self.cluster_list_random2[row]), self.cluster_k2),
            ])
        elif m == "knn_feat":
            row = self._h5_row(index)
            nns = np.asarray(self.nns_list[row])
            assert self.knn_k <= len(nns)
            # thread-LOCAL generator: get() runs on the loader's thread
            # pool and np Generators are not thread-safe (a shared one
            # corrupts its BitGenerator state under concurrent draws).
            # The reference draws from global np.random — random per
            # access, not reproducible — so per-thread streams match its
            # semantics while staying safe.
            pick = int(nns[self._thread_rng().integers(0, self.knn_k)])
            out["knn_feat"] = normalize_feat(
                np.asarray(self.feat_list[pick], dtype=np.float32)
            )
            out["knn_feat_random"] = normalize_feat(
                np.asarray(
                    self.feat_list[int(self.nns_list_random[row])], dtype=np.float32
                )
            )
        else:
            raise ValueError(m)
        return out


class LostLookup:
    """Per-image LOST bbox lookup. Parity: unsupervised_lost.py:14-27."""

    def __init__(self, lost_file: str):
        self._h5 = h5.File(Path(lost_file).expanduser().resolve(), "r")
        self.cluster_k = int(self._h5.attrs.get("cluster_k", 0)) if self._h5.attrs else 0
        self._boxes: dict[str, np.ndarray] = {}   # read once a name: the loader asks every epoch

    def get_bbox(self, image_name: str) -> np.ndarray:
        box = self._boxes.get(image_name)
        if box is None:
            box = self._boxes[image_name] = np.asarray(self._h5[f"{image_name}_bbox"])
            box.flags.writeable = False
        return box

    def get_clusterid(self, image_name: str) -> int:
        return int(np.asarray(self._h5[f"{image_name}_clusterid"]).item())
