"""PCA-view and ensemble clustering: several k-means assignments a sample.

The port's copy of `sgdm_tpu/selfsup/cluster_pca.py`:

  * `run_pca_views`: sklearn's ``PCA(n_components=d, svd_solver="full")``
    fitted on (a ``default_rng(seed)`` subsample of 100,000 rows of) the
    train features and applied to train + val, in numpy / scipy as
    scikit-learn 1.9.0 computes it (`sklearn/decomposition/_pca.py
    PCA._fit_full`, svd_solver "full": the float32 mean, a centred copy,
    ``scipy.linalg.svd(full_matrices=False)`` (LAPACK gesdd); `sklearn/utils/
    extmath.py svd_flip(u_based_decision=False)`, the rule since 1.5: each
    row of Vᵀ signed so its largest |entry| is positive; `_BasePCA.
    _transform`: ``X @ Vᵀᵀ − mean @ Vᵀᵀ``); the spectrum, in order or
    shuffled by the same generator, split into ``total_view`` contiguous
    views (the card's machine has no sklearn);
  * `clustering_pca`: k-means (`ops.kmeans.run_kmeans`, on the device) per
    view, on ``view[:n_train].copy()`` with the final assignment on the
    whole view;
  * `clustering_ensemble`: ``ensemble_num`` k-means runs on the same
    features, member i seeded 1234 + i; the first member normalises
    ``train_feat`` in place (`run_kmeans`' quirk) and the others train on
    that;
  * each writes ``train`` / ``val`` as [N, views] int64 and the
    ``all_attributes`` attributes through `utils.h5`, under the JAX
    package's file names.
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from scipy import linalg

from ..device import resolve_device
from ..ops.kmeans import run_kmeans
from ..utils import h5
from ..utils.logging import logger
from .cluster import _git_sha

__all__ = ["pca_fit", "run_pca_views", "clustering_pca", "clustering_ensemble"]


def pca_fit(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean [d], components [d, d]) of ``PCA(svd_solver="full").fit(x)``."""
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    mean = np.mean(x, axis=0)
    centred = np.array(x, copy=True)
    centred -= mean
    _, _, vt = linalg.svd(centred, full_matrices=False)
    # svd_flip(u_based_decision=False): the largest |entry| of each row positive
    rows = np.arange(vt.shape[0])
    vt *= np.sign(vt[rows, np.argmax(np.abs(vt), axis=1)])[:, None]
    return mean, vt


def run_pca_views(train_feat: np.ndarray, trainval_feat: np.ndarray, total_view: int = 4,
                  downsample_num: int = 100_000, pca_shuffle: bool = False,
                  seed: int = 0) -> list[np.ndarray]:
    """``total_view`` float32 views [N, d // total_view] of the projection of
    ``trainval_feat`` on the train features' principal components."""
    rng = np.random.default_rng(seed)
    fit = train_feat
    if len(fit) > downsample_num:
        fit = fit[rng.permutation(len(fit))[:downsample_num]]
    d = train_feat.shape[1]
    mean, components = pca_fit(fit)
    x = trainval_feat if trainval_feat.dtype in (np.float32, np.float64) \
        else trainval_feat.astype(np.float64)
    proj = x @ components.T
    proj -= mean.reshape(1, -1) @ components.T
    order = np.arange(d)
    if pca_shuffle:
        rng.shuffle(order)
    chunk = d // total_view
    return [np.ascontiguousarray(proj[:, order[i * chunk:(i + 1) * chunk]], dtype=np.float32)
            for i in range(total_view)]


def _open(feat_h5_path: str, debug: bool):
    f_feat = h5.File(Path(feat_h5_path).expanduser().resolve(), "r")
    attrs = f_feat["all_attributes"].attrs
    get = (lambda split: f_feat[split][:1000]) if debug else (lambda split: f_feat[split][:])
    train_feat, val_feat = np.array(get("train")), np.array(get("val"))
    return f_feat, attrs, train_feat, val_feat


def _write(out: Path, attrs, cluster_k: int, train: np.ndarray, val: np.ndarray) -> None:
    with h5.File(out, "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("val", data=val)
        d = f.create_dataset("all_attributes", (1,))
        d.attrs["dataset_name"] = attrs["dataset_name"]
        d.attrs["feat_from"] = attrs["feat_from"]
        d.attrs["cluster_k"] = cluster_k
        d.attrs["feat_dim"] = attrs["feat_dim"]
        d.attrs["is_grey"] = int(attrs.get("is_grey", 0))


def _out_path(cluster_h5_root: str | None, fname: str) -> Path:
    root = Path(cluster_h5_root or "~/data/sg_data/cluster").expanduser()
    root.mkdir(parents=True, exist_ok=True)
    return (root / fname).resolve()


def clustering_pca(feat_h5_path: str, cluster_k: int = 100, niter: int = 30, minp: int = 200,
                   pca_group: int = 4, pca_shuffle: bool = False,
                   cluster_h5_root: str | None = None, debug: bool = False,
                   report: Callable[[dict], None] | None = None,
                   device: str | torch.device = "cuda") -> Path:
    """k-means on each of ``pca_group`` PCA views; ``report``, when given,
    gets the PCA's seconds, then each view's."""
    device = resolve_device(device)
    f_feat, attrs, train_feat, val_feat = _open(feat_h5_path, debug)
    time_str = datetime.now().isoformat(timespec="hours")
    out = _out_path(cluster_h5_root, (
        f"v4_{attrs['dataset_name']}_cluster{cluster_k}_iter{niter}minp{minp}_nns0_"
        f"{attrs['feat_from']}_grey{int(attrs.get('is_grey', 0))}_pcagroup{pca_group}separate_"
        f"shuffle{int(pca_shuffle)}_{time_str}_{_git_sha()}.h5"))
    trainval = np.concatenate([train_feat, val_feat], 0)
    n_train = len(train_feat)

    t0 = time.perf_counter()
    views = run_pca_views(train_feat, trainval, total_view=pca_group, pca_shuffle=pca_shuffle)
    if report is not None:
        report(dict(pca_seconds=time.perf_counter() - t0))
    assigned = -np.ones((len(trainval), pca_group), np.int64)
    for vi, view in enumerate(views):
        t0 = time.perf_counter()
        assigned[:, vi], _ = run_kmeans(feat_train=view[:n_train].copy(), feat_trainval=view,
                                        cluster_k=cluster_k, niter=niter, minp=minp,
                                        device=device)
        logger.info(f"pca view {vi}: done")
        if report is not None:
            report(dict(view=vi, seconds=time.perf_counter() - t0))
    _write(out, attrs, cluster_k, assigned[:n_train], assigned[n_train:])
    f_feat.close()
    logger.warning(f"saved {out}")
    return out


def clustering_ensemble(feat_h5_path: str, cluster_k: int = 100, niter: int = 30,
                        minp: int = 200, ensemble_num: int = 4,
                        cluster_h5_root: str | None = None, debug: bool = False,
                        report: Callable[[dict], None] | None = None,
                        device: str | torch.device = "cuda") -> Path:
    """``ensemble_num`` k-means runs, member i seeded 1234 + i; ``report``,
    when given, gets each member's seconds."""
    device = resolve_device(device)
    f_feat, attrs, train_feat, val_feat = _open(feat_h5_path, debug)
    time_str = datetime.now().isoformat(timespec="hours")
    out = _out_path(cluster_h5_root, (
        f"v4_{attrs['dataset_name']}_cluster{cluster_k}emsemble{ensemble_num}_"
        f"iter{niter}minp{minp}_nns0_{attrs['feat_from']}_grey{int(attrs.get('is_grey', 0))}_"
        f"{time_str}_{_git_sha()}.h5"))
    trainval = np.concatenate([train_feat, val_feat], 0)
    n_train = len(train_feat)

    assigned = -np.ones((len(trainval), ensemble_num), np.int64)
    for ei in range(ensemble_num):
        t0 = time.perf_counter()
        # train_feat is normalised in place by the first member, as in JAX
        assigned[:, ei], _ = run_kmeans(feat_train=train_feat, feat_trainval=trainval,
                                        cluster_k=cluster_k, niter=niter, minp=minp,
                                        seed=1234 + ei, device=device)
        logger.info(f"ensemble member {ei}: done")
        if report is not None:
            report(dict(member=ei, seconds=time.perf_counter() - t0))
    _write(out, attrs, cluster_k, assigned[:n_train], assigned[n_train:])
    f_feat.close()
    logger.warning(f"saved {out}")
    return out
