"""Clustering CLI: feat h5 → cluster h5 (the JAX package's schema).

The port's copy of `sgdm_tpu/selfsup/cluster.py`, on the port's k-means
and kNN (`ops.kmeans`, `ops.knn`) and `utils.h5` (no h5py):

  * output schema: ``train`` / ``val`` int64 assignments, ``centroids``
    [k, feat_dim], with ``nns`` > 0 ``train_feat`` (UNNORMALISED) and
    ``{split}_nns`` / ``{split}_nns_radius``, ``train/val_attentions``
    copied through, attrs {dataset_name, feat_from, cluster_k, feat_dim,
    is_grey} on ``all_attributes``, the sibling ``.json`` copied from the
    feat h5; a tencrop feat file ([N, crops, D]) is clustered on its
    crop-mean;
  * file name ``v4_{ds}_cluster{k}_iter{n}minp{m}_nns{nns}_{feat}_grey{g}_
    {time}_{sha}.h5``;
  * the order of the JAX package: trainval concatenated and the nearest
    neighbours searched on ``train_feat`` BEFORE `run_kmeans` normalises
    ``train_feat`` in place, so the final assignment and the neighbours use
    the unnormalised features;
  * NMI / AMI / ARI against labels when present: `cal_cluster_metric`, the
    reference's sklearn scores in numpy / scipy (the card's machine has no
    sklearn).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from datetime import datetime
from math import log
from pathlib import Path

import numpy as np
import torch
from scipy.special import gammaln

from ..device import resolve_device
from ..ops.kmeans import run_kmeans
from ..ops.knn import run_nns
from ..utils import h5
from ..utils.logging import logger

__all__ = ["cal_cluster_metric", "clustering", "main", "normalized_mutual_info_score",
           "adjusted_mutual_info_score", "adjusted_rand_score"]

_EPS64 = np.finfo("float64").eps


def _contingency(labels_true, labels_pred):
    """Nonzero cells of the contingency table in row-major order (classes,
    then clusters, each ascending, as sklearn's CSR table): (rows, cols,
    counts int64, row sums, column sums)."""
    t = np.asarray(labels_true).reshape(-1)
    p = np.asarray(labels_pred).reshape(-1)
    if len(t) != len(p):
        raise ValueError(f"labels of {len(t)} and {len(p)} samples")
    _, ti = np.unique(t, return_inverse=True)
    clusters, pi_ = np.unique(p, return_inverse=True)
    cells, counts = np.unique(ti.astype(np.int64) * len(clusters) + pi_, return_counts=True)
    rows, cols = cells // len(clusters), cells % len(clusters)
    row_sums = np.bincount(rows, weights=counts).astype(np.int64)
    col_sums = np.bincount(cols, weights=counts, minlength=len(clusters)).astype(np.int64)
    return rows, cols, counts.astype(np.int64), row_sums, col_sums


def _mutual_info(rows, cols, nz, pi, pj) -> float:
    """sklearn's mutual_info_score on a contingency table."""
    if pi.size == 1 or pj.size == 1:
        return 0.0
    total = nz.sum()
    log_nm = np.log(nz)
    nm = nz / total
    outer = pi.take(rows).astype(np.int64) * pj.take(cols).astype(np.int64)
    log_outer = -np.log(outer) + log(pi.sum()) + log(pj.sum())
    mi = nm * (log_nm - log(total)) + nm * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def _entropy(labels) -> float:
    labels = np.asarray(labels).reshape(-1)
    if len(labels) == 0:
        return 1.0
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - log(pi_sum))))


def _expected_mutual_info(a: np.ndarray, b: np.ndarray, n: int) -> float:
    """sklearn's expected_mutual_information (the hypergeometric model)
    from the row sums ``a`` and column sums ``b``: the same terms, each
    distinct (a_i, b_j) pair once, weighted by how often it occurs."""
    if a.size == 1 or b.size == 1:
        return 0.0
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    A, B = np.broadcast_arrays(ua[:, None], ub[None, :])
    weight = (ca[:, None].astype(np.float64) * cb[None, :])
    start = np.maximum(1, A - n + B)
    end = np.minimum(A, B) + 1
    log_n, gln_n = np.log(n), gammaln(n + 1)
    emi = 0.0
    for nij in range(int(start.min()), int(end.max())):
        live = np.nonzero((start <= nij) & (nij < end))
        if not live[0].size:
            continue
        a_, b_ = A[live], B[live]
        term2 = log_n + np.log(nij) - np.log(a_) - np.log(b_)
        gln = (gammaln(a_ + 1) + gammaln(b_ + 1) + gammaln(n - a_ + 1) + gammaln(n - b_ + 1)
               - (gammaln(nij + 1) + gln_n) - gammaln(a_ - nij + 1) - gammaln(b_ - nij + 1)
               - gammaln(n - a_ - b_ + nij + 1))
        emi += float(np.sum((nij / n) * term2 * np.exp(gln) * weight[live]))
    return emi


def normalized_mutual_info_score(labels_true, labels_pred) -> float:
    """sklearn's ``normalized_mutual_info_score`` (arithmetic mean)."""
    rows, cols, nz, pi, pj = _contingency(labels_true, labels_pred)
    if pi.size == pj.size == 1 or pi.size == pj.size == 0:
        return 1.0
    mi = _mutual_info(rows, cols, nz.astype(np.float64), pi, pj)
    if mi == 0:
        return 0.0
    return float(mi / np.mean([_entropy(labels_true), _entropy(labels_pred)]))


def adjusted_mutual_info_score(labels_true, labels_pred) -> float:
    """sklearn's ``adjusted_mutual_info_score`` (arithmetic mean)."""
    rows, cols, nz, pi, pj = _contingency(labels_true, labels_pred)
    if pi.size == pj.size == 1 or pi.size == pj.size == 0:
        return 1.0
    if pi.size == 1 or pj.size == 1:
        return 0.0
    mi = _mutual_info(rows, cols, nz, pi, pj)
    emi = _expected_mutual_info(pi, pj, int(nz.sum()))
    normalizer = np.mean([_entropy(labels_true), _entropy(labels_pred)])
    denominator = normalizer - emi
    denominator = min(denominator, -_EPS64) if denominator < 0 else max(denominator, _EPS64)
    numerator = mi - emi
    numerator = min(numerator, -_EPS64) if numerator < 0 else max(numerator, _EPS64)
    return float(numerator / denominator)


def adjusted_rand_score(labels_true, labels_pred) -> float:
    """sklearn's ``adjusted_rand_score`` (pair confusion in Python ints)."""
    rows, cols, nz, pi, pj = _contingency(labels_true, labels_pred)
    n = int(nz.sum())
    sum_squares = int((nz ** 2).sum())
    tp = sum_squares - n
    fp = int((nz * pj[cols]).sum()) - sum_squares
    fn = int((nz * pi[rows]).sum()) - sum_squares
    tn = n ** 2 - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def cal_cluster_metric(gt_np, pred_np, need_nmi=True, need_ami=True, need_ari=True):
    """Parity: clustering/cal_cluster_metric.py:7-15, ``labels_pred_num``
    counting the GROUND-TRUTH labels as the reference does."""
    result = dict(labels_pred_num=len(np.unique(gt_np)))
    if need_nmi:
        result["nmi"] = normalized_mutual_info_score(gt_np, pred_np)
    if need_ami:
        result["ami"] = adjusted_mutual_info_score(gt_np, pred_np)
    if need_ari:
        result["ari"] = adjusted_rand_score(gt_np, pred_np)
    return result


def _git_sha() -> str:
    try:
        return subprocess.check_output(["git", "rev-parse", "HEAD"], text=True,
                                       stderr=subprocess.DEVNULL).strip()[:7]
    except (OSError, subprocess.CalledProcessError):
        return "nogit"


def clustering(
    feat_h5_path: str,
    nns: int = 0,
    cluster_k: int = 5000,
    niter: int = 30,
    minp: int = 200,
    cluster_h5_root: str | None = None,
    debug: bool = False,
    seed: int = 1234,
    device: str | torch.device = "cuda",
) -> Path:
    device = resolve_device(device)
    feat_h5_path = Path(feat_h5_path).expanduser().resolve()
    f_feat = h5.File(feat_h5_path, "r")
    attrs = f_feat["all_attributes"].attrs
    dataset_name = attrs["dataset_name"]
    feat_from = attrs["feat_from"]
    is_grey = int(attrs.get("is_grey", 0))

    def get_feat(split):
        return f_feat[split][:1000] if debug else f_feat[split][:]

    if debug:
        cluster_k, niter = 10, 30

    time_str = datetime.now().isoformat(timespec="hours")
    fname = (f"v4_{dataset_name}_cluster{cluster_k}_iter{niter}minp{minp}_"
             f"nns{nns}_{feat_from}_grey{is_grey}_{time_str}_{_git_sha()}.h5")
    if debug:
        fname = fname.replace(".h5", "debug.h5")
    root = Path(cluster_h5_root or "~/data/sg_data/cluster").expanduser()
    root.mkdir(parents=True, exist_ok=True)
    out_path = (root / fname).resolve()

    # the sibling .json name map copied from the feat h5
    src_json = Path(str(feat_h5_path).replace(".h5", ".json"))
    if src_json.exists():
        shutil.copy(src_json, Path(str(out_path).replace(".h5", ".json")))

    # a read is a fresh copy: no second one
    train_feat, val_feat = get_feat("train"), get_feat("val")
    if train_feat.ndim == 3:  # tencrop feats [N, crops, D] → crop-mean
        train_feat = train_feat.mean(axis=1)
        val_feat = val_feat.mean(axis=1)
    trainval_feat = np.concatenate([train_feat, val_feat], 0)
    trainset_size = len(train_feat)

    with h5.File(out_path, "w") as f:
        f.create_dataset("train", data=-np.ones(len(train_feat), dtype=np.int64))
        f.create_dataset("val", data=-np.ones(len(val_feat), dtype=np.int64))
        dset = f.create_dataset("all_attributes", (1,))
        dset.attrs["dataset_name"] = dataset_name
        dset.attrs["feat_from"] = feat_from
        dset.attrs["cluster_k"] = cluster_k
        dset.attrs["feat_dim"] = attrs["feat_dim"]
        dset.attrs["is_grey"] = is_grey

        if nns > 0:
            logger.warning("creating nns datasets")
            # train_feat as it is: run_kmeans normalises it in place only below
            sample_nns, radii = run_nns(train_feat, features_trainval=trainval_feat, k_nn=nns,
                                        device=device)
            f.create_dataset("train_feat", data=train_feat)
            f.create_dataset("train_nns", data=sample_nns[:trainset_size])
            f.create_dataset("train_nns_radius", data=radii[:trainset_size])
            f.create_dataset("val_nns", data=sample_nns[trainset_size:])
            f.create_dataset("val_nns_radius", data=radii[trainset_size:])

        if "train_attentions" in f_feat:
            f.create_dataset("train_attentions", data=f_feat["train_attentions"])
            f.create_dataset("val_attentions", data=f_feat["val_attentions"])

        assigned, centroids = run_kmeans(
            feat_train=train_feat, feat_trainval=trainval_feat,
            cluster_k=cluster_k, niter=niter, minp=minp, seed=seed, device=device,
        )
        f["train"][:] = assigned[:trainset_size]
        f["val"][:] = assigned[trainset_size:]
        f.create_dataset("centroids", data=centroids)

        if "train_labels" in f_feat:
            labels = np.concatenate([get_feat("train_labels"), get_feat("val_labels")], 0)
            logger.warning(f"train cluster metrics: "
                           f"{cal_cluster_metric(labels[:trainset_size], assigned[:trainset_size])}")
            logger.warning(f"val cluster metrics: "
                           f"{cal_cluster_metric(labels[trainset_size:], assigned[trainset_size:])}")

    f_feat.close()
    logger.warning(f"saved {out_path}")
    return out_path


def main(argv: list[str] | None = None) -> Path:
    p = argparse.ArgumentParser(description="cluster_on_feat (PyTorch port)")
    p.add_argument("--feat_h5", required=True)
    p.add_argument("--k", type=int, default=5000)
    p.add_argument("--niter", type=int, default=30)
    p.add_argument("--minp", type=int, default=200)
    p.add_argument("--nns", type=int, default=0)
    p.add_argument("--out_root", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    return clustering(a.feat_h5, nns=a.nns, cluster_k=a.k, niter=a.niter, minp=a.minp,
                      cluster_h5_root=a.out_root, debug=a.debug, device=a.device)


if __name__ == "__main__":
    main()
