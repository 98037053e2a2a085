"""Patch clustering: per-token k-means over a 'withpatches' spatial feat h5.

The port's copy of `sgdm_tpu/selfsup/cluster_patch.py`: the input feat
file holds per-token features [N, 1 + S², D] (CLS + an S×S resampled patch
grid, attrs['resampled_size']; written by ``feat_extractor --spatial``),
and each token position is k-means-clustered INDEPENDENTLY with the port's
faiss-semantics k-means (`ops.kmeans.run_kmeans`, on the card), giving

  * ``train`` / ``val``: int64 [N, 1 + S²] per-token cluster assignments,
  * ``centroids``: [cluster_k, 1 + S², feat_dim],
  * attrs {dataset_name, feat_from, cluster_k, feat_dim, resampled_size}
    and the copied id2name / name2id sidecar json,
  * file name ``v3_{ds}_cluster{k}_iter{n}minp{m}_{feat}_{time}_{sha}_
    withpatches_size{S}.h5``,

written through `utils.h5` (no h5py).  This is the producer of the
``patchcluster`` condition the port's `data/h5cond.py` reads.
"""

from __future__ import annotations

import argparse
import shutil
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kmeans import run_kmeans
from ..utils import h5
from ..utils.logging import logger
from .cluster import _git_sha, cal_cluster_metric

__all__ = ["clustering_withpatches", "main"]


def clustering_withpatches(
    feat_h5_path: str,
    cluster_k: int = 100,
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
    resampled_size = int(attrs.get("resampled_size", 14))
    feat_dim = int(attrs["feat_dim"])

    def get_feat(split):
        return f_feat[split][:1000] if debug else f_feat[split][:]

    if debug:
        token_num_all, cluster_k, niter = 3, 10, 30
    else:
        token_num_all = 1 + resampled_size * resampled_size

    time_str = datetime.now().isoformat(timespec="hours")
    fname = (
        f"v3_{dataset_name}_cluster{cluster_k}_iter{niter}minp{minp}_"
        f"{feat_from}_{time_str}_{_git_sha()}_withpatches_size{resampled_size}.h5"
    )
    if debug:
        fname = fname.replace(".h5", "debug.h5")
    root = Path(cluster_h5_root or "~/data/sg_data/cluster").expanduser()
    root.mkdir(parents=True, exist_ok=True)
    out_path = (root / fname).resolve()

    src_json = Path(str(feat_h5_path).replace(".h5", ".json"))
    if src_json.exists():
        shutil.copy(src_json, Path(str(out_path).replace(".h5", ".json")))

    train = np.asarray(get_feat("train"), dtype=np.float32)
    val = np.asarray(get_feat("val"), dtype=np.float32)
    if train.ndim != 3:
        raise ValueError(f"patch clustering needs a spatial feat file [N, tokens, D]; got "
                         f"{train.shape}: extract with `feat_extractor --spatial`")
    n_train = len(train)

    with h5.File(out_path, "w") as f:
        f.create_dataset(
            "train", data=-np.ones((n_train, token_num_all), dtype=np.int64)
        )
        f.create_dataset(
            "val", data=-np.ones((len(val), token_num_all), dtype=np.int64)
        )
        f.create_dataset(
            "centroids", data=np.ones((cluster_k, token_num_all, feat_dim))
        )
        dset = f.create_dataset("all_attributes", (1,))
        dset.attrs["dataset_name"] = dataset_name
        dset.attrs["feat_from"] = feat_from
        dset.attrs["cluster_k"] = cluster_k
        dset.attrs["feat_dim"] = feat_dim
        dset.attrs["resampled_size"] = resampled_size

        assigned = None
        for token_id in range(token_num_all):
            train_tok = np.ascontiguousarray(train[:, token_id, :])
            trainval = np.concatenate([train_tok, val[:, token_id, :]], 0)
            assigned, centroids = run_kmeans(
                feat_train=train_tok, feat_trainval=trainval,
                cluster_k=cluster_k, niter=niter, minp=minp, seed=seed, device=device,
            )
            f["train"][:, token_id] = assigned[:n_train]
            f["val"][:, token_id] = assigned[n_train:]
            f["centroids"][:, token_id, :] = centroids
            if token_id % 10 == 0:
                logger.info(f"patch clustering token {token_id}/{token_num_all}")

        # metrics on the LAST token's assignment, as the reference
        if "train_labels" in f_feat and assigned is not None:
            labels = np.concatenate(
                [get_feat("train_labels"), get_feat("val_labels")], 0
            )
            logger.warning(
                f"train cluster metrics: "
                f"{cal_cluster_metric(labels[:n_train], assigned[:n_train])}"
            )
            logger.warning(
                f"val cluster metrics: "
                f"{cal_cluster_metric(labels[n_train:], assigned[n_train:])}"
            )

    f_feat.close()
    logger.warning(f"saved {out_path}")
    return out_path


def main(argv: list[str] | None = None) -> Path:
    p = argparse.ArgumentParser(description="cluster_patch (PyTorch port)")
    p.add_argument("--feat_h5", required=True)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--niter", type=int, default=30)
    p.add_argument("--minp", type=int, default=200)
    p.add_argument("--out_root", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    return clustering_withpatches(a.feat_h5, cluster_k=a.k, niter=a.niter, minp=a.minp,
                                  cluster_h5_root=a.out_root, debug=a.debug, device=a.device)


if __name__ == "__main__":
    main()
