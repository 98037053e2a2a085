"""Feature-extraction CLI: dataset → feat h5 (reference-compatible).

The port's copy of `sgdm_tpu/selfsup/feat_extractor.py`:

  * CLI: ``python -m sgdm_tpu_torch.selfsup.feat_extractor --feat
    dino_vitb16 --ds in64p --bs 256 --image_size 64`` (the JAX CLI's flags,
    and ``--device``: the card unless ``cpu`` is asked for);
  * iterates the train and val loaders, `transform_batch` (resize to 224,
    ImageNet normalisation), `batch_encode_feat` (the CLS token), and
    writes the feat h5 contract through `utils.h5` (no h5py): datasets
    ``train`` [N, feat_dim] f32 / ``val``, ``train_labels`` /
    ``val_labels`` when the dataset has labels, attrs {dataset_name,
    feat_from, feat_dim, version, is_grey} on ``all_attributes`` (the
    strings as h5py 3 writes them), and a sibling ``.json`` with
    id2name / name2id;
  * ``crops=10`` (tencrop: [N, 10, feat_dim]), ``spatial`` (the
    'withpatches' [N, 1 + S², feat_dim] file with ``resampled_size``) and
    ``attention_map`` (``{split}_attentions`` [N, heads, n_patches]).

Plain CLS extraction runs one batch deep: batch k's encode is queued on the
card and its result copied into pinned host memory asynchronously, while
the host writes batch k−1's rows (waiting on its copy's event) and loads
batch k+1.
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..data.loader import DataLoader
from ..utils import h5
from ..utils.logging import logger
from .ssl_backbone import HostCopy, get_ssl_backbone, tencrop_batch

__all__ = ["extract_feat", "main"]


def extract_feat(
    dataset_train,
    dataset_val,
    dataset_name: str,
    feat_from: str = "dino_vitb16",
    batch_size: int = 32,
    out_root: str = "~/data/sg_data/feat",
    is_grey: bool = False,
    ckpt_path: str | None = None,
    version: str = "v4",
    crops: int = 1,
    spatial: bool = False,
    resampled_size: int = 14,
    attention_map: bool = False,
    device: str | torch.device = "cuda",
) -> Path:
    """``crops=10`` writes the tencrop variant: [N, 10, feat_dim] datasets;
    ``crops=1`` the standard CLS-feature file.  ``spatial=True`` writes the
    per-token 'withpatches' file consumed by patch clustering: datasets
    [N, 1 + resampled_size², feat_dim] plus the ``resampled_size``
    attribute.  ``attention_map=True`` also writes ``{split}_attentions``
    [N, heads, n_patches], the last block's CLS attention."""
    backbone = get_ssl_backbone(feat_from, ckpt_path=ckpt_path, device=device)
    out_root = Path(out_root).expanduser()
    out_root.mkdir(parents=True, exist_ok=True)
    time_str = datetime.now().isoformat(timespec="hours")
    suffix = "_tencrop" if crops == 10 else ("_withpatches" if spatial else "")
    out_path = out_root / (
        f"{version}_{dataset_name}_{feat_from}{suffix}_grey{int(is_grey)}_{time_str}.h5"
    )
    n_tokens = 1 + resampled_size * resampled_size
    if attention_map:
        n_patches = (backbone.image_size // backbone.model.patch_size) ** 2
        n_heads = backbone.model.num_heads
    else:
        n_patches = n_heads = 0

    id2name: dict[int, str] = {}
    with h5.File(out_path, "w") as f:
        for split, ds in [("train", dataset_train), ("val", dataset_val)]:
            n = len(ds)
            if spatial:
                shape = (n, n_tokens, backbone.feat_dim)
            elif crops == 10:
                shape = (n, crops, backbone.feat_dim)
            else:
                shape = (n, backbone.feat_dim)
            feats = f.create_dataset(split, shape, dtype="f4")
            attn_ds = (f.create_dataset(f"{split}_attentions", (n, n_heads, n_patches),
                                        dtype="f4") if attention_map else None)
            has_labels = "label_id" in ds[0] or "label" in ds[0]
            labels = f.create_dataset(f"{split}_labels", (n,), dtype="i8") if has_labels else None
            dl = DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False)
            i = 0

            def _commit(start, feat_np, batch):
                """Write one batch's rows (feats + labels + name map)."""
                b = len(feat_np)
                feats[start:start + b] = feat_np
                if labels is not None:
                    lab = batch.get("label_id")
                    if lab is None:
                        lab = np.argmax(batch["label"], axis=-1)
                    labels[start:start + b] = lab
                for j in range(b):
                    idx = int(batch["id"][j])
                    id2name[idx] = ds.id2name(idx) if hasattr(ds, "id2name") else f"{idx}.jpg"
                return b

            pending = None  # (start row, host copy, batch)
            pipeline = crops != 10 and not spatial and attn_ds is None
            for batch in dl:
                imgs = batch["img4unsup"]
                if crops == 10:
                    tc = tencrop_batch(imgs)  # [B, 10, h, w, 3]
                    b_, c_ = tc.shape[:2]
                    flat = tc.reshape(b_ * c_, *tc.shape[2:])
                    feat = backbone.batch_encode_feat(
                        backbone.transform_batch(flat)).reshape(b_, c_, -1)
                    x = None
                elif spatial:
                    x = backbone.transform_batch(imgs)
                    feat = backbone.batch_encode_tokens(x, resampled_size)
                else:
                    x = backbone.transform_batch(imgs)
                    if pipeline:
                        dev = HostCopy(backbone.batch_encode_feat(x, as_numpy=False))
                        if pending is not None:
                            _commit(pending[0], pending[1].numpy(), pending[2])
                        pending = (i, dev, batch)
                        i += len(imgs)
                        if i % (batch_size * 50) == 0:
                            logger.info(f"{split}: {i}/{n}")
                        continue
                    feat = backbone.batch_encode_feat(x)
                if attn_ds is not None:
                    if x is None:
                        x = backbone.transform_batch(imgs)
                    attn_ds[i:i + len(imgs)] = backbone.batch_encode_cls_attention(x)
                i += _commit(i, feat, batch)
                if i % (batch_size * 50) == 0:
                    logger.info(f"{split}: {i}/{n}")
            if pending is not None:
                _commit(pending[0], pending[1].numpy(), pending[2])
            if i != n:
                raise RuntimeError(f"{split}: {i} rows written of {n}")

        attrs = f.create_dataset("all_attributes", (1,))
        attrs.attrs["dataset_name"] = dataset_name
        attrs.attrs["feat_from"] = feat_from
        attrs.attrs["feat_dim"] = backbone.feat_dim
        attrs.attrs["version"] = version
        attrs.attrs["is_grey"] = int(is_grey)
        if spatial:
            attrs.attrs["resampled_size"] = resampled_size

    with open(str(out_path).replace(".h5", ".json"), "w") as fh:
        json.dump({"id2name": {str(k): v for k, v in id2name.items()},
                   "name2id": {v: k for k, v in id2name.items()}}, fh)
    logger.warning(f"saved feats to {out_path}")
    return out_path


def _build_datasets(ds: str, image_size: int, data_root: str, debug: bool):
    """get_train_val_dl parity (the JAX package's `_build_datasets`)."""
    if ds in ("in32p", "in64p"):
        from ..data.imagenet_pickle import ImageNetPickle

        mk = lambda train: ImageNetPickle(root=data_root, train=train, image_size=image_size,
                                          debug=debug)
        return mk(True), mk(False)
    if ds == "cifar10":
        from ..data.cifar10 import CIFAR10

        return CIFAR10(data_root, train=True, debug=debug), CIFAR10(data_root, train=False,
                                                                     debug=debug)
    if ds == "synthetic":
        from ..data.synthetic import SyntheticImages

        return (SyntheticImages(size=image_size, length=512, seed=0),
                SyntheticImages(size=image_size, length=128, seed=1))
    raise ValueError(ds)


def main(argv: list[str] | None = None) -> Path:
    p = argparse.ArgumentParser(description="feat_extractor (PyTorch port)")
    p.add_argument("--feat", default="dino_vitb16")
    p.add_argument("--ds", default="in32p")
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--data_root", default="~/data")
    p.add_argument("--out_root", default="~/data/sg_data/feat")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--tencrop", action="store_true")
    p.add_argument("--spatial", action="store_true",
                   help="write per-token features (patch clustering input)")
    p.add_argument("--resampled_size", type=int, default=14)
    p.add_argument("--attn", action="store_true",
                   help="also write last-block CLS attention maps")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    train, val = _build_datasets(a.ds, a.image_size, a.data_root, a.debug)
    return extract_feat(train, val, dataset_name=a.ds, feat_from=a.feat, batch_size=a.bs,
                        out_root=a.out_root, ckpt_path=a.ckpt, crops=10 if a.tencrop else 1,
                        spatial=a.spatial, resampled_size=a.resampled_size,
                        attention_map=a.attn, device=a.device)


if __name__ == "__main__":
    main()
