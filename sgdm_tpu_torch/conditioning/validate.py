"""Config validation, the default eval kwargs and batch-range logging.

Port of `sgdm_tpu/conditioning/validate.py` (numpy only):

  * `assert_check`: per-condition-method invariants (unconditional ⇒
    cond_dim 0, cond_scale 0, drop 1; the cluster family ⇒ an h5_file; feat
    ⇒ the feature name in the h5 file's name; layout ⇒ no h5_file);
  * `assert_image_dir`: the FID folders exist before training;
  * `get_default_config`: the condition / sampling / FID kwarg dicts every
    eval path reads;
  * `log_range`: min / max / mean / std of every batch tensor.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ..utils.logging import logger

__all__ = ["assert_check", "assert_image_dir", "get_default_config", "log_range"]

_H5_METHODS = (
    "labelcluster", "cluster", "cluster_lookup", "clusterrandom", "clustermix",
    "centroid", "patchcluster", "labelcentroid", "clusterlayout", "knn_feat",
)


def assert_check(hparams: Mapping[str, Any]) -> None:
    """hparams: the sg.params-style dict (condition_method, cond_dim,
    cond_scale, cond_drop_prob, condition, data...)."""
    m = hparams.get("condition_method")
    assert hparams.get("parameterization", "eps") in ("eps", "x0")
    data = hparams.get("data") or {}
    condition = hparams.get("condition") or {}
    h5_file = data.get("h5_file")

    if m is None:
        assert not hparams.get("cond_dim"), "unconditional ⇒ cond_dim=0"
        assert not hparams.get("cond_scale"), "unconditional ⇒ cond_scale=0"
        assert hparams.get("cond_drop_prob") in (1, 1.0, None), (
            "unconditional ⇒ cond_drop_prob=1"
        )
    elif m in ("feat", "patchfeat"):
        feat_from = (condition.get("feat") or {}).get("feat_from")
        assert feat_from is not None, "feat requires condition.feat.feat_from"
        assert h5_file is not None, "feat requires data.h5_file"
        assert feat_from in str(h5_file), (
            f"h5_file {h5_file} should include the feature name {feat_from}"
        )
    elif m in ("label", "attr", "stegoclusterlayout"):
        pass
    elif m in _H5_METHODS[:-1]:  # all the cluster-family methods
        assert h5_file is not None, f"{m} requires data.h5_file"
    elif m == "layout":
        assert h5_file is None, "layout-only runs take no h5_file"
    elif m == "knn_feat":
        assert h5_file is not None
    else:
        raise ValueError(m)
    if h5_file is not None:
        logger.warning(f"reading condition info from h5 file {h5_file}")


def assert_image_dir(data_cfg: Mapping[str, Any]) -> None:
    """FID folders must exist before training starts (misc.py:8-28)."""
    for key in ("fid_train_image_dir", "fid_val_image_dir", "fid_debug_dir"):
        d = data_cfg.get(key)
        if d is None:
            continue
        d = Path(str(d)).expanduser()
        assert d.exists(), f"{key}={d} does not exist"
        logger.warning(f"{key}: {d}, image_num={len(os.listdir(d))}")


def get_default_config(hparams: Mapping[str, Any]) -> tuple[dict, dict, dict]:
    """The three eval kwarg dicts. Parity: misc.py:94-143."""
    data = hparams["data"]
    model = hparams["model"]

    def resolved(key):
        v = data.get(key)
        return None if v is None else str(Path(str(v)).expanduser())

    condition_kwargs = dict(
        cond_scale=hparams.get("cond_scale"),
        condition_method=hparams.get("condition_method"),
    )
    fid_kwargs = dict(
        fid_num=None,
        vis_knn=False,
        fid_train_image_dir=resolved("fid_train_image_dir"),
        fid_val_image_dir=resolved("fid_val_image_dir"),
        fid_debug_dir=resolved("fid_debug_dir"),
        sample_dir="sample",
        save_dir=None,
        dataset_name=data.get("name"),
        image_size=data.get("image_size"),
    )
    sampling_kwargs = dict(
        sampling_method=model.get("sampling", "native"),
        num_timesteps=model.get("num_timesteps", 1000),
        ddim_eta=hparams.get("ddim_eta", 0.0),
        log_num_per_prog=hparams.get("log_num_per_prog", 10),
        clip_denoised=model.get("clip_denoised", True),
        dtp=hparams.get("dtp", 1.0),
        temperature=1.0,
        noise_dropout=0,
        random_sample_condition=False,
    )
    return condition_kwargs, sampling_kwargs, fid_kwargs


def log_range(tracker, batch: Mapping[str, Any], step: int | None = None) -> None:
    """min/max/mean/std per batch tensor. Parity: misc.py:146-155."""
    log = {}
    for k, v in batch.items():
        arr = np.asarray(v, dtype=np.float64)
        if arr.ndim == 0:
            continue
        log[f"range/max_{k}"] = float(arr.max())
        log[f"range/mean_{k}"] = float(arr.mean())
        log[f"range/min_{k}"] = float(arr.min())
        log[f"range/std_{k}"] = float(arr.std())
    tracker.log(log, step=step)
