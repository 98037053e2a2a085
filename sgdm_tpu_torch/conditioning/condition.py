"""Conditioning glue: batch dict → denoiser kwargs.

The port's copy of `sgdm_tpu/conditioning/condition.py`:

  * `prepare_condition_kwargs` maps ``condition_method`` to what the
    denoiser takes: vector methods pass ``batch[condition_method]`` as
    ``cond``; ``cluster_lookup`` passes the dataset ids as
    ``image_batch_ids``; ``clusterlayout`` passes cond = cluster one-hot and
    the layout picked by ``condition.clusterlayout.how`` ∈ {lost, oracle,
    stego}; ``layout`` passes the layout only; ``stegoclusterlayout`` passes
    cond = ``stego_attr`` n-hot and layout = ``stegomask``.  The drop
    probability is ``cond_drop_prob`` when training, else 1.0;
    unconditional training forces 1.0.
  * `randomsample_cond` swaps ``<m>`` for ``<m>_random`` (the
    random-guidance FID control).
  * `prepare_sampling_kwargs` adds ``cond_scale`` and drops the train-only
    ``cond_drop_prob``.
  * `layout_dim_of` reads ``condition.<method>.layout_dim``.
  * `layout_to_device` puts a layout on the device as float32, expanding
    integer id masks to one-hot there.

Batches are dicts of numpy arrays or tensors (NHWC for image-like entries).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["VECTOR_COND_METHODS", "LAYOUT_COND_METHODS", "prepare_condition_kwargs",
           "randomsample_cond", "prepare_sampling_kwargs", "layout_dim_of", "layout_to_device"]

VECTOR_COND_METHODS = (
    "label", "attr", "feat", "knn_feat", "patchfeat", "centroid",
    "labelcentroid", "cluster", "clustermix", "clusterrandom",
    "labelcluster", "patchcluster",
)
LAYOUT_COND_METHODS = ("clusterlayout", "layout", "stegoclusterlayout")

_LAYOUT_BY_HOW = {"lost": "lostbboxmask", "oracle": "segmask", "stego": "stegomask"}
_RANDOMIZABLE = ("label", "cluster", "centroid", "knn_feat")


def prepare_condition_kwargs(
    condition_method: str | None,
    batch: Mapping[str, Any],
    *,
    cond_drop_prob: float | None = None,
    training: bool = True,
    condition_cfg: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """Return {cond_drop_prob, cond[, layout][, image_batch_ids]} for the denoiser."""
    if condition_method is not None:
        if cond_drop_prob is None or not cond_drop_prob > 0:
            raise ValueError("conditional training requires cond_drop_prob > 0")
        drop = cond_drop_prob if training else 1.0
    else:
        drop = 1.0
    out: dict[str, Any] = {"cond_drop_prob": drop}
    if condition_method is None:
        out["cond"] = None
    elif condition_method == "cluster_lookup":
        out["cond"] = None
        out["image_batch_ids"] = batch["id"]
    elif condition_method in VECTOR_COND_METHODS:
        out["cond"] = batch[condition_method]
    elif condition_method == "clusterlayout":
        out["cond"] = batch["cluster"]
        out["layout"] = batch[_LAYOUT_BY_HOW[_how(condition_cfg, "clusterlayout")]]
    elif condition_method == "layout":
        out["layout"] = batch[_LAYOUT_BY_HOW[_how(condition_cfg, "layout")]]
    elif condition_method == "stegoclusterlayout":
        out["cond"] = batch["stego_attr"]
        out["layout"] = batch["stegomask"]
    else:
        raise ValueError(condition_method)
    return out


def _how(condition_cfg: Mapping[str, Any] | None, method: str) -> str:
    how = ((condition_cfg or {}).get(method) or {}).get("how")
    if how not in _LAYOUT_BY_HOW:
        raise ValueError(f"condition.{method}.how must be one of {sorted(_LAYOUT_BY_HOW)}, "
                         f"got {how!r}")
    return how


def randomsample_cond(condition_method: str | None, batch: dict[str, Any],
                      random_sample_condition: bool) -> dict[str, Any]:
    """Swap a condition for its randomized variant (FID control)."""
    if not random_sample_condition:
        return batch
    if condition_method in _RANDOMIZABLE:
        batch = dict(batch)
        batch[condition_method] = batch[f"{condition_method}_random"]
        return batch
    raise ValueError(f"random_sample_condition unsupported for {condition_method!r}")


def prepare_sampling_kwargs(
    condition_method: str | None,
    batch: dict[str, Any],
    cond_scale,
    *,
    random_sample_condition: bool = False,
    condition_cfg: Mapping[str, Any] | None = None,
    cond_drop_prob: float | None = 0.1,
) -> dict[str, Any]:
    """Condition kwargs for guided sampling: adds cond_scale, drops cond_drop_prob."""
    batch = randomsample_cond(condition_method, batch, random_sample_condition)
    kw = prepare_condition_kwargs(condition_method, batch, cond_drop_prob=cond_drop_prob,
                                  training=True, condition_cfg=condition_cfg)
    kw.pop("cond_drop_prob")
    kw["cond_scale"] = cond_scale
    return kw


def layout_dim_of(condition_method: str | None,
                  condition_cfg: Mapping[str, Any] | None) -> int:
    """The configured ``condition.<method>.layout_dim`` (0 when unset)."""
    cfg = (condition_cfg or {}).get(condition_method or "") or {}
    return int(cfg.get("layout_dim") or 0)


def layout_to_device(layout, layout_dim: int,
                     device: str | torch.device = "cpu") -> torch.Tensor | None:
    """Layout → float32 on ``device``, expanding the id-mask wire format.

      * float one-hot [.., H, W, K] or binary [.., H, W, 1] maps: a cast;
      * integer id masks [B, H, W] or [H, W], as numpy arrays or tensors:
        sent to the device as uint8 (one byte per pixel) and expanded to
        one-hot [.., H, W, layout_dim] there.  An id ≥ ``layout_dim`` or < 0
        raises.  Integer [.., H, W, 1] binary masks are cast like the maps.
    """
    if layout is None:
        return None
    t = layout if isinstance(layout, torch.Tensor) else torch.as_tensor(np.asarray(layout))
    integer = not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool)
    if integer and t.ndim in (2, 3) and t.shape[-1] != 1:
        if layout_dim <= 0:
            raise ValueError("an id-mask layout needs condition.<method>.layout_dim")
        if layout_dim > 256:
            raise ValueError(f"id masks travel as uint8: layout_dim {layout_dim} > 256")
        if t.numel() and (int(t.max()) >= layout_dim or int(t.min()) < 0):
            raise ValueError(f"layout id mask holds ids in [{int(t.min())}, {int(t.max())}], "
                             f"outside [0, {layout_dim})")
        ids = t.to(torch.uint8).to(device)
        return torch.nn.functional.one_hot(ids.long(), layout_dim).float()
    return t.to(device=device, dtype=torch.float32)
