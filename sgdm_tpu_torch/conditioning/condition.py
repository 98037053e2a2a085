"""Conditioning glue: batch dict → denoiser kwargs.

The port's copy of `sgdm_tpu/conditioning/condition.py`
`prepare_condition_kwargs` for the vector-condition methods and
``cluster_lookup``: vector methods pass ``batch[condition_method]`` as
``cond``; ``cluster_lookup`` passes the dataset ids as
``image_batch_ids``.  The drop probability is ``cond_drop_prob`` when
training, else 1.0; unconditional training forces 1.0.  The layout methods
(``clusterlayout``, ``layout``, ``stegoclusterlayout``) come with the VOC64
slice and raise `NotImplementedError` until then.
"""

from __future__ import annotations

from typing import Any, Mapping

__all__ = ["VECTOR_COND_METHODS", "LAYOUT_COND_METHODS", "prepare_condition_kwargs"]

VECTOR_COND_METHODS = (
    "label", "attr", "feat", "knn_feat", "patchfeat", "centroid",
    "labelcentroid", "cluster", "clustermix", "clusterrandom",
    "labelcluster", "patchcluster",
)
LAYOUT_COND_METHODS = ("clusterlayout", "layout", "stegoclusterlayout")


def prepare_condition_kwargs(
    condition_method: str | None,
    batch: Mapping[str, Any],
    *,
    cond_drop_prob: float | None = None,
    training: bool = True,
    condition_cfg: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """Return {cond_drop_prob, cond[, image_batch_ids]} for the denoiser."""
    del condition_cfg  # read by the layout methods only
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
    elif condition_method in LAYOUT_COND_METHODS:
        raise NotImplementedError(f"layout condition {condition_method!r} is not ported yet")
    else:
        raise ValueError(condition_method)
    return out
