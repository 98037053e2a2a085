"""Build denoiser modules from reference-style config params.

Port of `sgdm_tpu/models/factory.py`.  `create_denoiser` takes the params
of a ``configs/dynamic/*.yaml`` group (keys that only matter elsewhere,
such as ``image_size`` or ``use_checkpoint``, are accepted and not used)
and builds a `UNetModel`, or a `UNetCAModel` where the JAX factory does
(``use_ca_block: true`` or an explicit ``cond_token_num``).  The flax
modules infer the layout channels from the layout they are given; a torch
module must know them when it is built, so ``layout_dim`` comes from the
params or their nested ``condition`` group.
`init_train_params` draws the training init (flax's distributions);
`init_random_params` draws nonzero weights everywhere for the chip checks.
The machine with the card has no YAML parser, so the two headline models
are also written out here: `UNET_FAST_IN64` and `UNETCA_FAST_VOC64`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .unet import UNetCAModel, UNetModel

__all__ = ["create_denoiser", "init_random_params", "init_train_params", "UNET_FAST_IN64",
           "UNETCA_FAST_VOC64"]

# configs/dynamic/unet_fast.yaml params composed at data.image_size = 64
# (data=in64_pickle), without the nested `condition` group
UNET_FAST_IN64 = {
    "image_size": 64,
    "in_channels": 3,
    "out_channels": 3,
    "dropout": 0.1,
    "model_channels": 128,
    "attention_resolutions": [4],
    "num_res_blocks": 2,
    "channel_mult": [1, 2, 4],
    "num_heads": 8,
    "use_scale_shift_norm": True,
    "resblock_updown": True,
    "use_checkpoint": False,
    "cond_dim": None,
    "condition_method": None,
}

# configs/dynamic/unetca_fast.yaml params composed at data=voc64 with the
# VOC64 STEGO headline overrides (condition_method=stegoclusterlayout,
# cond_dim=21, dynamic.params.cond_token_num=1, dynamic.params.context_dim=32,
# condition.stegoclusterlayout.layout_dim=21: VOC's 21 classes in cond and
# layout), without the nested `condition` group: its layout_dim is written
# out as `layout_dim`
UNETCA_FAST_VOC64 = {
    "image_size": 64,
    "in_channels": 3,
    "out_channels": 3,
    "dropout": 0.0,
    "model_channels": 128,
    "attention_resolutions": [4],
    "num_res_blocks": 2,
    "channel_mult": [1, 2, 4],
    "num_heads": 8,
    "use_scale_shift_norm": True,
    "use_ca_block": True,
    "use_checkpoint": False,
    "cond_token_num": 1,
    "cond_dim": 21,
    "context_dim": 32,
    "use_cls_token_as_pooled": True,
    "condition_method": "stegoclusterlayout",
    "layout_dim": 21,
}

_COMMON_KEYS = {
    "in_channels", "model_channels", "out_channels", "num_res_blocks",
    "attention_resolutions", "channel_mult", "num_heads", "num_head_channels",
    "use_scale_shift_norm", "cond_dim", "condition_method", "layout_dim", "dropout",
}
_UNET_KEYS = _COMMON_KEYS | {"resblock_updown", "lookup_table_size"}
_CA_KEYS = _COMMON_KEYS | {"cond_token_num", "context_dim", "use_cls_token_as_pooled"}


def _implied_cond_dim(method: str | None, condition: Any) -> int:
    """The cond width of a CA model configured without ``cond_dim``.  The
    JAX model's first Dense takes its input width from the first ``cond`` it
    is initialised with; the port builds its layers up front, so it reads
    the width the batches will have from the config: `stegoclusterlayout`'s
    ``cond`` is the n-hot of the STEGO classes, ``stego_k`` wide (the README's
    COCO-Stuff64 command sets no ``cond_dim``)."""
    stego_k = ((condition or {}).get(method) or {}).get("stego_k") if isinstance(
        condition, dict) else None
    if method == "stegoclusterlayout" and stego_k:
        return int(stego_k)
    raise ValueError(f"condition_method={method!r} with cond_token_num >= 1 needs "
                     "sg.params.cond_dim (the width of the batches' cond)")


def create_denoiser(dtype: torch.dtype = torch.float32, **params: Any) -> torch.nn.Module:
    """A `UNetModel` or `UNetCAModel` from reference-style params (compute
    ``dtype``, f32 params)."""
    is_ca = bool(params.get("use_ca_block", False)) or "cond_token_num" in params
    keys = _CA_KEYS if is_ca else _UNET_KEYS
    kwargs = {k: v for k, v in params.items() if k in keys and v is not None}
    method = kwargs.get("condition_method")
    if is_ca and int(params.get("cond_token_num") or 0) >= 1 and params.get("cond_dim") is None:
        kwargs["cond_dim"] = _implied_cond_dim(method, params.get("condition"))
    if "layout_dim" not in kwargs and isinstance(params.get("condition"), dict):
        layout_dim = (params["condition"].get(method) or {}).get("layout_dim")
        if layout_dim is not None:
            kwargs["layout_dim"] = int(layout_dim)
    for key in ("attention_resolutions", "channel_mult"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    return (UNetCAModel if is_ca else UNetModel)(dtype=dtype, **kwargs)


@torch.no_grad()
def init_random_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter from ``numpy.random.default_rng(seed)``, in place.

    Weights get N(0, 1/fan_in); norm scales 1 + N(0, 0.1²); biases
    N(0, 0.1²); ``null_kv`` N(0, 1).  Unlike the training init nothing is
    zero (not the output conv, not proj_out), so random-weight runs exercise
    every block.
    """
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            val = 0.1 * rng.standard_normal(shape)
        elif name.endswith("null_kv"):
            val = rng.standard_normal(shape)
        elif p.ndim == 1:  # GroupNorm / LayerNorm scale
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:])) if p.ndim > 1 else 1
            if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), torch.nn.Embedding):
                fan_in = 1
            val = rng.standard_normal(shape) / np.sqrt(fan_in)
        p.copy_(torch.as_tensor(val, dtype=p.dtype))
    return model


def _truncated_normal(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
    """Standard normal truncated to [-2, 2], by redrawing what falls outside."""
    val = rng.standard_normal(shape)
    bad = np.abs(val) > 2.0
    while bad.any():
        val[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(val) > 2.0
    return val


# zero-initialised leaves of the JAX package (layers.py ResBlock out_conv,
# SelfAttentionBlock proj_out, unet.py UNetBackbone out_conv)
_ZERO_INIT = ("out_conv", "proj_out")


@torch.no_grad()
def init_train_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The training init of the flax modules, in place, from ``seed``:
    lecun-normal kernels (truncated normal, variance 1/fan_in), zero biases,
    norm scales 1 and biases 0, zero ``out_conv`` / ``proj_out`` kernels,
    embedding tables N(0, 1/features), ``null_kv`` N(0, 1).  The same
    distributions, not flax's numbers: jax.random cannot be reproduced here."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        shape = tuple(p.shape)
        if leaf == "bias":
            val = np.zeros(shape)
        elif isinstance(mod, torch.nn.Embedding):
            val = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif leaf == "null_kv":
            val = rng.standard_normal(shape)
        elif p.ndim == 1:  # GroupNorm / LayerNorm scale
            val = np.ones(shape)
        elif owner.rsplit(".", 1)[-1] in _ZERO_INIT:
            val = np.zeros(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            # 0.8796…: the std of a standard normal truncated to [-2, 2]
            val = _truncated_normal(rng, shape) / np.sqrt(fan_in) / 0.87962566103423978
        p.copy_(torch.as_tensor(val, dtype=p.dtype))
    return model
