"""Build denoiser modules from reference-style config params.

Port of `sgdm_tpu/models/factory.py` for the concat-conditioning
`UNetModel` family.  `create_denoiser` takes the params of a
``configs/dynamic/*.yaml`` group (keys that only matter elsewhere, such as
``image_size`` or ``use_checkpoint``, are accepted and not used).
`init_train_params` draws the training init (flax's distributions);
`init_random_params` draws nonzero weights everywhere for the chip checks.
The machine with the card has no YAML parser, so the IN64 headline model
is also written out here as `UNET_FAST_IN64`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .unet import UNetModel

__all__ = ["create_denoiser", "init_random_params", "init_train_params", "UNET_FAST_IN64"]

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

_UNET_KEYS = {
    "in_channels", "model_channels", "out_channels", "num_res_blocks",
    "attention_resolutions", "channel_mult", "num_heads", "num_head_channels",
    "resblock_updown", "cond_dim", "condition_method", "layout_dim",
    "lookup_table_size", "dropout",
}


def create_denoiser(dtype: torch.dtype = torch.float32, **params: Any) -> UNetModel:
    """A `UNetModel` from reference-style params (compute ``dtype``, f32 params)."""
    if params.get("use_ca_block") or "cond_token_num" in params:
        raise NotImplementedError("UNetCAModel is not ported yet")
    if params.get("use_scale_shift_norm", True) is not True:
        raise NotImplementedError("the port's ResBlock takes scale-shift norm only")
    kwargs = {k: v for k, v in params.items() if k in _UNET_KEYS and v is not None}
    method = kwargs.get("condition_method")
    if "layout_dim" not in kwargs and isinstance(params.get("condition"), dict):
        layout_dim = (params["condition"].get(method) or {}).get("layout_dim")
        if layout_dim is not None:
            kwargs["layout_dim"] = int(layout_dim)
    for key in ("attention_resolutions", "channel_mult"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    return UNetModel(dtype=dtype, **kwargs)


@torch.no_grad()
def init_random_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter from ``numpy.random.default_rng(seed)``, in place.

    Weights get N(0, 1/fan_in); GroupNorm scales 1 + N(0, 0.1²); biases
    N(0, 0.1²).  Unlike the training init nothing is zero (not the output
    conv, not proj_out), so random-weight runs exercise every block.
    """
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            val = 0.1 * rng.standard_normal(shape)
        elif p.ndim == 1:  # GroupNorm scale
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
    GroupNorm scale 1 and bias 0, zero ``out_conv`` / ``proj_out`` kernels,
    embedding tables N(0, 1/features).  The same distributions, not flax's
    numbers: jax.random cannot be reproduced here."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        shape = tuple(p.shape)
        if leaf == "bias":
            val = np.zeros(shape)
        elif isinstance(mod, torch.nn.Embedding):
            val = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif p.ndim == 1:  # GroupNorm scale
            val = np.ones(shape)
        elif owner.rsplit(".", 1)[-1] in _ZERO_INIT:
            val = np.zeros(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            # 0.8796…: the std of a standard normal truncated to [-2, 2]
            val = _truncated_normal(rng, shape) / np.sqrt(fan_in) / 0.87962566103423978
        p.copy_(torch.as_tensor(val, dtype=p.dtype))
    return model
