"""Shared helpers for the `sgdm_tpu_torch` parity tests (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both
packages; everything runs in float32 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from flax import traverse_util

SMALL_UNET = dict(
    model_channels=32, channel_mult=(1, 2, 2), num_res_blocks=1,
    attention_resolutions=(2,), num_heads=4, cond_dim=10,
)


def perturbed_flat(params, seed: int) -> dict[str, np.ndarray]:
    """Flatten a flax param tree (arrays or shape structs) with '/' and give
    EVERY leaf a random value (zero-initialised out_conv / proj_out
    included): kernels N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.1²),
    biases N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params, sep="/")
    out = {}
    for path in sorted(flat):
        shape = tuple(flat[path].shape)
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "bias":
            val = 0.1 * rng.standard_normal(shape)
        elif leaf == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "embedding":
            val = rng.standard_normal(shape)
        else:
            val = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        out[path] = val.astype(np.float32)
    return out


def unflatten(flat: dict[str, np.ndarray]):
    import jax.numpy as jnp

    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def t32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))
