"""`jax.image.resize`'s linear and cubic resampling, as separable matmuls.

The JAX package resizes with ``jax.image.resize`` in three places the
self-labeling path runs: the backbone's input transform (64 → 224 for
IN64, 300 → 224 for VOC's ``img4unsup``), the ViT's position-embedding
grid off the 224 grid (cubic) and the token grid of the spatial features
(linear).  ``torch.nn.functional.interpolate`` gives other numbers, so
this module rebuilds JAX's weights (`jax._src.image.scale
compute_weight_mat`):

* half-pixel centres: output ``i`` samples input ``(i + 0.5) / scale - 0.5``;
* when downsampling (``antialias``, JAX's default) the kernel is widened by
  ``1 / scale``, a low-pass filter and an interpolation in one;
* each output's weights are renormalised over the taps inside the input;
  an output whose sample lies outside ``[-0.5, in - 0.5]`` is zero;
* the triangle kernel for ``linear`` and Keys' cubic with a = -0.5 for
  ``cubic`` (torch's bicubic takes a = -0.75).

Weights are computed in float32 with JAX's order of operations and applied
per resized axis as one matmul, in the input's dtype, on its device.
``scale_and_translate_weights`` holds these rules at a float scale and
translation (``jax.image.scale_and_translate``), batched; the v-diffusion
CLI's cutouts take their weights from it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["resize", "resize_weights", "scale_and_translate_weights"]

_LINEAR = ("linear", "bilinear", "trilinear", "triangle")
_CUBIC = ("cubic", "bicubic", "tricubic")


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def scale_and_translate_weights(in_size: int, out_size: int, inv_scale: torch.Tensor,
                                translation: torch.Tensor, method: str = "linear",
                                antialias: bool = True) -> torch.Tensor:
    """``jax.image.scale_and_translate``'s weights, float32 [..., in_size,
    out_size]: output ``i`` samples input ``(i + 0.5 - translation) /
    scale - 0.5``.  ``inv_scale`` (1 / scale) and ``translation`` are float32
    tensors of one batch shape ``...``, one weight matrix each."""
    if method in _LINEAR:
        kernel = _triangle
    elif method in _CUBIC:
        kernel = _keys_cubic
    else:
        raise ValueError(f"resize method {method!r}: only linear and cubic are ported")
    f32, dev = torch.float32, inv_scale.device
    inv = inv_scale[..., None]
    kernel_scale = torch.clamp(inv, min=1.0) if antialias else torch.ones_like(inv)
    sample_f = ((torch.arange(out_size, dtype=f32, device=dev) + 0.5) * inv
                - translation[..., None] * inv - 0.5)
    x = (sample_f[..., None, :] - torch.arange(in_size, dtype=f32, device=dev)[:, None]).abs() \
        / kernel_scale[..., None]
    w = kernel(x)
    total = w.sum(-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros_like(w))


def resize_weights(in_size: int, out_size: int, method: str = "linear",
                   antialias: bool = True, device: torch.device | str | None = None
                   ) -> torch.Tensor:
    """float32 [in_size, out_size]: column ``i`` holds output ``i``'s weights."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)           # a Python float, as JAX's
    return scale_and_translate_weights(
        in_size, out_size, torch.tensor(inv_scale, dtype=f32, device=device),
        torch.zeros((), dtype=f32, device=device), method, antialias)


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` for ``linear`` and
    ``cubic``: every axis whose size changes is resampled; the rest pass
    through.  Float input only; the result has ``x``'s dtype."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} has {len(shape)} axes, the input {x.ndim}")
    if not x.is_floating_point():
        raise TypeError(f"resize takes a float tensor, not {x.dtype}")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = resize_weights(n_in, n_out, method, antialias, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
