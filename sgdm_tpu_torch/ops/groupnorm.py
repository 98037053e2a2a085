"""Fused GroupNorm(+FiLM)+SiLU: the CUDA kernel (K6) and its plain version.

K6 replaces the Pallas TPU kernel `sgdm_tpu/ops/pallas/groupnorm.py`
`fused_groupnorm_silu` (`_apply_kernel`), which the ResBlock's unfused
composition calls in sampling mode:

    out = silu((GN(x)·γ + β)·(1 + film_scale) + film_shift)   in x.dtype,

the whole chain in float32 and ONE cast at the end (the non-kernel
GroupNorm of `models/layers.py` rounds to the compute dtype after the
affine instead; in bf16 the two differ by a few bf16 ulps of the output).
As in the JAX package the per-(sample, group) statistics (E[x²] − mean²,
clamped at 0) are computed outside the kernel, which is the apply pass: on
the card by the GN-statistics kernel the ResBlock kernels already use
(``csrc/resblock.cu`` ``sgdm_gn_coef``: one block per sample, fixed-order
sums), in the plain version by `group_stats`.

On a CUDA tensor `fused_groupnorm_silu` calls `groupnorm_silu_cuda`, which
launches ``csrc/groupnorm.cu`` (one launch per call, counted in
``groupnorm_silu_cuda.launches``) or raises; on a CPU tensor, or with
``kernels=False``, it runs `groupnorm_silu_plain`.  The backward
recomputes through the plain version, as the TPU kernel's custom VJP
recomputes through its reference.
"""

from __future__ import annotations

import ctypes

import torch

from .build import library
from .resblock import _lib as _resblock_lib

__all__ = ["fused_groupnorm_silu", "groupnorm_silu_plain", "groupnorm_silu_cuda", "group_stats"]


def group_stats(x: torch.Tensor, num_groups: int, eps: float):
    """x [B, H, W, C] → per-(sample, group) f32 (mean, rstd), each [B, G]."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    return mean, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def groupnorm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         film_scale: torch.Tensor | None = None,
                         film_shift: torch.Tensor | None = None,
                         num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x [B, H, W, C], gamma/beta [C], film_* [B, C] or None: the kernel's arithmetic."""
    b, c = x.shape[0], x.shape[-1]
    gs = c // num_groups
    mean, rstd = group_stats(x, num_groups, eps)
    rep = lambda t: t.repeat_interleave(gs, dim=-1)[:, None, None, :]
    h = (x.float() - rep(mean)) * rep(rstd)
    h = h * gamma.float() + beta.float()
    if film_scale is not None:
        h = h * (1.0 + film_scale.float().reshape(b, 1, 1, c)) \
            + film_shift.float().reshape(b, 1, 1, c)
    return (h * torch.sigmoid(h)).to(x.dtype)


def _lib():
    lib = library("groupnorm")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sgdm_groupnorm_silu.argtypes = [vp] * 8 + [i] * 4 + [vp]
        lib.sgdm_groupnorm_silu.restype = i
        lib._sgdm_typed = True
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def groupnorm_silu_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        film_scale: torch.Tensor | None = None,
                        film_shift: torch.Tensor | None = None,
                        num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """K6 on the CUDA kernel: bf16, contiguous NHWC on one card; C up to
    3072 when a multiple of 8, else up to 512 (the statistics kernel's block)."""
    if not x.is_cuda:
        raise ValueError("CUDA kernel wrapper called with a CPU tensor")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the GroupNorm+SiLU kernel takes bf16 activations, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got {tuple(x.shape)}")
    b, hh, ww, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift come together")
    want = {"gamma": (gamma, (c,)), "beta": (beta, (c,))}
    if film_scale is not None:
        want.update(film_scale=(film_scale, (b, c)), film_shift=(film_shift, (b, c)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} != {shape} on {x.device}")
    chunks = c // 8 if c % 8 == 0 else c  # the statistics kernel: 512 threads, 48 KB
    if chunks > 512 or (2 * (512 // chunks) * c + 2 * c) * 4 > 48 * 1024:
        raise ValueError(f"channel count {c} beyond the GN statistics kernel")
    if c % 8 == 0 and x.data_ptr() % 16:
        x = x.clone()
    f32 = lambda t: None if t is None else t.detach().float().contiguous()
    gamma, beta, fs, fsh = f32(gamma), f32(beta), f32(film_scale), f32(film_shift)
    coef = torch.empty((b, 3, c), device=x.device, dtype=torch.float32)
    rstd = torch.empty((b, c), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    err = _resblock_lib().sgdm_gn_coef(_ptr(x), 0, b, hh * ww, c, num_groups, eps, _ptr(gamma),
                                       _ptr(beta), None, None, _ptr(coef), _ptr(rstd), stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_silu statistics: CUDA error {err}")
    err = _lib().sgdm_groupnorm_silu(_ptr(x), _ptr(coef), _ptr(rstd), _ptr(gamma), _ptr(beta),
                                     _ptr(fs), _ptr(fsh), _ptr(out), b, hh * ww, c, sms, stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_silu: CUDA error {err}")
    groupnorm_silu_cuda.launches += 1
    return out


groupnorm_silu_cuda.launches = 0


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, film_scale, film_shift, num_groups, eps, kernels):
        if kernels and x.is_cuda:
            out = groupnorm_silu_cuda(x, gamma, beta, film_scale, film_shift, num_groups, eps)
        elif not kernels or x.device.type == "cpu":
            out = groupnorm_silu_plain(x, gamma, beta, film_scale, film_shift, num_groups, eps)
        else:
            raise ValueError(f"no GroupNorm+SiLU kernel for device {x.device}")
        ctx.save_for_backward(x, gamma, beta, film_scale, film_shift)
        ctx.cfg = (num_groups, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_() for t in saved]
            out = groupnorm_silu_plain(*leaves, *ctx.cfg)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, live, g.to(out.dtype)))
        return (*(None if t is None else next(grads) for t in leaves), None, None, None)


def fused_groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         film_scale: torch.Tensor | None = None,
                         film_shift: torch.Tensor | None = None,
                         num_groups: int = 32, eps: float = 1e-5,
                         kernels: bool = True) -> torch.Tensor:
    """silu((GN(x)·γ+β)[·(1+film_scale)+film_shift]) for NHWC ``x``, in x.dtype."""
    return _GroupNormSiLU.apply(x, gamma, beta, film_scale, film_shift, int(num_groups),
                                float(eps), bool(kernels))
