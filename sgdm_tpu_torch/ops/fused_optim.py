"""Fused AdamW + EMA update: CUDA kernel (K8) and its plain version.

Replaces the Pallas TPU kernel `sgdm_tpu/ops/pallas/fused_optim.py`
`make_fused_adamw_ema` (`_leaf_pallas` → `_kernel`), one pass per step:

    mu = mu·b1 + g·(1−b1);  nu = nu·b2 + g·g·(1−b2)
    p' = p − lr·((mu·inv_bc1) / (√(nu·inv_bc2) + eps) + wd·p)
    e' = e − (1−d)·(e − p')

optax-exact AdamW (lr(count) read before the count's increment, bias
correction with the count after it, decoupled weight decay, eps outside
the square root) and the LitEma update.  The scalars come from
`adamw_ema_scalars`.  The port keeps parameters, μ, ν and the EMA as flat
f32 buffers, so one call updates the whole tree **in place**.  On CUDA
tensors `fused_adamw_ema` launches ``csrc/fused_optim.cu`` (counted in
``adamw_ema_cuda.launches``) or raises; on CPU tensors it runs
`adamw_ema_plain`, whose every operation rounds as the kernel's does.
f32 μ only: the JAX package's bf16-μ knob is not ported.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from .build import library

__all__ = ["adamw_ema_scalars", "adamw_ema_plain", "adamw_ema_cuda", "fused_adamw_ema"]


def adamw_ema_scalars(lr_schedule: Callable[[int], float], count: int, ema_updates: int, *,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      weight_decay: float = 1e-2, ema_decay: float = 0.9999,
                      use_ema: bool = True) -> dict[str, float]:
    """The update's f32 scalars, as `make_fused_adamw_ema.update` computes them
    (``count`` is optax's pre-increment count; ``ema_updates`` LitEma's)."""
    f32 = np.float32
    t = f32(count + 1)
    one = f32(1.0)
    inv_bc1 = one / (one - f32(b1) ** t)
    inv_bc2 = one / (one - f32(b2) ** t)
    if use_ema:
        n = f32(ema_updates + 1)
        d = min(f32(ema_decay), (one + n) / (f32(10.0) + n))
        one_minus = one - f32(d)
    else:
        one_minus = one  # ema ≡ params
    vals = dict(lr=lr_schedule(count), inv_bc1=inv_bc1, inv_bc2=inv_bc2, one_minus=one_minus,
                b1=b1, omb1=1.0 - b1, b2=b2, omb2=1.0 - b2, eps=eps, wd=weight_decay)
    return {k: float(f32(v)) for k, v in vals.items()}


def adamw_ema_plain(p, g, mu, nu, ema, *, lr, inv_bc1, inv_bc2, one_minus, b1, omb1, b2,
                    omb2, eps, wd) -> None:
    """K8's arithmetic on f32 tensors, in place, one rounding per operation."""
    mu.copy_(mu * b1 + g * omb1)
    nu.copy_(nu * b2 + g * g * omb2)
    upd = (mu * inv_bc1) / (torch.sqrt(nu * inv_bc2) + eps) + wd * p
    p.copy_(p - lr * upd)
    ema.copy_(ema - one_minus * (ema - p))


def _lib():
    lib = library("fused_optim")
    if not getattr(lib, "_sgdm_typed", False):
        vp, f = ctypes.c_void_p, ctypes.c_float
        lib.sgdm_adamw_ema.argtypes = [vp] * 5 + [ctypes.c_longlong] + [f] * 10 + [vp]
        lib.sgdm_adamw_ema.restype = ctypes.c_int
        lib._sgdm_typed = True
    return lib


_ORDER = ("lr", "inv_bc1", "inv_bc2", "one_minus", "b1", "omb1", "b2", "omb2", "eps", "wd")


def adamw_ema_cuda(p, g, mu, nu, ema, **scalars) -> None:
    """K8 on the CUDA kernel: contiguous f32 tensors of one size on one card."""
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu), ("ema", ema)):
        if not t.is_cuda:
            raise ValueError("CUDA kernel wrapper called with a CPU tensor")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: K8 takes contiguous f32, got {t.dtype}")
        if t.numel() != p.numel() or t.device != p.device:
            raise ValueError(f"{name}: size/device {t.numel()}/{t.device} != p's")
    stream = ctypes.c_void_p(torch.cuda.current_stream(p.device).cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _lib().sgdm_adamw_ema(ptr(p), ptr(g), ptr(mu), ptr(nu), ptr(ema), p.numel(),
                                *(scalars[k] for k in _ORDER), stream)
    if err != 0:
        raise RuntimeError(f"adamw_ema: CUDA error {err}")
    adamw_ema_cuda.launches += 1


adamw_ema_cuda.launches = 0


def fused_adamw_ema(p, g, mu, nu, ema, scalars: dict[str, float], *,
                    kernels: bool = True) -> None:
    """One in-place AdamW + EMA step over flat f32 buffers: K8 on CUDA
    tensors, the plain version on CPU tensors or when ``kernels`` is False."""
    if kernels and p.is_cuda:
        adamw_ema_cuda(p, g, mu, nu, ema, **scalars)
    elif not kernels or p.device.type == "cpu":
        adamw_ema_plain(p, g, mu, nu, ema, **scalars)
    else:
        raise ValueError(f"no optimizer kernel for device {p.device}")
