"""Sampling self-attention: CUDA kernel (K3) and its plain version.

Replaces the Pallas TPU kernel `sgdm_tpu/ops/pallas/attention.py`
`fused_self_attention` (`_self_attn_kernel`), forward only:

    out = softmax((q·s)(k·s)ᵀ) v,   s = d^-1/4 on BOTH q and k,

with f32 logits and softmax, the weights cast to v's dtype before the PV
product, accumulated in f32.  On a CUDA tensor `fused_self_attention`
calls `self_attention_cuda`, which launches ``csrc/attention.cu`` (one
launch per call; see that file for the design and what bounds it) or
raises; on a CPU tensor it runs `self_attention_plain`.  The kernel's
launches are counted in ``self_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import library

__all__ = ["fused_self_attention", "self_attention_plain", "self_attention_cuda"]


def self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, N, D] → [B, H, N, D], the kernel's arithmetic."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    logits = torch.matmul(q.float() * scale, (k.float() * scale).transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def _lib():
    lib = library("attention")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgdm_self_attention.argtypes = [vp, vp, vp, vp, i, i, i, f, vp]
        lib.sgdm_self_attention.restype = i
        lib.sgdm_attention_max_n.argtypes = [i]
        lib.sgdm_attention_max_n.restype = i
        lib._sgdm_typed = True
    return lib


def self_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3 on the CUDA kernel: bf16, contiguous [B, H, N, D] on one card."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the attention kernel takes bf16, got {t.dtype}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name}: shape/device {tuple(t.shape)}/{t.device} != q's")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [B, H, N, D]")
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, N, D], got {tuple(q.shape)}")
    b, h, n, d = q.shape
    lib = _lib()
    max_n = lib.sgdm_attention_max_n(d)
    if max_n == 0:
        raise ValueError(f"head dim {d} not supported by the kernel (32, 64 or 128)")
    if n > max_n:
        raise ValueError(f"sequence length {n} beyond the kernel's shared memory (max {max_n})")
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    scale2 = (1.0 / (d ** 0.25)) ** 2
    err = lib.sgdm_self_attention(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                                  ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                                  b * h, n, d, scale2, stream)
    if err != 0:
        raise RuntimeError(f"self_attention: CUDA error {err}")
    self_attention_cuda.launches += 1
    return out


self_attention_cuda.launches = 0


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, N, D] → out [B, H, N, D] (scale d^-1/4 on q and k)."""
    if q.is_cuda:
        return self_attention_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {q.device}")
    return self_attention_plain(q, k, v)
