"""ADM-UNet building blocks (NHWC at the public boundary).

Port of `sgdm_tpu/models/layers.py`.  As in the JAX package:

  * activations are NHWC; parameters live in float32 and are cast to the
    compute ``dtype`` at use;
  * GroupNorm runs in float32 (groups = gcd(32, C)) and casts back;
  * attention scales BOTH q and k by d^-1/4, softmax in float32, and the
    qkv projection's columns are ordered [3, heads, d];
  * nearest 2× upsampling is a broadcast.

Submodules and parameters are named after the flax tree (``in_norm``,
``in_conv``, ``emb_proj``, ``out_norm``, ``out_conv``, ``skip_proj``,
``qkv``, ``proj_out`` …) so `convert.from_flax` maps each flax leaf to one
parameter: conv ``kernel`` HWIO ↔ ``weight`` OIHW, dense ``kernel``
[in, out] ↔ ``weight`` [out, in], GroupNorm ``scale`` ↔ ``weight``.

``ResBlock`` always computes the fused formulation (the JAX package's
sampling path, ``use_pallas=True``); its ``kernels`` attribute plays the
part of ``use_pallas``: True (the default) calls `ops.fused_resblock` /
`ops.fused_self_attention`, which launch the CUDA kernels on CUDA tensors;
False calls their plain versions, so a caller can run the same model
through both on the card and compare.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import fused_self_attention, self_attention_plain
from ..ops.resblock import fused_resblock, resblock_plain, upsample_nearest2x

__all__ = [
    "timestep_embedding", "Dense", "Conv", "ConvParams", "GroupNorm32", "ResBlock",
    "SelfAttentionBlock", "Upsample", "Downsample", "upsample_nearest2x", "set_kernels",
]


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, [N] -> [N, dim] f32, cos‖sin order (odd dim zero-padded)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dense(nn.Module):
    """flax ``nn.Dense``: f32 ``weight`` [out, in] and ``bias``, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class ConvParams(nn.Module):
    """Parameter holder for a conv the fused ResBlock consumes: ``weight`` OIHW, ``bias``."""

    def __init__(self, in_features: int, out_features: int, ksize: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def hwio(self) -> torch.Tensor:
        """The kernel in flax's HWIO layout ([kh, kw, Cin, Cout], a view)."""
        return self.weight.permute(2, 3, 1, 0)


class Conv(ConvParams):
    """flax ``nn.Conv`` on NHWC input, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, ksize: int = 3, stride: int = 1,
                 padding: int = 1, dtype=torch.float32):
        super().__init__(in_features, out_features, ksize)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), self.weight.to(self.dtype),
                       self.bias.to(self.dtype), stride=self.stride, padding=self.padding)
        return out.permute(0, 2, 3, 1)


class GroupNorm32(nn.Module):
    """GroupNorm with gcd(32, C) groups, in float32, cast back to the input dtype."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.groups = math.gcd(num_groups, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups, eps=1e-5)
        return (xn.permute(0, 2, 3, 1) * self.weight + self.bias).to(x.dtype)


class Upsample(nn.Module):
    """2× nearest upsample + 3×3 conv (flax name of the conv: ``Conv_0``)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(upsample_nearest2x(x))


class Downsample(nn.Module):
    """Stride-2 3×3 conv (flax name of the conv: ``Conv_0``)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class ResBlock(nn.Module):
    """Residual block with scale-shift-norm FiLM, through the fused ResBlock op.

    Covers the JAX package's fused gate: scale-shift norm, identity or 1×1
    projection skip, and the ``up``/``down`` resblock_updown variants
    (identity skip).  Dropout is a training feature and is not taken here.
    """

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, *,
                 up: bool = False, down: bool = False, dtype=torch.float32):
        super().__init__()
        if (up or down) and in_channels != out_channels:
            raise ValueError("up/down ResBlocks keep the channel count")
        self.resample = "up" if up else ("down" if down else None)
        self.dtype = dtype
        self.kernels = True
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = ConvParams(in_channels, out_channels, 3)
        self.emb_proj = Dense(emb_channels, 2 * out_channels, dtype=dtype)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = ConvParams(out_channels, out_channels, 3)
        self.skip_proj = (ConvParams(in_channels, out_channels, 1)
                          if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        emb_out = self.emb_proj(F.silu(emb))
        film_scale, film_shift = emb_out.chunk(2, dim=-1)
        skw = skb = None
        if self.skip_proj is not None:
            skw, skb = self.skip_proj.hwio(), self.skip_proj.bias
        args = (x.to(self.dtype), self.in_norm.weight, self.in_norm.bias,
                self.in_conv.hwio(), self.in_conv.bias, film_scale, film_shift,
                self.out_norm.weight, self.out_norm.bias, self.out_conv.hwio(),
                self.out_conv.bias, skw, skb)
        if self.kernels:
            return fused_resblock(*args, resample=self.resample)
        return resblock_plain(*args, resample=self.resample)


class SelfAttentionBlock(nn.Module):
    """Spatial self-attention: GN → qkv → per-head attention → zero-init proj_out → residual."""

    def __init__(self, channels: int, num_heads: int = 8, num_head_channels: int = -1,
                 dtype=torch.float32):
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"{channels} channels not divisible by {num_head_channels}")
            self.heads = channels // num_head_channels
        self.dtype = dtype
        self.kernels = True
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        n, d = hh * ww, c // self.heads
        h = self.norm(x).reshape(b, n, c)
        qkv = self.qkv(h).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)  # [b, heads, n, d] each
        attn = fused_self_attention if self.kernels else self_attention_plain
        out = attn(q, k, v).permute(0, 2, 1, 3).reshape(b, n, c)
        out = self.proj_out(out)
        return x + out.reshape(b, hh, ww, c)


def set_kernels(module: nn.Module, enabled: bool) -> None:
    """Route every ResBlock / SelfAttentionBlock under ``module`` through the
    kernels (True) or their plain versions (False)."""
    for m in module.modules():
        if isinstance(m, (ResBlock, SelfAttentionBlock)):
            m.kernels = enabled
