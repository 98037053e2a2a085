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

Two routes, as in the JAX package's two Pallas modes:

  * sampling (``train=False``, the JAX package's ``use_pallas=True``):
    every ResBlock is the fused formulation (`ops.fused_resblock`, K1/K2)
    and attention is `ops.fused_self_attention` (K3);
  * training (``train=True``, ``use_pallas="fused"``): same-resolution
    ResBlocks take `ops.fused_resblock_train` (K4 forward, K5 backward,
    dropout by the kernels' counter hash); the up/down ResBlocks take the
    composition GN → SiLU → resample → conv → FiLM-GN → SiLU → dropout →
    conv → skip in plain PyTorch ops (the JAX package computes them outside
    any Pallas kernel in this mode), with dropout drawn from a
    `torch.Generator` seeded per block; attention takes `ops.flash_attention`
    (K9) where the JAX package's flash gate passes (N ≥ 128, d % 64 == 0)
    and the einsum path otherwise.

The ``kernels`` attribute plays the part of ``use_pallas``: True (the
default) calls the ops above, which launch the CUDA kernels on CUDA
tensors; False calls their plain versions, so a caller can run the same
model through both on the card and compare.  ``dropout_seed`` (training)
is turned into one seed per block by `block_seed`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import flash_attention, fused_self_attention, self_attention_plain
from ..ops.resblock import fused_resblock, fused_resblock_train, resblock_plain, \
    upsample_nearest2x

__all__ = [
    "timestep_embedding", "Dense", "Conv", "ConvParams", "GroupNorm32", "ResBlock",
    "SelfAttentionBlock", "Upsample", "Downsample", "upsample_nearest2x", "set_kernels",
    "block_seed",
]


def block_seed(seed: int, index: int) -> int:
    """The dropout seed of block ``index`` for a step's ``seed`` (an int32 ≥ 0)."""
    return (int(seed) * 1_000_003 + 7_919 * (index + 1)) & 0x7FFFFFFF


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

    def conv(self, x: torch.Tensor, dtype, stride: int = 1, padding: int = 1) -> torch.Tensor:
        """flax ``nn.Conv`` on NHWC ``x`` with these parameters, computed in ``dtype``."""
        out = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), self.weight.to(dtype),
                       self.bias.to(dtype), stride=stride, padding=padding)
        return out.permute(0, 2, 3, 1)


class Conv(ConvParams):
    """flax ``nn.Conv`` on NHWC input, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, ksize: int = 3, stride: int = 1,
                 padding: int = 1, dtype=torch.float32):
        super().__init__(in_features, out_features, ksize)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.dtype, self.stride, self.padding)


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
    """Residual block with scale-shift-norm FiLM.

    Covers the JAX package's fused gate: scale-shift norm, identity or 1×1
    projection skip, and the ``up``/``down`` resblock_updown variants
    (identity skip).  ``dropout`` acts on h3 in training only.
    ``block_index`` (set by the backbone) picks the block's dropout seed.
    """

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, *,
                 up: bool = False, down: bool = False, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        if (up or down) and in_channels != out_channels:
            raise ValueError("up/down ResBlocks keep the channel count")
        self.resample = "up" if up else ("down" if down else None)
        self.dtype = dtype
        self.dropout = float(dropout)
        self.block_index = 0
        self.kernels = True
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = ConvParams(in_channels, out_channels, 3)
        self.emb_proj = Dense(emb_channels, 2 * out_channels, dtype=dtype)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = ConvParams(out_channels, out_channels, 3)
        self.skip_proj = (ConvParams(in_channels, out_channels, 1)
                          if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, train: bool = False,
                dropout_seed: int = 0) -> torch.Tensor:
        if train and self.resample is not None:
            return self._composition(x, emb, dropout_seed)
        emb_out = self.emb_proj(F.silu(emb))
        film_scale, film_shift = emb_out.chunk(2, dim=-1)
        skw = skb = None
        if self.skip_proj is not None:
            skw, skb = self.skip_proj.hwio(), self.skip_proj.bias
        args = (x.to(self.dtype), self.in_norm.weight, self.in_norm.bias,
                self.in_conv.hwio(), self.in_conv.bias, film_scale, film_shift,
                self.out_norm.weight, self.out_norm.bias, self.out_conv.hwio(),
                self.out_conv.bias, skw, skb)
        if train:
            return fused_resblock_train(
                *args, block_seed(dropout_seed, self.block_index), dropout_rate=self.dropout,
                kernels=self.kernels)
        if self.kernels:
            return fused_resblock(*args, resample=self.resample)
        return resblock_plain(*args, resample=self.resample)

    def _composition(self, x: torch.Tensor, emb: torch.Tensor, dropout_seed: int) -> torch.Tensor:
        """The up/down block in training (`layers.py ResBlock` fallback path):
        GroupNorm's affine in f32, then FiLM and SiLU in the compute dtype."""
        dt = self.dtype
        x = x.to(dt)
        h = F.silu(self.in_norm(x))
        if self.resample == "up":
            h, x = upsample_nearest2x(h), upsample_nearest2x(x)
        else:
            pool = lambda t: t.reshape(t.shape[0], t.shape[1] // 2, 2, t.shape[2] // 2, 2,
                                       t.shape[3]).mean(dim=(2, 4))
            h, x = pool(h), pool(x)
        h = self.in_conv.conv(h, dt)
        scale, shift = self.emb_proj(F.silu(emb)).chunk(2, dim=-1)
        h = self.out_norm(h)
        h = F.silu(h * (1.0 + scale.to(dt)[:, None, None, :]) + shift.to(dt)[:, None, None, :])
        if self.dropout > 0.0:
            gen = torch.Generator(device=h.device)
            gen.manual_seed(block_seed(dropout_seed, self.block_index))
            keep = torch.rand(h.shape, generator=gen, device=h.device) >= self.dropout
            h = torch.where(keep, h / (1.0 - self.dropout), torch.zeros_like(h))
        h = self.out_conv.conv(h, dt)
        return x + h


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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, hh, ww, c = x.shape
        n, d = hh * ww, c // self.heads
        h = self.norm(x).reshape(b, n, c)
        qkv = self.qkv(h).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)  # [b, heads, n, d] each
        if not train:
            attn = fused_self_attention if self.kernels else self_attention_plain
            out = attn(q, k, v)
        elif n >= 128 and d % 64 == 0 and n % min(512, n) == 0:  # layers.py:400-409
            out = flash_attention(q, k, v, kernels=self.kernels)
        else:  # the einsum path, layers.py:433-442
            s = 1.0 / (d ** 0.25)
            logits = torch.matmul((q * s).float(), (k * s).float().transpose(-1, -2))
            weights = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.matmul(weights, v.to(x.dtype))
        out = out.permute(0, 2, 1, 3).reshape(b, n, c)
        out = self.proj_out(out)
        return x + out.reshape(b, hh, ww, c)


def set_kernels(module: nn.Module, enabled: bool) -> None:
    """Route every module under ``module`` that has a ``kernels`` switch
    (ResBlock, SelfAttentionBlock, the model itself, which the train step
    reads for the optimizer kernel) through the kernels (True) or their
    plain versions (False)."""
    for m in module.modules():
        if hasattr(m, "kernels"):
            m.kernels = enabled
