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
    a ResBlock that passes the JAX package's fused gate (`ResBlock.
    fused_route`: scale-shift norm, no conv skip, width a multiple of 8,
    and for up/down blocks equal channels, even sides and a resampled
    width that is a multiple of 8) is the fused formulation
    (`ops.fused_resblock`, K1/K2); any other block is the unfused
    composition GN → SiLU → resample → conv → (FiLM-)GN → SiLU → conv →
    skip whose two GN(+FiLM)+SiLU stages are `ops.fused_groupnorm_silu`
    (K6); attention is `ops.fused_self_attention` (K3);
  * training (``train=True``, ``use_pallas="fused"``): same-resolution
    ResBlocks that pass the gate take `ops.fused_resblock_train` (K4
    forward, K5 backward, dropout by the kernels' counter hash); every other
    block takes the composition in plain PyTorch ops with autograd and the
    non-kernel GroupNorm (the JAX package computes them outside any Pallas
    kernel in this mode), with dropout drawn from a `torch.Generator` seeded
    per block; attention takes K9 (`ops.attention._packed_flash_attention`
    on the qkv projection) where the JAX package's flash gate passes
    (N ≥ 128, d % 64 == 0) and the einsum path otherwise.

A third route is the JAX package's ``use_pallas=False``, which a model
sets on the blocks it builds (``use_pallas=False`` here too: the
classifier's `models/encoder_unet.py`): its ResBlocks are the composition
with the non-kernel GroupNorm in training and in sampling, and its
attention takes K9 wherever the flash gate passes, in training and in
sampling alike (forward only without autograd), and the einsum path
otherwise; never K1-K6.

The ``kernels`` attribute is the switch between a kernel and its plain
version: True (the default) calls the ops above, which launch the CUDA
kernels on CUDA tensors; False calls their plain versions, so a caller can
run the same model through both on the card and compare.  ``dropout_seed`` (training)
is turned into one seed per block by `block_seed`.  ``flash`` False
(`set_routes`) forces the einsum attention, the route the JAX trainer takes
under sharded state; a module that `parallel.tp.shard_model` gave a shard
computes on it (``tp``, ``tp_role``), a ResBlock on its composition.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import _packed_flash_attention, fused_self_attention, self_attention_plain
from ..ops.groupnorm import fused_groupnorm_silu
from ..ops.resblock import fused_resblock, fused_resblock_train, resblock_plain, \
    upsample_nearest2x
from ..parallel import tp as tpx

__all__ = [
    "timestep_embedding", "Dense", "Conv", "ConvParams", "GroupNorm32", "ResBlock",
    "SelfAttentionBlock", "Upsample", "Downsample", "upsample_nearest2x", "set_kernels",
    "set_routes", "block_seed",
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
    """flax ``nn.Dense``: f32 ``weight`` [out, in] and (unless ``bias=False``)
    ``bias``, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    tp = tp_role = None  # set by `parallel.tp.shard_model`: "col" or "row"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.tp_role == "row":
            y = tpx.reduce(F.linear(x.to(self.dtype), w), self.tp)
            return y if bias is None else y + bias
        if self.tp_role == "col":
            x = tpx.enter(x, self.tp)
        return F.linear(x.to(self.dtype), w, bias)


class ConvParams(nn.Module):
    """Parameter holder for a conv the fused ResBlock consumes: ``weight`` OIHW, ``bias``."""

    def __init__(self, in_features: int, out_features: int, ksize: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def hwio(self) -> torch.Tensor:
        """The kernel in flax's HWIO layout ([kh, kw, Cin, Cout], a view)."""
        return self.weight.permute(2, 3, 1, 0)

    # set by `parallel.tp.shard_model`: "col" (output channels), "row" (input
    # channels: partial sums, bias once), "col_gather" (the stem: output
    # channels gathered), "row_slice" (the last conv: a replicated input)
    tp = tp_role = None

    def conv(self, x: torch.Tensor, dtype, stride: int = 1, padding: int = 1) -> torch.Tensor:
        """flax ``nn.Conv`` on NHWC ``x`` with these parameters, computed in ``dtype``."""
        role, tp = self.tp_role, self.tp
        if role in ("col", "col_gather"):
            x = tpx.enter(x, tp)
        elif role == "row_slice":
            x = tpx.local(tpx.enter(x, tp), tp)
        row = role in ("row", "row_slice")
        out = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), self.weight.to(dtype),
                       None if row else self.bias.to(dtype), stride=stride, padding=padding)
        out = out.permute(0, 2, 3, 1)
        if row:
            return tpx.reduce(out, tp) + self.bias.to(dtype)
        return tpx.gather(out, tp) if role == "col_gather" else out


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


def _pool2(t: torch.Tensor) -> torch.Tensor:
    """2×2 average pool, stride 2, of NHWC ``t`` (an odd last row or column is dropped)."""
    b, h, w, c = t.shape
    t = t[:, :h // 2 * 2, :w // 2 * 2]
    return t.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class ResBlock(nn.Module):
    """Residual block with FiLM time conditioning.

    ``use_scale_shift_norm`` (FiLM ``out_norm(h)·(1+scale)+shift``) or the
    additive form (``h + emb_out`` before ``out_norm``); identity, 1×1
    projection (``skip_proj``) or 3×3 (``use_conv_skip``: ``skip_conv``)
    skip; the ``up``/``down`` resblock_updown variants.  ``dropout`` acts in
    training only.  ``block_index`` (set by the backbone) picks the block's
    dropout seed.  `fused_route` is the JAX package's gate: it says whether a
    call takes the fused kernels or the unfused composition.  ``use_pallas``
    False is the JAX field of that name at False: the composition with the
    non-kernel GroupNorm on every call.
    """

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, *,
                 up: bool = False, down: bool = False, dropout: float = 0.0,
                 use_scale_shift_norm: bool = True, use_conv_skip: bool = False,
                 use_pallas: bool = True, dtype=torch.float32):
        super().__init__()
        self.use_pallas = use_pallas
        self.resample = "up" if up else ("down" if down else None)
        self.dtype = dtype
        self.dropout = float(dropout)
        self.use_scale_shift_norm = use_scale_shift_norm
        self.use_conv_skip = use_conv_skip
        self.in_channels, self.out_channels = in_channels, out_channels
        self.block_index = 0
        self.kernels = True
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = ConvParams(in_channels, out_channels, 3)
        self.emb_proj = Dense(emb_channels,
                              2 * out_channels if use_scale_shift_norm else out_channels,
                              dtype=dtype)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = ConvParams(out_channels, out_channels, 3)
        self.skip_proj = self.skip_conv = None
        if in_channels != out_channels:
            if use_conv_skip:
                self.skip_conv = ConvParams(in_channels, out_channels, 3)
            else:
                self.skip_proj = ConvParams(in_channels, out_channels, 1)

    tp = None  # set by `parallel.tp.shard_model` when the block holds a shard

    def fused_route(self, x: torch.Tensor, train: bool) -> bool:
        """Whether this call takes the fused ResBlock kernels: the gate of
        `sgdm_tpu/models/layers.py` ``ResBlock.__call__``, with ``train``
        standing for its ``use_pallas="fused"`` and ``not train`` for
        ``use_pallas=True``.  A tensor-parallel shard takes the composition."""
        w = x.shape[2]
        if self.tp is not None or not self.use_pallas:
            return False
        if not self.use_scale_shift_norm or self.use_conv_skip or w % 8:
            return False
        if self.resample is None:
            return True
        return (not train and self.in_channels == self.out_channels
                and (w * 2 if self.resample == "up" else w // 2) % 8 == 0
                and x.shape[1] % 2 == 0 and w % 2 == 0)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, train: bool = False,
                dropout_seed: int = 0, dropout_rows: tuple[int, int] | None = None
                ) -> torch.Tensor:
        """``dropout_rows`` (first row, rows): where ``x``'s rows sit in the
        batch whose dropout draws they share (a data-parallel rank's slice of
        the global batch); their masks are those rows of that batch's."""
        if not self.fused_route(x, train):
            return self._composition(x, emb, train, dropout_seed, dropout_rows)
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
            # the hash keys on seed + sample: row r of the global batch
            row0 = dropout_rows[0] if dropout_rows else 0
            return fused_resblock_train(
                *args, block_seed(dropout_seed, self.block_index) + row0,
                dropout_rate=self.dropout, kernels=self.kernels)
        if self.kernels:
            return fused_resblock(*args, resample=self.resample)
        return resblock_plain(*args, resample=self.resample)

    def _norm_silu(self, norm: GroupNorm32, h: torch.Tensor, train: bool,
                   scale: torch.Tensor | None = None,
                   shift: torch.Tensor | None = None) -> torch.Tensor:
        """silu(GN(h) [FiLM]): K6 (or its plain version) in sampling; in
        training, and on every call without ``use_pallas``, the non-kernel
        GroupNorm (affine in f32, then FiLM and SiLU in the compute dtype),
        which autograd differentiates."""
        if not train and self.use_pallas:
            return fused_groupnorm_silu(h.contiguous(), norm.weight, norm.bias, scale, shift,
                                        norm.groups, 1e-5, kernels=self.kernels)
        h = norm(h)
        if scale is not None:
            scale, shift = (t.to(h.dtype)[:, None, None, :] for t in (scale, shift))
            h = h * (1.0 + scale) + shift
        return F.silu(h)

    def _composition(self, x: torch.Tensor, emb: torch.Tensor, train: bool,
                     dropout_seed: int, dropout_rows: tuple[int, int] | None = None
                     ) -> torch.Tensor:
        """The unfused block (the fallback path of the JAX `ResBlock`).  Under
        tensor parallelism ``h`` holds this rank's channels between the convs."""
        dt, tp = self.dtype, self.tp
        x = x.to(dt)
        h = self._norm_silu(self.in_norm, x, train)
        if self.resample == "up":
            h, x = upsample_nearest2x(h), upsample_nearest2x(x)
        elif self.resample == "down":
            h, x = _pool2(h), _pool2(x)
        h = self.in_conv.conv(h, dt)
        emb_out = tpx.enter(self.emb_proj(F.silu(emb)), tp)
        if self.use_scale_shift_norm:
            scale, shift = (tpx.local(t, tp) for t in emb_out.chunk(2, dim=-1))
            h = self._norm_silu(self.out_norm, h, train, scale, shift)
        else:
            h = self._norm_silu(self.out_norm, h + tpx.local(emb_out, tp)[:, None, None, :],
                                train)
        if train and self.dropout > 0.0:
            # drawn for the whole batch and every channel, then this call's part
            gen = torch.Generator(device=h.device)
            gen.manual_seed(block_seed(dropout_seed, self.block_index))
            b, hh, ww, c = h.shape
            row0, rows = dropout_rows or (0, b)
            c0, cs = (0, c) if tp is None else (tp.rank * c, tp.size * c)
            u = torch.rand((rows, hh, ww, cs), generator=gen, device=h.device)
            keep = u[row0:row0 + b, ..., c0:c0 + c] >= self.dropout
            h = torch.where(keep, h / (1.0 - self.dropout), torch.zeros_like(h))
        h = self.out_conv.conv(h, dt)
        if self.skip_conv is not None:
            x = self.skip_conv.conv(x, dt)
        elif self.skip_proj is not None:
            x = self.skip_proj.conv(x, dt, padding=0)
        return x + h


class SelfAttentionBlock(nn.Module):
    """Spatial self-attention: GN → qkv → per-head attention → zero-init proj_out → residual.

    ``use_pallas`` False (the JAX field at False) leaves out K3: sampling
    takes the flash gate as training does."""

    def __init__(self, channels: int, num_heads: int = 8, num_head_channels: int = -1,
                 use_pallas: bool = True, dtype=torch.float32):
        super().__init__()
        self.use_pallas = use_pallas
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"{channels} channels not divisible by {num_head_channels}")
            self.heads = channels // num_head_channels
        self.dtype = dtype
        self.kernels = True
        self.flash = True
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``flash`` False (`set_routes`; the JAX package's
        ``flash_attention=False``) takes the einsum path in training and in
        sampling.  Under tensor parallelism ``heads`` counts this rank's."""
        b, hh, ww, c = x.shape
        n, d = hh * ww, self.qkv.weight.shape[0] // (3 * self.heads)
        h = self.norm(x).reshape(b, n, c)
        qkv = self.qkv(h).reshape(b, n, 3, self.heads, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [b, heads, n, d] views of the projection: no copy
        if not train and self.flash and self.use_pallas:
            attn = fused_self_attention if self.kernels else self_attention_plain
            out = attn(q, k, v)
        elif ((train or not self.use_pallas) and self.flash and n >= 128 and d % 64 == 0
              and n % min(512, n) == 0):
            # layers.py:400-409
            # K9 on the projection itself: its gradient comes back in this layout
            out = _packed_flash_attention(qkv, kernels=self.kernels)
        else:  # the einsum path, layers.py:433-442
            s = 1.0 / (d ** 0.25)
            logits = torch.matmul((q * s).float(), (k * s).float().transpose(-1, -2))
            weights = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.matmul(weights, v.to(x.dtype))
        out = out.permute(0, 2, 1, 3).reshape(b, n, self.heads * d)
        out = self.proj_out(out)
        return x + out.reshape(b, hh, ww, c)


def set_routes(module: nn.Module, flash: bool) -> None:
    """``flash`` False: every `SelfAttentionBlock` under ``module`` takes the
    einsum path; True: the flash gate decides again."""
    for m in module.modules():
        if isinstance(m, SelfAttentionBlock):
            m.flash = flash


def set_kernels(module: nn.Module, enabled: bool) -> None:
    """Route every module under ``module`` that has a ``kernels`` switch
    (ResBlock, SelfAttentionBlock, AttentionLR, the model itself, which the
    train step reads for the optimizer kernel) through the kernels (True) or their
    plain versions (False)."""
    for m in module.modules():
        if hasattr(m, "kernels"):
            m.kernels = enabled
