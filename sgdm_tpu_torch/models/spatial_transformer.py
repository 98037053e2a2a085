"""LDM SpatialTransformer: a cross-attention transformer over pixels.

Port of `sgdm_tpu/models/spatial_transformer.py` (GEGLU, CrossAttention,
BasicTransformerBlock, SpatialTransformer): GroupNorm, a 1×1 ``proj_in``
to ``heads·dim_head`` channels, ``depth`` pre-LayerNorm blocks
(self-attention ``attn1``, cross-attention ``attn2`` on the context, a
GEGLU feed-forward with the exact erf GELU), a zero-initialised 1×1
``proj_out`` and the residual.  The JAX modules compute attention with
einsums (f32 logits and softmax, the weights cast back to the compute
dtype), and so do these, in plain PyTorch ops.  NHWC in and out; the
context [B, M, context_dim] (None: self-attention in ``attn2`` too).
Parameters carry the flax names (``norm``, ``proj_in``, ``block_{i}``,
``norm1..3``, ``attn1/2`` with ``to_q``, ``to_k``, ``to_v``, ``to_out``,
``ff_geglu.proj``, ``ff_out``, ``proj_out``), which `convert.from_flax`
maps.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention_lr import LayerNorm
from .layers import Conv, Dense, GroupNorm32

__all__ = ["GEGLU", "CrossAttention", "BasicTransformerBlock", "SpatialTransformer"]


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim_in, 2 * dim_out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 context_dim: int | None = None, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        context = x if context is None else context
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        split = lambda t: t.reshape(b, -1, h, d).transpose(1, 2)
        q, k, v = split(self.to_q(x)), split(self.to_k(context)), split(self.to_v(context))
        sim = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * d ** -0.5
        attn = torch.softmax(sim, dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v).transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int | None = None,
                 dtype=torch.float32):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head, dtype=dtype)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, dtype=dtype)
        self.ff_geglu = GEGLU(dim, 4 * dim, dtype=dtype)
        self.ff_out = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x).to(x.dtype))
        x = x + self.attn2(self.norm2(x).to(x.dtype), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x).to(x.dtype)))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int = 8, dim_head: int = 64, depth: int = 1,
                 context_dim: int | None = None, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels)
        self.proj_in = Conv(channels, inner, 1, padding=0, dtype=dtype)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}",
                            BasicTransformerBlock(inner, heads, dim_head, context_dim, dtype))
        self.proj_out = Conv(inner, channels, 1, padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x)).reshape(b, hh * ww, -1)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        return x + self.proj_out(h.reshape(b, hh, ww, -1))
