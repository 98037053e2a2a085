"""Imagen-style attention with a learned null key/value (multi-query).

Port of `sgdm_tpu/models/attention_lr.py` `GammaLayerNorm` and
`AttentionLR`: pixel tokens are the queries; keys and values are
SINGLE-head (``to_kv`` projects to one ``dim_head``) and shared by every
query head; the key/value sequence is, in this order,

    [projected context tokens ‖ learned null-KV ‖ self-KV]

(the order the JAX module's concatenations give); a gamma-only LayerNorm
before and after, and a residual.  q is scaled by ``dim_head**-0.5`` in
the compute dtype before the attention, which applies no scale itself.
NHWC in and out, softmax in float32.

Routes, as in the JAX package: sampling (``train=False``, its
``use_pallas=True``) takes `ops.fused_null_kv_attention` (K7 on CUDA
tensors with ``kernels`` on, else its plain version); training takes the
einsum path in plain PyTorch ops with autograd, as the JAX package leaves
it to XLA there.

Parameters are named after the flax tree (``norm.gamma``, ``to_q``,
``to_kv``, ``null_kv``, ``context_norm``, ``to_context``, ``to_out``,
``out_norm.gamma``).

`CrossAttentionLR` (`sgdm_tpu/models/attention_lr.py:108-153`): full
multi-head cross-attention of the pixels on a context sequence, the keys
and values being, in this order, [learned null-KV ‖ projected context ‖
the queries themselves] (Imagen D.3.1), q scaled by ``dim_head**-0.5``
after it joins them, f32 logits and softmax; the same gamma-only
LayerNorms and residual.  The JAX module computes it with einsums in every
mode, and so does this one, in plain PyTorch ops.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import fused_null_kv_attention
from ..parallel import tp as tpx
from .layers import Dense

__all__ = ["AttentionLR", "CrossAttentionLR", "GammaLayerNorm", "LayerNorm"]


class GammaLayerNorm(nn.Module):
    """LayerNorm over the last axis with a learned scale and no bias, in f32 (eps 1e-5)."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features))

    tp = tp_role = None  # "gather": `parallel.tp.shard_model` left a shard of gamma here

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        gamma = tpx.gather(self.gamma, self.tp) if self.tp_role == "gather" else self.gamma
        return ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: scale (``weight``) and bias, eps
    1e-6; the output is float32 whatever the input."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, eps=1e-6)


class AttentionLR(nn.Module):
    """Self-attention over pixels with null-KV and context-KV (multi-query)."""

    def __init__(self, channels: int, heads: int = 8, dim_head: int = 64,
                 context_dim: int | None = None, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.kernels = True
        inner = heads * dim_head
        self.norm = GammaLayerNorm(channels)
        self.to_q = Dense(channels, inner, bias=False, dtype=dtype)
        self.to_kv = Dense(channels, 2 * dim_head, bias=False, dtype=dtype)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        if context_dim is not None:
            self.context_norm = LayerNorm(context_dim)
            self.to_context = Dense(context_dim, 2 * dim_head, dtype=dtype)
        self.to_out = Dense(inner, channels, bias=False, dtype=dtype)
        self.out_norm = GammaLayerNorm(channels)

    tp = None  # set by `parallel.tp.shard_model`: ``heads`` then counts this rank's

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        b, hh, ww, c = x.shape
        n, d = hh * ww, self.dim_head
        x_seq = x.reshape(b, n, c)
        x_normed = self.norm(x_seq)
        q = self.to_q(x_normed).reshape(b, n, self.heads, d) * (d ** -0.5)
        k, v = self.to_kv(x_normed).chunk(2, dim=-1)  # [b, n, d] single-head
        null_kv = self.null_kv.to(k.dtype)
        k = torch.cat([null_kv[0].expand(b, 1, d), k], dim=1)
        v = torch.cat([null_kv[1].expand(b, 1, d), v], dim=1)
        if context is not None:
            if not hasattr(self, "to_context"):
                raise ValueError("context given to an AttentionLR built without context_dim")
            ck, cv = self.to_context(self.context_norm(context)).chunk(2, dim=-1)
            k = torch.cat([ck.to(k.dtype), k], dim=1)
            v = torch.cat([cv.to(v.dtype), v], dim=1)
        if self.tp is not None:  # the shared k / v enter this rank's heads
            k, v = tpx.enter(k, self.tp), tpx.enter(v, self.tp)
        if not train:
            out = fused_null_kv_attention(q, k, v, kernels=self.kernels)
        else:  # the einsum path, attention_lr.py:97-101
            sim = torch.einsum("bnhd,bjd->bhnj", q.float(), k.float())
            attn = torch.softmax(sim, dim=-1).to(x.dtype)
            out = torch.einsum("bhnj,bjd->bnhd", attn, v)
        out = self.out_norm(self.to_out(out.reshape(b, n, self.heads * d)))
        return (x_seq + out).reshape(b, hh, ww, c)


class CrossAttentionLR(nn.Module):
    """Full multi-head cross-attention with null-KV and q appended to KV.
    ``context_dim`` (the context's last axis) defaults to ``channels``."""

    def __init__(self, channels: int, heads: int = 8, dim_head: int = 64,
                 context_dim: int | None = None, norm_context: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        context_dim = context_dim or channels
        self.norm = GammaLayerNorm(channels)
        if norm_context:
            self.context_norm = GammaLayerNorm(context_dim)
        self.to_q = Dense(channels, inner, bias=False, dtype=dtype)
        self.to_kv = Dense(context_dim, 2 * inner, bias=False, dtype=dtype)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = Dense(inner, channels, bias=False, dtype=dtype)
        self.out_norm = GammaLayerNorm(channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        n, h, d = hh * ww, self.heads, self.dim_head
        x_seq = x.reshape(b, n, c)
        if hasattr(self, "context_norm"):
            context = self.context_norm(context)
        split = lambda t: t.reshape(b, -1, h, d).transpose(1, 2)  # [b, heads, tokens, d]
        q = split(self.to_q(self.norm(x_seq)))
        k, v = (split(t) for t in self.to_kv(context).chunk(2, dim=-1))
        null_kv = self.null_kv.to(k.dtype)
        k = torch.cat([null_kv[0].expand(b, h, 1, d), k, q], dim=2)
        v = torch.cat([null_kv[1].expand(b, h, 1, d), v, q], dim=2)
        q = q * (d ** -0.5)
        sim = torch.einsum("bhnd,bhjd->bhnj", q.float(), k.float())
        attn = torch.softmax(sim, dim=-1).to(x.dtype)
        out = torch.einsum("bhnj,bhjd->bhnd", attn, v).transpose(1, 2).reshape(b, n, h * d)
        out = self.out_norm(self.to_out(out))
        return (x_seq + out).reshape(b, hh, ww, c)
