"""The Imagen UNet (lucidrains imagen-pytorch) and its Base-64 preset.

Port of `sgdm_tpu/models/zoo_imagen.py` (zoo breadth: no shipped config
builds it):

  * the cross-embed stem: parallel convs at kernel sizes (3, 7, 15) with
    the channels split dim/2, dim/4, the rest;
  * time: learned-sinusoidal features (or the fixed sinusoid) → time
    hiddens → ``num_time_tokens`` condition tokens and a FiLM time vector;
  * text: a Linear to cond_dim, the per-sample classifier-free swap to the
    null tokens, the Perceiver resampler (latents query [text ‖ latents],
    mean-pooled extra latents) and a pooled path added to the time vector;
  * ResnetBlock: GN → FiLM (scale + 1, shift, on block2 only) → SiLU →
    conv, twice, token cross-attention (null kv) between, a GlobalContext
    gate (attention-style squeeze-excite) on the output;
  * TransformerBlock: self-attention with ONE shared k/v head and a null
    kv (+ the condition tokens), then a channel feed-forward; the linear
    attention variant (depthwise-conv projections, softmax-factorised);
  * skips scaled by 2^-½, two a level;
  * `forward_with_cond_scale`: (1 − s)·ε(z) + s·ε(z, c), one pass for s in
    {0, 1}, one doubled batch otherwise.

Modules take NHWC, as the JAX module, and keep its layout: a convolution
runs on the NCHW view of the NHWC tensor (channels-last memory); norms,
attention and feed-forwards on the last axis.  Parameters carry the flax
names (`models/convert.py imagen_from_flax`); attention, norms and
convolutions are plain PyTorch ops, as the JAX package's are XLA ops.

The condition-drop draw: ``cond_drop_prob`` a scalar or a per-sample [B]
vector; with ``generator`` (or the uniform draw ``cond_drop_u`` [B] handed
in) a sample keeps its condition where u < 1 − p; without either, u = ½,
exact for the 0 / 1 vectors CFG uses, and a fractional scalar raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ImagenUNet", "BaseUnet64"]


def _cast_tuple(v, length: int) -> tuple:
    if isinstance(v, (tuple, list)):
        assert len(v) == length
        return tuple(v)
    return (v,) * length


def _randn(*shape) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape))


class _LN(nn.Module):
    """LayerNorm over the last axis, eps 1e-5: scale and bias (torch's
    nn.LayerNorm) or scale only (``bias=False``)."""

    def __init__(self, dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class _GammaLN(nn.Module):
    """The scale-only LayerNorm under the name ``ln``."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = _LN(dim, bias=False)

    def forward(self, x):
        return self.ln(x)


class _Conv(nn.Conv2d):
    """A conv of NHWC tensors (on their channels-last NCHW view)."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _linear(cin, cout, bias=True):
    return nn.Linear(cin, cout, bias=bias)


class _FeedForward(nn.Module):
    """LN → Dense → GELU → LN → Dense, bias-free."""

    def __init__(self, dim: int, mult: float = 2.0):
        super().__init__()
        hidden = int(dim * mult)
        self.norm_in = _GammaLN(dim)
        self.proj_in = _linear(dim, hidden, False)
        self.norm_mid = _GammaLN(hidden)
        self.proj_out = _linear(hidden, dim, False)

    def forward(self, x):
        x = F.gelu(self.proj_in(self.norm_in(x)))
        return self.proj_out(self.norm_mid(x))


def _split_heads(t, heads: int, dim_head: int):
    b, n, _ = t.shape
    return t.reshape(b, n, heads, dim_head).transpose(1, 2)


class _PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm, self.norm_latents = _LN(dim), _LN(dim)
        self.to_q = _linear(dim, inner, False)
        self.to_kv = _linear(dim, 2 * inner, False)
        self.to_out = _linear(inner, dim, False)
        self.out_norm = _LN(dim)

    def forward(self, x, latents):
        x, latents = self.norm(x), self.norm_latents(latents)
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], -2)).chunk(2, -1)
        q, k, v = (_split_heads(t, self.heads, self.dim_head) for t in (q, k, v))
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q * self.dim_head ** -0.5, k), -1)
        out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2)
        out = out.reshape(x.shape[0], -1, self.heads * self.dim_head)
        return self.out_norm(self.to_out(out))


class _PerceiverResampler(nn.Module):
    def __init__(self, dim: int, depth: int = 2, dim_head: int = 64, heads: int = 8,
                 num_latents: int = 32, num_latents_mean_pooled: int = 4,
                 max_seq_len: int = 512, ff_mult: float = 4.0):
        super().__init__()
        self.dim, self.depth, self.n_pooled = dim, depth, num_latents_mean_pooled
        self.pos_emb = _randn(max_seq_len, dim)
        self.latents = _randn(num_latents, dim)
        if num_latents_mean_pooled > 0:
            self.mean_norm = _GammaLN(dim)
            self.mean_to_latents = _linear(dim, dim * num_latents_mean_pooled)
        for i in range(depth):
            setattr(self, f"attn_{i}", _PerceiverAttention(dim, dim_head, heads))
            setattr(self, f"ff_{i}", _FeedForward(dim, ff_mult))

    def forward(self, x):
        b, n, _ = x.shape
        x_pos = x + self.pos_emb[:n]
        latents = self.latents.expand(b, *self.latents.shape)
        if self.n_pooled > 0:
            pooled = self.mean_to_latents(self.mean_norm(x.mean(1)))
            latents = torch.cat([pooled.reshape(b, self.n_pooled, self.dim), latents], -2)
        for i in range(self.depth):
            latents = getattr(self, f"attn_{i}")(x_pos, latents) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        return latents


class _Attention(nn.Module):
    """Self-attention with ONE shared kv head and a null kv (+ context kv)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = _GammaLN(dim)
        self.to_q = _linear(dim, inner, False)
        self.to_kv = _linear(dim, 2 * dim_head, False)
        self.null_kv = _randn(2, dim_head)
        if context_dim is not None:
            self.context_norm = _LN(context_dim)
            self.to_context = _linear(context_dim, 2 * dim_head)
        self.to_out = _linear(inner, dim, False)
        self.out_norm = _GammaLN(dim)

    def forward(self, x, context=None):
        b = x.shape[0]
        x = self.norm(x)
        q = _split_heads(self.to_q(x), self.heads, self.dim_head) * self.dim_head ** -0.5
        k, v = self.to_kv(x).chunk(2, -1)
        k = torch.cat([self.null_kv[0].expand(b, 1, -1), k], -2)
        v = torch.cat([self.null_kv[1].expand(b, 1, -1), v], -2)
        if context is not None:
            ck, cv = self.to_context(self.context_norm(context)).chunk(2, -1)
            k, v = torch.cat([ck, k], -2), torch.cat([cv, v], -2)
        attn = torch.softmax(torch.einsum("bhid,bjd->bhij", q, k), -1)
        out = torch.einsum("bhij,bjd->bhid", attn, v).transpose(1, 2)
        return self.out_norm(self.to_out(out.reshape(b, -1, self.heads * self.dim_head)))


class _CrossAttention(nn.Module):
    """Per-head token cross-attention with a null kv; ``linear``: the
    softmax-factorised form."""

    def __init__(self, dim: int, context_dim: int, dim_head: int = 64, heads: int = 8,
                 linear: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.linear = heads, dim_head, linear
        inner = dim_head * heads
        self.norm = _GammaLN(dim)
        self.to_q = _linear(dim, inner, False)
        self.to_kv = _linear(context_dim, 2 * inner, False)
        self.null_kv = _randn(2, dim_head)
        self.to_out = _linear(inner, dim, False)
        self.out_norm = _GammaLN(dim)

    def forward(self, x, context):
        b, n, _ = x.shape
        q = _split_heads(self.to_q(self.norm(x)), self.heads, self.dim_head)
        k, v = (_split_heads(t, self.heads, self.dim_head)
                for t in self.to_kv(context).chunk(2, -1))
        k = torch.cat([self.null_kv[0].expand(b, self.heads, 1, -1), k], -2)
        v = torch.cat([self.null_kv[1].expand(b, self.heads, 1, -1), v], -2)
        if self.linear:
            q = torch.softmax(q, -1) * self.dim_head ** -0.5
            ctx = torch.einsum("bhnd,bhne->bhde", torch.softmax(k, -2), v)
            out = torch.einsum("bhnd,bhde->bhne", q, ctx)
        else:
            attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q * self.dim_head ** -0.5, k),
                                 -1)
            out = torch.einsum("bhij,bhjd->bhid", attn, v)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.out_norm(self.to_out(out))


class _LinearAttention(nn.Module):
    """Linear attention on a feature map: 1×1 then depthwise 3×3 projections."""

    def __init__(self, dim: int, dim_head: int = 32, heads: int = 8, dropout: float = 0.05,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        inner = dim_head * heads
        self.norm = _GammaLN(dim)
        for name in ("to_q", "to_k", "to_v"):
            setattr(self, f"{name}_proj", _Conv(dim, inner, 1, bias=False))
            setattr(self, f"{name}_dw", _Conv(inner, inner, 3, padding=1, groups=inner,
                                              bias=False))
        if context_dim is not None:
            self.context_norm = _LN(context_dim)
            self.to_context = _linear(context_dim, 2 * inner, False)
        self.to_out = _Conv(inner, dim, 1, bias=False)
        self.out_norm = _GammaLN(dim)

    def forward(self, fmap, context=None, train: bool = False):
        b, hh, ww, _ = fmap.shape
        fmap = self.norm(fmap)

        def proj(name):
            y = F.dropout(fmap, self.dropout, train)
            y = getattr(self, f"{name}_dw")(getattr(self, f"{name}_proj")(y))
            return y.reshape(b, hh * ww, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = proj("to_q"), proj("to_k"), proj("to_v")
        if context is not None:
            ck, cv = (_split_heads(t, self.heads, self.dim_head)
                      for t in self.to_context(self.context_norm(context)).chunk(2, -1))
            k, v = torch.cat([k, ck], -2), torch.cat([v, cv], -2)
        q = torch.softmax(q, -1) * self.dim_head ** -0.5
        ctx = torch.einsum("bhnd,bhne->bhde", torch.softmax(k, -2), v)
        out = torch.einsum("bhnd,bhde->bhne", q, ctx).transpose(1, 2)
        out = F.silu(out.reshape(b, hh, ww, self.heads * self.dim_head))
        return self.out_norm(self.to_out(out))


class _GlobalContext(nn.Module):
    """The attention-style squeeze-excite output gate."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        hidden = max(3, dim_out // 2)
        self.to_k = _Conv(dim_in, 1, 1)
        self.net_in = _linear(dim_in, hidden)
        self.net_out = _linear(hidden, dim_out)

    def forward(self, x):
        b, hh, ww, c = x.shape
        w = torch.softmax(self.to_k(x).reshape(b, hh * ww), -1)
        pooled = torch.einsum("bn,bnc->bc", w, x.reshape(b, hh * ww, c))
        y = self.net_out(F.silu(self.net_in(pooled)))
        return torch.sigmoid(y)[:, None, None, :]


class _Block(nn.Module):
    """GN → FiLM (scale + 1, shift) → SiLU → 3×3 conv."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.gn = nn.GroupNorm(groups, dim, eps=1e-5)
        self.conv = _Conv(dim, dim_out, 3, padding=1)

    def forward(self, x, scale_shift=None):
        x = self.gn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return self.conv(F.silu(x))


class _ResnetBlock(nn.Module):
    """block1 → [cross-attn] → block2 (FiLM from time) → GlobalContext gate
    → + res_conv(x)."""

    def __init__(self, dim: int, dim_out: int, cond_dim: Optional[int] = None,
                 time_cond_dim: Optional[int] = None, groups: int = 8,
                 linear_attn: bool = False, use_gca: bool = False):
        super().__init__()
        if time_cond_dim is not None:
            self.time_mlp = _linear(time_cond_dim, 2 * dim_out)
        self.block1 = _Block(dim, dim_out, groups)
        if cond_dim is not None:
            self.cross_attn = _CrossAttention(dim_out, cond_dim, linear=linear_attn)
        self.block2 = _Block(dim_out, dim_out, groups)
        if use_gca:
            self.gca = _GlobalContext(dim_out, dim_out)
        if dim != dim_out:
            self.res_conv = _Conv(dim, dim_out, 1)

    def forward(self, x, time_emb=None, cond=None):
        scale_shift = None
        if hasattr(self, "time_mlp") and time_emb is not None:
            scale_shift = self.time_mlp(F.silu(time_emb))[:, None, None, :].chunk(2, -1)
        h = self.block1(x)
        if hasattr(self, "cross_attn"):
            assert cond is not None
            b, hh, ww, c = h.shape
            tok = h.reshape(b, hh * ww, c)
            h = (self.cross_attn(tok, cond) + tok).reshape(b, hh, ww, c)
        h = self.block2(h, scale_shift)
        if hasattr(self, "gca"):
            h = h * self.gca(h)
        return h + (self.res_conv(x) if hasattr(self, "res_conv") else x)


class _TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, ff_mult: float = 2.0,
                 context_dim: Optional[int] = None, linear: bool = False):
        super().__init__()
        self.linear = linear
        self.attn = _LinearAttention(dim, dim_head, heads, context_dim=context_dim) if linear \
            else _Attention(dim, dim_head, heads, context_dim)
        self.ff = _FeedForward(dim, ff_mult)

    def forward(self, x, context=None, train: bool = False):
        if self.linear:
            x = self.attn(x, context=context, train=train) + x
        else:
            b, hh, ww, c = x.shape
            tok = x.reshape(b, hh * ww, c)
            x = (self.attn(tok, context=context) + tok).reshape(b, hh, ww, c)
        return self.ff(x) + x


class _CrossEmbedLayer(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, kernel_sizes: Sequence[int], stride: int = 2):
        super().__init__()
        ks = sorted(kernel_sizes)
        dims = [dim_out // (2 ** i) for i in range(1, len(ks))]
        dims.append(dim_out - sum(dims))
        self.ks = ks
        for k, d in zip(ks, dims):
            setattr(self, f"conv_k{k}", _Conv(dim_in, d, k, stride, (k - stride) // 2))

    def forward(self, x):
        return torch.cat([getattr(self, f"conv_k{k}")(x) for k in self.ks], -1)


class _Upsample(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.conv = _Conv(dim, dim_out, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, 1).repeat_interleave(2, 2))


class _Parallel2(nn.Module):
    """conv3 + conv1, summed (the last level's channel change)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.conv3 = _Conv(dim, dim_out, 3, padding=1)
        self.conv1 = _Conv(dim, dim_out, 1)

    def forward(self, x):
        return self.conv3(x) + self.conv1(x)


class ImagenUNet(nn.Module):
    """``forward(x [B, H, W, C], timesteps [B], cond=None, cond_drop_prob=0.0,
    generator=None, cond_drop_u=None, train=False)``; ``cond`` [B, D] when
    ``max_text_len == 1``, else [B, N, D]."""

    def __init__(self, dim: int = 128, max_text_len: int = 256, text_embed_dim: int = 2048,
                 attn_pool_text: bool = True, attn_pool_num_latents: int = 32,
                 memory_efficient: bool = False, use_global_context_attn: bool = True,
                 cond_dim: Optional[int] = None,
                 num_resnet_blocks: Union[int, Sequence[int]] = 1, num_time_tokens: int = 2,
                 learned_sinu_pos_emb: bool = True, learned_sinu_pos_emb_dim: int = 16,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3,
                 channels_out: Optional[int] = None, attn_dim_head: int = 64,
                 attn_heads: int = 8, ff_mult: float = 2.0,
                 layer_attns: Union[bool, Sequence[bool]] = True, attend_at_middle: bool = True,
                 layer_cross_attns: Union[bool, Sequence[bool]] = True,
                 use_linear_attn: bool = False, use_linear_cross_attn: bool = False,
                 cond_on_text: bool = True, init_dim: Optional[int] = None,
                 resnet_groups: Union[int, Sequence[int]] = 8,
                 init_cross_embed_kernel_sizes: Sequence[int] = (3, 7, 15),
                 cross_embed_downsample: bool = False,
                 cross_embed_downsample_kernel_sizes: Sequence[int] = (2, 4),
                 init_conv_to_final_conv_residual: bool = False,
                 scale_skip_connection: bool = True, final_resnet_block: bool = True,
                 final_conv_kernel_size: int = 3):
        super().__init__()
        nlev = len(dim_mults)
        init_dim = init_dim or dim
        cond_dim = cond_dim or dim
        tcd = dim * 4
        self.num_blocks = _cast_tuple(num_resnet_blocks, nlev)
        groups = _cast_tuple(resnet_groups, nlev)
        self.layer_attns = _cast_tuple(layer_attns, nlev)
        self.layer_cross = _cast_tuple(layer_cross_attns, nlev)
        dims = [init_dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        self.skip_scale = 2 ** -0.5 if scale_skip_connection else 1.0
        self.nlev, self.num_time_tokens, self.cond_dim = nlev, num_time_tokens, cond_dim
        self.max_text_len, self.cond_on_text = max_text_len, cond_on_text
        self.attn_pool_text, self.learned_sinu = attn_pool_text, learned_sinu_pos_emb
        self.memory_efficient, self.attend_at_middle = memory_efficient, attend_at_middle
        self.use_linear_attn = use_linear_attn
        self.init_residual = init_conv_to_final_conv_residual
        self.final_resnet_block, self.dim = final_resnet_block, dim

        self.init_conv = _CrossEmbedLayer(channels, init_dim, init_cross_embed_kernel_sizes, 1)
        if learned_sinu_pos_emb:
            self.sinu_weights = _randn(learned_sinu_pos_emb_dim // 2)
            t_in = learned_sinu_pos_emb_dim + 1
        else:
            t_in = dim
        self.to_time_hiddens = _linear(t_in, tcd)
        self.to_time_tokens = _linear(tcd, cond_dim * num_time_tokens)
        self.to_time_cond = _linear(tcd, tcd)
        if cond_on_text:
            self.text_to_cond = _linear(text_embed_dim, cond_dim)
            self.null_text_embed = _randn(1, max_text_len, cond_dim)
            if attn_pool_text:
                self.attn_pool = _PerceiverResampler(cond_dim, 2, attn_dim_head, attn_heads,
                                                     attn_pool_num_latents)
            self.text_hidden_norm = _LN(cond_dim)
            self.to_text_hidden_1 = _linear(cond_dim, tcd)
            self.to_text_hidden_2 = _linear(tcd, tcd)
            self.null_text_hidden = _randn(1, tcd)
        self.norm_cond = _LN(cond_dim)
        if memory_efficient:
            self.init_resnet_block = _ResnetBlock(init_dim, init_dim, time_cond_dim=tcd,
                                                  groups=groups[0],
                                                  use_gca=use_global_context_attn)

        def down(cin, cout):
            if cross_embed_downsample:
                return _CrossEmbedLayer(cin, cout, cross_embed_downsample_kernel_sizes, 2)
            return _Conv(cin, cout, 4, 2, 1)

        def attn_block(d, linear):
            return _TransformerBlock(d, attn_heads, attn_dim_head, ff_mult, cond_dim, linear)

        skip_dims = []
        for i, (dim_in, dim_out) in enumerate(self.in_out):
            lin_x = not self.layer_cross[i] and use_linear_cross_attn
            lcond = cond_dim if (self.layer_cross[i] or lin_x) else None
            cur = dim_in
            if memory_efficient:
                setattr(self, f"down_{i}_pre", down(dim_in, dim_out))
                cur = dim_out
            setattr(self, f"down_{i}_init", _ResnetBlock(cur, cur, lcond, tcd, groups[i], lin_x))
            for j in range(self.num_blocks[i]):
                setattr(self, f"down_{i}_res_{j}", _ResnetBlock(
                    cur, cur, time_cond_dim=tcd, groups=groups[i],
                    use_gca=use_global_context_attn))
                skip_dims.append(cur)
            if self.layer_attns[i] or use_linear_attn:
                setattr(self, f"down_{i}_attn", attn_block(cur, not self.layer_attns[i]))
            skip_dims.append(cur)
            if not memory_efficient:
                setattr(self, f"down_{i}_post", down(cur, dim_out) if i < nlev - 1
                        else _Parallel2(cur, dim_out))

        mid = dims[-1]
        self.mid_block1 = _ResnetBlock(mid, mid, cond_dim, tcd, groups[-1])
        if attend_at_middle:
            self.mid_attn = _Attention(mid, attn_dim_head, attn_heads)
        self.mid_block2 = _ResnetBlock(mid, mid, cond_dim, tcd, groups[-1])

        cur = mid
        for i, (dim_in, dim_out) in enumerate(reversed(self.in_out)):
            ri = nlev - 1 - i
            lin_x = not self.layer_cross[ri] and use_linear_cross_attn
            lcond = cond_dim if (self.layer_cross[ri] or lin_x) else None
            skip = skip_dims.pop()
            setattr(self, f"up_{i}_init", _ResnetBlock(cur + skip, dim_out, lcond, tcd,
                                                       groups[ri], lin_x))
            cur = dim_out
            for j in range(self.num_blocks[ri]):
                skip = skip_dims.pop()
                setattr(self, f"up_{i}_res_{j}", _ResnetBlock(
                    cur + skip, dim_out, time_cond_dim=tcd, groups=groups[ri],
                    use_gca=use_global_context_attn))
            if self.layer_attns[ri] or use_linear_attn:
                setattr(self, f"up_{i}_attn", attn_block(dim_out, not self.layer_attns[ri]))
            if i != nlev - 1 or memory_efficient:
                setattr(self, f"up_{i}_upsample", _Upsample(dim_out, dim_in))
                cur = dim_in
        if init_conv_to_final_conv_residual:
            cur += init_dim
        if final_resnet_block:
            self.final_res_block = _ResnetBlock(cur, dim, time_cond_dim=tcd, groups=groups[0],
                                                use_gca=True)
            cur = dim
        k = final_conv_kernel_size
        self.final_conv = _Conv(cur, channels_out or channels, k, padding=k // 2)

    def _keep_mask(self, batch: int, cond_drop_prob, generator, u) -> torch.Tensor:
        """Keep a sample's condition where u < 1 − p."""
        dev = self.norm_cond.weight.device
        p = torch.as_tensor(cond_drop_prob, dtype=torch.float32, device=dev).expand(batch)
        if u is not None:
            u = torch.as_tensor(u, dtype=torch.float32, device=dev)
        elif generator is not None:
            u = torch.rand((batch,), generator=generator, device=dev)
        else:
            if isinstance(cond_drop_prob, (int, float)) and 0.0 < float(cond_drop_prob) < 1.0:
                raise ValueError(
                    "a fractional cond_drop_prob needs a generator (or the draw cond_drop_u); "
                    "without one the mask is exact only for the 0/1 per-sample vectors CFG "
                    "sampling uses")
            u = torch.full((batch,), 0.5, device=dev)
        return u < (1.0 - p)

    def forward(self, x, timesteps, cond=None, cond_drop_prob=0.0,
                generator: torch.Generator | None = None, cond_drop_u=None,
                train: bool = False):
        b = x.shape[0]
        x = self.init_conv(x)
        init_residual = x if self.init_residual else None

        t_in = torch.as_tensor(timesteps, device=x.device).float()
        if self.learned_sinu:
            freqs = t_in[:, None] * self.sinu_weights[None, :] * 2 * math.pi
            emb = torch.cat([t_in[:, None], torch.sin(freqs), torch.cos(freqs)], -1)
        else:
            half = self.dim // 2
            f = torch.exp(torch.arange(half, device=x.device)
                          * -(math.log(10000.0) / (half - 1)))
            ang = t_in[:, None] * f[None, :]
            emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        time_hiddens = F.silu(self.to_time_hiddens(emb))
        time_tokens = self.to_time_tokens(time_hiddens).reshape(b, self.num_time_tokens,
                                                                self.cond_dim)
        t = self.to_time_cond(time_hiddens)

        text_tokens = None
        if cond is not None and self.cond_on_text:
            if self.max_text_len == 1:
                assert cond.ndim == 2, "expected [B, D] text embed"
                cond = cond[:, None, :]
            else:
                assert cond.ndim == 3, "expected [B, N, D] text embeds"
            keep = self._keep_mask(b, cond_drop_prob, generator, cond_drop_u)
            text_tokens = self.text_to_cond(cond)
            text_tokens = torch.where(keep[:, None, None], text_tokens,
                                      self.null_text_embed[:, :text_tokens.shape[1]])
            if self.attn_pool_text:
                text_tokens = self.attn_pool(text_tokens)
            th = self.text_hidden_norm(text_tokens.mean(-2))
            th = self.to_text_hidden_2(F.silu(self.to_text_hidden_1(th)))
            t = t + torch.where(keep[:, None], th, self.null_text_hidden)

        c = time_tokens if text_tokens is None else torch.cat([time_tokens, text_tokens], -2)
        c = self.norm_cond(c)
        if self.memory_efficient:
            x = self.init_resnet_block(x, t)

        hiddens = []
        for i in range(self.nlev):
            if self.memory_efficient:
                x = getattr(self, f"down_{i}_pre")(x)
            x = getattr(self, f"down_{i}_init")(x, t, cond=c)
            for j in range(self.num_blocks[i]):
                x = getattr(self, f"down_{i}_res_{j}")(x, t)
                hiddens.append(x)
            if hasattr(self, f"down_{i}_attn"):
                x = getattr(self, f"down_{i}_attn")(x, context=c, train=train)
            hiddens.append(x)
            if not self.memory_efficient:
                x = getattr(self, f"down_{i}_post")(x)

        x = self.mid_block1(x, t, cond=c)
        if self.attend_at_middle:
            bm, hm, wm, cm = x.shape
            tok = x.reshape(bm, hm * wm, cm)
            x = (self.mid_attn(tok) + tok).reshape(bm, hm, wm, cm)
        x = self.mid_block2(x, t, cond=c)

        for i in range(self.nlev):
            ri = self.nlev - 1 - i
            x = torch.cat([x, hiddens.pop() * self.skip_scale], -1)
            x = getattr(self, f"up_{i}_init")(x, t, cond=c)
            for j in range(self.num_blocks[ri]):
                x = torch.cat([x, hiddens.pop() * self.skip_scale], -1)
                x = getattr(self, f"up_{i}_res_{j}")(x, t)
            if hasattr(self, f"up_{i}_attn"):
                x = getattr(self, f"up_{i}_attn")(x, context=c, train=train)
            if hasattr(self, f"up_{i}_upsample"):
                x = getattr(self, f"up_{i}_upsample")(x)

        if init_residual is not None:
            x = torch.cat([x, init_residual], -1)
        if self.final_resnet_block:
            x = self.final_res_block(x, t)
        return self.final_conv(x)

    def forward_with_cond_scale(self, x, timesteps, cond_scale, cond):
        """(1 − s)·ε(z) + s·ε(z, c): one pass for s in {0, 1}, else one
        doubled batch with the per-sample drop vector [0…0, 1…1]."""
        b = x.shape[0]
        if cond_scale == 1:
            return self(x, timesteps, cond=cond, cond_drop_prob=0.0)
        if cond_scale == 0:
            return self(x, timesteps, cond=cond, cond_drop_prob=1.0)
        timesteps = torch.as_tensor(timesteps, device=x.device)
        p = torch.cat([torch.zeros(b, device=x.device), torch.ones(b, device=x.device)])
        out = self(torch.cat([x, x]), torch.cat([timesteps, timesteps]),
                   cond=torch.cat([cond, cond]), cond_drop_prob=p)
        eps_zc, eps_z = out.chunk(2)
        return (1.0 - cond_scale) * eps_z + cond_scale * eps_zc


def BaseUnet64(**kwargs) -> ImagenUNet:
    """The paper appendix's Base-64 preset."""
    defaults = dict(dim=512, dim_mults=(1, 2, 3, 4), num_resnet_blocks=3,
                    layer_attns=(False, True, True, True),
                    layer_cross_attns=(False, True, True, True), attn_heads=8, ff_mult=2.0,
                    memory_efficient=False)
    defaults.update(kwargs)
    return ImagenUNet(**defaults)
