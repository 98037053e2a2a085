"""XCiT (cross-covariance image transformer): the ``dino_xcit_m24_p8`` backbone.

The port's copy of `sgdm_tpu/models/xcit.py`, under facebookresearch/xcit's
parameter names, so the torch.hub ``dino_xcit_medium_24_p8`` state dict
loads with ``load_state_dict(strict=True)``:

  * ``patch_embed.proj``: 3×3/2 conv + BN stages (GELU between), 3 for
    patch 8, 4 for patch 16;
  * ``pos_embeder.token_projection``: a 1×1 conv of the fixed Fourier table
    (positions ``1..n / (n + 1e-6) · 2π``, sin / cos interleaved, y first);
  * ``blocks.{i}``: XCA (q and k L2-normalised over the tokens, a d×d
    attention a head with a learned ``temperature``), LPI (``local_mp``:
    depthwise 3×3 → GELU → BN → depthwise 3×3 on the token grid) and the
    MLP, each branch scaled by ``gamma1`` / ``gamma3`` / ``gamma2``;
  * ``cls_attn_blocks.{i}``: CaiT class attention with upstream's two
    quirks (the first residual adds the norm1'd patch tokens, the second
    doubles them) and ``tokens_norm``; then ``norm``.

BatchNorm is inference only (`resnet.FrozenBN`); the JAX package folds it
at load with eps 1e-5, which gives the same values up to rounding.
``forward(x, out=...)``: ``cls`` → [B, C], ``tokens`` → the normed tokens
[B, 1 + N, C] (CLS first), ``attn_last`` → the last class-attention
block's CLS attention [B, heads, 1, 1 + N].  ``dtype`` is the compute dtype
of the convolutions and linear layers; LayerNorm, the L2 norms and the
softmaxes run in float32, with the JAX package's promotions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import FrozenBN
from .vit import Mlp, _layer_norm, _linear

__all__ = ["XCiT", "xcit_medium_24_p8", "load_xcit_torch_weights", "fourier_pos"]


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)``: input and parameters cast to ``dtype``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def _bn(bn: FrozenBN, x: torch.Tensor) -> torch.Tensor:
    """The folded BN in ``x``'s dtype, as the JAX package's ``FrozenBN``."""
    if x.dtype == torch.float32:
        return bn(x)
    return bn(x.float()).to(x.dtype)


class ConvPatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        if patch_size == 16:
            dims = [embed_dim // 8, embed_dim // 4, embed_dim // 2, embed_dim]
        elif patch_size == 8:
            dims = [embed_dim // 4, embed_dim // 2, embed_dim]
        else:
            raise ValueError(f"xcit patch_size must be 8/16, got {patch_size}")
        layers, cin = [], 3
        for i, d in enumerate(dims):
            layers.append(nn.Sequential(nn.Conv2d(cin, d, 3, 2, 1, bias=False), FrozenBN(d)))
            if i < len(dims) - 1:
                layers.append(nn.GELU())
            cin = d
        self.proj = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for layer in self.proj:
            if isinstance(layer, nn.GELU):
                x = F.gelu(x, approximate="none")
            else:
                x = _bn(layer[1], _conv(layer[0], x, dtype))
        return x                                               # [B, C, Hp, Wp]


def fourier_pos(hp: int, wp: int, hidden: int = 32, temperature: float = 10000.0,
                device: torch.device | str | None = None) -> torch.Tensor:
    """The Fourier table before its projection, [1, 2·hidden, hp, wp]
    float32 (y features first, sin / cos interleaved)."""
    eps, scale = 1e-6, 2 * math.pi
    f32 = torch.float32
    ys = torch.arange(1, hp + 1, dtype=f32, device=device) / (hp + eps) * scale
    xs = torch.arange(1, wp + 1, dtype=f32, device=device) / (wp + eps) * scale
    y_grid = ys[:, None].expand(hp, wp)
    x_grid = xs[None, :].expand(hp, wp)
    dim_t = torch.arange(hidden, dtype=f32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / hidden)

    def interleave(pos):
        pos = pos[..., None] / dim_t                           # [hp, wp, hidden]
        return torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                           dim=-1).reshape(hp, wp, hidden)

    return torch.cat([interleave(y_grid), interleave(x_grid)], -1).permute(2, 0, 1)[None]


class PositionalEncodingFourier(nn.Module):
    def __init__(self, dim: int, hidden: int = 32):
        super().__init__()
        self.hidden = hidden
        self.token_projection = nn.Conv2d(hidden * 2, dim, 1)

    def forward(self, hp: int, wp: int, dtype: torch.dtype) -> torch.Tensor:
        table = fourier_pos(hp, wp, self.hidden, device=self.token_projection.weight.device)
        return _conv(self.token_projection, table, dtype)       # [1, C, hp, wp]


def _l2norm(t: torch.Tensor) -> torch.Tensor:
    t32 = t.float()
    return (t32 / torch.sqrt((t32 * t32).sum(-1, keepdim=True)).clamp(min=1e-12)).to(t.dtype)


class XCA(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = _linear(self.qkv, x, dtype).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 4, 1)
        q, k, v = qkv[0], qkv[1], qkv[2]                       # [b, h, d, n]
        attn = torch.matmul(_l2norm(q).float(), _l2norm(k).float().transpose(-2, -1))
        attn = torch.softmax(attn * self.temperature.float(), -1).to(x.dtype)
        ct = torch.promote_types(attn.dtype, v.dtype)
        out = torch.matmul(attn.to(ct), v.to(ct))              # [b, h, d, n]
        return _linear(self.proj, out.permute(0, 3, 1, 2).reshape(b, n, c), dtype)


class LPI(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.bn = FrozenBN(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
        b, n, c = x.shape
        y = x.transpose(1, 2).reshape(b, c, *hw)
        y = F.gelu(_conv(self.conv1, y, dtype), approximate="none")
        y = _conv(self.conv2, _bn(self.bn, y), dtype)
        return y.reshape(b, c, n).transpose(1, 2)


class XCABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eta: float = 1.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = XCA(dim, num_heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.local_mp = LPI(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(eta * torch.ones(dim))
        self.gamma2 = nn.Parameter(eta * torch.ones(dim))
        self.gamma3 = nn.Parameter(eta * torch.ones(dim))

    def forward(self, x, hw, dtype):
        x = x + self.gamma1.to(x.dtype) * self.attn(_layer_norm(self.norm1, x), dtype)
        x = x + self.gamma3.to(x.dtype) * self.local_mp(_layer_norm(self.norm3, x), hw, dtype)
        return x + self.gamma2.to(x.dtype) * self.mlp(_layer_norm(self.norm2, x), dtype)


class ClassAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = _linear(self.qkv, x, dtype).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                       # [b, h, n, d]
        attn = (q[:, :, :1] * k).sum(-1).float() * (d ** -0.5)
        attn = torch.softmax(attn, -1)                         # [b, h, n]
        a = attn.to(x.dtype)
        ct = torch.promote_types(a.dtype, v.dtype)
        cls = torch.einsum("bhn,bhnd->bhd", a.to(ct), v.to(ct)).reshape(b, 1, c)
        cls = _linear(self.proj, cls, dtype)
        return torch.cat([cls.to(torch.promote_types(cls.dtype, x.dtype)),
                          x[:, 1:].to(torch.promote_types(cls.dtype, x.dtype))], 1), attn


class ClassAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eta: float = 1.0,
                 tokens_norm: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ClassAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(eta * torch.ones(dim))
        self.gamma2 = nn.Parameter(eta * torch.ones(dim))
        self.tokens_norm = tokens_norm

    def forward(self, x, dtype):
        y, attn = self.attn(_layer_norm(self.norm1, x), dtype)
        # upstream quirk (1): the residual is the whole ClassAttention output
        x = x + self.gamma1.to(x.dtype) * y
        if self.tokens_norm:
            x = _layer_norm(self.norm2, x).to(x.dtype)
        else:
            x = torch.cat([_layer_norm(self.norm2, x[:, :1]).to(x.dtype), x[:, 1:]], 1)
        cls = self.gamma2.to(x.dtype) * self.mlp(x[:, :1], dtype)
        # upstream quirk (2): cat(mlp(cls), patches) onto x doubles the patches
        ct = torch.promote_types(cls.dtype, x.dtype)
        return x.to(ct) + torch.cat([cls.to(ct), x[:, 1:].to(ct)], 1), attn


class XCiT(nn.Module):
    def __init__(self, patch_size: int = 8, embed_dim: int = 512, depth: int = 24,
                 num_heads: int = 8, mlp_ratio: float = 4.0, cls_attn_layers: int = 2,
                 eta: float = 1e-5, tokens_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.embed_dim, self.depth = patch_size, embed_dim, depth
        self.num_heads, self.dtype = num_heads, dtype
        self.patch_embed = ConvPatchEmbed(patch_size, embed_dim)
        self.pos_embeder = PositionalEncodingFourier(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(XCABlock(embed_dim, num_heads, mlp_ratio, eta)
                                    for _ in range(depth))
        self.cls_attn_blocks = nn.ModuleList(
            ClassAttentionBlock(embed_dim, num_heads, mlp_ratio, eta, tokens_norm)
            for _ in range(cls_attn_layers))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def feat_dim(self) -> int:
        return self.embed_dim

    def forward(self, x: torch.Tensor, out: str = "cls"):
        if out not in ("cls", "tokens", "attn_last"):
            raise ValueError(f"unknown out={out!r}")
        b = x.shape[0]
        y = self.patch_embed(x, self.dtype)
        hp, wp = y.shape[2], y.shape[3]
        tokens = y.flatten(2).transpose(1, 2)                  # [b, hp·wp, C]
        pos = self.pos_embeder(hp, wp, self.dtype).flatten(2).transpose(1, 2)
        tokens = tokens + pos
        for blk in self.blocks:
            tokens = blk(tokens, (hp, wp), self.dtype)
        z = torch.cat([self.cls_token.to(tokens.dtype).expand(b, 1, self.embed_dim), tokens], 1)
        attn = None
        for blk in self.cls_attn_blocks:
            z, attn = blk(z, self.dtype)
        z = _layer_norm(self.norm, z)
        if out == "cls":
            return z[:, 0]
        if out == "tokens":
            return z
        return attn[:, :, None, :]                              # [b, h, 1, 1 + N]


def xcit_medium_24_p8(dtype: torch.dtype = torch.float32) -> XCiT:
    """dino_xcit_medium_24_p8: 512 wide, 8 heads, 24 blocks, patch 8, η 1e-5."""
    return XCiT(patch_size=8, embed_dim=512, depth=24, num_heads=8, eta=1e-5, tokens_norm=True,
                dtype=dtype)


def load_xcit_torch_weights(path: str, eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """A facebookresearch/xcit (or timm) state dict → the port's XCiT state
    dict: ``head.*`` dropped, timm's ``pos_embed`` read as ``pos_embeder``.
    ``eps`` is the BatchNorms' epsilon, as the JAX loader folds with it: the
    modules add 1e-5, so each ``running_var`` is shifted by ``eps - 1e-5``."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("head."):
            continue
        if k.startswith("pos_embed."):
            k = "pos_embeder." + k[len("pos_embed."):]
        if k.endswith("running_var") and eps != 1e-5:
            v = v + (eps - 1e-5)
        out[k] = v
    return out
