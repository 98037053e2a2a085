"""Vision Transformer (DINO flavour): the self-labeling backbone.

The port's copy of `sgdm_tpu/models/vit.py`, with torch.hub DINO's (and
timm's) parameter names, so a DINO checkpoint loads with
``load_state_dict(strict=True)``:

  * conv patch embedding (``patch_embed.proj``), a CLS token, a learned
    position embedding stored on the ``pretrain_img_size`` grid and
    resampled with JAX's cubic (`utils.resize`, Keys a = -0.5,
    antialiased) for any other grid;
  * pre-LN blocks (``blocks.{i}.norm1`` / ``attn.qkv`` / ``attn.proj`` /
    ``norm2`` / ``mlp.fc1`` / ``mlp.fc2``): LayerNorm eps 1e-6 in float32,
    attention as explicit matmuls with the softmax in float32 (as the JAX
    package's XLA einsum; no fused kernel), exact GELU;
  * ``forward(x, out=...)`` with ``x`` [B, 3, H, W] normalised (ImageNet
    statistics), H and W multiples of the patch: ``cls`` → [B, D],
    ``tokens`` → the final normed tokens [B, 1 + N, D], ``tokens_pair`` →
    (pre-norm tokens, normed tokens), ``qkv_last`` → (normed tokens, (q, k,
    v) of the last block, each [B, heads, 1 + N, D / heads]), ``attn_last``
    → the last block's attention [B, heads, 1 + N, 1 + N].

``dtype`` is the compute dtype of the linear layers and the patch
embedding (float32 or bfloat16); the residual stream, the LayerNorms and
the softmax stay float32, as flax promotes them.

Two training options of the JAX network:

  * ``patch_keep_ids`` [B, n_keep] (MSN's anchor patch drop): only those
    patch tokens go through the blocks.  The position embedding is added
    to the patches before the gather, and the CLS token gets its own
    entry after it (the order of the JAX branch, which differs from the
    unmasked one);
  * ``drop_path_rate`` (MAE fine-tuning): timm's stochastic depth, block
    ``i`` at rate ``drop_path_rate · i / max(depth − 1, 1)``, each residual
    branch kept per sample with probability ``1 − rate`` and scaled by
    ``1 / (1 − rate)``.  The keep masks are an argument of `forward`
    (``drop_masks`` [depth, 2, B]: the attention branch's, then the MLP's),
    drawn by `draw_drop_masks` from a caller's `torch.Generator` or handed
    in (the tests hand in JAX's draws); without them the network is
    deterministic, as JAX's ``deterministic=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.resize import resize

__all__ = ["VisionTransformer", "vit_small", "vit_base", "interpolate_pos_embed"]

OUTS = ("cls", "tokens", "tokens_pair", "qkv_last", "attn_last")


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input and parameters cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight.float(),
                        layer.bias.float(), layer.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x, dtype), approximate="none"), dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, return_qkv: bool = False):
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = _linear(self.qkv, x, dtype).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                      # [b, h, n, d]
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1)) * (d ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v.to(attn.dtype))
        out = _linear(self.proj, out.transpose(1, 2).reshape(b, n, c), dtype)
        return out, ((q, k, v, attn) if return_qkv else None)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, return_qkv: bool = False,
                drop: tuple[float, torch.Tensor] | None = None):
        """``drop``: (keep probability, [2, B] keep masks of the two branches)."""
        y, qkv = self.attn(_layer_norm(self.norm1, x), dtype, return_qkv)
        x = x + _drop_path(y, drop, 0)
        x = x + _drop_path(self.mlp(_layer_norm(self.norm2, x), dtype), drop, 1)
        return x, qkv


def _drop_path(y: torch.Tensor, drop, branch: int) -> torch.Tensor:
    """timm's DropPath as the JAX Block applies it: ``y · mask / keep``."""
    if drop is None or drop[0] == 1.0:
        return y
    keep, masks = drop
    return y * masks[branch].to(y.dtype)[:, None, None] / keep


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: tuple[int, int]) -> torch.Tensor:
    """[1, 1 + N0, C] → [1, 1 + h·w, C]: the patch grid resampled with JAX's
    cubic (DINO's interpolate_pos_encoding), the CLS entry kept."""
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    g0 = int(round(patch_pe.shape[1] ** 0.5))
    h, w = grid_hw
    if (g0, g0) == (h, w):
        return pos_embed
    patch = patch_pe.reshape(1, g0, g0, -1)
    patch = resize(patch, (1, h, w, patch.shape[-1]), method="cubic")
    return torch.cat([cls_pe, patch.reshape(1, h * w, -1)], dim=1)


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, pretrain_img_size: int = 224,
                 dtype: torch.dtype = torch.float32, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.patch_size, self.embed_dim, self.depth = patch_size, embed_dim, depth
        self.num_heads, self.pretrain_img_size, self.dtype = num_heads, pretrain_img_size, dtype
        g0 = pretrain_img_size // patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g0 * g0, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def feat_dim(self) -> int:
        return self.embed_dim

    def block_keep(self, i: int) -> float:
        """Block ``i``'s keep probability (timm's linear drop-path ramp)."""
        return 1.0 - self.drop_path_rate * i / max(self.depth - 1, 1)

    def draw_drop_masks(self, b: int, generator: torch.Generator) -> torch.Tensor:
        """[depth, 2, B] Bernoulli(keep of the block) draws, on the generator's device."""
        keep = torch.tensor([self.block_keep(i) for i in range(self.depth)],
                            device=generator.device)
        u = torch.rand(self.depth, 2, b, generator=generator, device=generator.device)
        return (u < keep[:, None, None]).float()

    def forward(self, x: torch.Tensor, out: str = "cls", patch_keep_ids: torch.Tensor | None = None,
                drop_masks: torch.Tensor | None = None):
        """``patch_keep_ids`` [B, n_keep] and ``drop_masks`` [depth, 2, B]: see the module
        docstring; ``drop_masks=None`` is the deterministic network."""
        if out not in OUTS:
            raise ValueError(out)
        b, _, hh, ww = x.shape
        p = self.patch_size
        if hh % p or ww % p:
            raise ValueError(f"input {hh}x{ww} is not a multiple of the patch {p}")
        proj = self.patch_embed.proj
        x = F.conv2d(x.to(self.dtype), proj.weight.to(self.dtype), proj.bias.to(self.dtype),
                     stride=p)
        x = x.flatten(2).transpose(1, 2)                        # [b, gh*gw, D]
        pos = interpolate_pos_embed(self.pos_embed, (hh // p, ww // p))
        if patch_keep_ids is not None:
            x = x.to(pos.dtype) + pos[:, 1:]
            x = torch.gather(x, 1, patch_keep_ids[..., None].expand(-1, -1, self.embed_dim))
            cls = (self.cls_token + pos[:, :1]).expand(b, 1, self.embed_dim)
            x = torch.cat([cls, x], dim=1)
        else:
            cls = self.cls_token.expand(b, 1, self.embed_dim)
            x = torch.cat([cls, x.to(cls.dtype)], dim=1) + pos  # float32, as flax promotes

        qkv_last = None
        for i, blk in enumerate(self.blocks):
            want = i == self.depth - 1 and out in ("qkv_last", "attn_last")
            drop = None if drop_masks is None else (self.block_keep(i), drop_masks[i])
            x, qkv = blk(x, self.dtype, want, drop)
            if qkv is not None:
                qkv_last = qkv
        pre_norm = x
        x = _layer_norm(self.norm, x)
        if out == "cls":
            return x[:, 0]
        if out == "tokens":
            return x
        if out == "tokens_pair":
            return pre_norm, x
        if out == "qkv_last":
            q, k, v, _ = qkv_last
            return x, (q, k, v)
        return qkv_last[3]


def vit_small(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kw)
