"""MAE pre-training (Masked Autoencoder, He et al. 2021): the network, its
loss and its train step.

The port's copy of `sgdm_tpu/selfsup/mae.py`, under the official MAE's
torch names (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}``, ``norm``, ``decoder_embed``, ``mask_token``,
``decoder_pos_embed``, ``decoder_blocks.{i}``, ``decoder_norm``,
``decoder_pred``; `models/convert.py vit_from_flax` carries the JAX
package's params across):

  * the target: the input's patches ([B, N, p²·3], pixels of a patch in
    (row, column, channel) order), each normalised by its own mean and
    variance (``norm_pix``, eps 1e-6);
  * masking by the argsort of per-patch uniform noise [B, N]: the first
    ``max(int(N·(1 − mask_ratio)), 1)`` of the shuffle are kept, ``mask``
    is 1 where a patch is hidden;
  * the encoder (the port's ViT blocks) over CLS + the visible tokens, the
    position embedding added before the gather and to the CLS token;
  * the decoder: the visible tokens embedded, scattered back to their
    places among mask tokens, plus ``decoder_pos_embed`` (stored on the
    pretrain grid without a CLS row, resampled with a zero CLS row
    prepended), narrow ViT blocks, a float32 projection to pixels.

The noise comes from the caller: handed in (the tests hand in JAX's
``jax.random.uniform`` draw) or drawn from a `torch.Generator`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vit import Block, _layer_norm, _linear, interpolate_pos_embed
from .pretrain_common import apply_updates, grads_of

__all__ = ["MAE", "mae_loss", "make_mae_train_step", "encoder_state_for_backbone"]


class MAE(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, decoder_dim: int = 256, decoder_depth: int = 4,
                 decoder_heads: int = 8, mask_ratio: float = 0.75, pretrain_img_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.embed_dim, self.depth = patch_size, embed_dim, depth
        self.num_heads, self.decoder_dim = num_heads, decoder_dim
        self.decoder_depth, self.decoder_heads = decoder_depth, decoder_heads
        self.mask_ratio, self.pretrain_img_size, self.dtype = mask_ratio, pretrain_img_size, dtype
        g0 = pretrain_img_size // patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g0 * g0, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.decoder_embed = nn.Linear(embed_dim, decoder_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
        self.decoder_pos_embed = nn.Parameter(torch.zeros(1, g0 * g0, decoder_dim))
        self.decoder_blocks = nn.ModuleList(Block(decoder_dim, decoder_heads)
                                            for _ in range(decoder_depth))
        self.decoder_norm = nn.LayerNorm(decoder_dim, eps=1e-6)
        self.decoder_pred = nn.Linear(decoder_dim, patch_size * patch_size * 3)

    def n_keep(self, n: int) -> int:
        return max(int(n * (1 - self.mask_ratio)), 1)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """x [B, 3, H, W] → (pred [B, N, p²·3], normalised target, mask [B, N]);
        ``noise`` [B, N] uniform, else drawn from ``generator``."""
        b, _, hh, ww = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        n = gh * gw
        n_keep = self.n_keep(n)

        target = x.permute(0, 2, 3, 1).reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
        target = target.reshape(b, n, p * p * 3)
        var, mu = torch.var_mean(target, dim=-1, keepdim=True, correction=0)
        target_n = (target - mu) / torch.sqrt(var + 1e-6)

        proj = self.patch_embed.proj
        tokens = F.conv2d(x.to(self.dtype), proj.weight.to(self.dtype), proj.bias.to(self.dtype),
                          stride=p).flatten(2).transpose(1, 2).float()
        pos = interpolate_pos_embed(self.pos_embed, (gh, gw))
        tokens = tokens + pos[:, 1:]

        if noise is None:
            noise = torch.rand(b, n, generator=generator, device=x.device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :n_keep]
        d = self.embed_dim
        visible = torch.gather(tokens, 1, ids_keep[..., None].expand(-1, -1, d))
        mask = torch.ones(b, n, device=x.device)
        mask[:, :n_keep] = 0.0
        mask = torch.gather(mask, 1, ids_restore)                   # 1 = hidden

        cls = (self.cls_token + pos[:, :1]).expand(b, 1, d)
        h = torch.cat([cls, visible], dim=1)
        for blk in self.blocks:
            h, _ = blk(h, self.dtype)
        h = _layer_norm(self.norm, h)

        dd = self.decoder_dim
        dec = _linear(self.decoder_embed, h, self.dtype).float()
        dec_tokens = torch.scatter(self.mask_token.expand(b, n, dd), 1,
                                   ids_keep[..., None].expand(-1, -1, dd), dec[:, 1:])
        dec_pos = interpolate_pos_embed(
            torch.cat([torch.zeros_like(self.decoder_pos_embed[:, :1]), self.decoder_pos_embed],
                      dim=1), (gh, gw))[:, 1:]
        dh = torch.cat([dec[:, :1], dec_tokens + dec_pos], dim=1)
        for blk in self.decoder_blocks:
            dh, _ = blk(dh, self.dtype)
        dh = _layer_norm(self.decoder_norm, dh)
        pred = _linear(self.decoder_pred, dh[:, 1:], torch.float32)
        return pred, target_n, mask


def encoder_state_for_backbone(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The encoder's entries of an `MAE` state dict: a `VisionTransformer`'s."""
    keep = ("cls_token", "pos_embed", "patch_embed.", "norm.", "blocks.")
    return {k: v for k, v in state.items() if k.startswith(keep)}


def mae_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the hidden patches only."""
    per_patch = ((pred - target) ** 2).mean(-1)
    return (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_mae_train_step(model: MAE, tx):
    """``step(x, noise=None, generator=None) -> loss``: the loss, its gradient,
    ``tx``'s update (its state kept in ``step.opt_state``) applied in place."""
    params = list(model.parameters())
    holder = {"opt": tx.init(params)}

    def step(x, noise=None, generator=None):
        pred, target, mask = model(x, noise=noise, generator=generator)
        loss = mae_loss(pred, target, mask)
        grads = grads_of(loss, params)
        updates, holder["opt"] = tx.update(list(grads), holder["opt"], params)
        apply_updates(params, updates)
        return loss.detach()

    step.opt_state = holder
    return step
