"""Encoder-half UNet for noisy-image classification (classifier guidance).

Port of `sgdm_tpu/models/encoder_unet.py` `EncoderUNetModel`: the UNet's
downsampling trunk and middle block, then a pooling head to class logits,
conditioned on the diffusion timestep.  NHWC in, f32 logits out.

  * ``pool="adaptive"``: GN + SiLU, the spatial mean, a zero-initialised
    Dense ``out`` (logits start at exactly 0);
  * ``pool="spatial"``: the spatial means after the stem, after every
    res(+attn) block, after every downsample and after the middle block,
    concatenated, then ``spatial_fc`` (2048) → ReLU → ``out``.

Submodules carry the flax names (``time_embed_1/2``, ``in_conv``,
``down_{l}_{i}``, ``down_attn_{l}_{i}``, ``downsample_{l}``, ``mid_res1``,
``mid_attn``, ``mid_res2``, ``out_norm``, ``out``, ``spatial_fc``) so
`convert.from_flax` maps the JAX tree leaf for leaf.

Routes: the JAX encoder builds its blocks with ``use_pallas=False``, and so
does this one (`layers.ResBlock` / `layers.SelfAttentionBlock`): the
ResBlocks are the plain composition with the non-kernel GroupNorm (never
K1, K2, K4, K5 or K6), and attention takes K9 wherever the flash gate
passes (N ≥ 128, head dim a multiple of 64), in training and in eval
alike, on f32 operands when the model is f32, and the einsum path
otherwise.  At the defaults on 64 px the attention level is 16×16 (N =
256, 512 channels, 8 heads of 64): three K9 calls a forward.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, Dense, Downsample, GroupNorm32, ResBlock, SelfAttentionBlock, \
    timestep_embedding

__all__ = ["EncoderUNetModel"]


class EncoderUNetModel(nn.Module):
    def __init__(self, num_classes: int = 1000, model_channels: int = 128,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (4,),
                 channel_mult: Sequence[int] = (1, 2, 4), dropout: float = 0.0,
                 num_heads: int = 8, use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, pool: str = "adaptive",
                 in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        if pool not in ("adaptive", "spatial"):
            raise ValueError(pool)
        mc = model_channels
        self.pool, self.dtype, self.model_channels = pool, dtype, mc
        emb = 4 * mc
        self.time_embed_1 = Dense(mc, emb, dtype=dtype)
        self.time_embed_2 = Dense(emb, emb, dtype=dtype)
        self.in_conv = Conv(in_channels, mc, 3, dtype=dtype)
        common = dict(dropout=dropout, use_scale_shift_norm=use_scale_shift_norm,
                      use_pallas=False, dtype=dtype)
        # (kind, name) in call order; kind "res" / "attn" / "down"; "pool"
        # marks where the spatial head takes a mean
        self.plan: list[tuple[str, str]] = [("pool", "")]
        ch, ds, feature = mc, 1, mc
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                self._add(f"down_{level}_{i}", ResBlock(ch, mult * mc, emb, **common), "res")
                ch = mult * mc
                if ds in attention_resolutions:
                    self._add(f"down_attn_{level}_{i}",
                              SelfAttentionBlock(ch, num_heads, use_pallas=False, dtype=dtype),
                              "attn")
                self.plan.append(("pool", ""))
                feature += ch
            if level != len(channel_mult) - 1:
                if resblock_updown:
                    self._add(f"downsample_{level}", ResBlock(ch, ch, emb, down=True, **common),
                              "res")
                else:
                    self._add(f"downsample_{level}", Downsample(ch, dtype=dtype), "down")
                self.plan.append(("pool", ""))
                feature += ch
                ds *= 2
        self.mid_res1 = ResBlock(ch, ch, emb, **common)
        self.mid_attn = SelfAttentionBlock(ch, num_heads, use_pallas=False, dtype=dtype)
        self.mid_res2 = ResBlock(ch, ch, emb, **common)
        for i, blk in enumerate(m for m in self.modules() if isinstance(m, ResBlock)):
            blk.block_index = i  # its dropout seed
        if pool == "adaptive":
            self.out_norm = GroupNorm32(ch)
            self.out = Dense(ch, num_classes)
        else:
            self.spatial_fc = Dense(feature + ch, 2048, dtype=dtype)
            self.out = Dense(2048, num_classes)

    def _add(self, name: str, module: nn.Module, kind: str) -> None:
        self.add_module(name, module)
        self.plan.append((kind, name))

    def forward(self, x: torch.Tensor, t: torch.Tensor, train: bool = False,
                dropout_seed: int = 0) -> torch.Tensor:
        """x [B, H, W, C], t [B] → logits [B, num_classes] f32."""
        dt = self.dtype
        emb = self.time_embed_1(timestep_embedding(t, self.model_channels).to(dt))
        emb = self.time_embed_2(F.silu(emb))
        h = self.in_conv(x.to(dt))
        pools = []
        for kind, name in self.plan:
            if kind == "pool":
                pools.append(h.mean(dim=(1, 2)))
            elif kind == "res":
                h = getattr(self, name)(h, emb, train, dropout_seed)
            elif kind == "attn":
                h = getattr(self, name)(h, train)
            else:
                h = getattr(self, name)(h)
        h = self.mid_res1(h, emb, train, dropout_seed)
        h = self.mid_attn(h, train)
        h = self.mid_res2(h, emb, train, dropout_seed)
        if self.pool == "adaptive":
            h = F.silu(self.out_norm(h)).mean(dim=(1, 2))
            return self.out(h.float())
        pools.append(h.mean(dim=(1, 2)))
        h = self.spatial_fc(torch.cat(pools, dim=-1))
        return self.out(F.relu(h).float())
