"""ADM-style UNet denoisers: the concat-conditioning `UNetModel`
(`dynamic=unet_fast` family) and the cross-attention `UNetCAModel`
(`dynamic=unetca_fast` family).

Port of `sgdm_tpu/models/unet.py` `UNetBackbone`, `UNetModel` and
`UNetCAModel`.  NHWC in and out; both share one `UNetBackbone`; the output
conv runs in float32.

`UNetModel`: ``cond`` [B, cond_dim] is masked per sample by
``cond_drop_mask`` (True = drop → the zero null embedding), goes through a
2-layer MLP to 2·model_channels and is concatenated onto the
4·model_channels time embedding.  ``condition_method='clusterlayout'`` also
channel-concats the (masked) layout map onto x; ``'cluster_lookup'`` reads
cond from a learned per-image table.

`UNetCAModel`: the context of every `AttentionLR` block is
LayerNorm(concat(8 time tokens, condition tokens)); the pooled condition
goes through ``cond_mlp`` and is ADDED to the time embedding.
``cond_token_num`` 0: time tokens only (``condition_method='layout'``
channel-concats the layout); 1: a vector ``cond`` [B, cond_dim] becomes 8
tokens (``clusterlayout`` / ``stegoclusterlayout`` also concat the layout);
more: token conds [B, T, cond_dim] through a 4-layer MLP per token, pooled
by the first token or the mean.  The layout of a dropped sample is zeroed.

``forward(..., train=True, dropout_seed=s)`` takes the training routes of
`layers.py` (K4/K5 ResBlocks, K9 attention) with dropout; each ResBlock
draws its own seed from ``s`` and its ``block_index`` (the order the
blocks are built in); ``dropout_rows`` places the batch in the global
batch of a data-parallel step (`layers.ResBlock.forward`).

Submodule names follow the flax tree (``backbone.down_0_0``,
``backbone.mid_attn``, ``backbone.GroupNorm32_0`` …).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention_lr import AttentionLR, LayerNorm
from .layers import (
    Conv,
    Dense,
    Downsample,
    GroupNorm32,
    ResBlock,
    SelfAttentionBlock,
    Upsample,
    timestep_embedding,
)

__all__ = ["UNetBackbone", "UNetModel", "UNetCAModel"]


def _mask_cond(cond: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace dropped samples' condition with the (zero) null embedding."""
    shape = (-1,) + (1,) * (cond.ndim - 1)
    return torch.where(mask.reshape(shape), torch.zeros_like(cond), cond)


class UNetBackbone(nn.Module):
    """Encoder / middle / decoder trunk with skip concatenation."""

    def __init__(
        self,
        in_channels: int,
        emb_channels: int,
        model_channels: int = 128,
        out_channels: int = 3,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4,),
        channel_mult: Sequence[int] = (1, 2, 4),
        num_heads: int = 8,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = False,
        use_ca_block: bool = False,
        context_dim: int | None = None,
        dropout: float = 0.0,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.resblock_updown = resblock_updown
        self.use_ca_block = use_ca_block
        mc = model_channels
        res = lambda cin, cout, **kw: ResBlock(cin, cout, emb_channels, dropout=dropout,
                                               use_scale_shift_norm=use_scale_shift_norm,
                                               dtype=dtype, **kw)

        def attn(c):
            if not use_ca_block:
                return SelfAttentionBlock(c, num_heads, num_head_channels, dtype=dtype)
            if num_head_channels == -1:
                heads, dim_head = num_heads, c // num_heads
            else:
                heads, dim_head = c // num_head_channels, num_head_channels
            return AttentionLR(c, heads, dim_head, context_dim, dtype=dtype)

        self.in_conv = Conv(in_channels, mc, 3, dtype=dtype)
        ch, chans, ds = mc, [mc], 1
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}", res(ch, mult * mc))
                ch = mult * mc
                if ds in self.attention_resolutions:
                    self.add_module(f"down_attn_{level}_{i}", attn(ch))
                chans.append(ch)
            if level != len(self.channel_mult) - 1:
                self.add_module(f"downsample_{level}",
                                res(ch, ch, down=True) if resblock_updown
                                else Downsample(ch, dtype=dtype))
                chans.append(ch)
                ds *= 2
        self.mid_res1 = res(ch, ch)
        self.mid_attn = attn(ch)
        self.mid_res2 = res(ch, ch)
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}", res(ch + chans.pop(), mult * mc))
                ch = mult * mc
                if ds in self.attention_resolutions:
                    self.add_module(f"up_attn_{level}_{i}", attn(ch))
                if level and i == num_res_blocks:
                    self.add_module(f"upsample_{level}",
                                    res(ch, ch, up=True) if resblock_updown
                                    else Upsample(ch, dtype=dtype))
                    ds //= 2
        assert not chans
        self.GroupNorm32_0 = GroupNorm32(ch)
        self.out_conv = Conv(ch, out_channels, 3, dtype=torch.float32)
        for index, blk in enumerate(m for m in self.modules() if isinstance(m, ResBlock)):
            blk.block_index = index

    def _updown(self, name: str, h: torch.Tensor, emb: torch.Tensor, *tr) -> torch.Tensor:
        blk = getattr(self, name)
        return blk(h, emb, *tr) if self.resblock_updown else blk(h)

    def _attend(self, name: str, h: torch.Tensor, context, train: bool) -> torch.Tensor:
        blk = getattr(self, name)
        return blk(h, context, train) if self.use_ca_block else blk(h, train)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, context: torch.Tensor | None = None,
                train: bool = False, dropout_seed: int = 0,
                dropout_rows: tuple[int, int] | None = None) -> torch.Tensor:
        tr = (train, dropout_seed, dropout_rows)
        h = self.in_conv(x)
        hs = [h]
        ds = 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_{i}")(h, emb, *tr)
                if ds in self.attention_resolutions:
                    h = self._attend(f"down_attn_{level}_{i}", h, context, train)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = self._updown(f"downsample_{level}", h, emb, *tr)
                hs.append(h)
                ds *= 2
        h = self._attend("mid_attn", self.mid_res1(h, emb, *tr), context, train)
        h = self.mid_res2(h, emb, *tr)
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                h = getattr(self, f"up_{level}_{i}")(h, emb, *tr)
                if ds in self.attention_resolutions:
                    h = self._attend(f"up_attn_{level}_{i}", h, context, train)
                if level and i == self.num_res_blocks:
                    h = self._updown(f"upsample_{level}", h, emb, *tr)
                    ds //= 2
        h = F.silu(self.GroupNorm32_0(h))
        return self.out_conv(h.float())


class UNetModel(nn.Module):
    """Concat-conditioning UNet: ``forward(x, t, cond, layout, cond_drop_mask,
    image_batch_ids, train, dropout_seed) -> eps`` (f32, NHWC).  ``kernels``
    (see `layers.set_kernels`) also selects the train step's optimizer kernel."""

    def __init__(
        self,
        in_channels: int = 3,
        model_channels: int = 128,
        out_channels: int = 3,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4,),
        channel_mult: Sequence[int] = (1, 2, 4),
        num_heads: int = 8,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = True,
        cond_dim: int = 0,
        condition_method: str | None = None,
        layout_dim: int = 1,
        lookup_table_size: int = 0,
        dropout: float = 0.0,
        dtype=torch.float32,
    ):
        super().__init__()
        mc = model_channels
        self.kernels = True
        self.model_channels = mc
        self.cond_dim = cond_dim
        self.condition_method = condition_method
        self.layout_dim = layout_dim if cond_dim > 0 and condition_method == "clusterlayout" else 0
        self.dtype = dtype
        self.time_embed_1 = Dense(mc, 4 * mc, dtype=dtype)
        self.time_embed_2 = Dense(4 * mc, 4 * mc, dtype=dtype)
        emb_channels = 4 * mc
        x_channels = in_channels
        if condition_method == "cluster_lookup":
            self.lookup_table = nn.Embedding(lookup_table_size, cond_dim)
        if cond_dim > 0:
            self.mlp_cond_1 = Dense(cond_dim, 2 * mc, dtype=dtype)
            self.mlp_cond_2 = Dense(2 * mc, 2 * mc, dtype=dtype)
            emb_channels += 2 * mc
            if condition_method == "clusterlayout":
                x_channels += layout_dim
        self.backbone = UNetBackbone(
            x_channels, emb_channels, model_channels=mc, out_channels=out_channels,
            num_res_blocks=num_res_blocks, attention_resolutions=attention_resolutions,
            channel_mult=channel_mult, num_heads=num_heads,
            num_head_channels=num_head_channels, use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown, dropout=dropout, dtype=dtype,
        )

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        cond: torch.Tensor | None = None,
        layout: torch.Tensor | None = None,
        cond_drop_mask: torch.Tensor | None = None,
        image_batch_ids: torch.Tensor | None = None,
        train: bool = False,
        dropout_seed: int = 0,
        dropout_rows: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        b = x.shape[0]
        if cond_drop_mask is None:
            cond_drop_mask = torch.zeros((b,), dtype=torch.bool, device=x.device)
        if self.condition_method == "cluster_lookup":
            if image_batch_ids is None:
                raise ValueError("cluster_lookup needs image_batch_ids")
            cond = self.lookup_table(image_batch_ids.long())

        emb = self.time_embed_1(timestep_embedding(t, self.model_channels))
        emb = self.time_embed_2(F.silu(emb))
        if self.cond_dim > 0:
            if cond is None or tuple(cond.shape) != (b, self.cond_dim):
                raise ValueError(f"cond must be [{b}, {self.cond_dim}]")
            cond_masked = _mask_cond(cond.to(emb.dtype), cond_drop_mask)
            if self.condition_method == "clusterlayout":
                if layout is None:
                    raise ValueError("clusterlayout needs a layout")
                x = torch.cat([x, _mask_cond(layout.to(x.dtype), cond_drop_mask)], dim=-1)
            c = self.mlp_cond_1(cond_masked)
            c = self.mlp_cond_2(F.silu(c))
            emb = torch.cat([emb, c], dim=-1)
        return self.backbone(x.to(self.dtype), emb, None, train, dropout_seed, dropout_rows)


class UNetCAModel(nn.Module):
    """Cross-attention UNet: ``forward(x, t, cond, layout, cond_drop_mask,
    train, dropout_seed) -> eps`` (f32, NHWC).  ``layout_dim`` is the channel
    count of the layout map the condition method concatenates onto x (0 for
    none).  ``kernels`` as in `UNetModel`."""

    def __init__(
        self,
        in_channels: int = 3,
        model_channels: int = 128,
        out_channels: int = 3,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4,),
        channel_mult: Sequence[int] = (1, 2, 4),
        num_heads: int = 8,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = False,
        cond_dim: int = 0,
        cond_token_num: int = 0,
        context_dim: int = 32,
        num_time_tokens: int = 8,
        num_cond_tokens: int = 8,
        use_cls_token_as_pooled: bool = True,
        condition_method: str | None = None,
        layout_dim: int = 0,
        dropout: float = 0.0,
        dtype=torch.float32,
    ):
        super().__init__()
        mc = model_channels
        self.kernels = True
        self.model_channels = mc
        self.cond_dim = cond_dim
        self.cond_token_num = cond_token_num
        self.context_dim = context_dim
        self.num_time_tokens, self.num_cond_tokens = num_time_tokens, num_cond_tokens
        self.use_cls_token_as_pooled = use_cls_token_as_pooled
        self.condition_method = condition_method
        self.dtype = dtype
        self.time_embed_1 = Dense(mc, 4 * mc, dtype=dtype)
        self.time_embed_2 = Dense(4 * mc, 4 * mc, dtype=dtype)
        self.to_time_tokens_1 = Dense(mc, mc, dtype=dtype)
        self.to_time_tokens_2 = Dense(mc, context_dim * num_time_tokens, dtype=dtype)
        if cond_token_num == 0:
            self.concat_layout = condition_method == "layout"
        elif cond_token_num == 1:
            self.to_cond_tokens = Dense(cond_dim, context_dim * num_cond_tokens, dtype=dtype)
            self.concat_layout = condition_method in ("clusterlayout", "stegoclusterlayout")
        else:
            mid = int((context_dim * cond_dim) ** 0.5)
            self.to_cond_tokens_2d_1 = Dense(cond_dim, mid, dtype=dtype)
            self.to_cond_tokens_2d_2 = Dense(mid, mid, dtype=dtype)
            self.to_cond_tokens_2d_3 = Dense(mid, mid, dtype=dtype)
            self.to_cond_tokens_2d_4 = Dense(mid, context_dim, dtype=dtype)
            self.concat_layout = False
        if cond_token_num >= 1:
            self.cond_mlp_1 = Dense(cond_dim, 4 * mc, dtype=dtype)
            self.cond_mlp_2 = Dense(4 * mc, 4 * mc, dtype=dtype)
        if self.concat_layout and layout_dim <= 0:
            raise ValueError(f"condition_method {condition_method!r} needs layout_dim > 0")
        self.layout_dim = layout_dim if self.concat_layout else 0
        self.norm_cond = LayerNorm(context_dim)
        self.backbone = UNetBackbone(
            in_channels + self.layout_dim, 4 * mc, model_channels=mc, out_channels=out_channels,
            num_res_blocks=num_res_blocks, attention_resolutions=attention_resolutions,
            channel_mult=channel_mult, num_heads=num_heads,
            num_head_channels=num_head_channels, use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown, use_ca_block=True, context_dim=context_dim,
            dropout=dropout, dtype=dtype,
        )

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        cond: torch.Tensor | None = None,
        layout: torch.Tensor | None = None,
        cond_drop_mask: torch.Tensor | None = None,
        train: bool = False,
        dropout_seed: int = 0,
        dropout_rows: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        b = x.shape[0]
        if cond_drop_mask is None:
            cond_drop_mask = torch.zeros((b,), dtype=torch.bool, device=x.device)
        t_emb = timestep_embedding(t, self.model_channels).to(self.dtype)
        emb = self.time_embed_2(F.silu(self.time_embed_1(t_emb)))
        tt = self.to_time_tokens_2(F.silu(self.to_time_tokens_1(t_emb)))
        context = tt.reshape(b, self.num_time_tokens, self.context_dim)

        if self.cond_token_num >= 1:
            want = 2 if self.cond_token_num == 1 else 3
            if cond is None or cond.ndim != want or cond.shape[-1] != self.cond_dim:
                raise ValueError(f"cond must have {want} axes, the last {self.cond_dim} wide")
            cond_masked = _mask_cond(cond.to(self.dtype), cond_drop_mask)
            if self.cond_token_num == 1:
                tokens = self.to_cond_tokens(cond_masked).reshape(
                    b, self.num_cond_tokens, self.context_dim)
                pooled = cond_masked
            else:
                h = self.to_cond_tokens_2d_1(cond_masked)
                h = self.to_cond_tokens_2d_2(F.silu(h))
                h = self.to_cond_tokens_2d_3(F.silu(h))
                tokens = self.to_cond_tokens_2d_4(F.silu(h))
                pooled = cond_masked[:, 0] if self.use_cls_token_as_pooled \
                    else cond_masked.mean(dim=1)
            context = torch.cat([context, tokens], dim=1)
            emb = emb + self.cond_mlp_2(F.silu(self.cond_mlp_1(pooled)))
        if self.concat_layout:
            if layout is None or layout.shape[-1] != self.layout_dim:
                raise ValueError(f"{self.condition_method} needs a layout {self.layout_dim} "
                                 "channels deep")
            x = torch.cat([x, _mask_cond(layout.to(x.dtype), cond_drop_mask)], dim=-1)
        context = self.norm_cond(context).to(self.dtype)
        return self.backbone(x.to(self.dtype), emb, context, train, dropout_seed, dropout_rows)
