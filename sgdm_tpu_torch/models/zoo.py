"""Extra denoisers: the diffae latent MLP and the lucidrains UNets.

Port of `sgdm_tpu/models/zoo.py` (no shipped config instantiates them):

* `LatentFC`: the diffae latent-DPM MLP.  Sinusoidal t-embedding → a time
  MLP; hidden layers that re-concatenate the input, each ``linear → x ·
  (condition_bias + linear_emb(act(emb))) → LayerNorm → act``; an identity
  output layer.
* `VDMUNet`: the lucidrains denoising-diffusion UNet.  7×7 stem, per level
  two ResnetBlocks (conv → GroupNorm → FiLM (scale + 1, shift) → SiLU,
  twice, plus a 1×1 residual), pre-norm linear attention and a stride-2 4×4
  down conv; a mid block with full attention; the ups mirror it with skip
  concatenation and 4×4 transposed-conv upsampling; a last ResnetBlock over
  [x ‖ stem output].  ``learned_sinusoidal_cond`` keeps the raw t beside
  its learned Fourier features.
* `DDPMUNet`: the newer lucidrains variant (two skips a level, the channel
  changes inside the down conv and the nearest-up + 3×3 conv).

Like the JAX modules they take NHWC images and a float t [B] and ignore
conditioning arguments; parameters carry the flax names (``down_0_b1.
block1.proj`` …), the attention of a level under ``<level>_attn.fn``
(`models/convert.py zoo_from_flax`).  Linear attention is q softmaxed over
features, k over tokens; attention, norms and convolutions are plain
PyTorch ops, as the JAX package's are XLA ops.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import timestep_embedding

__all__ = ["LatentFC", "VDMUNet", "DDPMUNet"]


_ACTS = {
    "none": lambda x: x,
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, 0.2),
    "silu": F.silu,
    "tanh": torch.tanh,
}


class _MLPLNAct(nn.Module):
    """linear → (× cond) → LayerNorm → act (dropout off at inference)."""

    def __init__(self, cin: int, cout: int, emb: int, norm: bool, use_cond: bool,
                 activation: str, condition_bias: float = 1.0, dropout: float = 0.0):
        super().__init__()
        self.act, self.condition_bias, self.dropout = _ACTS[activation], condition_bias, dropout
        self.linear = nn.Linear(cin, cout)
        self.linear_emb = nn.Linear(emb, cout) if use_cond else None
        self.norm = nn.LayerNorm(cout, eps=1e-6) if norm else None

    def forward(self, x, cond=None):
        x = self.linear(x)
        if self.linear_emb is not None:
            x = x * (self.condition_bias + self.linear_emb(self.act(cond)))
        if self.norm is not None:
            x = self.norm(x)
        return F.dropout(self.act(x), self.dropout, self.training)


class LatentFC(nn.Module):
    """The diffae latent-DPM MLP denoiser: ``forward(x [B, num_channels], t [B])``."""

    def __init__(self, num_layers: int = 10, num_time_layers: int = 2,
                 num_channels: int = 2048, num_time_emb_channels: int = 64,
                 model_channels: int = 512, condition_bias: float = 1.0,
                 time_last_act: bool = False, dropout: float = 0.0, use_norm: bool = True,
                 activation: str = "silu", last_act: str = "none"):
        super().__init__()
        self.num_time_emb_channels, self.time_last_act = num_time_emb_channels, time_last_act
        self.act, self.last_act = _ACTS[activation], _ACTS[last_act]
        self.num_time_layers = num_time_layers
        for i in range(num_time_layers):
            self.add_module(f"time_{i}", nn.Linear(
                num_time_emb_channels if i == 0 else num_channels, num_channels))
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            cin = num_channels if i == 0 else model_channels + num_channels
            self.add_module(f"layer_{i}", _MLPLNAct(
                cin, num_channels if last else model_channels, num_channels,
                norm=use_norm and not last, use_cond=not last,
                activation="none" if last else activation, condition_bias=condition_bias,
                dropout=0.0 if last else dropout))

    def forward(self, x: torch.Tensor, t: torch.Tensor, **_ignored) -> torch.Tensor:
        emb = timestep_embedding(t, self.num_time_emb_channels)
        for i in range(self.num_time_layers):
            emb = getattr(self, f"time_{i}")(emb)
            if i < self.num_time_layers - 1 or self.time_last_act:
                emb = self.act(emb)
        h = x
        for i in range(self.num_layers):
            if i >= 1:
                h = torch.cat([h, x], dim=-1)
            h = getattr(self, f"layer_{i}")(h, emb)
        return self.last_act(h)


class _ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels (biased variance, eps 1e-5), gain ``g``,
    bias ``b``."""

    def __init__(self, c: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(c))
        self.b = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.g[:, None, None] \
            + self.b[:, None, None]


class _Block(nn.Module):
    """conv3×3 → GroupNorm → FiLM (scale + 1, shift) → SiLU."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm = nn.GroupNorm(groups, cout, eps=1e-6)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale[:, :, None, None] + 1) + shift[:, :, None, None]
        return F.silu(x)


class _ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, time_dim: int, groups: int):
        super().__init__()
        self.mlp = nn.Linear(time_dim, 2 * cout)
        self.block1 = _Block(cin, cout, groups)
        self.block2 = _Block(cout, cout, groups)
        self.res_conv = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, t_emb):
        scale_shift = self.mlp(F.silu(t_emb)).chunk(2, dim=-1)
        h = self.block2(self.block1(x, scale_shift))
        return h + (x if self.res_conv is None else self.res_conv(x))


def _heads(qkv: torch.Tensor, heads: int, dim_head: int):
    """[B, 3·hid, H, W] → q, k, v each [B, N, heads, dim_head]."""
    b = qkv.shape[0]
    qkv = qkv.flatten(2).transpose(1, 2).reshape(b, -1, 3, heads, dim_head)
    return qkv.unbind(2)


class _LinearAttention(nn.Module):
    """softmax(q over features)·d^-½ against softmax(k over tokens) in the
    efficient-attention order, then a 1×1 conv and a channel LayerNorm."""

    def __init__(self, c: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hid = heads * dim_head
        self.to_qkv = nn.Conv2d(c, 3 * hid, 1, bias=False)
        self.to_out = nn.Conv2d(hid, c, 1)
        self.out_norm = _ChannelLayerNorm(c)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = _heads(self.to_qkv(x), self.heads, self.dim_head)
        q = q.softmax(-1) * self.dim_head ** -0.5
        k = k.softmax(1)
        ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", ctx, q).reshape(b, h, w, -1)
        return self.out_norm(self.to_out(out.permute(0, 3, 1, 2)))


class _Attention(nn.Module):
    """Softmax attention over the pixels, then a 1×1 conv."""

    def __init__(self, c: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hid = heads * dim_head
        self.to_qkv = nn.Conv2d(c, 3 * hid, 1, bias=False)
        self.to_out = nn.Conv2d(hid, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = _heads(self.to_qkv(x), self.heads, self.dim_head)
        sim = torch.einsum("bnhd,bmhd->bhnm", q * self.dim_head ** -0.5, k)
        out = torch.einsum("bhnm,bmhd->bnhd", sim.softmax(-1), v).reshape(b, h, w, -1)
        return self.to_out(out.permute(0, 3, 1, 2))


class _PreNormResidual(nn.Module):
    def __init__(self, c: int, fn: nn.Module):
        super().__init__()
        self.norm = _ChannelLayerNorm(c)
        self.fn = fn

    def forward(self, x):
        return x + self.fn(self.norm(x))


class _LucidrainsUNet(nn.Module):
    """What VDMUNet and DDPMUNet share: stem, time MLP, mid block, output."""

    def __init__(self, dim, init_dim, out_dim, dim_mults, channels, resnet_block_groups,
                 learned_variance, time_in):
        super().__init__()
        self.dim, self.groups = dim, resnet_block_groups
        init_dim = init_dim or dim
        self.init_conv = nn.Conv2d(channels, init_dim, 7, padding=3)
        self.time_dim = dim * 4
        self.time_mlp1 = nn.Linear(time_in, self.time_dim)
        self.time_mlp2 = nn.Linear(self.time_dim, self.time_dim)
        dims = [init_dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        mid = dims[-1]
        self.mid_b1 = self._res(mid, mid)
        self.mid_attn = _PreNormResidual(mid, _Attention(mid))
        self.mid_b2 = self._res(mid, mid)
        self.final_res = self._res(2 * init_dim, dim)
        self.final_conv = nn.Conv2d(dim, out_dim or channels * (2 if learned_variance else 1), 1)

    def _res(self, cin, cout):
        return _ResnetBlock(cin, cout, self.time_dim, self.groups)

    def _time(self, emb):
        return self.time_mlp2(F.gelu(self.time_mlp1(emb), approximate="tanh"))

    def _mid(self, x, emb):
        return self.mid_b2(self.mid_attn(self.mid_b1(x, emb)), emb)

    def forward_with_cond_scale(self, x, t, cond_scale=None, **kwargs):
        """Unconditional passthrough."""
        return self(x, t, **kwargs)


class VDMUNet(_LucidrainsUNet):
    """The lucidrains denoising-diffusion UNet: ``forward(x [B, H, W, C], t [B])``."""

    def __init__(self, dim: int = 64, init_dim: int | None = None, out_dim: int | None = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3,
                 resnet_block_groups: int = 8, learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False, learned_sinusoidal_dim: int = 16):
        super().__init__(dim, init_dim, out_dim, dim_mults, channels, resnet_block_groups,
                         learned_variance,
                         learned_sinusoidal_dim + 1 if learned_sinusoidal_cond else dim)
        self.sinu_weights = (nn.Parameter(torch.randn(learned_sinusoidal_dim // 2))
                             if learned_sinusoidal_cond else None)
        n = len(self.in_out)
        for i, (din, dout) in enumerate(self.in_out):
            self.add_module(f"down_{i}_b1", self._res(din, dout))
            self.add_module(f"down_{i}_b2", self._res(dout, dout))
            self.add_module(f"down_{i}_attn", _PreNormResidual(dout, _LinearAttention(dout)))
            if i < n - 1:
                self.add_module(f"down_{i}_ds", nn.Conv2d(dout, dout, 4, stride=2, padding=1))
        for i, (din, dout) in enumerate(reversed(self.in_out)):
            self.add_module(f"up_{i}_b1", self._res(2 * dout, din))
            self.add_module(f"up_{i}_b2", self._res(din, din))
            self.add_module(f"up_{i}_attn", _PreNormResidual(din, _LinearAttention(din)))
            if i < n - 1:
                self.add_module(f"up_{i}_us", nn.ConvTranspose2d(din, din, 4, stride=2,
                                                                 padding=1))

    def forward(self, x: torch.Tensor, t: torch.Tensor, **_ignored) -> torch.Tensor:
        x = self.init_conv(x.permute(0, 3, 1, 2))
        r = x
        tf = t.float()
        if self.sinu_weights is not None:
            freqs = tf[:, None] * self.sinu_weights[None] * 2 * math.pi
            emb = torch.cat([tf[:, None], freqs.sin(), freqs.cos()], dim=-1)
        else:
            emb = timestep_embedding(tf, self.dim)
        emb = self._time(emb)
        n, hs = len(self.in_out), []
        for i in range(n):
            x = getattr(self, f"down_{i}_b1")(x, emb)
            x = getattr(self, f"down_{i}_b2")(x, emb)
            x = getattr(self, f"down_{i}_attn")(x)
            hs.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_ds")(x)
        x = self._mid(x, emb)
        for i in range(n):
            x = torch.cat([x, hs.pop()], dim=1)
            x = getattr(self, f"up_{i}_b1")(x, emb)
            x = getattr(self, f"up_{i}_b2")(x, emb)
            x = getattr(self, f"up_{i}_attn")(x)
            if i < n - 1:
                x = getattr(self, f"up_{i}_us")(x)
        x = self.final_res(torch.cat([x, r], dim=1), emb)
        return self.final_conv(x).permute(0, 2, 3, 1)


class DDPMUNet(_LucidrainsUNet):
    """The lucidrains DDPM UNet variant: ``forward(x [B, H, W, C], t [B])``."""

    def __init__(self, dim: int = 64, init_dim: int | None = None, out_dim: int | None = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3,
                 resnet_block_groups: int = 8, learned_variance: bool = False):
        super().__init__(dim, init_dim, out_dim, dim_mults, channels, resnet_block_groups,
                         learned_variance, dim)
        n = len(self.in_out)
        for i, (din, dout) in enumerate(self.in_out):
            self.add_module(f"down_{i}_b1", self._res(din, din))
            self.add_module(f"down_{i}_b2", self._res(din, din))
            self.add_module(f"down_{i}_attn", _PreNormResidual(din, _LinearAttention(din)))
            self.add_module(f"down_{i}_ds", nn.Conv2d(din, dout, 4, stride=2, padding=1)
                            if i < n - 1 else nn.Conv2d(din, dout, 3, padding=1))
        for i, (din, dout) in enumerate(reversed(self.in_out)):
            self.add_module(f"up_{i}_b1", self._res(dout + din, dout))
            self.add_module(f"up_{i}_b2", self._res(dout + din, dout))
            self.add_module(f"up_{i}_attn", _PreNormResidual(dout, _LinearAttention(dout)))
            self.add_module(f"up_{i}_us", nn.Conv2d(dout, din, 3, padding=1))

    def forward(self, x: torch.Tensor, t: torch.Tensor, **_ignored) -> torch.Tensor:
        x = self.init_conv(x.permute(0, 3, 1, 2))
        r = x
        emb = self._time(timestep_embedding(t.float(), self.dim))
        n, hs = len(self.in_out), []
        for i in range(n):
            x = getattr(self, f"down_{i}_b1")(x, emb)
            hs.append(x)
            x = getattr(self, f"down_{i}_attn")(getattr(self, f"down_{i}_b2")(x, emb))
            hs.append(x)
            x = getattr(self, f"down_{i}_ds")(x)
        x = self._mid(x, emb)
        for i in range(n):
            x = getattr(self, f"up_{i}_b1")(torch.cat([x, hs.pop()], dim=1), emb)
            x = getattr(self, f"up_{i}_b2")(torch.cat([x, hs.pop()], dim=1), emb)
            x = getattr(self, f"up_{i}_attn")(x)
            if i < n - 1:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"up_{i}_us")(x)
        x = self.final_res(torch.cat([x, r], dim=1), emb)
        return self.final_conv(x).permute(0, 2, 3, 1)
