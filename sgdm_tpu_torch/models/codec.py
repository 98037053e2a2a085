"""The LDM first-stage codec family (CompVis latent-diffusion `model.py`).

Port of `sgdm_tpu/models/codec.py` (zoo breadth: no shipped config builds
these): the DDPM-style `LDMModel` UNet, `Encoder`, `Decoder`,
`SimpleDecoder`, `UpsampleDecoder`, `LatentRescaler`,
`MergedRescaleEncoder` / `MergedRescaleDecoder`, `Upsampler`, `resize` and
`FirstStagePostProcessor`, on the shared pieces:

  * Normalize = GroupNorm(32, eps 1e-6) (C groups where 32 does not divide
    C, as the JAX package allows for narrow test widths); swish;
  * `CodecResnetBlock`: GN → swish → conv3 twice, the time projection added
    after conv1, a 3×3 or 1×1 shortcut on a channel change;
  * `AttnBlock`: single-head 1×1-conv token attention, residual;
    `LinAttnBlock`: linear attention at heads 1, dim_head C, not residual;
  * Downsample pads (0, 1, 0, 1), then a 3×3 stride-2 conv without padding
    (or a 2×2 average pool); Upsample is nearest ×2 (+ a 3×3 conv).

Modules take and return NHWC tensors, as the JAX modules do, and compute
NCHW inside; their parameters carry the flax names (``down_0_block_0.
norm1.gn`` …), so `models/convert.py codec_from_flax` is `from_flax`.
Attention, norms and convolutions are plain PyTorch ops, as the JAX
package's are XLA ops.  `FirstStagePostProcessor` takes the frozen
first stage's ``encode_fn`` (or encoded features) and detaches it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.resize import resize as _jax_resize

__all__ = [
    "LDMModel", "Encoder", "Decoder", "SimpleDecoder", "UpsampleDecoder",
    "LatentRescaler", "MergedRescaleEncoder", "MergedRescaleDecoder",
    "Upsampler", "resize", "FirstStagePostProcessor", "CodecResnetBlock",
    "AttnBlock", "LinAttnBlock",
]


def _swish(x):
    return x * torch.sigmoid(x)


class _Norm(nn.Module):
    """GroupNorm(num_groups, eps 1e-6) under the name ``gn``; C groups where
    ``num_groups`` does not divide C."""

    def __init__(self, c: int, num_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(num_groups if c % num_groups == 0 else c, c, eps=1e-6)

    def forward(self, x):
        return self.gn(x)


def _conv(cin, cout, k=3, stride=1, pad=None):
    return nn.Conv2d(cin, cout, k, stride, k // 2 if pad is None else pad)


def _ddpm_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The tensor2tensor sinusoid, frequencies exp(−log(10⁴)·i / (half − 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    return F.pad(emb, (0, 1)) if dim % 2 == 1 else emb


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class _NHWC(nn.Module):
    """``forward`` takes and returns NHWC; ``run`` is the NCHW body."""

    def forward(self, x, *args, **kwargs):
        return _nhwc(self.run(_nchw(x), *args, **kwargs))


class Upsample(nn.Module):
    def __init__(self, c: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = _conv(c, c)
        self.with_conv = with_conv

    def forward(self, x):
        x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
        return self.conv(x) if self.with_conv else x


class Downsample(nn.Module):
    """Pad (0, 1, 0, 1), then a 3×3 stride-2 conv without padding; or a 2×2
    average pool."""

    def __init__(self, c: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = nn.Conv2d(c, c, 3, 2, 0)
        self.with_conv = with_conv

    def forward(self, x):
        if self.with_conv:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class CodecResnetBlock(_NHWC):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.0, temb_channels: int = 512):
        super().__init__()
        out = out_channels or in_channels
        self.in_ch, self.out_ch, self.dropout = in_channels, out, dropout
        self.norm1 = _Norm(in_channels)
        self.conv1 = _conv(in_channels, out)
        if temb_channels > 0:
            self.temb_proj = nn.Linear(temb_channels, out)
        self.norm2 = _Norm(out)
        self.conv2 = _conv(out, out)
        if in_channels != out:
            if conv_shortcut:
                self.conv_shortcut = _conv(in_channels, out)
            else:
                self.nin_shortcut = _conv(in_channels, out, 1)

    def run(self, x, temb=None, train: bool = False):
        h = self.conv1(_swish(self.norm1(x)))
        if temb is not None and hasattr(self, "temb_proj"):
            h = h + self.temb_proj(_swish(temb))[:, :, None, None]
        h = F.dropout(_swish(self.norm2(h)), self.dropout, train)
        h = self.conv2(h)
        if self.in_ch != self.out_ch:
            x = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else self.nin_shortcut(x)
        return x + h


class AttnBlock(_NHWC):
    """Single-head token attention over the pixels, residual."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _Norm(c)
        self.q, self.k, self.v = _conv(c, c, 1), _conv(c, c, 1), _conv(c, c, 1)
        self.proj_out = _conv(c, c, 1)

    def run(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (m(h).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        w = torch.softmax(torch.einsum("bic,bjc->bij", q, k) * c ** -0.5, -1)
        out = torch.einsum("bij,bjc->bic", w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(out)


class LinAttnBlock(_NHWC):
    """Linear attention, heads 1, dim_head C: k softmaxed over the tokens; not
    residual."""

    def __init__(self, c: int):
        super().__init__()
        self.to_qkv = nn.Conv2d(c, 3 * c, 1, bias=False)
        self.to_out = _conv(c, c, 1)

    def run(self, x):
        b, c, hh, ww = x.shape
        q, k, v = self.to_qkv(x).flatten(2).transpose(1, 2).split(c, -1)
        k = torch.softmax(k, dim=1)
        ctx = torch.einsum("bnd,bne->bde", k, v)
        out = torch.einsum("bde,bnd->bne", ctx, q).transpose(1, 2).reshape(b, c, hh, ww)
        return self.to_out(out)


class _Identity(nn.Module):
    def run(self, x):
        return x


def _make_attn(attn_type: str, c: int) -> nn.Module:
    assert attn_type in ("vanilla", "linear", "none"), attn_type
    if attn_type == "vanilla":
        return AttnBlock(c)
    if attn_type == "linear":
        return LinAttnBlock(c)
    return _Identity()


def _res(cin, cout=None, temb=0, dropout=0.0):
    return CodecResnetBlock(cin, cout, temb_channels=temb, dropout=dropout)


class LDMModel(_NHWC):
    """The DDPM-style codec UNet: ``forward(x, t=None, context=None)``."""

    def __init__(self, ch: int = 64, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True, in_channels: int = 3,
                 resolution: int = 64, use_timestep: bool = True, use_linear_attn: bool = False,
                 attn_type: str = "vanilla"):
        super().__init__()
        attn_type = "linear" if use_linear_attn else attn_type
        self.nres, self.num_res_blocks, self.use_timestep = len(ch_mult), num_res_blocks, \
            use_timestep
        self.ch, temb = ch, ch * 4 if use_timestep else 0
        if use_timestep:
            self.temb_dense0, self.temb_dense1 = nn.Linear(ch, temb), nn.Linear(temb, temb)
        self.conv_in = _conv(in_channels, ch)
        self.attn_at: set = set()
        curr_res, chans, block_in = resolution, [ch], ch
        for i in range(self.nres):
            block_out = ch * ch_mult[i]
            for j in range(num_res_blocks):
                setattr(self, f"down_{i}_block_{j}", _res(block_in, block_out, temb, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    setattr(self, f"down_{i}_attn_{j}", _make_attn(attn_type, block_in))
                chans.append(block_in)
            if i != self.nres - 1:
                setattr(self, f"down_{i}_downsample", Downsample(block_in, resamp_with_conv))
                chans.append(block_in)
                curr_res //= 2
        self.mid_block_1 = _res(block_in, None, temb, dropout)
        self.mid_attn_1 = _make_attn(attn_type, block_in)
        self.mid_block_2 = _res(block_in, None, temb, dropout)
        for i in reversed(range(self.nres)):
            block_out = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                setattr(self, f"up_{i}_block_{j}",
                        _res(block_in + chans.pop(), block_out, temb, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    setattr(self, f"up_{i}_attn_{j}", _make_attn(attn_type, block_in))
            if i != 0:
                setattr(self, f"up_{i}_upsample", Upsample(block_in, resamp_with_conv))
                curr_res *= 2
        self.norm_out = _Norm(block_in)
        self.conv_out = _conv(block_in, out_ch)

    def _attn(self, name, h):
        return getattr(self, name).run(h) if hasattr(self, name) else h

    def forward(self, x, t=None, context=None, train: bool = False):
        if context is not None:
            x = torch.cat([x, context], -1)
        return _nhwc(self.run(_nchw(x), t, train))

    def run(self, x, t=None, train: bool = False):
        temb = None
        if self.use_timestep:
            assert t is not None
            temb = self.temb_dense0(_ddpm_timestep_embedding(torch.as_tensor(t, device=x.device),
                                                             self.ch))
            temb = self.temb_dense1(_swish(temb))
        hs = [self.conv_in(x)]
        for i in range(self.nres):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}").run(hs[-1], temb, train)
                hs.append(self._attn(f"down_{i}_attn_{j}", h))
            if i != self.nres - 1:
                hs.append(getattr(self, f"down_{i}_downsample")(hs[-1]))
        h = self.mid_block_1.run(hs[-1], temb, train)
        h = self.mid_block_2.run(self.mid_attn_1.run(h), temb, train)
        for i in reversed(range(self.nres)):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}").run(torch.cat([h, hs.pop()], 1), temb,
                                                          train)
                h = self._attn(f"up_{i}_attn_{j}", h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(_swish(self.norm_out(h)))


class Encoder(_NHWC):
    """No time embedding; a 2·z_channels head (``double_z``)."""

    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True, in_channels: int = 3,
                 resolution: int = 64, z_channels: int = 4, double_z: bool = True,
                 use_linear_attn: bool = False, attn_type: str = "vanilla"):
        super().__init__()
        attn_type = "linear" if use_linear_attn else attn_type
        self.nres, self.num_res_blocks = len(ch_mult), num_res_blocks
        self.conv_in = _conv(in_channels, ch)
        curr_res, block_in = resolution, ch
        for i in range(self.nres):
            block_out = ch * ch_mult[i]
            for j in range(num_res_blocks):
                setattr(self, f"down_{i}_block_{j}", _res(block_in, block_out, 0, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    setattr(self, f"down_{i}_attn_{j}", _make_attn(attn_type, block_in))
            if i != self.nres - 1:
                setattr(self, f"down_{i}_downsample", Downsample(block_in, resamp_with_conv))
                curr_res //= 2
        self.mid_block_1 = _res(block_in, None, 0, dropout)
        self.mid_attn_1 = _make_attn(attn_type, block_in)
        self.mid_block_2 = _res(block_in, None, 0, dropout)
        self.norm_out = _Norm(block_in)
        self.conv_out = _conv(block_in, 2 * z_channels if double_z else z_channels)

    def run(self, x, train: bool = False):
        h = self.conv_in(x)
        for i in range(self.nres):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}").run(h, None, train)
                if hasattr(self, f"down_{i}_attn_{j}"):
                    h = getattr(self, f"down_{i}_attn_{j}").run(h)
            if i != self.nres - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_1.run(h, None, train)
        h = self.mid_block_2.run(self.mid_attn_1.run(h), None, train)
        return self.conv_out(_swish(self.norm_out(h)))


class Decoder(_NHWC):
    def __init__(self, ch: int = 64, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True, resolution: int = 64,
                 z_channels: int = 4, give_pre_end: bool = False, tanh_out: bool = False,
                 use_linear_attn: bool = False, attn_type: str = "vanilla"):
        super().__init__()
        attn_type = "linear" if use_linear_attn else attn_type
        self.nres, self.num_res_blocks = len(ch_mult), num_res_blocks
        self.give_pre_end, self.tanh_out = give_pre_end, tanh_out
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (self.nres - 1)
        self.conv_in = _conv(z_channels, block_in)
        self.mid_block_1 = _res(block_in, None, 0, dropout)
        self.mid_attn_1 = _make_attn(attn_type, block_in)
        self.mid_block_2 = _res(block_in, None, 0, dropout)
        for i in reversed(range(self.nres)):
            block_out = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                setattr(self, f"up_{i}_block_{j}", _res(block_in, block_out, 0, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    setattr(self, f"up_{i}_attn_{j}", _make_attn(attn_type, block_in))
            if i != 0:
                setattr(self, f"up_{i}_upsample", Upsample(block_in, resamp_with_conv))
                curr_res *= 2
        if not give_pre_end:
            self.norm_out = _Norm(block_in)
            self.conv_out = _conv(block_in, out_ch)

    def run(self, z, train: bool = False):
        h = self.conv_in(z)
        h = self.mid_block_1.run(h, None, train)
        h = self.mid_block_2.run(self.mid_attn_1.run(h), None, train)
        for i in reversed(range(self.nres)):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}").run(h, None, train)
                if hasattr(self, f"up_{i}_attn_{j}"):
                    h = getattr(self, f"up_{i}_attn_{j}").run(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        if self.give_pre_end:
            return h
        h = self.conv_out(_swish(self.norm_out(h)))
        return torch.tanh(h) if self.tanh_out else h


class SimpleDecoder(_NHWC):
    """1×1 → three res blocks (2×, 4×, 2× widths) → 1×1 → up ×2 → GN head."""

    def __init__(self, in_channels: int, out_channels: int = 3):
        super().__init__()
        c = in_channels
        self.conv_pre = _conv(c, c, 1)
        widths = [c, 2 * c, 4 * c, 2 * c]
        for i in range(3):
            setattr(self, f"res_{i}", _res(widths[i], widths[i + 1]))
        self.conv_post = _conv(2 * c, c, 1)
        self.upsample = Upsample(c, True)
        self.norm_out = _Norm(c)
        self.conv_out = _conv(c, out_channels)

    def run(self, x, train: bool = False):
        x = self.conv_pre(x)
        for i in range(3):
            x = getattr(self, f"res_{i}").run(x, None, train)
        x = self.upsample(self.conv_post(x))
        return self.conv_out(_swish(self.norm_out(x)))


class UpsampleDecoder(_NHWC):
    """(res × (n + 1) → up) per level, a GN head."""

    def __init__(self, in_channels: int, out_channels: int = 3, ch: int = 64,
                 num_res_blocks: int = 2, ch_mult: Sequence[int] = (2, 2), dropout: float = 0.0):
        super().__init__()
        self.nres, self.num_res_blocks = len(ch_mult), num_res_blocks
        block_in = in_channels
        for i in range(self.nres):
            block_out = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                setattr(self, f"res_{i}_{j}", _res(block_in, block_out, 0, dropout))
                block_in = block_out
            if i != self.nres - 1:
                setattr(self, f"upsample_{i}", Upsample(block_in, True))
        self.norm_out = _Norm(block_in)
        self.conv_out = _conv(block_in, out_channels)

    def run(self, x, train: bool = False):
        for i in range(self.nres):
            for j in range(self.num_res_blocks + 1):
                x = getattr(self, f"res_{i}_{j}").run(x, None, train)
            if i != self.nres - 1:
                x = getattr(self, f"upsample_{i}")(x)
        return self.conv_out(_swish(self.norm_out(x)))


def _jax_nearest(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` of NCHW: source index
    ⌊(i + ½)·in / out⌋."""
    h, w = x.shape[-2:]
    ri = ((torch.arange(nh, dtype=torch.float64) + 0.5) * h / nh).floor().long().clamp_max(h - 1)
    ci = ((torch.arange(nw, dtype=torch.float64) + 0.5) * w / nw).floor().long().clamp_max(w - 1)
    return x[:, :, ri.to(x.device)][:, :, :, ci.to(x.device)]


class LatentRescaler(_NHWC):
    """conv → res × depth → nearest resize by ``factor`` → attn → res × depth → 1×1."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int, out_channels: int,
                 depth: int = 2):
        super().__init__()
        self.factor, self.depth = factor, depth
        self.conv_in = _conv(in_channels, mid_channels)
        for i in range(depth):
            setattr(self, f"res1_{i}", _res(mid_channels))
        self.attn = AttnBlock(mid_channels)
        for i in range(depth):
            setattr(self, f"res2_{i}", _res(mid_channels))
        self.conv_out = _conv(mid_channels, out_channels, 1)

    def run(self, x, train: bool = False):
        x = self.conv_in(x)
        for i in range(self.depth):
            x = getattr(self, f"res1_{i}").run(x, None, train)
        h, w = x.shape[-2:]
        x = _jax_nearest(x, int(round(h * self.factor)), int(round(w * self.factor)))
        x = self.attn.run(x)
        for i in range(self.depth):
            x = getattr(self, f"res2_{i}").run(x, None, train)
        return self.conv_out(x)


class MergedRescaleEncoder(_NHWC):
    """`Encoder` (``double_z`` off) → `LatentRescaler`."""

    def __init__(self, in_channels: int = 3, ch: int = 64, out_ch: int = 4,
                 ch_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), dropout: float = 0.0,
                 resamp_with_conv: bool = True, resolution: int = 64,
                 rescale_factor: float = 1.0, rescale_module_depth: int = 1):
        super().__init__()
        inter = ch * ch_mult[-1]
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               attn_resolutions=attn_resolutions, dropout=dropout,
                               resamp_with_conv=resamp_with_conv, in_channels=in_channels,
                               resolution=resolution, z_channels=inter, double_z=False)
        self.rescaler = LatentRescaler(rescale_factor, inter, inter, out_ch,
                                       rescale_module_depth)

    def run(self, x, train: bool = False):
        return self.rescaler.run(self.encoder.run(x, train), train)


class MergedRescaleDecoder(_NHWC):
    """`LatentRescaler` → `Decoder`."""

    def __init__(self, z_channels: int = 4, out_ch: int = 3, ch: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), dropout: float = 0.0,
                 resamp_with_conv: bool = True, resolution: int = 64,
                 rescale_factor: float = 1.0, rescale_module_depth: int = 1):
        super().__init__()
        tmp = z_channels * ch_mult[-1]
        self.rescaler = LatentRescaler(rescale_factor, z_channels, tmp, tmp,
                                       rescale_module_depth)
        self.decoder = Decoder(out_ch=out_ch, ch=ch, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks, attn_resolutions=attn_resolutions,
                               dropout=dropout, resamp_with_conv=resamp_with_conv,
                               resolution=resolution, z_channels=tmp)

    def run(self, x, train: bool = False):
        return self.decoder.run(self.rescaler.run(x, train), train)


class Upsampler(_NHWC):
    """`LatentRescaler` → a `Decoder` of equal multipliers."""

    def __init__(self, in_size: int, out_size: int, in_channels: int, out_channels: int,
                 ch_mult: int = 2):
        super().__init__()
        assert out_size >= in_size
        num_blocks = int(math.log2(out_size // in_size)) + 1
        factor_up = 1.0 + (out_size % in_size)
        self.rescaler = LatentRescaler(factor_up, in_channels, 2 * in_channels, in_channels)
        self.decoder = Decoder(out_ch=out_channels, resolution=out_size, num_res_blocks=2,
                               attn_resolutions=(), ch=in_channels,
                               ch_mult=tuple(ch_mult for _ in range(num_blocks)),
                               z_channels=in_channels)

    def run(self, x, train: bool = False):
        return self.decoder.run(self.rescaler.run(x, train), train)


def resize(x: torch.Tensor, scale_factor: float = 1.0, mode: str = "bilinear") -> torch.Tensor:
    """`Resize` of NHWC ``x``: ``jax.image.resize`` (half-pixel centres,
    antialiased when shrinking) to ⌊size · scale_factor⌋; the identity at
    factor 1."""
    if scale_factor == 1.0:
        return x
    b, h, w, c = x.shape
    method = {"bilinear": "linear", "nearest": "nearest", "bicubic": "cubic"}[mode]
    nh, nw = int(h * scale_factor), int(w * scale_factor)
    if method == "nearest":
        return _nhwc(_jax_nearest(_nchw(x), nh, nw))
    return _jax_resize(x, (b, nh, nw, c), method=method)


class FirstStagePostProcessor(_NHWC):
    """A GN-projection of the (frozen, detached) first-stage features, then
    (res → 2×2 average pool) per multiplier; ``reshape`` flattens to tokens."""

    def __init__(self, ch_mult: Sequence[int], in_channels: int, n_channels: int,
                 reshape: bool = False, dropout: float = 0.0):
        super().__init__()
        self.reshape, self.n = reshape, len(ch_mult)
        self.proj_norm = _Norm(in_channels, num_groups=in_channels // 2)
        self.proj = _conv(in_channels, n_channels)
        cin = n_channels
        for i, m in enumerate(ch_mult):
            setattr(self, f"block_{i}", _res(cin, m * n_channels, 0, dropout))
            cin = m * n_channels

    def forward(self, x, encode_fn: Optional[Callable] = None, train: bool = False):
        if encode_fn is not None:
            x = encode_fn(x)
        z = self.run(_nchw(x.detach()), train)
        z = _nhwc(z)
        if self.reshape:
            b, h, w, c = z.shape
            z = z.reshape(b, h * w, c)
        return z

    def run(self, z, train: bool = False):
        z = _swish(self.proj(self.proj_norm(z)))
        for i in range(self.n):
            z = F.avg_pool2d(getattr(self, f"block_{i}").run(z, None, train), 2, 2)
        return z
