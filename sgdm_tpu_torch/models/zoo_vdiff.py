"""crowsonkb's v-diffusion model zoo, under the published checkpoints' names.

Port of `sgdm_tpu/models/zoo_vdiff.py`.  The eight entries of `_MODELS`
(danbooru_128, imagenet_128, wikiart_128, wikiart_256, yfcc_1, yfcc_2,
cc12m_1, cc12m_1_cfg) are one recursive skip-concat U-Net generated from a
*spec* (`_build_net_spec`): per level, down → N res[+attn] blocks → inner
skip → N res[+attn] blocks → up.  `VDiffUNet` builds its modules from the
spec as v-diffusion-pytorch's ``nn.Sequential`` nets do, so its
``state_dict()`` names and shapes are the published ``.pth`` files' keys
(`vdiff_torch_key_map`) and a checkpoint loads with
``load_state_dict(strict=True)``.

The per-model quirks the JAX package reproduces:

* skip concatenation ``cat([skip, main])`` (danbooru, imagenet, wikiart) or
  ``cat([main, skip])`` (yfcc, cc12m);
* the timestep Fourier features take log-SNR (the DDPM-schedule models) or
  the raw cosine t (yfcc, cc12m);
* danbooru_128 and wikiart_128 end their last block in a ReLU;
* attention heads = channels // 128 or // 64, with an affine GroupNorm(1)
  pre-norm in the yfcc / cc12m family only;
* cc12m's blocks normalise with GroupNorm(1) without affine (biased
  variance, eps 1e-5) and modulate ``x·(scale + 1) + shift`` from a
  1024-wide condition, ``mapping(cat[√512·normalize(clip_embed),
  Fourier(t)])``.

Images are NCHW, as the published torch classes take them.  Attention,
norms and convolutions are plain PyTorch ops: the JAX package computes them
in XLA ops, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..diffusion.samplers.v_objective import (
    alpha_sigma_to_log_snr, get_ddpm_schedule, t_to_alpha_sigma,
)

__all__ = [
    "VDiffUNet", "VDiffModelMeta", "get_vdiff_model", "get_vdiff_models",
    "vdiff_torch_key_map", "load_vdiff_torch_checkpoint",
]


# ---------------------------------------------------------------------------
# the spec: one recursion for all eight nets
# ---------------------------------------------------------------------------

def _build_net_spec(size: int, cs: Tuple[int, ...], nb: int,
                    divisor: Optional[int], final_last: bool) -> tuple:
    """Nested block descriptors of one net.

    Nodes: ("res", c_in, c_mid, c_out, last) · ("attn", c, heads) ·
    ("down",) · ("up",) · ("skip", inner_spec).  Level i runs at
    size / 2**i; a model with attention has it after every res block at
    resolutions ≤ 16.
    """
    depth = len(cs) - 1

    def res(seq, level, cin, cmid, cout, last=False):
        seq.append(("res", cin, cmid, cout, last))
        if divisor is not None and (size >> level) <= 16:
            seq.append(("attn", cout, max(cout // divisor, 1)))

    def level(i: int) -> list:
        seq = [("down",)]
        res(seq, i, cs[i - 1], cs[i], cs[i])
        for _ in range(nb - 1):
            res(seq, i, cs[i], cs[i], cs[i])
        if i < depth:
            seq.append(("skip", tuple(level(i + 1))))
            res(seq, i, cs[i] * 2, cs[i], cs[i])
            for _ in range(nb - 2):
                res(seq, i, cs[i], cs[i], cs[i])
        else:
            for _ in range(nb - 1):
                res(seq, i, cs[i], cs[i], cs[i])
        res(seq, i, cs[i], cs[i], cs[i - 1])
        seq.append(("up",))
        return seq

    seq: list = []
    res(seq, 0, 3 + 16, cs[0], cs[0])
    for _ in range(nb - 1):
        res(seq, 0, cs[0], cs[0], cs[0])
    seq.append(("skip", tuple(level(1))))
    res(seq, 0, cs[0] * 2, cs[0], cs[0])
    for _ in range(nb - 2):
        res(seq, 0, cs[0], cs[0], cs[0])
    res(seq, 0, cs[0], cs[0], 3, last=final_last)
    return tuple(seq)


@dataclasses.dataclass(frozen=True)
class _NetCfg:
    size: int
    cs: Tuple[int, ...]
    nb: int
    divisor: Optional[int]
    attn_norm: bool
    up_mode: str            # "nearest" | "bilinear"
    skip_first: bool        # cat([skip, main]) vs cat([main, skip])
    t_input: str            # "log_snr" | "t"
    ff_std: float
    final_relu: bool        # the output block ends in a ReLU
    ddpm_range: bool        # min_t / max_t from get_ddpm_schedule's endpoints
    clip_dim: int = 0       # > 0: cc12m's modulated variant
    cond_width: int = 1024

    @property
    def modulated(self) -> bool:
        return self.clip_dim > 0

    def spec(self) -> tuple:
        return _build_net_spec(self.size, self.cs, self.nb, self.divisor,
                               final_last=not self.final_relu)


_CC12M = _NetCfg(size=256, cs=(128, 256, 256, 512, 512, 1024, 1024), nb=4,
                 divisor=64, attn_norm=True, up_mode="bilinear",
                 skip_first=False, t_input="t", ff_std=1.0, final_relu=False,
                 ddpm_range=False, clip_dim=512, cond_width=1024)

_MODELS = {
    "danbooru_128": _NetCfg(size=128, cs=(256, 512, 512, 1024, 1024, 2048),
                            nb=2, divisor=128, attn_norm=False,
                            up_mode="nearest", skip_first=True,
                            t_input="log_snr", ff_std=0.2, final_relu=True,
                            ddpm_range=True),
    "imagenet_128": _NetCfg(size=128, cs=(128, 256, 256, 512, 512, 1024),
                            nb=4, divisor=128, attn_norm=False,
                            up_mode="nearest", skip_first=True,
                            t_input="log_snr", ff_std=0.2, final_relu=False,
                            ddpm_range=True),
    "wikiart_128": _NetCfg(size=128, cs=(128, 256, 256, 512, 512, 1024),
                           nb=4, divisor=None, attn_norm=False,
                           up_mode="nearest", skip_first=True,
                           t_input="log_snr", ff_std=0.2, final_relu=True,
                           ddpm_range=True),
    "wikiart_256": _NetCfg(size=256, cs=(64, 128, 256, 256, 512, 512, 1024),
                           nb=4, divisor=128, attn_norm=False,
                           up_mode="nearest", skip_first=True,
                           t_input="log_snr", ff_std=0.2, final_relu=False,
                           ddpm_range=True),
    "yfcc_1": _NetCfg(size=512, cs=(128, 128, 256, 256, 512, 512, 1024, 1024),
                      nb=4, divisor=64, attn_norm=True, up_mode="bilinear",
                      skip_first=False, t_input="t", ff_std=1.0,
                      final_relu=False, ddpm_range=False),
    "yfcc_2": _NetCfg(size=512, cs=(128, 256, 512, 512, 1024, 1024, 2048, 2048),
                      nb=2, divisor=64, attn_norm=True, up_mode="bilinear",
                      skip_first=False, t_input="t", ff_std=1.0,
                      final_relu=False, ddpm_range=False),
    "cc12m_1": _CC12M,
    "cc12m_1_cfg": _CC12M,
}


@dataclasses.dataclass(frozen=True)
class VDiffModelMeta:
    """The published classes' shape / min_t / max_t / clip_model."""
    name: str
    shape: Tuple[int, int, int]          # (H, W, C)
    min_t: float
    max_t: float
    clip_dim: int = 0
    clip_model: Optional[str] = None


def _meta(name: str, cfg: _NetCfg) -> VDiffModelMeta:
    if cfg.ddpm_range:
        min_t = float(get_ddpm_schedule(0.0))
        max_t = float(get_ddpm_schedule(1.0))
    else:
        min_t, max_t = 0.0, 1.0
    return VDiffModelMeta(name=name, shape=(cfg.size, cfg.size, 3), min_t=min_t,
                          max_t=max_t, clip_dim=cfg.clip_dim,
                          clip_model="ViT-B/16" if cfg.modulated else None)


# ---------------------------------------------------------------------------
# blocks (v-diffusion-pytorch's names)
# ---------------------------------------------------------------------------

class FourierFeatures(nn.Module):
    """cat[cos, sin](2π · x Wᵀ), W: [out // 2, in]."""

    def __init__(self, in_features: int, out_features: int, std: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_features // 2, in_features) * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = 2 * math.pi * (x @ self.weight.T)
        return torch.cat([f.cos(), f.sin()], dim=-1)


class ResLinearBlock(nn.Module):
    """Linear → ReLU → Linear (→ ReLU unless last), plus a bias-free linear
    skip when the width changes."""

    def __init__(self, f_in: int, f_mid: int, f_out: int, is_last: bool = False):
        super().__init__()
        self.is_last = is_last
        self.main = nn.Sequential(nn.Linear(f_in, f_mid), nn.ReLU(), nn.Linear(f_mid, f_out))
        self.skip = nn.Linear(f_in, f_out, bias=False) if f_in != f_out else None

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.main[2](F.relu(self.main[0](z)))
        if not self.is_last:
            h = F.relu(h)
        return h + (z if self.skip is None else self.skip(z))


class Modulation2d(nn.Module):
    """x · (scale + 1) + shift, (scale, shift) = layer(cond)."""

    def __init__(self, feats_in: int, c_out: int):
        super().__init__()
        self.layer = nn.Linear(feats_in, c_out * 2, bias=False)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scales, shifts = self.layer(cond).chunk(2, dim=-1)
        return x * (scales[..., None, None] + 1) + shifts[..., None, None]


def _gn1(x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1) without affine: per-sample statistics over (C, H, W)
    (biased variance, eps 1e-5).  A reduction over the whole sample, not
    ``F.group_norm``, whose statistics kernel gives each (sample, group) row
    one block: at one group a sample that is one block for 8 M values."""
    var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class ResConvBlock(nn.Module):
    """conv3×3 → ReLU → conv3×3 (→ ReLU unless last) + skip; cc12m's
    variant normalises and modulates after each convolution."""

    def __init__(self, cin: int, cmid: int, cout: int, last: bool = False,
                 cond_width: int = 0):
        super().__init__()
        self.last, self.modulated = last, cond_width > 0
        if self.modulated:
            mods = [nn.Conv2d(cin, cmid, 3, padding=1), nn.Identity(),
                    Modulation2d(cond_width, cmid), nn.ReLU(),
                    nn.Conv2d(cmid, cout, 3, padding=1)]
            if not last:
                mods += [nn.Identity(), Modulation2d(cond_width, cout), nn.ReLU()]
        else:
            mods = [nn.Conv2d(cin, cmid, 3, padding=1), nn.ReLU(),
                    nn.Conv2d(cmid, cout, 3, padding=1)]
        self.main = nn.Sequential(*mods)
        self.skip = nn.Conv2d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor]) -> torch.Tensor:
        m = self.main
        if self.modulated:
            h = F.relu(m[2](_gn1(m[0](x)), cond))
            h = m[4](h)
            if not self.last:
                h = F.relu(m[6](_gn1(h), cond))
        else:
            h = m[2](F.relu(m[0](x)))
            if not self.last:
                h = F.relu(h)
        return h + (x if self.skip is None else self.skip(x))


class SelfAttention2d(nn.Module):
    """Multi-head self-attention over the pixels; qkv channels are
    (q | k | v) × head × d, q and k each scaled by d^-¼."""

    def __init__(self, c: int, heads: int, norm: bool):
        super().__init__()
        self.heads = heads
        self.norm = nn.GroupNorm(1, c) if norm else None
        self.qkv_proj = nn.Conv2d(c, 3 * c, 1)
        self.out_proj = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        d = c // self.heads
        y = x if self.norm is None else \
            _gn1(x) * self.norm.weight[:, None, None] + self.norm.bias[:, None, None]
        qkv = self.qkv_proj(y).view(b, 3 * self.heads, d, h * w).transpose(2, 3)
        q, k, v = qkv.chunk(3, dim=1)
        scale = d ** -0.25
        att = ((q * scale) @ (k.transpose(2, 3) * scale)).softmax(3)
        y = (att @ v).transpose(2, 3).reshape(b, c, h, w)
        return x + self.out_proj(y)


class _Resample(nn.Module):
    """2×2 average pool ("down") or 2× nearest / bilinear upsampling ("up")."""

    def __init__(self, kind: str, mode: str = "nearest"):
        super().__init__()
        self.kind, self.mode = kind, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "down":
            return F.avg_pool2d(x, 2)
        if self.mode == "nearest":
            return F.interpolate(x, scale_factor=2, mode="nearest")
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class SkipBlock(nn.Module):
    def __init__(self, main: nn.Sequential, skip_first: bool):
        super().__init__()
        self.main, self.skip_first = main, skip_first


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------

class VDiffUNet(nn.Module):
    """``forward(x, t, clip_embed=None) -> v``: x [B, 3, H, W], t [B] (or a
    scalar) continuous cosine time, clip_embed [B, clip_dim] for cc12m
    (zeros when None)."""

    def __init__(self, cfg: _NetCfg):
        super().__init__()
        self.cfg = cfg
        self.timestep_embed = FourierFeatures(1, 16, cfg.ff_std)
        if cfg.modulated:
            w = cfg.cond_width
            self.mapping_timestep_embed = FourierFeatures(1, 128)
            self.mapping = nn.Sequential(ResLinearBlock(cfg.clip_dim + 128, w, w),
                                         ResLinearBlock(w, w, w, is_last=True))
        self.net = self._seq(cfg.spec())

    def _seq(self, spec) -> nn.Sequential:
        cfg, mods = self.cfg, []
        for node in spec:
            kind = node[0]
            if kind == "res":
                _, cin, cmid, cout, last = node
                mods.append(ResConvBlock(cin, cmid, cout, last,
                                         cfg.cond_width if cfg.modulated else 0))
            elif kind == "attn":
                mods.append(SelfAttention2d(node[1], node[2], cfg.attn_norm))
            elif kind in ("down", "up"):
                mods.append(_Resample(kind, cfg.up_mode))
            elif kind == "skip":
                mods.append(SkipBlock(self._seq(node[1]), cfg.skip_first))
            else:  # pragma: no cover
                raise ValueError(f"unknown spec node {node!r}")
        return nn.Sequential(*mods)

    def _run(self, seq: nn.Sequential, x: torch.Tensor, cond) -> torch.Tensor:
        for mod in seq:
            if isinstance(mod, ResConvBlock):
                x = mod(x, cond)
            elif isinstance(mod, SkipBlock):
                inner = self._run(mod.main, x, cond)
                x = torch.cat((x, inner) if mod.skip_first else (inner, x), dim=1)
            else:
                x = mod(x)
        return x

    def forward(self, x: torch.Tensor, t, clip_embed: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg, b = self.cfg, x.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.ndim == 0:
            t = t.expand(b)
        ff_in = alpha_sigma_to_log_snr(*t_to_alpha_sigma(t)) if cfg.t_input == "log_snr" else t
        temb = self.timestep_embed(ff_in[:, None])
        cond = None
        if cfg.modulated:
            if clip_embed is None:
                clip_embed = x.new_zeros(b, cfg.clip_dim)
            ce = F.normalize(clip_embed.float(), dim=-1) * math.sqrt(cfg.clip_dim)
            cond = self.mapping(torch.cat([ce, self.mapping_timestep_embed(t[:, None])], dim=-1))
        planes = temb[:, :, None, None].to(x.dtype).expand(b, temb.shape[1], *x.shape[2:])
        return self._run(self.net, torch.cat([x, planes], dim=1), cond)


def get_vdiff_models() -> list:
    return list(_MODELS)


def get_vdiff_model(name: str, device: torch.device | str = "cuda"):
    """(VDiffUNet, VDiffModelMeta) of a zoo entry in eval mode, initialised as
    torch initialises its layers (from its global generator) on ``device``
    (the card unless the caller asks for the CPU); ``device="meta"``
    allocates nothing."""
    cfg = _MODELS[name]
    if torch.device(device).type != "meta":
        device = resolve_device(device)
    with torch.device(device):
        model = VDiffUNet(cfg)
    return model.eval(), _meta(name, cfg)


# ---------------------------------------------------------------------------
# the published checkpoints' keys (from the same spec walk)
# ---------------------------------------------------------------------------

def _iter_params(cfg: _NetCfg):
    """(torch_key, flax_name, leaf, kind, flax shape) of every weight; kind:
    conv (OIHW ↔ HWIO) | dense (transposed) | raw; leaf None for the
    Fourier weights, which sit at the top of the flax tree."""
    out = []

    def conv(tk, fn, cin, cout, k, bias=True):
        out.append((f"{tk}.weight", fn, "kernel", "conv", (k, k, cin, cout)))
        if bias:
            out.append((f"{tk}.bias", fn, "bias", "raw", (cout,)))

    def dense(tk, fn, fin, fout, bias=True):
        out.append((f"{tk}.weight", fn, "kernel", "dense", (fin, fout)))
        if bias:
            out.append((f"{tk}.bias", fn, "bias", "raw", (fout,)))

    def walk(seq, tp, fp):
        for i, node in enumerate(seq):
            tk, fn = f"{tp}.{i}", f"{fp}_{i}"
            if node[0] == "res":
                _, cin, cmid, cout, last = node
                conv(f"{tk}.main.0", f"{fn}_main_0", cin, cmid, 3)
                if cfg.modulated:
                    dense(f"{tk}.main.2.layer", f"{fn}_main_2", cfg.cond_width, 2 * cmid,
                          bias=False)
                    conv(f"{tk}.main.4", f"{fn}_main_4", cmid, cout, 3)
                    if not last:
                        dense(f"{tk}.main.6.layer", f"{fn}_main_6", cfg.cond_width,
                              2 * cout, bias=False)
                else:
                    conv(f"{tk}.main.2", f"{fn}_main_2", cmid, cout, 3)
                if cin != cout:
                    conv(f"{tk}.skip", f"{fn}_skip", cin, cout, 1, bias=False)
            elif node[0] == "attn":
                c = node[1]
                if cfg.attn_norm:
                    out.append((f"{tk}.norm.weight", f"{fn}_norm", "scale", "raw", (c,)))
                    out.append((f"{tk}.norm.bias", f"{fn}_norm", "bias", "raw", (c,)))
                conv(f"{tk}.qkv_proj", f"{fn}_qkv_proj", c, 3 * c, 1)
                conv(f"{tk}.out_proj", f"{fn}_out_proj", c, c, 1)
            elif node[0] == "skip":
                walk(node[1], f"{tk}.main", f"{fn}_main")

    out.append(("timestep_embed.weight", "timestep_embed_weight", None, "raw", (8, 1)))
    if cfg.modulated:
        out.append(("mapping_timestep_embed.weight", "mapping_timestep_embed_weight", None,
                    "raw", (64, 1)))
        fin, w = cfg.clip_dim + 128, cfg.cond_width
        dense("mapping.0.main.0", "mapping_0_main_0", fin, w)
        dense("mapping.0.main.2", "mapping_0_main_2", w, w)
        dense("mapping.0.skip", "mapping_0_skip", fin, w, bias=False)
        dense("mapping.1.main.0", "mapping_1_main_0", w, w)
        dense("mapping.1.main.2", "mapping_1_main_2", w, w)
    walk(cfg.spec(), "net", "net")
    return out


def vdiff_torch_key_map(name: str) -> dict:
    """torch state_dict key → (flax_name, leaf, kind, flax shape)."""
    return {tk: (fn, leaf, kind, shape)
            for tk, fn, leaf, kind, shape in _iter_params(_MODELS[name])}


def load_vdiff_torch_checkpoint(name: str, path: str,
                                device: torch.device | str = "cuda") -> VDiffUNet:
    """The zoo entry ``name`` with a published ``.pth``'s weights (a state
    dict, possibly under ``"state_dict"``; ``strict=True``: every key and
    shape must match), on ``device`` (the card unless the caller asks for
    the CPU)."""
    device = resolve_device(device)
    model, _ = get_vdiff_model(name, "meta")
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict({k: v.to(device, torch.float32) for k, v in sd.items()},
                          strict=True, assign=True)
    return model.eval()
