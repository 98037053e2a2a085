"""Fused ResBlock forward: CUDA kernels (K1, K2) and their plain version.

Replaces the Pallas TPU kernels of `sgdm_tpu/ops/pallas/resblock.py`
(`fused_resblock` → `_fwd_kernel` with ``save_res=False``, and
`_fwd_resample_kernel`), sampling forward only:

    h1  = silu(GN1(x)·g1 + b1)                 (up/down: resampled in f32)
    h2  = conv3x3(bf16(h1), W1) + c1            (f32)
    h3  = silu((GN2(h2)·g2 + b2)·(1 + fs) + fsh)
    out = bf16(conv3x3(bf16(h3), W2) + c2 + skip(x)) (+ skip bias, added after)

On a CUDA tensor `fused_resblock` launches the kernels of
``csrc/resblock.cu`` (four launches per call: GN1 statistics, conv1, GN2
statistics, conv2; see that file for the design and what bounds it) or
raises; on a CPU tensor it runs `resblock_plain`, which keeps the kernel's
rounding points: FiLM and SiLU in f32, bf16 only at conv inputs and at the
output, h2 never rounded, and for ``down`` the activated h1 pooled in f32
before the cast.

`resblock_cuda` (K1) and `resblock_resample_cuda` (K2) each count one
launch per call in their ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .build import library

__all__ = ["fused_resblock", "resblock_plain", "resblock_cuda", "resblock_resample_cuda"]


def _groups(num_groups: int, c: int) -> int:
    return math.gcd(num_groups, c)


# ------------------------------------------------------------ plain version

def _group_stats(xf: torch.Tensor, groups: int, eps: float):
    """xf [B, N, C] f32 → per-channel (mean, rstd) [B, 1, C]: E[x²]−mean²."""
    b, n, c = xf.shape
    s = xf.sum(1).reshape(b, groups, c // groups).sum(-1)
    q = (xf * xf).sum(1).reshape(b, groups, c // groups).sum(-1)
    cnt = n * (c // groups)
    mean = s / cnt
    var = q / cnt - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    rep = lambda t: t.repeat_interleave(c // groups, dim=-1)[:, None, :]
    return rep(mean), rep(rstd)


def _conv3x3(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC h (conv dtype) ⊛ HWIO w, products of the conv-dtype values in f32."""
    out = F.conv2d(h.permute(0, 3, 1, 2).float(), w.float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _pool2(t: torch.Tensor) -> torch.Tensor:
    b, h, w, c = t.shape
    return t.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def upsample_nearest2x(t: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2× upsampling as a broadcast."""
    b, h, w, c = t.shape
    return t[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def resblock_plain(
    x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
    gn2_scale, gn2_bias, w2, b2, skip_w=None, skip_b=None,
    *, num_groups: int = 32, eps: float = 1e-5, resample: str | None = None,
) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch (NHWC; weights HWIO)."""
    cdtype = x.dtype
    bsz, h, w, cin = x.shape
    cout = w1.shape[-1]
    g_in, g_out = _groups(num_groups, cin), _groups(num_groups, cout)
    xf = x.float().reshape(bsz, h * w, cin)
    mean1, rstd1 = _group_stats(xf, g_in, eps)
    h1 = F.silu((xf - mean1) * rstd1 * gn1_scale.float() + gn1_bias.float())
    h1 = h1.reshape(bsz, h, w, cin)
    skip = xf.reshape(bsz, h, w, cin)
    if resample == "down":
        h1, skip = _pool2(h1), _pool2(skip)
    elif resample == "up":
        h1, skip = upsample_nearest2x(h1), upsample_nearest2x(skip)
    ho, wo = h1.shape[1], h1.shape[2]
    h2 = _conv3x3(h1.to(cdtype), w1.to(cdtype)) + b1.float()
    h2 = h2.reshape(bsz, ho * wo, cout)
    mean2, rstd2 = _group_stats(h2, g_out, eps)
    pre = (h2 - mean2) * rstd2 * gn2_scale.float() + gn2_bias.float()
    pre = pre * (1.0 + film_scale.float()[:, None, :]) + film_shift.float()[:, None, :]
    h3 = F.silu(pre).to(cdtype).reshape(bsz, ho, wo, cout)
    out = _conv3x3(h3, w2.to(cdtype)) + b2.float()
    if skip_w is None:
        out = out + skip
    else:
        skw = skip_w.reshape(cin, cout).to(cdtype).float()
        out = out + (x.to(cdtype).float() @ skw)
    out = out.to(x.dtype)
    if skip_w is not None and skip_b is not None:
        out = out + skip_b.to(out.dtype)
    return out


# ------------------------------------------------------------ CUDA kernels

def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _lib():
    lib = library("resblock")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgdm_gn_coef.argtypes = [vp, i, i, i, i, i, f, vp, vp, vp, vp, vp, vp]
        lib.sgdm_gn_coef.restype = i
        lib.sgdm_resblock_conv.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp,
                                           i, i, i, i, i, i, i, i, vp]
        lib.sgdm_resblock_conv.restype = i
        lib._sgdm_typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3,3,Ci,Co] → bf16 [9,Ci,Co] (tap = dy*3 + dx)."""
    return w.detach().to(torch.bfloat16).reshape(9, w.shape[2], w.shape[3]).contiguous()


def _validate(x, g1, b1, w1, c1, fs, fsh, g2, b2, w2, c2, skip_w):
    """Raise unless every operand fits x and lies on x's card."""
    if not x.is_cuda:
        raise ValueError("CUDA kernel wrapper called with a CPU tensor")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the ResBlock kernels take bf16 activations, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got {tuple(x.shape)}")
    bsz, _, _, cin = x.shape
    cout = w1.shape[-1]
    want = {"gn1_scale": (g1, (cin,)), "gn1_bias": (b1, (cin,)),
            "w1": (w1, (3, 3, cin, cout)), "b1": (c1, (cout,)),
            "film_scale": (fs, (bsz, cout)), "film_shift": (fsh, (bsz, cout)),
            "gn2_scale": (g2, (cout,)), "gn2_bias": (b2, (cout,)),
            "w2": (w2, (3, 3, cout, cout)), "b2": (c2, (cout,))}
    if skip_w is not None:
        want["skip_w"] = (skip_w, (1, 1, cin, cout))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape} (Cin={cin}, Cout={cout})")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    for c in (cin, cout):
        if (c // 8 if c % 8 == 0 else c) > 512:
            raise ValueError(f"channel count {c} beyond the GN statistics kernel")


def _run(x, g1, b1, w1, c1, fs, fsh, g2, b2, w2, c2, skip_w, *, num_groups, eps, rs):
    lib = _lib()
    bsz, hi, wi, cin = x.shape
    cout = w1.shape[-1]
    if rs == 2:
        ho, wo = hi // 2, wi // 2
    elif rs == 1:
        ho, wo = hi * 2, wi * 2
    else:
        ho, wo = hi, wi
    dev = x.device
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    g_in, g_out = _groups(num_groups, cin), _groups(num_groups, cout)
    g1, b1, c1, g2, b2, c2 = (_f32(t) for t in (g1, b1, c1, g2, b2, c2))
    fs, fsh = _f32(fs), _f32(fsh)
    w1t, w2t = _taps(w1), _taps(w2)
    coef1 = torch.empty((bsz, 3, cin), device=dev, dtype=torch.float32)
    coef2 = torch.empty((bsz, 3, cout), device=dev, dtype=torch.float32)
    h2 = torch.empty((bsz, ho, wo, cout), device=dev, dtype=torch.float32)
    out = torch.empty((bsz, ho, wo, cout), device=dev, dtype=torch.bfloat16)

    _check(lib.sgdm_gn_coef(_ptr(x), 0, bsz, hi * wi, cin, g_in, eps, _ptr(g1), _ptr(b1),
                            None, None, _ptr(coef1), stream), "gn_coef(x)")
    _check(lib.sgdm_resblock_conv(1, rs, _ptr(x), _ptr(coef1), _ptr(w1t), _ptr(c1), None, None,
                                  _ptr(h2), bsz, ho, wo, cin, cout, hi, wi, 0, stream), "conv1")
    _check(lib.sgdm_gn_coef(_ptr(h2), 1, bsz, ho * wo, cout, g_out, eps, _ptr(g2), _ptr(b2),
                            _ptr(fs), _ptr(fsh), _ptr(coef2), stream), "gn_coef(h2)")
    if skip_w is None:
        _check(lib.sgdm_resblock_conv(2, rs, _ptr(h2), _ptr(coef2), _ptr(w2t), _ptr(c2), _ptr(x),
                                      None, _ptr(out), bsz, ho, wo, cout, cout, hi, wi, cout,
                                      stream), "conv2")
    else:
        skw = skip_w.detach().to(torch.bfloat16).reshape(cin, cout).contiguous()
        _check(lib.sgdm_resblock_conv(3, 0, _ptr(h2), _ptr(coef2), _ptr(w2t), _ptr(c2), _ptr(x),
                                      _ptr(skw), _ptr(out), bsz, ho, wo, cout, cout, hi, wi, cin,
                                      stream), "conv2")
    return out


def resblock_cuda(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
                  gn2_scale, gn2_bias, w2, b2, skip_w=None, skip_b=None,
                  *, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """K1: identity or 1×1-projection skip, on the CUDA kernels."""
    _validate(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale, gn2_bias,
              w2, b2, skip_w)
    if skip_b is not None and (tuple(skip_b.shape) != (w1.shape[-1],)
                               or skip_b.device != x.device):
        raise ValueError(f"skip_b {tuple(skip_b.shape)} on {skip_b.device} does not fit")
    if skip_w is None and x.shape[-1] != w1.shape[-1]:
        raise ValueError("identity skip needs Cin == Cout")
    out = _run(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale, gn2_bias,
               w2, b2, skip_w, num_groups=num_groups, eps=eps, rs=0)
    resblock_cuda.launches += 1
    if skip_w is not None and skip_b is not None:
        out = out + skip_b.to(out.dtype)
    return out


resblock_cuda.launches = 0


def resblock_resample_cuda(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
                           gn2_scale, gn2_bias, w2, b2, *, resample: str,
                           num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """K2: the resblock_updown variant (identity skip, Cin == Cout)."""
    _validate(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale, gn2_bias,
              w2, b2, None)
    if x.shape[-1] != w1.shape[-1]:
        raise ValueError("the up/down ResBlock needs Cin == Cout")
    if resample == "down" and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"'down' needs even H and W, got {tuple(x.shape)}")
    rs = {"up": 1, "down": 2}[resample]
    out = _run(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale, gn2_bias,
               w2, b2, None, num_groups=num_groups, eps=eps, rs=rs)
    resblock_resample_cuda.launches += 1
    return out


resblock_resample_cuda.launches = 0


def fused_resblock(
    x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
    gn2_scale, gn2_bias, w2, b2, skip_w=None, skip_b=None, seed=None,
    *, num_groups: int = 32, eps: float = 1e-5, dropout_rate: float = 0.0,
    resample: str | None = None,
) -> torch.Tensor:
    """out = skip(x) + conv2(silu(GN2(conv1(silu(GN1(x))))·FiLM)), forward only.

    x [B,H,W,Cin]; w1 [3,3,Cin,Cout]; w2 [3,3,Cout,Cout]; film_* [B,Cout];
    skip_w None (identity, Cin == Cout) or [1,1,Cin,Cout].  ``resample``
    'up'/'down' selects the resblock_updown variant (identity skip).
    ``seed`` is accepted for signature parity; the forward kernels take no
    dropout path, so ``dropout_rate`` must be 0.
    """
    del seed
    if dropout_rate != 0.0:
        raise NotImplementedError("the forward ResBlock kernels take no dropout path")
    if resample is not None:
        if resample not in ("up", "down"):
            raise ValueError(f"resample must be 'up' or 'down', got {resample!r}")
        if skip_w is not None:
            raise ValueError("resample blocks have an identity skip")
    if x.is_cuda:
        if resample is not None:
            return resblock_resample_cuda(
                x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale, gn2_bias,
                w2, b2, resample=resample, num_groups=num_groups, eps=eps)
        return resblock_cuda(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
                             gn2_scale, gn2_bias, w2, b2, skip_w, skip_b,
                             num_groups=num_groups, eps=eps)
    if x.device.type != "cpu":
        raise ValueError(f"no ResBlock kernel for device {x.device}")
    return resblock_plain(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
                          gn2_scale, gn2_bias, w2, b2, skip_w, skip_b,
                          num_groups=num_groups, eps=eps, resample=resample)
