"""Fused ResBlock: CUDA kernels (K1, K2, K4, K5) and their plain versions.

Replaces the Pallas TPU kernels of `sgdm_tpu/ops/pallas/resblock.py`:
`fused_resblock` → `_fwd_kernel` with ``save_res=False`` (K1) and
`_fwd_resample_kernel` (K2) for sampling; `_fwd_kernel` with
``save_res=True`` (K4) and `_bwd_kernel` (K5), the custom VJP, for training:

    h1  = silu(GN1(x)·g1 + b1)                 (up/down: resampled in f32)
    h2  = conv3x3(bf16(h1), W1) + c1            (f32)
    h3  = silu((GN2(h2)·g2 + b2)·(1 + fs) + fsh) · dropout mask (K4)
    out = bf16(conv3x3(bf16(h3), W2) + c2 + skip(x)) (+ skip bias, added after)

On a CUDA tensor `fused_resblock` launches the kernels of
``csrc/resblock.cu`` (four launches per call: GN1 statistics, conv1, GN2
statistics, conv2; the two convolutions are one `wgmma` kernel that activates
each haloed input tile once per channel chunk and runs the nine taps on
windows of it; see that file for the design and what bounds it) or
raises; on a CPU tensor it runs `resblock_plain`, which keeps the kernel's
rounding points: FiLM and SiLU in f32, bf16 only at conv inputs and at the
output, h2 never rounded, and for ``down`` the activated h1 pooled in f32
before the cast.

K4 (`resblock_train_cuda`) is K1's launches with the dropout mask applied
in the conv2 prologue and the residuals kept: h2 (f32; the TPU kernel
stores it in bf16, so the two backwards see GN2 inputs that differ by up to
one bf16 rounding, well inside the bf16 tolerance) and the per-channel GN
mean and rstd of x and h2.  It keeps neither h1 nor h3d: K5
(`resblock_bwd_cuda`, ``csrc/resblock_bwd.cu``) rebuilds both once, in its
GroupNorm-backward passes, with K4's SiLU and folded coefficients; its data
gradients run on the forward's convolution (``csrc/conv_core.cuh``), its
weight gradients on a `wgmma` kernel over runs of 16 x 16 spatial tiles
whose per-run partials are summed in a fixed order (`wgrad_splits`).
The mask is `dropout_mask`, the TPU kernel's counter hash bit for bit.
`resblock_bwd_plain` is K5's arithmetic written out step by step (not
autograd of the plain forward), with its rounding points.
`fused_resblock_train` is the autograd entry: K4/K5 on CUDA tensors, the
plain pair on CPU tensors (or on any device with ``kernels=False``).

`resblock_cuda` (K1), `resblock_resample_cuda` (K2), `resblock_train_cuda`
(K4) and `resblock_bwd_cuda` (K5) each count one launch per call in their
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .build import library

__all__ = ["fused_resblock", "resblock_plain", "resblock_cuda", "resblock_resample_cuda",
           "dropout_mask", "resblock_train_cuda", "resblock_bwd_plain", "resblock_bwd_cuda",
           "fused_resblock_train", "conv_blocks_per_sm", "bwd_blocks_per_sm", "wgrad_splits"]


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


_M32 = 0xFFFFFFFF


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z · c) mod 2³² for int64 z in [0, 2³²), without int64 overflow."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_mask(batch: int, hw: int, channels: int, seed: int, rate: float,
                 device=None) -> torch.Tensor:
    """f32 [batch, hw, channels]: 1/(1-rate) where kept, else 0.

    Bit for bit `sgdm_tpu/ops/pallas/resblock.py _dropout_mask`: sample b,
    pixel i, channel j hashes z = (i·C + j) + (seed + b)·2654435761 through
    two multiply/xor rounds (uint32 wrap-around, done in int64 here) and
    keeps when its top 24 bits, as a fraction of 2²⁴, are ≥ rate.
    """
    i = torch.arange(hw, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(channels, dtype=torch.int64, device=device)[None, :]
    s = (seed + torch.arange(batch, dtype=torch.int64, device=device)) & _M32
    z = ((i * channels + j)[None] + _mul32(s, 2654435761)[:, None, None]) & _M32
    z = z ^ (z >> 16)
    z = _mul32(z, 0x7FEB352D)
    z = z ^ (z >> 15)
    z = _mul32(z, 0x846CA68B)
    z = z ^ (z >> 16)
    u = (z >> 8).to(torch.float32) * (1.0 / (1 << 24))
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return (u >= torch.tensor(rate, dtype=torch.float32)).to(torch.float32) * inv_keep.to(u.device)


def resblock_plain(
    x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
    gn2_scale, gn2_bias, w2, b2, skip_w=None, skip_b=None,
    *, num_groups: int = 32, eps: float = 1e-5, resample: str | None = None,
    dropout_rate: float = 0.0, seed: int = 0, save_res: bool = False,
):
    """The kernels' arithmetic in plain PyTorch (NHWC; weights HWIO).

    ``dropout_rate`` > 0 multiplies h3 by `dropout_mask` (seed ``seed``).
    ``save_res`` (K4) returns (out, h2 f32 [B,H,W,Cout], mean1, rstd1,
    mean2, rstd2), the GN statistics per channel [B, C].
    """
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
    h3 = F.silu(pre)
    if dropout_rate > 0.0:
        h3 = h3 * dropout_mask(bsz, ho * wo, cout, seed, dropout_rate, x.device)
    h3 = h3.to(cdtype).reshape(bsz, ho, wo, cout)
    out = _conv3x3(h3, w2.to(cdtype)) + b2.float()
    if skip_w is None:
        out = out + skip
    else:
        skw = skip_w.reshape(cin, cout).to(cdtype).float()
        out = out + (x.to(cdtype).float() @ skw)
    out = out.to(x.dtype)
    if skip_w is not None and skip_b is not None:
        out = out + skip_b.to(out.dtype)
    if save_res:
        return (out, h2.reshape(bsz, ho, wo, cout), mean1[:, 0], rstd1[:, 0], mean2[:, 0],
                rstd2[:, 0])
    return out


def _dsilu(z: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def _group_mean(t: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-(sample, group) mean of t [B, N, C], broadcast back to [B, 1, C]."""
    b, n, c = t.shape
    m = t.sum(1).reshape(b, groups, c // groups).sum(-1) / (n * (c // groups))
    return m.repeat_interleave(c // groups, dim=-1)[:, None, :]


def _flip_taps(w: torch.Tensor) -> torch.Tensor:
    """Conv-transpose kernel, HWIO [3,3,Ci,Co] → [3,3,Co,Ci]: out[dy,dx] = W[2-dy,2-dx]ᵀ
    (`resblock.py _stack_w_flip`)."""
    return w.flip(0, 1).transpose(2, 3)


def _wgrad3x3(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW [3,3,Ci,Co] f32 = Σ_pixels shifted a [B,H,W,Ci] ⊗ g [B,H,W,Co], zero padding."""
    bsz, h, w, ci = a.shape
    ap = F.pad(a.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(-1, g.shape[-1])
    rows = [ap[:, dy:dy + h, dx:dx + w, :].reshape(-1, ci).T @ gf
            for dy in range(3) for dx in range(3)]
    return torch.stack(rows).reshape(3, 3, ci, g.shape[-1])


def resblock_bwd_plain(
    x, dout, h2, mean1, rstd1, mean2, rstd2, gn1_scale, gn1_bias, w1, film_scale, film_shift,
    gn2_scale, gn2_bias, w2, skip_w=None, *, num_groups: int = 32, dropout_rate: float = 0.0,
    seed: int = 0,
):
    """K5's arithmetic step by step (`resblock.py _bwd_kernel`), in plain PyTorch.

    Returns (dx, dg1, db1, dw1, dc1, dfs, dfsh, dg2, db2, dw2, dc2, dskw, dskb);
    dskw and dskb are None for an identity skip (dskb = Σ dout otherwise).
    Rounding points are the kernel's: dout and dh2 enter the gradient
    convolutions in x's dtype; the conv1 weight gradient takes the rounded
    dh2 (the TPU kernel: f32 dh2; identical in f32).
    """
    cd = x.dtype
    bsz, h, w, cin = x.shape
    cout = w1.shape[-1]
    g_in, g_out = _groups(num_groups, cin), _groups(num_groups, cout)
    xf = x.float().reshape(bsz, h * w, cin)
    xhat1 = (xf - mean1.float()[:, None]) * rstd1.float()[:, None]
    pre1 = xhat1 * gn1_scale.float() + gn1_bias.float()
    h2f = h2.float().reshape(bsz, h * w, cout)
    xhat2 = (h2f - mean2.float()[:, None]) * rstd2.float()[:, None]
    gn2 = xhat2 * gn2_scale.float() + gn2_bias.float()
    f = 1.0 + film_scale.float()[:, None, :]
    pre3 = gn2 * f + film_shift.float()[:, None, :]
    g = dout.float().reshape(bsz, h * w, cout)
    gc = dout.to(cd).reshape(bsz, h, w, cout)

    # conv2 backward: input h3d recomputed from h2, FiLM and the mask
    h3 = F.silu(pre3)
    mask = None
    if dropout_rate > 0.0:
        mask = dropout_mask(bsz, h * w, cout, seed, dropout_rate, x.device)
        h3 = h3 * mask
    h3d = h3.to(cd).reshape(bsz, h, w, cout)
    dc2 = g.sum((0, 1))
    dw2 = _wgrad3x3(h3d, gc)
    dh3d = _conv3x3(gc, _flip_taps(w2).to(cd)).reshape(bsz, h * w, cout)

    # dropout / SiLU / FiLM / GN2 backward
    dh3 = dh3d * mask if mask is not None else dh3d
    dpre3 = dh3 * _dsilu(pre3)
    dfs = (dpre3 * gn2).sum(1)
    dfsh = dpre3.sum(1)
    dgn2 = dpre3 * f
    dg2 = (dgn2 * xhat2).sum((0, 1))
    db2 = dgn2.sum((0, 1))
    dxhat2 = dgn2 * gn2_scale.float()
    dh2 = rstd2.float()[:, None] * (dxhat2 - _group_mean(dxhat2, g_out)
                                    - xhat2 * _group_mean(dxhat2 * xhat2, g_out))

    # conv1 backward: input h1 recomputed from x and the GN1 statistics
    dc1 = dh2.sum((0, 1))
    dh2c = dh2.to(cd).reshape(bsz, h, w, cout)
    h1 = F.silu(pre1).to(cd).reshape(bsz, h, w, cin)
    dw1 = _wgrad3x3(h1, dh2c)
    dh1 = _conv3x3(dh2c, _flip_taps(w1).to(cd)).reshape(bsz, h * w, cin)

    # SiLU / GN1 backward
    dpre1 = dh1 * _dsilu(pre1)
    dg1 = (dpre1 * xhat1).sum((0, 1))
    db1 = dpre1.sum((0, 1))
    dxhat1 = dpre1 * gn1_scale.float()
    dx = rstd1.float()[:, None] * (dxhat1 - _group_mean(dxhat1, g_in)
                                   - xhat1 * _group_mean(dxhat1 * xhat1, g_in))

    # skip path
    dskw = dskb = None
    if skip_w is None:
        dx = dx + g
    else:
        skw = skip_w.reshape(cin, cout).to(cd).float()
        dskw = (x.to(cd).float().reshape(-1, cin).T @ gc.float().reshape(-1, cout))
        dskw = dskw.reshape(1, 1, cin, cout)
        dx = dx + gc.float().reshape(bsz, h * w, cout) @ skw.T
        dskb = dc2
    return (dx.reshape(bsz, h, w, cin).to(x.dtype), dg1, db1, dw1, dc1,
            dfs.to(film_scale.dtype), dfsh.to(film_shift.dtype), dg2, db2, dw2, dc2, dskw, dskb)


# ------------------------------------------------------------ CUDA kernels

def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _lib():
    lib = library("resblock")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgdm_gn_coef.argtypes = [vp, i, i, i, i, i, f, vp, vp, vp, vp, vp, vp, vp]
        lib.sgdm_gn_coef.restype = i
        lib.sgdm_resblock_conv.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp,
                                           i, i, i, i, i, i, i, i, f, i, vp]
        lib.sgdm_resblock_conv.restype = i
        lib.sgdm_resblock_conv_occupancy.argtypes = []
        lib.sgdm_resblock_conv_occupancy.restype = i
        lib._sgdm_typed = True
    return lib


def conv_blocks_per_sm() -> int:
    """Blocks of the ResBlock convolution kernel an SM of the current card
    holds, as the CUDA runtime's occupancy calculator counts them."""
    return _lib().sgdm_resblock_conv_occupancy()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _pad8(w: torch.Tensor) -> torch.Tensor:
    """bf16 copy of w [..., Co] with Co padded by zero columns to a multiple of
    8, so the convolution kernel loads every weight row 16 bytes at a time."""
    co = w.shape[-1]
    out = w.new_zeros(w.shape[:-1] + (-(-co // 8) * 8,), dtype=torch.bfloat16)
    out[..., :co] = w.detach()
    return out


def _taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3,3,Ci,Co] → bf16 [9,Ci,Co8] (tap = dy*3 + dx; Co8: `_pad8`)."""
    return _pad8(w.reshape(9, w.shape[2], w.shape[3]))


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


def _run(x, g1, b1, w1, c1, fs, fsh, g2, b2, w2, c2, skip_w, *, num_groups, eps, rs,
         rate=0.0, seed=0, save=False):
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
    rstd1 = rstd2 = None
    if save:
        rstd1 = torch.empty((bsz, cin), device=dev, dtype=torch.float32)
        rstd2 = torch.empty((bsz, cout), device=dev, dtype=torch.float32)
    h2 = torch.empty((bsz, ho, wo, cout), device=dev, dtype=torch.float32)
    out = torch.empty((bsz, ho, wo, cout), device=dev, dtype=torch.bfloat16)
    seed = _seed32(seed)

    _check(lib.sgdm_gn_coef(_ptr(x), 0, bsz, hi * wi, cin, g_in, eps, _ptr(g1), _ptr(b1),
                            None, None, _ptr(coef1), _ptr(rstd1), stream), "gn_coef(x)")
    _check(lib.sgdm_resblock_conv(1, rs, _ptr(x), _ptr(coef1), _ptr(w1t), _ptr(c1), None, None,
                                  _ptr(h2), bsz, ho, wo, cin, cout, hi, wi, 0, 0.0, 0, stream),
           "conv1")
    _check(lib.sgdm_gn_coef(_ptr(h2), 1, bsz, ho * wo, cout, g_out, eps, _ptr(g2), _ptr(b2),
                            _ptr(fs), _ptr(fsh), _ptr(coef2), _ptr(rstd2), stream), "gn_coef(h2)")
    if skip_w is None:
        _check(lib.sgdm_resblock_conv(2, rs, _ptr(h2), _ptr(coef2), _ptr(w2t), _ptr(c2), _ptr(x),
                                      None, _ptr(out), bsz, ho, wo, cout, cout, hi, wi, cout,
                                      rate, seed, stream), "conv2")
    else:
        skw = _pad8(skip_w.reshape(cin, cout))
        _check(lib.sgdm_resblock_conv(3, 0, _ptr(h2), _ptr(coef2), _ptr(w2t), _ptr(c2), _ptr(x),
                                      _ptr(skw), _ptr(out), bsz, ho, wo, cout, cout, hi, wi, cin,
                                      rate, seed, stream), "conv2")
    if save:
        return out, h2, coef1[:, 0], rstd1, coef2[:, 0], rstd2
    return out


def _seed32(seed: int) -> int:
    """A seed as the int32 the kernels take (the hash reads it mod 2**32)."""
    seed = int(seed) & _M32
    return seed - (1 << 32) if seed >= (1 << 31) else seed


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


def resblock_train_cuda(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
                        gn2_scale, gn2_bias, w2, b2, skip_w=None, skip_b=None, *,
                        dropout_rate: float = 0.0, seed: int = 0, num_groups: int = 32,
                        eps: float = 1e-5):
    """K4: the training forward.  Returns (out, h2 f32, mean1, rstd1, mean2,
    rstd2), the statistics per channel [B, C]."""
    _validate(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale, gn2_bias,
              w2, b2, skip_w)
    if skip_w is None and x.shape[-1] != w1.shape[-1]:
        raise ValueError("identity skip needs Cin == Cout")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    res = _run(x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale, gn2_bias,
               w2, b2, skip_w, num_groups=num_groups, eps=eps, rs=0, rate=dropout_rate,
               seed=seed, save=True)
    resblock_train_cuda.launches += 1
    out = res[0]
    if skip_w is not None and skip_b is not None:
        out = out + skip_b.to(out.dtype)
    return (out,) + res[1:]


resblock_train_cuda.launches = 0


def _bwd_lib():
    lib = library("resblock_bwd")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.sgdm_gn_bwd.argtypes = [i, i] + [vp] * 14 + [i, i, i, i, vp, vp, i, i, i, i, f, i, vp]
        lib.sgdm_gn_bwd.restype = i
        lib.sgdm_dgrad.argtypes = [vp, vp, i, vp, vp, i, vp, i, i, i, i, vp]
        lib.sgdm_dgrad.restype = i
        lib.sgdm_wgrad.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
        lib.sgdm_wgrad.restype = i
        lib.sgdm_colsum.argtypes = [vp, i, ll, ll, vp, vp]
        lib.sgdm_colsum.restype = i
        lib.sgdm_wgrad_occupancy.argtypes = []
        lib.sgdm_wgrad_occupancy.restype = i
        lib.sgdm_dgrad_occupancy.argtypes = []
        lib.sgdm_dgrad_occupancy.restype = i
        for fn in (lib.sgdm_wgrad_smem, lib.sgdm_dgrad_smem):
            fn.argtypes, fn.restype = [], i
        lib._sgdm_typed = True
    return lib


def bwd_blocks_per_sm() -> dict:
    """Blocks an SM of the current card holds of K5's weight-gradient kernel
    and of its data-gradient convolution (the occupancy calculator's count),
    and the dynamic shared memory a block of each takes."""
    lib = _bwd_lib()
    return dict(wgrad_kernel=lib.sgdm_wgrad_occupancy(), dgrad_conv=lib.sgdm_dgrad_occupancy(),
                wgrad_smem_bytes=lib.sgdm_wgrad_smem(), dgrad_smem_bytes=lib.sgdm_dgrad_smem())


WGRAD_TILE = 16        # the weight gradients reduce over 16 x 16 spatial tiles
WGRAD_BLOCK = 64       # input and output channels of a weight-gradient block


def wgrad_splits(bsz: int, h: int, w: int, cin: int, cout: int, sm_count: int) -> int:
    """How many runs of spatial tiles the weight-gradient kernel cuts the pixel
    reduction into.  One block a (run, 64 x 64 channel tile) and one block an
    SM, so a count costs ceil(blocks / SMs) waves of ceil(tiles / runs) tile
    steps; every run also writes one f32 partial of the whole gradient that a
    second pass sums.  The fewest runs (at most 64) within 10 % of the
    fewest tile steps."""
    tiles = bsz * -(-h // WGRAD_TILE) * -(-w // WGRAD_TILE)
    out_tiles = -(-cin // WGRAD_BLOCK) * -(-cout // WGRAD_BLOCK)
    cost = {s: -(-out_tiles * s // sm_count) * -(-tiles // s)
            for s in range(1, min(tiles, 64) + 1)}
    best = min(cost.values())
    return min(s for s, c in cost.items() if c <= 1.1 * best)


def _ch8(t: torch.Tensor) -> torch.Tensor:
    """t with its channels (last dim) zero-padded to a multiple of 8: the
    weight-gradient kernel loads 16-byte rows by cp.async."""
    c = t.shape[-1]
    return t if c % 8 == 0 else F.pad(t, (0, -c % 8))


def resblock_bwd_cuda(x, dout, h2, mean1, rstd1, mean2, rstd2, gn1_scale, gn1_bias, w1,
                      film_scale, film_shift, gn2_scale, gn2_bias, w2, skip_w=None, *,
                      num_groups: int = 32, dropout_rate: float = 0.0, seed: int = 0):
    """K5: the VJP of K4 on the kernels of ``csrc/resblock_bwd.cu``.

    Same outputs as `resblock_bwd_plain`.  dx is bf16; parameter gradients
    are f32; dfs/dfsh take film_scale's dtype.
    """
    if not x.is_cuda:
        raise ValueError("CUDA kernel wrapper called with a CPU tensor")
    if x.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16:
        raise TypeError(f"K5 takes bf16 x and dout, got {x.dtype}, {dout.dtype}")
    bsz, h, w, cin = x.shape
    cout = w1.shape[-1]
    if tuple(dout.shape) != (bsz, h, w, cout) or tuple(h2.shape) != (bsz, h, w, cout):
        raise ValueError(f"dout {tuple(dout.shape)} / h2 {tuple(h2.shape)} do not fit x "
                         f"{tuple(x.shape)} and Cout={cout}")
    if skip_w is None and cin != cout:
        raise ValueError("identity skip needs Cin == Cout")
    for c in (cin, cout):
        if (c // 8 if c % 8 == 0 else c) > 512:
            raise ValueError(f"channel count {c} beyond the GroupNorm backward kernel")
    for name, t in (("dout", dout), ("h2", h2), ("w1", w1), ("w2", w2), ("mean1", mean1),
                    ("rstd1", rstd1), ("mean2", mean2), ("rstd2", rstd2),
                    ("film_scale", film_scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    lib = _bwd_lib()
    dev = x.device
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    g_in, g_out = _groups(num_groups, cin), _groups(num_groups, cout)
    hw = h * w
    f32 = dict(device=dev, dtype=torch.float32)
    bf = dict(device=dev, dtype=torch.bfloat16)
    x = x.contiguous()
    dout = dout.contiguous()
    h2 = _f32(h2)
    mean1, rstd1, mean2, rstd2 = (_f32(t) for t in (mean1, rstd1, mean2, rstd2))
    g1, b1, g2, b2 = (_f32(t) for t in (gn1_scale, gn1_bias, gn2_scale, gn2_bias))
    fs, fsh = _f32(film_scale), _f32(film_shift)
    w1f = _taps(_flip_taps(w1.detach()))      # [9, Cout, Cin8]
    w2f = _taps(_flip_taps(w2.detach()))      # [9, Cout, Cout8]
    rate, seed = float(dropout_rate), _seed32(seed)

    # per-sample partial sums: dg1 | db1 | dg2 | db2 | dc1 | dc2
    og1, ob1, og2 = 0, cin, 2 * cin
    ob2, oc1, oc2 = og2 + cout, og2 + 2 * cout, og2 + 3 * cout
    ld = 2 * cin + 4 * cout
    part = torch.empty((bsz, ld), **f32)

    dh3d = torch.empty((bsz, h, w, cout), **f32)
    h3d = torch.empty((bsz, h, w, cout), **bf)
    coef2 = torch.empty((bsz, 3, cout), **f32)
    dfs = torch.empty((bsz, cout), **f32)
    dfsh = torch.empty((bsz, cout), **f32)
    dh2 = torch.empty((bsz, h, w, cout), **bf)
    dh1 = torch.empty((bsz, h, w, cin), **f32)
    h1 = torch.empty((bsz, h, w, cin), **bf)
    coef1 = torch.empty((bsz, 3, cin), **f32)
    dx = torch.empty((bsz, h, w, cin), **bf)
    p = _ptr

    _check(lib.sgdm_dgrad(p(dout), p(w2f), cout, None, None, 0, p(dh3d), bsz, h, w, cout,
                          stream), "dgrad conv2")
    _check(lib.sgdm_gn_bwd(0, 2, p(dh3d), p(h2), p(mean2), p(rstd2), p(g2), p(b2), p(fs),
                           p(fsh), p(dout), None, p(coef2), p(dfs), p(dfsh), p(part), ld, og2,
                           ob2, oc2, None, p(h3d), bsz, hw, cout, g_out, rate, seed, stream),
           "GN2 backward (reduce)")
    _check(lib.sgdm_gn_bwd(1, 2, p(dh3d), p(h2), p(mean2), p(rstd2), p(g2), p(b2), p(fs),
                           p(fsh), None, None, p(coef2), None, None, p(part), ld, 0, 0, oc1,
                           p(dh2), None, bsz, hw, cout, g_out, rate, seed, stream),
           "GN2 backward (apply)")
    _check(lib.sgdm_dgrad(p(dh2), p(w1f), cout, None, None, 0, p(dh1), bsz, h, w, cin, stream),
           "dgrad conv1")
    skip_grad = None
    if skip_w is not None:
        skt = _pad8(skip_w.detach().reshape(cin, cout).T)     # [Cout, Cin8]
        skip_grad = torch.empty((bsz, h, w, cin), **f32)
        _check(lib.sgdm_dgrad(None, None, 0, p(dout), p(skt), cout, p(skip_grad), bsz, h, w,
                              cin, stream), "dgrad skip")
    _check(lib.sgdm_gn_bwd(0, 1, p(dh1), p(x), p(mean1), p(rstd1), p(g1), p(b1), None, None,
                           None, None, p(coef1), None, None, p(part), ld, og1, ob1, -1, None,
                           p(h1), bsz, hw, cin, g_in, 0.0, 0, stream), "GN1 backward (reduce)")
    _check(lib.sgdm_gn_bwd(1, 1, p(dh1), p(x), p(mean1), p(rstd1), p(g1), p(b1), None, None,
                           p(dout) if skip_w is None else None, p(skip_grad), p(coef1), None,
                           None, p(part), ld, 0, 0, -1, p(dx), None, bsz, hw, cin, g_in, 0.0, 0,
                           stream), "GN1 backward (apply)")

    # weight gradients: partials per run of spatial tiles, summed in run order
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g8, dh2_8 = _ch8(dout), _ch8(dh2)
    n_w2, n_w1 = 9 * cout * cout, 9 * cin * cout
    n_sk = cin * cout if skip_w is not None else 0
    dwv = torch.empty((n_w2 + n_w1 + n_sk,), **f32)
    wgrads = [(9, _ch8(h3d), g8, cout, 0, n_w2), (9, _ch8(h1), dh2_8, cin, n_w2, n_w1)]
    if skip_w is not None:
        wgrads.append((1, _ch8(x), g8, cin, n_w2 + n_w1, n_sk))
    for taps, act, gg, k, off, n in wgrads:
        splits = wgrad_splits(bsz, h, w, k, cout, sms)
        rows = splits if taps == 9 else 3 * splits
        pw = torch.empty((rows, n), **f32)
        _check(lib.sgdm_wgrad(taps, p(act), p(gg), p(pw), bsz, h, w, k, cout, act.shape[-1],
                              gg.shape[-1], splits, stream), f"wgrad ({taps} taps, K={k})")
        _check(lib.sgdm_colsum(p(pw), rows, n, n, p(dwv[off:]), stream), "colsum weights")
    vec = torch.empty((ld,), **f32)
    _check(lib.sgdm_colsum(p(part), bsz, ld, ld, p(vec), stream), "colsum per-sample")
    resblock_bwd_cuda.launches += 1

    dw2 = dwv[:n_w2].reshape(3, 3, cout, cout)
    dw1 = dwv[n_w2:n_w2 + n_w1].reshape(3, 3, cin, cout)
    dskw = dwv[n_w2 + n_w1:].reshape(1, 1, cin, cout) if skip_w is not None else None
    dc2 = vec[oc2:oc2 + cout]
    return (dx, vec[og1:og1 + cin], vec[ob1:ob1 + cin], dw1, vec[oc1:oc1 + cout],
            dfs.to(film_scale.dtype), dfsh.to(film_shift.dtype), vec[og2:og2 + cout],
            vec[ob2:ob2 + cout], dw2, dc2, dskw, dc2 if skip_w is not None else None)


resblock_bwd_cuda.launches = 0


class _ResBlockTrain(torch.autograd.Function):
    """K4 forward, K5 backward (or the plain pair): the custom VJP of
    `resblock.py _build.f`."""

    @staticmethod
    def forward(ctx, x, g1, b1, w1, c1, fs, fsh, g2, b2, w2, c2, skw, skb, rate, seed,
                num_groups, eps, kernels):
        args = (x, g1, b1, w1, c1, fs, fsh, g2, b2, w2, c2, skw, skb)
        kw = dict(dropout_rate=rate, seed=seed, num_groups=num_groups, eps=eps)
        if kernels and x.is_cuda:
            res = resblock_train_cuda(*args, **kw)
        elif not kernels or x.device.type == "cpu":
            res = resblock_plain(*args, **kw, save_res=True)
        else:
            raise ValueError(f"no ResBlock kernel for device {x.device}")
        out, h2, m1, r1, m2, r2 = res
        ctx.save_for_backward(x, g1, b1, w1, fs, fsh, g2, b2, w2, skw, h2, m1, r1, m2, r2)
        ctx.cfg = (rate, seed, num_groups, kernels and x.is_cuda, skb is not None)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, g1, b1, w1, fs, fsh, g2, b2, w2, skw, h2, m1, r1, m2, r2 = ctx.saved_tensors
        rate, seed, num_groups, use_kernel, has_skb = ctx.cfg
        bwd = resblock_bwd_cuda if use_kernel else resblock_bwd_plain
        (dx, dg1, db1, dw1, dc1, dfs, dfsh, dg2, db2, dw2, dc2, dskw, dskb) = bwd(
            x, dout.to(x.dtype).contiguous(), h2, m1, r1, m2, r2, g1, b1, w1, fs, fsh, g2, b2,
            w2, skw, num_groups=num_groups, dropout_rate=rate, seed=seed)
        return (dx, dg1, db1, dw1, dc1, dfs, dfsh, dg2, db2, dw2, dc2, dskw,
                dskb if has_skb else None, None, None, None, None, None)


def fused_resblock_train(
    x, gn1_scale, gn1_bias, w1, b1, film_scale, film_shift,
    gn2_scale, gn2_bias, w2, b2, skip_w=None, skip_b=None, seed: int = 0,
    *, num_groups: int = 32, eps: float = 1e-5, dropout_rate: float = 0.0,
    kernels: bool = True,
) -> torch.Tensor:
    """The training ResBlock (same-resolution; identity or projection skip)
    with its backward: K4/K5 on a CUDA tensor, the plain pair on a CPU tensor
    or whenever ``kernels`` is False."""
    return _ResBlockTrain.apply(
        x.contiguous(), gn1_scale, gn1_bias, w1, b1, film_scale, film_shift, gn2_scale,
        gn2_bias, w2, b2, skip_w, skip_b, float(dropout_rate), int(seed), num_groups, eps,
        bool(kernels))


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
    ``seed`` is accepted for signature parity; dropout is a training
    feature (`fused_resblock_train`), so ``dropout_rate`` must be 0 here.
    """
    del seed
    if dropout_rate != 0.0:
        raise NotImplementedError("dropout trains through fused_resblock_train")
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
