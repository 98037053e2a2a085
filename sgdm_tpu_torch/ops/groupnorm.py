"""Fused GroupNorm(+FiLM)+SiLU: the CUDA kernel (K6) and its plain version.

K6 replaces the Pallas TPU kernel `sgdm_tpu/ops/pallas/groupnorm.py`
`fused_groupnorm_silu` (`_apply_kernel`), which the ResBlock's unfused
composition calls in sampling mode:

    out = silu((GN(x)·γ + β)·(1 + film_scale) + film_shift)   in x.dtype,

the whole chain in float32 and ONE cast at the end (the non-kernel
GroupNorm of `models/layers.py` rounds to the compute dtype after the
affine instead; in bf16 the two differ by a few bf16 ulps of the output).
The per-(sample, group) statistics are E[x²] − mean², clamped at 0, as the
JAX package's `_group_stats` has them; the TPU kernel left them to XLA
because a sample did not fit VMEM.  On the card they are computed inside K6
(``csrc/groupnorm.cu``), on one of two routes that `plan_groupnorm` picks
per shape: "cluster", one launch in which a thread-block cluster holds a
whole sample in shared memory, so x is read once; or "split", a statistics
launch and an apply launch, for samples larger than a cluster holds.  The
plain version computes them with `group_stats`.

On a CUDA tensor `fused_groupnorm_silu` calls `groupnorm_silu_cuda`, which
launches ``csrc/groupnorm.cu`` (counted once per call in
``groupnorm_silu_cuda.launches``, whichever route) or raises; on a CPU
tensor, or with ``kernels=False``, it runs `groupnorm_silu_plain`.  The
backward recomputes through the plain version, as the TPU kernel's custom
VJP recomputes through its reference.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .build import library

__all__ = ["fused_groupnorm_silu", "groupnorm_silu_plain", "groupnorm_silu_cuda", "group_stats",
           "plan_groupnorm", "GnPlan"]


def group_stats(x: torch.Tensor, num_groups: int, eps: float):
    """x [B, H, W, C] → per-(sample, group) f32 (mean, rstd), each [B, G]."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    return mean, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def groupnorm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         film_scale: torch.Tensor | None = None,
                         film_shift: torch.Tensor | None = None,
                         num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x [B, H, W, C], gamma/beta [C], film_* [B, C] or None: the kernel's arithmetic."""
    b, c = x.shape[0], x.shape[-1]
    gs = c // num_groups
    mean, rstd = group_stats(x, num_groups, eps)
    rep = lambda t: t.repeat_interleave(gs, dim=-1)[:, None, None, :]
    h = (x.float() - rep(mean)) * rep(rstd)
    h = h * gamma.float() + beta.float()
    if film_scale is not None:
        h = h * (1.0 + film_scale.float().reshape(b, 1, 1, c)) \
            + film_shift.float().reshape(b, 1, 1, c)
    return (h * torch.sigmoid(h)).to(x.dtype)


CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_STAGES = 4          # TMA pieces of a rank's run (csrc/groupnorm.cu MAX_STAGES)
SM_RESERVED = 1024      # shared memory the card reserves per resident block
MAX_SLICES = 32         # split route: statistics slices a sample


@dataclass(frozen=True)
class GnPlan:
    """One launch plan of K6.  ``route`` "cluster": ``cluster`` blocks a sample,
    rank r owning pixels ``runs[r]`` (``per`` each, the last possibly fewer),
    brought in ``stages`` TMA pieces, ``smem`` bytes a block, ``blocks_per_sm``
    resident on an SM; ``grid`` clusters walk the samples
    (as many as the card holds at once, at most B), each block ``threads``
    consumers and a producer warp.  ``route`` "split": ``slices`` statistics
    blocks of ``per`` pixels and ``chunks`` apply blocks of ``per_chunk``
    pixels a sample, ``threads`` a block, ``smem`` bytes a statistics block."""
    route: str
    threads: int
    per: int
    smem: int
    cluster: int = 0
    runs: tuple = ()
    stages: int = 0
    blocks_per_sm: int = 0
    grid: int = 0
    slices: int = 0
    chunks: int = 0
    per_chunk: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _layout(c: int) -> tuple[int, int]:
    """(V, threads): channels a thread (8 when C % 8 == 0, else 1) and the block
    size that gives every one of the C / V channel slots a thread."""
    v = 8 if c % 8 == 0 else 1
    return v, (256 if c // v <= 256 else 512)


def cluster_smem(per: int, c: int, groups: int, threads: int) -> int:
    """Shared-memory bytes of a cluster-route block: the run [per, C] bf16
    (16-byte rounded), 2·MAX_STAGES + 2 mbarriers, the row partials [R, C]
    (at least 32·G floats: the ranks' group partials reuse them), the channel
    sums [2, C], two samples' group partials and the statistics [6, G] f32
    (csrc/groupnorm.cu cluster_smem)."""
    v, _ = _layout(c)
    rows = threads // (c // v)
    return (_cdiv(per * c * 2, 16) * 16 + 8 * (2 * MAX_STAGES + 2)
            + (max(rows * c, 32 * groups) + 2 * c + 6 * groups) * 4)


def plan_groupnorm(B: int, HW: int, C: int, sms: int, max_smem: int, *, num_groups: int = 32,
                   route: str | None = None, cluster: int | None = None,
                   clusters=None, blocks=None) -> GnPlan:
    """K6's launch plan for x [B, HW, C] on a card of ``sms`` SMs whose block
    may take ``max_smem`` bytes of shared memory.

    The route is "cluster" when ceil(HW / n)·C·2 bytes (plus the block's
    partials) fit a block for some cluster size n ≤ 16 with no rank empty:
    the smallest n whose block leaves room for a second one on its SM (one
    block's stores then overlap another's loads), else the smallest n whose
    block fits alone, with 512 consumer threads where they fit.
    ``blocks(threads, smem)``, where given (on the card:
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, which counts registers
    too), counts the blocks an SM holds; without it shared memory alone
    decides.  ``clusters(n, threads, smem)``, where given (on the card:
    cudaOccupancyMaxActiveClusters), counts the clusters the card holds at
    once: at least one, else the next n is tried; the grid is that many
    clusters (at most B), each walking its samples.  Without it the grid
    follows from the blocks an SM holds.  When no n is left the route is
    "split".  ``route`` forces a route (the card test and chip_smoke.py) and
    ``cluster`` a cluster size (the CPU tests); a forced route that cannot be
    planned raises.
    """
    if route not in (None, "cluster", "split"):
        raise ValueError(f"route {route!r} is not None, 'cluster' or 'split'")
    if min(B, HW, C, num_groups) < 1 or C % num_groups:
        raise ValueError(f"no GroupNorm of {C} channels in {num_groups} groups over {HW} pixels")
    v, threads = _layout(C)
    if C // v > 512:
        raise ValueError(f"channel count {C} beyond the GroupNorm+SiLU kernel's thread "
                         "layout (4096 when a multiple of 8, else 512)")
    if blocks is None:
        blocks = lambda t, smem: (max_smem + SM_RESERVED) // (smem + SM_RESERVED)
    if route != "split":
        fits_two, fits_one = [], []
        for n in (CLUSTER_SIZES if cluster is None else (cluster,)):
            per = _cdiv(HW, n)
            if n not in CLUSTER_SIZES or (n - 1) * per >= HW:
                continue  # a rank without pixels
            smem = cluster_smem(per, C, num_groups, threads)
            if smem > max_smem:
                continue
            per_sm = blocks(threads, smem)
            if per_sm >= 1:
                (fits_two if per_sm >= 2 else fits_one).append((n, per, smem, per_sm))
        for n, per, smem, per_sm in fits_two + fits_one:
            t = threads
            wide = cluster_smem(per, C, num_groups, 512)
            if per_sm == 1 and threads == 256 and wide <= max_smem and blocks(512, wide) >= 1:
                t, smem, per_sm = 512, wide, blocks(512, wide)  # alone: twice the warps
            resident = sms * per_sm // n if clusters is None else clusters(n, t, smem)
            if resident < 1:
                continue
            runs = tuple((r * per, min(HW, (r + 1) * per)) for r in range(n))
            return GnPlan("cluster", t, per, smem, cluster=n, runs=runs,
                          stages=min(MAX_STAGES, per), blocks_per_sm=per_sm,
                          grid=min(B, resident))
        if route == "cluster":
            raise ValueError(f"no cluster takes a sample of {HW} pixels x {C} channels")
    slices = max(1, min(MAX_SLICES, HW, _cdiv(2 * sms, B)))
    per = _cdiv(HW, slices)
    chunks = max(1, min(_cdiv(HW, 16), _cdiv(4 * sms, B)))
    per_chunk = _cdiv(HW, chunks)
    rows = threads // (C // v)
    return GnPlan("split", threads, per, (rows * C + 2 * C) * 4, slices=_cdiv(HW, per),
                  chunks=_cdiv(HW, per_chunk), per_chunk=per_chunk)


def _lib():
    lib = library("groupnorm")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgdm_groupnorm_cluster.argtypes = [vp] * 6 + [i] * 4 + [f] + [i] * 8 + [vp]
        lib.sgdm_groupnorm_cluster.restype = i
        lib.sgdm_groupnorm_split.argtypes = [vp] * 7 + [i] * 4 + [f] + [i] * 7 + [vp]
        lib.sgdm_groupnorm_split.restype = i
        lib.sgdm_groupnorm_max_clusters.argtypes = [i] * 4
        lib.sgdm_groupnorm_max_clusters.restype = i
        lib.sgdm_groupnorm_blocks_per_sm.argtypes = [i] * 3
        lib.sgdm_groupnorm_blocks_per_sm.restype = i
        lib.sgdm_groupnorm_max_smem.argtypes = []
        lib.sgdm_groupnorm_max_smem.restype = i
        lib._sgdm_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def device_plan(device_index: int, B: int, HW: int, C: int, num_groups: int,
                route: str | None = None) -> GnPlan:
    """`plan_groupnorm` for the card ``device_index``, its blocks an SM and
    clusters asked of the card's occupancy calculator (cached per shape)."""
    lib = _lib()
    with torch.cuda.device(device_index):
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
        max_smem = lib.sgdm_groupnorm_max_smem()
        vec = int(C % 8 == 0)
        held = lambda t, s: lib.sgdm_groupnorm_blocks_per_sm(vec, t, s)
        resident = lambda n, t, s: lib.sgdm_groupnorm_max_clusters(vec, n, t, s)
        return plan_groupnorm(B, HW, C, sms, max_smem, num_groups=num_groups, route=route,
                              clusters=resident, blocks=held)


def _film(fs: torch.Tensor | None, fsh: torch.Tensor | None):
    """FiLM as the kernels read it: (scale, shift, row stride, bf16?).  Rows of
    unit-stride f32 or bf16 are read in place (the model hands over the two
    halves of one projection, views a row apart); anything else is copied to
    contiguous f32."""
    if fs is None:
        return None, None, 0, 0
    if (fs.dtype == fsh.dtype and fs.dtype in (torch.float32, torch.bfloat16)
            and fs.stride(1) == 1 and fsh.stride(1) == 1 and fs.stride(0) == fsh.stride(0)):
        return fs.detach(), fsh.detach(), fs.stride(0), int(fs.dtype == torch.bfloat16)
    fs, fsh = (t.detach().float().contiguous() for t in (fs, fsh))
    return fs, fsh, fs.shape[1], 0


def groupnorm_silu_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        film_scale: torch.Tensor | None = None,
                        film_shift: torch.Tensor | None = None,
                        num_groups: int = 32, eps: float = 1e-5, *,
                        route: str | None = None) -> torch.Tensor:
    """K6 on the CUDA kernels: bf16, contiguous NHWC on one card; C up to
    4096 when a multiple of 8, else up to 512; any H and W.  ``route`` (None:
    the plan decides) forces the cluster or the split route."""
    if not x.is_cuda:
        raise ValueError("CUDA kernel wrapper called with a CPU tensor")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the GroupNorm+SiLU kernel takes bf16 activations, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got {tuple(x.shape)}")
    b, hh, ww, c = x.shape
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift come together")
    for name, t, shape in (("gamma", gamma, (c,)), ("beta", beta, (c,)),
                           ("film_scale", film_scale, (b, c)), ("film_shift", film_shift, (b, c))):
        if t is not None and (t.shape != shape or t.device != x.device):
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} != {shape} on {x.device}")
    plan = device_plan(x.device.index, b, hh * ww, c, int(num_groups), route)
    f32 = lambda t: t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()
    gamma, beta = f32(gamma.detach()), f32(beta.detach())
    fs, fsh, film_stride, film_bf16 = _film(film_scale, film_shift)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "split" and c % 8 == 0 and x.data_ptr() % 16:
        x = x.clone()
    ptr = lambda t: None if t is None else t.data_ptr()
    common = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(fs), ptr(fsh), ptr(out))
    if plan.route == "cluster":
        err = _lib().sgdm_groupnorm_cluster(*common, b, hh * ww, c, num_groups, eps,
                                            film_stride, film_bf16, plan.grid, plan.cluster,
                                            plan.per, plan.stages, plan.threads, plan.smem,
                                            stream)
    else:
        part = torch.empty((b, plan.slices, 2, c), device=x.device, dtype=torch.float32)
        err = _lib().sgdm_groupnorm_split(*common, part.data_ptr(), b, hh * ww, c, num_groups,
                                          eps, film_stride, film_bf16, plan.slices, plan.per,
                                          plan.chunks, plan.per_chunk, plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_silu ({plan.route}): CUDA error {err}")
    groupnorm_silu_cuda.launches += 1
    return out


groupnorm_silu_cuda.launches = 0


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, film_scale, film_shift, num_groups, eps, kernels):
        if kernels and x.is_cuda:
            out = groupnorm_silu_cuda(x, gamma, beta, film_scale, film_shift, num_groups, eps)
        elif not kernels or x.device.type == "cpu":
            out = groupnorm_silu_plain(x, gamma, beta, film_scale, film_shift, num_groups, eps)
        else:
            raise ValueError(f"no GroupNorm+SiLU kernel for device {x.device}")
        ctx.save_for_backward(x, gamma, beta, film_scale, film_shift)
        ctx.cfg = (num_groups, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_() for t in saved]
            out = groupnorm_silu_plain(*leaves, *ctx.cfg)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, live, g.to(out.dtype)))
        return (*(None if t is None else next(grads) for t in leaves), None, None, None)


def fused_groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         film_scale: torch.Tensor | None = None,
                         film_shift: torch.Tensor | None = None,
                         num_groups: int = 32, eps: float = 1e-5,
                         kernels: bool = True) -> torch.Tensor:
    """silu((GN(x)·γ+β)[·(1+film_scale)+film_shift]) for NHWC ``x``, in x.dtype."""
    return _GroupNormSiLU.apply(x, gamma, beta, film_scale, film_shift, int(num_groups),
                                float(eps), bool(kernels))
