"""Attention: CUDA kernels (K3, K7, K9) and their plain versions.

K3 replaces the Pallas TPU kernel `sgdm_tpu/ops/pallas/attention.py`
`fused_self_attention` (`_self_attn_kernel`), the sampling forward:

    out = softmax((q·s)(k·s)ᵀ) v,   s = d^-1/4 on BOTH q and k,

with f32 logits and softmax, the weights cast to v's dtype before the PV
product, accumulated in f32.  On a CUDA tensor `fused_self_attention`
calls `self_attention_cuda`, which launches ``csrc/attention.cu``
`attn_pp_kernel` (head dim 64, N ≤ 256: the model shapes) or `attn_kernel`
(the rest), one launch per call, or raises; on a CPU tensor it runs
`self_attention_plain`.  The kernel's launches are counted in
``self_attention_cuda.launches``.

K9 replaces the library TPU flash attention the training step calls
(`sgdm_tpu/models/layers.py:400-432`, softmax(q kᵀ/√d) v with its
backward): `flash_attention_fwd_cuda` is K3's kernel also writing the f32
row log-sum-exp (natural log of the scaled logits), `flash_attention_bwd_cuda`
the two launches of the backward kernel of ``csrc/attention.cu`` (dq and
Dr = rowsum(dO∘o), then dk/dv, from q, k, v, o, dO and the lse): one block
design on the forward's core, `wgmma` for all five products with P and dS in
registers, every operand by strides.  `flash_attention` is the autograd
entry (CUDA tensors: K9, or raise; CPU tensors or ``kernels=False``:
`flash_attention_plain` and `flash_attention_bwd_plain`); q, k, v, o and
dO in a layout the kernels do not take are copied first.
`_packed_flash_attention` takes the packed [B, N, 3, H, D] projection
itself (what `SelfAttentionBlock` has) and writes its gradient straight into
that layout.  1/√d on q·k is the d^-1/4 on q and on k of the einsum path.
Launches are counted on the two K9 wrappers.

K9 on f32 operands (the noisy-image classifier's encoder, `models/
encoder_unet.py`, trains in f32): `flash_attention_fwd_f32_cuda` and
`flash_attention_bwd_f32_cuda` launch the kernels of ``csrc/attention_f32.cuh``
(the design note is there), counted on their own wrappers; `flash_attention`
and `_packed_flash_attention` pick them by dtype, and `self_attention_cuda`
(K3) takes the same forward on f32.  Every product is f32 FFMA on the CUDA
cores, no operand or weight rounded, so the plain versions on f32 tensors
(no casts then) are their arithmetic up to the order of the sums.  Two
routes by head dim, fixed per shape: at 64 `f32_fwd_kernel` (256 query rows
a block, 8 x 8 register tiles fed by cp.async rings) and `f32_bwd_kernel`
(one launch, one block a head, the five products, dq summed over key tiles
in place: deterministic); at 128 the simple blocks of the first f32 port,
`f32_fwd_tile_kernel` and the two launches of `f32_bwd_tile_kernel`.

K7 replaces the Pallas TPU kernel `fused_null_kv_attention`
(`_null_kv_kernel`), the sampling attention of `models/attention_lr.py`
`AttentionLR`: multi-query attention of q [B, N, H, D] (pre-scaled by the
caller; the kernel applies no scale) against ONE single-head k/v [B, M, D]
per item, M = context + null + self keys.  `null_kv_attention_cuda`
launches ``csrc/null_kv_attention.cu`` `null_kv_kernel` (counted in its
``launches``) or raises; `fused_null_kv_attention` is the autograd entry
(CUDA tensors: K7, or raise; CPU tensors or ``kernels=False``:
`null_kv_attention_plain`); its backward recomputes through the plain
version, as the TPU kernel's custom VJP recomputes with einsums.

The two forward kernels are one design, ``csrc/attention_core.cuh``.  On an
H100 both are bound by bytes on paper (K3 at [1024 heads, 256, 64]: 134 MB,
40 µs, against 17 µs of tensor-core time; K7 at [128, 2048 rows, 64] × 273
keys: 76 MB, 23 µs, against 19 µs), with the one exponential per logit
costing about as much again, so loads, tensor cores and softmax have to
overlap.  What the design does about it: a block is one warpgroup that walks
over a contiguous run of 64-row query tiles (two blocks per SM, a grid of two
per SM); both products are `wgmma` with f32 accumulators in registers, the
weights going from the accumulator fragment straight into the second product;
the softmax runs in registers (row maximum and sum by quad shuffles, one
`ex2` per logit with scale·log₂e folded into a multiply-add); K, V and Q come
by `cp.async` into 128-byte-swizzled shared-memory tiles, a head's (an item's)
K/V once per run of tiles and the next one's while the present tile is
computed.  Keys come in chunks of 256 (128 at head dim 128), the last as wide
as it needs (32, 64, 128 or 256).  With one chunk the weights are normalised
in f32 and then rounded to bf16, as in the TPU kernels and the plain versions;
with more (K7's M = 273, N > 256) the running maximum and sum are carried, the
unnormalised weights are rounded and the division comes last: bf16 ulps of the
weights, inside the 2⁻⁶ tolerance the kernels are held to.  Budget at the main
shapes: 203 registers a thread, 81 KB (K3/K9) and 89 KB (K7) of shared memory
a block, two blocks an SM.  Shapes taken: any N or M ≥ 1; K3/K9 head dim 32,
64 or 128 (K9: 64 or 128) with q, k, v strided (unit stride along D, the other
strides multiples of 8 elements) and the output written as [B, N, H, D]; K7
any D ≤ 128, contiguous, element-wise loads when D % 8 ≠ 0.

At head dim 64 and N ≤ 256 (every self-attention of the IN64 model), K3 and
K9's forward run a warp-specialised block instead (``attention_core.cuh``
`pingpong_block`): a producer warp loads every operand by TMA into mbarrier
rings, two consumer warpgroups alternate their `wgmma` products so one's
softmax runs under the other's, registers move to the consumers by
`setmaxnreg`, and the output is stored by TMA; same arithmetic and rounding.
"""

from __future__ import annotations

import ctypes

import torch

from .build import library

__all__ = ["fused_self_attention", "self_attention_plain", "self_attention_cuda",
           "flash_attention", "flash_attention_plain", "flash_attention_bwd_plain",
           "flash_attention_fwd_cuda", "flash_attention_bwd_cuda",
           "flash_attention_fwd_f32_cuda", "flash_attention_bwd_f32_cuda",
           "fused_null_kv_attention", "null_kv_attention_plain", "null_kv_attention_cuda",
           "forward_blocks_per_sm", "backward_blocks_per_sm", "f32_blocks_per_sm"]


def self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, N, D] → [B, H, N, D], the kernel's arithmetic."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    logits = torch.matmul(q.float() * scale, (k.float() * scale).transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def _lib():
    lib = library("attention")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgdm_self_attention.argtypes = [vp, vp, vp, vp, i, i, i, i,
                                            ctypes.POINTER(ctypes.c_longlong), f, vp, vp]
        lib.sgdm_self_attention.restype = i
        lib.sgdm_attention_bwd.argtypes = [vp] * 10 + [i, i, i, i,
                                                       ctypes.POINTER(ctypes.c_longlong), f, vp]
        lib.sgdm_attention_bwd.restype = i
        lib.sgdm_self_attention_f32.argtypes = lib.sgdm_self_attention.argtypes
        lib.sgdm_self_attention_f32.restype = i
        lib.sgdm_attention_bwd_f32.argtypes = lib.sgdm_attention_bwd.argtypes
        lib.sgdm_attention_bwd_f32.restype = i
        lib.sgdm_attention_bwd_occupancy.argtypes = [i, i]
        lib.sgdm_attention_bwd_occupancy.restype = i
        lib.sgdm_self_attention_occupancy.argtypes = [i, i]
        lib.sgdm_self_attention_occupancy.restype = i
        lib.sgdm_attention_f32_occupancy.argtypes = [i, i]
        lib.sgdm_attention_f32_occupancy.restype = i
        lib._sgdm_typed = True
    return lib


def _scale(d: int) -> float:
    """(d^-1/4)², the scale both kernels apply to q·k (1/√d up to rounding)."""
    return (1.0 / (d ** 0.25)) ** 2


def _check_qkv(q, k, v, contiguous: bool = True, dtype=torch.bfloat16):
    """Raise on what the forward kernel does not take: ``dtype`` [B, H, N, D]
    on one card, head dim 32, 64 or 128 (f32: 64 or 128); contiguous, or
    (``contiguous=False``) any batch, head and row strides that keep unit
    stride along D and every row 16-byte aligned."""
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, N, D], got {tuple(q.shape)}")
    if not q.is_cuda:
        raise ValueError("CUDA kernel wrapper called with a CPU tensor")
    if q.shape[-1] not in ((32, 64, 128) if dtype == torch.bfloat16 else (64, 128)):
        raise ValueError(f"head dim {q.shape[-1]} not supported by the {dtype} kernel")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: this attention kernel takes {dtype}, got {t.dtype}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name}: shape/device {tuple(t.shape)}/{t.device} != q's")
        if contiguous:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous [B, H, N, D]")
        else:
            _check_strides(name, t)


def _strides_taken(t: torch.Tensor) -> bool:
    """Whether the kernels can read or write ``t`` [B, H, N, D] by its
    strides: unit stride along D, the others multiples of 8 elements, a
    16-byte aligned base."""
    sb, sh, sn, sd = t.stride()
    return sd == 1 and sb % 8 == 0 and sh % 8 == 0 and sn % 8 == 0 and t.data_ptr() % 16 == 0


def _check_strides(name: str, t: torch.Tensor) -> None:
    if not _strides_taken(t):
        raise ValueError(f"{name}: strides {t.stride()} (unit along D, the others multiples "
                         f"of 8 elements, 16-byte aligned base) not taken by the kernel")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels take its strides (the views the model
    hands them), else a contiguous copy: a layout copy, for an expanded dO
    (``out.sum().backward()``), a transposed q or a misaligned view."""
    if t.ndim != 4 or _strides_taken(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _forward(q, k, v, out, lse):
    """One launch of the forward kernel of q's dtype (bf16: ``attn_kernel`` or
    ``attn_pp_kernel``; f32: ``f32_fwd_kernel``); `out` [B, H, N, D] by
    strides, like q, k, v."""
    b, h, n, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    lib = _lib()
    fn = lib.sgdm_self_attention_f32 if q.dtype == torch.float32 else lib.sgdm_self_attention
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, h, n, d, strides, _scale(d), _ptr(lse),
             stream)
    if err != 0:
        raise RuntimeError(f"self_attention: CUDA error {err}")
    return out


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _bnhd_like(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised [B, H, N, D] tensor laid out as [B, N, H, D], so the
    caller's ``permute(0, 2, 1, 3).reshape(B, N, H·D)`` is free."""
    b, h, n, d = q.shape
    return torch.empty((b, n, h, d), device=q.device, dtype=q.dtype).permute(0, 2, 1, 3)


def self_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3 on the CUDA kernel: bf16 [B, H, N, D] on one card, any N, D 32, 64
    or 128 (f32: K9's f32 forward, D 64 or 128).  q, k, v may be strided
    views (the permuted thirds of a [B, N, 3, H, D] projection: unit stride
    along D, batch, head and row strides multiples of 8 elements); they are
    read in place.  The result is the [B, H, N, D] view of an output
    allocated as [B, N, H, D], so the caller's ``permute(0, 2, 1,
    3).reshape(B, N, H·D)`` is free."""
    _check_qkv(q, k, v, contiguous=False,
               dtype=torch.float32 if q.dtype == torch.float32 else torch.bfloat16)
    out = _forward(q, k, v, _bnhd_like(q), None)
    self_attention_cuda.launches += 1
    return out


self_attention_cuda.launches = 0


def forward_blocks_per_sm(keys: int, d: int, null_kv: bool = False) -> int:
    """Blocks of the forward kernel (``null_kv``: of K7's) an SM of the current
    card holds at ``keys`` keys and head dim ``d``, as the CUDA runtime's
    occupancy calculator counts them from registers and shared memory."""
    if null_kv:
        return _nkv_lib().sgdm_null_kv_occupancy(keys, d)
    return _lib().sgdm_self_attention_occupancy(keys, d)


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, N, D] → out [B, H, N, D] (scale d^-1/4 on q and k)."""
    if q.is_cuda:
        return self_attention_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {q.device}")
    return self_attention_plain(q, k, v)


# ------------------------------------------------------------------ K9

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out, lse): K9's forward arithmetic; lse f32 [B, H, N] is the row
    log-sum-exp of the scaled logits."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.sum(-1, keepdim=True)
    weights = (e / s).to(v.dtype)
    out = torch.matmul(weights.float(), v.float()).to(q.dtype)
    return out, (m + torch.log(s))[..., 0]


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """(dq, dk, dv): K9's backward arithmetic.  P = exp(s·q·kᵀ − lse),
    Dr = rowsum(dO∘o), dS = P∘(dO vᵀ − Dr); P and dS are rounded to v's
    dtype before their products, as in the kernel."""
    scale = _scale(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dr = (dof * o.float()).sum(-1, keepdim=True)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - dr)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_flash(q, k, v, dtype=torch.bfloat16):
    _check_qkv(q, k, v, contiguous=False, dtype=dtype)
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head dim {q.shape[-1]} not supported by K9 (64 or 128)")


def _flash_fwd(q, k, v, dtype):
    _check_flash(q, k, v, dtype)
    b, h, n, _ = q.shape
    lse = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    return _forward(q, k, v, _bnhd_like(q), lse), lse


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K9 forward on the CUDA kernel: (out bf16, lse f32 [B, H, N]).  q, k, v
    may be strided views as for `self_attention_cuda`; out is the [B, H, N, D]
    view of a [B, N, H, D] tensor."""
    out = _flash_fwd(q, k, v, torch.bfloat16)
    flash_attention_fwd_cuda.launches += 1
    return out


flash_attention_fwd_cuda.launches = 0


def flash_attention_fwd_f32_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """`flash_attention_fwd_cuda` on f32 q, k, v: (out f32, lse f32), one
    launch of ``f32_fwd_kernel`` (head dim 64) or of ``f32_fwd_tile_kernel``
    (the D = 128 route)."""
    out = _flash_fwd(q, k, v, torch.float32)
    flash_attention_fwd_f32_cuda.launches += 1
    return out


flash_attention_fwd_f32_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, lse, do, grads=None):
    """K9 backward on the CUDA kernels: (dq, dk, dv), bf16 [B, H, N, D].
    q, k, v, o and do may be strided views (unit stride along D, the other
    strides multiples of 8 elements); they are read in place, and copied
    first when laid out otherwise.  ``grads``: three [B, H, N, D] tensors
    (views of one gradient buffer, say) the kernels write dq, dk and dv
    into, by their strides; else they are allocated as [B, N, H, D]."""
    grads = _flash_bwd(q, k, v, o, lse, do, grads, torch.bfloat16)
    flash_attention_bwd_cuda.launches += 1
    return grads


flash_attention_bwd_cuda.launches = 0


def flash_attention_bwd_f32_cuda(q, k, v, o, lse, do, grads=None):
    """`flash_attention_bwd_cuda` on f32 operands and gradients: one launch
    of ``f32_bwd_kernel`` (head dim 64; it writes dq, dk, dv and the Dr
    scratch, the same bits every run), or the two of ``f32_bwd_tile_kernel``
    (the D = 128 route)."""
    grads = _flash_bwd(q, k, v, o, lse, do, grads, torch.float32)
    flash_attention_bwd_f32_cuda.launches += 1
    return grads


flash_attention_bwd_f32_cuda.launches = 0


def _flash_bwd(q, k, v, o, lse, do, grads, dtype):
    q, k, v, o, do = (_kernel_layout(t) for t in (q, k, v, o, do))
    _check_flash(q, k, v, dtype)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} does not match q")
        _check_strides(name, t)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be f32 {tuple(q.shape[:3])} on q's device")
    if grads is None:
        grads = tuple(_bnhd_like(q) for _ in range(3))
    for name, t in zip(("dq", "dk", "dv"), grads):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} does not match q")
        _check_strides(name, t)
    b, h, n, d = q.shape
    lse = lse.contiguous()
    dr = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    ops = (q, k, v, o, do) + tuple(grads)
    strides = (ctypes.c_longlong * 24)(*(s for t in ops for s in t.stride()[:3]))
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    lib = _lib()
    fn = lib.sgdm_attention_bwd_f32 if dtype == torch.float32 else lib.sgdm_attention_bwd
    err = fn(*(_ptr(t) for t in ops[:5]), _ptr(lse), _ptr(dr), *(_ptr(t) for t in grads),
             b, h, n, d, strides, _scale(d), stream)
    if err != 0:
        raise RuntimeError(f"attention backward: CUDA error {err}")
    return tuple(grads)


def backward_blocks_per_sm(d: int) -> dict:
    """Blocks of each K9 backward kernel an SM of the current card holds at
    head dim ``d``, as the CUDA runtime's occupancy calculator counts them."""
    lib = _lib()
    return {"dq": lib.sgdm_attention_bwd_occupancy(d, 0),
            "dkdv": lib.sgdm_attention_bwd_occupancy(d, 1)}


def f32_blocks_per_sm(d: int) -> dict:
    """Blocks of the f32 kernels of head dim ``d`` an SM of the current card
    holds (``bwd``: the fewer of the D = 128 route's two), as the CUDA
    runtime's occupancy calculator counts them."""
    lib = _lib()
    return {"fwd": lib.sgdm_attention_f32_occupancy(d, 0),
            "bwd": lib.sgdm_attention_f32_occupancy(d, 1)}


def _flash_forward(q, k, v, kernels):
    if kernels and q.is_cuda:
        if q.dtype == torch.float32:
            return flash_attention_fwd_f32_cuda(q, k, v)
        return flash_attention_fwd_cuda(q, k, v)
    if not kernels or q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    raise ValueError(f"no attention kernel for device {q.device}")


def _flash_backward_cuda(q):
    return flash_attention_bwd_f32_cuda if q.dtype == torch.float32 else flash_attention_bwd_cuda


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kernels):
        if kernels and q.is_cuda:
            q, k, v = (_kernel_layout(t) for t in (q, k, v))
        out, lse = _flash_forward(q, k, v, kernels)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.use_kernel = kernels and q.is_cuda
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = _flash_backward_cuda(q) if ctx.use_kernel else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, do.to(q.dtype))
        return dq, dk, dv, None


class _PackedFlashAttention(torch.autograd.Function):
    """The same on q, k, v given as ONE packed [B, N, 3, H, D] tensor (a
    qkv projection): the backward writes dq, dk and dv straight into the
    [B, N, 3, H, D] gradient of that tensor, so neither the split nor the
    reshape back to the projection's layout copies anything."""

    @staticmethod
    def forward(ctx, qkv, kernels):
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out, lse = _flash_forward(q, k, v, kernels)
        ctx.save_for_backward(qkv, out, lse)
        ctx.use_kernel = kernels and qkv.is_cuda
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        if ctx.use_kernel:
            dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
            _flash_backward_cuda(q)(q, k, v, out, lse, do.to(q.dtype),
                                    grads=tuple(dqkv.permute(2, 0, 3, 1, 4)))
        else:
            grads = flash_attention_bwd_plain(q, k, v, out, lse, do.to(q.dtype))
            dqkv = torch.stack(grads).permute(1, 3, 0, 2, 4)
        return dqkv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kernels: bool = True) -> torch.Tensor:
    """Training attention with its backward: q, k, v [B, H, N, D] → [B, H, N, D].
    Strided views are read in place, other layouts copied."""
    return _FlashAttention.apply(q, k, v, bool(kernels))


def _packed_flash_attention(qkv: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """`flash_attention` of the three thirds of one [B, N, 3, H, D] qkv
    projection (`SelfAttentionBlock`'s training route): → [B, H, N, D], and
    the backward writes the projection's gradient in that layout."""
    return _PackedFlashAttention.apply(qkv, bool(kernels))


# ------------------------------------------------------------------ K7

def null_kv_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, N, H, D] (pre-scaled), k, v [B, M, D] → [B, N, H, D]: the
    kernel's arithmetic (f32 logits and softmax, weights in v's dtype, f32
    accumulation, one cast)."""
    sim = torch.einsum("bnhd,bjd->bhnj", q.float(), k.float())
    weights = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.einsum("bhnj,bjd->bnhd", weights.float(), v.float()).to(q.dtype)


def _nkv_lib():
    lib = library("null_kv_attention")
    if not getattr(lib, "_sgdm_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sgdm_null_kv_attention.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        lib.sgdm_null_kv_attention.restype = i
        lib.sgdm_null_kv_occupancy.argtypes = [i, i]
        lib.sgdm_null_kv_occupancy.restype = i
        lib._sgdm_typed = True
    return lib


def null_kv_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K7 on the CUDA kernel: bf16, contiguous q [B, N, H, D] and k, v
    [B, M, D] on one card; any D ≤ 128 and any M ≥ 1.  One kernel design for
    every shape, in two builds the launch picks by shape: D % 8 == 0 loads
    and stores 16 bytes a thread (`null_kv_kernel<DP, true>`), any other D
    element by element (`<DP, false>`); M ≤ 512 (256 at D > 64) keeps the
    item's K/V in shared memory, a longer M streams them in chunks."""
    if not q.is_cuda:
        raise ValueError("CUDA kernel wrapper called with a CPU tensor")
    if q.ndim != 4 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"q [B, N, H, D] and k, v [B, M, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the attention kernel takes bf16, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if not 1 <= d <= 128 or m < 1:
        raise ValueError(f"head dim {d} (1..128) or {m} keys (≥ 1) beyond the kernel")
    if d % 8 == 0:  # the kernel's 16-byte row loads
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    err = _nkv_lib().sgdm_null_kv_attention(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, n * h, m, d,
                                            stream)
    if err != 0:
        raise RuntimeError(f"null_kv_attention: CUDA error {err}")
    null_kv_attention_cuda.launches += 1
    return out


null_kv_attention_cuda.launches = 0


class _NullKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kernels):
        if kernels and q.is_cuda:
            out = null_kv_attention_cuda(q, k, v)
        elif not kernels or q.device.type == "cpu":
            out = null_kv_attention_plain(q, k, v)
        else:
            raise ValueError(f"no attention kernel for device {q.device}")
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = null_kv_attention_plain(*leaves)
            dq, dk, dv = torch.autograd.grad(out, leaves, g.to(out.dtype))
        return dq, dk, dv, None


def fused_null_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kernels: bool = True) -> torch.Tensor:
    """Multi-query attention: q [B, N, H, D] (pre-scaled), single-head k, v
    [B, M, D] → [B, N, H, D]."""
    return _NullKVAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(kernels))
