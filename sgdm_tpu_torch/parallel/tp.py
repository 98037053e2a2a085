"""Tensor parallelism for the UNet family over the mesh's ``'model'`` axis.

The port's counterpart of `sgdm_tpu/parallel/tp.py`, whose pairing scheme
it keeps (per UNet module name, `models/unet.py`):

  * ResBlock ``in_conv`` column split (output channels), ``out_conv`` row
    split (input channels): the partial products are summed over the group
    and the bias is added once.  ``out_norm`` (32 groups) rides the sharded
    channels; the port asks that the group count divide by the axis size,
    so no GroupNorm statistic crosses ranks;
  * attention ``qkv`` column / ``proj_out`` row; `AttentionLR` ``to_q``
    column / ``to_out`` row (the single-head ``to_kv`` and ``null_kv``
    replicated); ``time_embed_1`` / ``mlp_cond_1`` / ``cond_mlp_1`` column,
    ``_2`` row;
  * FiLM ``emb_proj``, skip projections and the input GroupNorms replicated.

`unet_param_pspecs` is the JAX package's rule table as a pure function of
the port's parameter names and shapes: it gives the sharded dimension of
each parameter in the port's layout (conv ``weight`` OIHW, dense
``weight`` [out, in]), or None, and falls back to replicated wherever the
JAX package does.  Where GSPMD would partition any layout, the port's
ranks compute on their own shard, so `shard_model` also asks the pairs to
agree (a column split with its row split), the heads to divide, and the
GroupNorm groups to divide; it raises otherwise.  Two leaves the JAX table
shards but whose module sits outside a pair: the stem ``in_conv`` (its
output channels are gathered after the conv) and the final ``out_conv``
(each rank convolves its channels of the input, then the sum); and
`AttentionLR`'s ``out_norm`` scale, gathered where it is used.

The attention ``qkv`` shard of a rank holds the q, k and v columns of its
heads (the projection's columns are ordered [3, heads, d]), so attention
runs on local heads.  The collectives are Megatron's pair: `enter`
(identity forward, sum of the gradients backward) where a replicated
activation enters a sharded region, `reduce` (sum forward, identity
backward) where a row split leaves it; sums run in float32.

Only the plain route runs under tensor parallelism (the fused ResBlock
kernels take whole weights): `models.layers.ResBlock` takes its unfused
composition when it holds a shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from .mesh import Mesh, all_gather_cat, all_reduce

__all__ = ["TPGroup", "TpPlan", "unet_param_pspecs", "shard_model", "enter", "reduce",
           "gather", "local", "split", "join"]

_COL_DENSE = ("time_embed_1", "mlp_cond_1", "cond_mlp_1")  # weight [F, D]: shard F
_ROW_DENSE = ("time_embed_2", "mlp_cond_2", "cond_mlp_2")  # weight [D, F]: shard F


def _spec(names: Sequence[str], shape: Sequence[int], n: int) -> int | None:
    """The sharded dim of one parameter (port layout), keyed on its module name."""
    leaf = names[-1] if names else ""
    mod = names[-2] if len(names) >= 2 else ""

    def ok(dim: int) -> bool:
        return shape[dim] % n == 0

    if mod == "in_conv":
        if leaf == "weight" and len(shape) == 4 and ok(0):
            return 0
        if leaf == "bias" and len(shape) == 1 and ok(0):
            return 0
    elif mod == "out_conv":
        if leaf == "weight" and len(shape) == 4 and ok(1):
            return 1
    elif mod == "out_norm":
        if len(shape) == 1 and ok(0):
            return 0
    elif mod in ("qkv", "to_q") or mod in _COL_DENSE:
        if leaf == "weight" and len(shape) == 2 and ok(0):
            return 0
        if leaf == "bias" and len(shape) == 1 and ok(0):
            return 0
    elif mod in ("proj_out", "to_out") or mod in _ROW_DENSE:
        if leaf == "weight" and len(shape) == 2 and ok(1):
            return 1
    return None


def unet_param_pspecs(shapes: Mapping[str, Sequence[int]], *, axis_size: int
                      ) -> dict[str, int | None]:
    """{parameter name: sharded dim or None} for tensor parallelism over
    ``axis_size`` ranks (names as `named_parameters` gives them)."""
    return {name: _spec(name.split("."), tuple(shape), axis_size)
            for name, shape in shapes.items()}


# ---------------------------------------------------------------- collectives

@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The ranks that share one model: the mesh's ``'model'`` group."""

    group: Any
    size: int
    rank: int


def _sum(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    y = x.detach().float().contiguous().clone()
    all_reduce(y, tp.group)
    return y.to(x.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.tp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _sum(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.c = tp, x.shape[-1]
        return all_gather_cat(x.contiguous(), tp.group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        # the consumer is replicated: every rank holds the same gradient
        return g.narrow(-1, ctx.tp.rank * ctx.c, ctx.c).contiguous(), None


def enter(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """A replicated activation entering a sharded region."""
    return x if tp is None or tp.size == 1 else _Enter.apply(x, tp)


def reduce(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """The sum over the group of a row split's partial products."""
    return x if tp is None or tp.size == 1 else _Reduce.apply(x, tp)


def gather(x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """Every rank's last-axis shard of ``x`` concatenated in rank order."""
    return x if tp is None or tp.size == 1 else _Gather.apply(x, tp)


def local(x: torch.Tensor, tp: TPGroup | None, dim: int = -1) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim``."""
    if tp is None or tp.size == 1:
        return x
    c = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * c, c)


# ---------------------------------------------------------------- layouts

def split(t: torch.Tensor, dim: int, groups: int, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s shard of ``t`` along ``dim``: the dim read as [groups, n,
    rest] and part ``r`` of the middle taken (groups 1: a contiguous block)."""
    shape = t.shape
    v = t.reshape(*shape[:dim], groups, n, shape[dim] // (groups * n), *shape[dim + 1:])
    return v.select(dim + 1, r).reshape(*shape[:dim], -1, *shape[dim + 1:])


def join(parts: Sequence[torch.Tensor], dim: int, groups: int) -> torch.Tensor:
    """The inverse of `split` over every rank's shard, in rank order."""
    shape = parts[0].shape
    v = torch.stack([p.reshape(*shape[:dim], groups, shape[dim] // groups, *shape[dim + 1:])
                     for p in parts], dim=dim + 1)
    return v.reshape(*shape[:dim], -1, *shape[dim + 1:])


@dataclasses.dataclass(frozen=True)
class TpPlan:
    """How `shard_model` split a model: each sharded parameter's (dim,
    groups), and every parameter's full shape in `named_parameters` order."""

    tp: TPGroup
    splits: Mapping[str, tuple[int, int]]
    full_layout: tuple[tuple[str, tuple[int, ...]], ...]

    def local_shape(self, name: str, shape: Sequence[int]) -> tuple[int, ...]:
        if name not in self.splits:
            return tuple(shape)
        dim, _ = self.splits[name]
        return tuple(s // self.tp.size if d == dim else s for d, s in enumerate(shape))

    def gather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The full-layout flat buffer from every rank's local flat buffer."""
        parts = all_gather_cat(flat.detach()[None], self.tp.group, dim=0)
        out, off = [], 0
        for name, shape in self.full_layout:
            ls = self.local_shape(name, shape)
            k = math.prod(ls)
            if name in self.splits:
                dim, groups = self.splits[name]
                out.append(join([p[off:off + k].view(ls) for p in parts], dim, groups).reshape(-1))
            else:
                out.append(parts[0, off:off + k])
            off += k
        return torch.cat(out)

    def scatter_flat(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's local flat buffer from a full-layout flat buffer."""
        out, off = [], 0
        for name, shape in self.full_layout:
            k = math.prod(shape)
            leaf = full[off:off + k].view(shape)
            if name in self.splits:
                dim, groups = self.splits[name]
                leaf = split(leaf, dim, groups, self.tp.size, self.tp.rank)
            out.append(leaf.reshape(-1))
            off += k
        return torch.cat(out)


def _pair(a: str, b: str, sharded: set, where: str) -> None:
    if (a in sharded) != (b in sharded):
        raise ValueError(f"{where}: tensor parallelism splits {a if a in sharded else b} but "
                         f"not {b if a in sharded else a}; the port needs both or neither")


def shard_model(model: torch.nn.Module, mesh: Mesh, axis: str = "model") -> TpPlan:
    """Replace every parameter the rule table shards by this rank's shard,
    and mark the modules that hold one (``tp``, ``tp_role``)."""
    from ..models.attention_lr import AttentionLR
    from ..models.layers import ResBlock, SelfAttentionBlock
    from ..models.unet import UNetBackbone

    tp = TPGroup(mesh.group(axis), mesh.size(axis), mesh.index(axis))
    named = dict(model.named_parameters())
    full_layout = tuple((name, tuple(p.shape)) for name, p in named.items())
    dims = unet_param_pspecs({k: v for k, v in full_layout}, axis_size=tp.size)
    sharded = {k for k, d in dims.items() if d is not None}
    splits: dict[str, tuple[int, int]] = {}
    if tp.size == 1:
        return TpPlan(tp, splits, full_layout)

    def has(prefix: str, child: str) -> bool:
        return f"{prefix}{child}.weight" in sharded or f"{prefix}{child}.gamma" in sharded

    roles: dict[str, str] = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, ResBlock):
            for a, b in (("in_conv", "out_conv"), ("in_conv", "out_norm")):
                _pair(f"{pre}{a}.weight", f"{pre}{b}.weight", sharded, mname)
            if has(pre, "in_conv"):
                if m.out_norm.groups % tp.size:
                    raise ValueError(f"{mname}: out_norm's {m.out_norm.groups} groups do not "
                                     f"split over {tp.size} ranks")
                roles.update({f"{pre}in_conv": "col", f"{pre}out_conv": "row",
                              f"{pre}out_norm": "local", mname: "block"})
        elif isinstance(m, (SelfAttentionBlock, AttentionLR)):
            col, row = ("qkv", "proj_out") if isinstance(m, SelfAttentionBlock) else ("to_q", "to_out")
            _pair(f"{pre}{col}.weight", f"{pre}{row}.weight", sharded, mname)
            if has(pre, col):
                if m.heads % tp.size:
                    raise ValueError(f"{mname}: {m.heads} heads do not split over {tp.size} ranks")
                roles.update({f"{pre}{col}": "col", f"{pre}{row}": "row", mname: "heads"})
            if isinstance(m, AttentionLR) and f"{pre}out_norm.gamma" in sharded:
                roles[f"{pre}out_norm"] = "gather"
        elif isinstance(m, UNetBackbone):
            if has(pre, "in_conv"):
                roles[f"{pre}in_conv"] = "col_gather"
            if has(pre, "out_conv"):
                roles[f"{pre}out_conv"] = "row_slice"
    for col, row in zip(_COL_DENSE, _ROW_DENSE):
        if f"{col}.weight" in named:
            _pair(f"{col}.weight", f"{row}.weight", sharded, type(model).__name__)
            if col + ".weight" in sharded:
                roles.update({col: "col", row: "row"})

    modules = dict(model.named_modules())
    for mname, role in roles.items():
        m = modules[mname]
        m.tp, m.tp_role = tp, role
        if role == "heads":
            m.heads //= tp.size
        elif role == "local":
            m.groups //= tp.size
        for pname, p in m.named_parameters(recurse=False):
            full = f"{mname}.{pname}"
            if dims.get(full) is None:
                continue
            groups = 3 if mname.endswith("qkv") else 1
            splits[full] = (dims[full], groups)
            p.data = split(p.data, dims[full], groups, tp.size, tp.rank).contiguous()
        assert role in ("block", "heads") or any(f"{mname}.{k}" in splits
                                                  for k, _ in m.named_parameters(recurse=False))
    left = sharded - set(splits)
    if left:
        raise ValueError(f"tensor parallelism has no rule to run {sorted(left)[:4]} sharded")
    return TpPlan(tp, splits, full_layout)
