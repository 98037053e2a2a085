"""FSDP over the port's flat train state, and the layout of a sharded state.

The port's counterpart of `sgdm_tpu/parallel/fsdp.py`.  The JAX package
shards each parameter leaf (and its Adam moments and EMA) over ``'data'``
by GSPMD's rules (the largest free divisible dim, leaves under
``min_size`` replicated).  The port's state is four flat f32 buffers
(`training.state.TrainState`), so FSDP here is one contiguous shard of each:

  * the flat length is padded with zeros to S per rank (a multiple of
    `ALIGN` elements across ranks, so every shard starts 256-byte aligned
    for K8's vector loads); rank r owns elements [r·S, (r+1)·S) of μ, ν and
    the EMA (they are stored as that shard alone) and updates that part of
    the params;
  * the train step reduce-scatters the gradient, runs the elementwise
    update on the shard (K8 takes any equal-length flat views), and
    all-gathers the params for the next forward.  The padding stays zero:
    its gradient, parameters and moments are 0, so AdamW moves nothing;
  * per-rank optimizer and EMA bytes drop by the data-axis size
    (`state_bytes`); the params stay whole on each rank between steps, as
    the model computes on them.

`StateSharding` is a sharded state's layout (FSDP over data, a tensor-
parallel `TpPlan` over model, or both): `host_state` gathers it into the
one-device layout that `training.checkpoints` writes, `load_host` takes a
rank's part of that layout, so a checkpoint restores at any world size.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .mesh import Mesh, all_gather_into, reduce_scatter
from .tp import TpPlan

__all__ = ["FlatShard", "StateSharding", "shard_train_state", "state_bytes", "ALIGN"]

ALIGN = 64  # elements: a shard of more than one rank starts on a 256-byte boundary


@dataclasses.dataclass(frozen=True)
class FlatShard:
    """Rank ``rank``'s contiguous shard of a flat buffer of ``numel``
    elements, padded to ``world`` shards of ``size``."""

    group: Any
    world: int
    rank: int
    numel: int

    @property
    def size(self) -> int:
        per = -(-self.numel // self.world)
        return per if self.world == 1 else -(-per // ALIGN) * ALIGN

    @property
    def padded(self) -> int:
        return self.size * self.world

    @property
    def start(self) -> int:
        return self.rank * self.size

    @property
    def stop(self) -> int:
        return self.start + self.size

    def pad(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` (numel elements) zero-padded to the padded length."""
        if flat.numel() == self.padded:
            return flat
        out = flat.new_zeros(self.padded)
        out[:flat.numel()] = flat
        return out

    def reduce_scatter_mean(self, grads: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the mean over the group of ``grads``."""
        g = reduce_scatter(self.pad(grads), self.group)
        return g / self.world if self.world > 1 else g

    def gather(self, shard: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """The padded flat buffer from every rank's shard (into ``out``)."""
        if out is None:
            out = shard.new_empty(self.padded)
        return all_gather_into(out, shard, self.group)


@dataclasses.dataclass(frozen=True)
class StateSharding:
    """How a `TrainState` lies across ranks: ``fsdp`` (μ, ν and the EMA
    stored as this rank's shard of the padded flat buffer, the params whole
    and padded) and ``tp`` (every buffer in the model's local layout)."""

    fsdp: FlatShard | None = None
    tp: TpPlan | None = None

    def full(self, flat: torch.Tensor) -> torch.Tensor:
        """A buffer of the local layout whole: a shard gathered (collective)."""
        if self.fsdp is None or flat.numel() == self.fsdp.padded:
            return flat
        return self.fsdp.gather(flat)

    def _global(self, flat: torch.Tensor) -> torch.Tensor:
        if self.fsdp is not None:
            flat = self.full(flat)[:self.fsdp.numel]
        return self.tp.gather_flat(flat) if self.tp is not None else flat

    def _local(self, full: torch.Tensor, shard: bool) -> torch.Tensor:
        if self.tp is not None:
            full = self.tp.scatter_flat(full)
        if self.fsdp is not None:
            full = self.fsdp.pad(full)
            if shard:
                full = full[self.fsdp.start:self.fsdp.stop]
        return full

    def host_state(self, state) -> dict[str, Any]:
        """``state`` in the one-device layout, on the host (every rank takes
        part; each gets the whole)."""
        o = state.opt_state
        host = lambda t: self._global(t.detach()).to("cpu", copy=True)
        layout = self.full_layout(state)
        return {"step": int(state.step), "params": host(state.params),
                "ema_params": host(state.ema_params), "mu": host(o.mu), "nu": host(o.nu),
                "count": int(o.count), "schedule_count": int(o.schedule_count),
                "ema_updates": int(state.ema_updates),
                "layout": [[name, list(shape)] for name, shape in layout]}

    def full_layout(self, state) -> tuple:
        """(name, shape) of every parameter in the one-device layout."""
        return self.tp.full_layout if self.tp is not None else tuple(state.layout)

    def load_host(self, host: dict[str, Any], template) -> None:
        """Fill ``template``'s buffers with this rank's part of a one-device
        host state (layout already checked)."""
        o = template.opt_state
        for dst, key, shard in ((template.params, "params", False),
                                (template.ema_params, "ema_params", True),
                                (o.mu, "mu", True), (o.nu, "nu", True)):
            src = self._local(host[key], shard)
            if src.dtype != dst.dtype or src.shape != dst.shape:
                raise ValueError(f"checkpoint {key}: {src.dtype} {tuple(src.shape)} != "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)


def shard_train_state(state, mesh: Mesh, axis: str = "data"):
    """Shard ``state``'s μ, ν and EMA over ``axis`` in place (params padded,
    kept whole); returns it."""
    prev = state.sharding or StateSharding()
    sh = FlatShard(mesh.group(axis), mesh.size(axis), mesh.index(axis), state.params.numel())
    o = state.opt_state
    state.params = sh.pad(state.params.detach()).clone()
    take = lambda t: sh.pad(t.detach())[sh.start:sh.stop].clone()
    state.ema_params = take(state.ema_params)
    state.opt_state = dataclasses.replace(o, mu=take(o.mu), nu=take(o.nu))
    state.sharding = StateSharding(fsdp=sh, tp=prev.tp)
    return state


def state_bytes(state) -> dict[str, int]:
    """This rank's bytes of each state buffer."""
    o = state.opt_state
    nbytes = lambda t: t.numel() * t.element_size()
    return {"params": nbytes(state.params), "ema_params": nbytes(state.ema_params),
            "mu": nbytes(o.mu), "nu": nbytes(o.nu)}
