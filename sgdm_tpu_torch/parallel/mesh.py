"""Process groups, the device mesh and each rank's slice of the global batch.

The port's counterpart of `sgdm_tpu/parallel/mesh.py`.  The JAX package
runs one program over a ``Mesh(('data',))`` (or ``('data', 'model')``)
and lets XLA insert the collectives; the port runs one process per rank,
each on its own card (``cuda:{local_rank}``) or on the CPU, joined by
`torch.distributed`: NCCL between cards, gloo on the CPU and wherever two
ranks share one card (NCCL refuses two ranks on one device).

  * `init_process_group` joins the world (``env://`` under torchrun, or an
    explicit ``init_method`` such as a ``file://`` store);
  * `create_mesh` lays the ranks out on named axes with
    ``torch.distributed.device_mesh.init_device_mesh`` (row-major: rank =
    data index · model size + model index) and keeps it as the current
    mesh, which the data module reads for its slice of every batch;
  * `local_batch_slice` is this rank's rows of a global batch, with the
    JAX package's assertion; `shard_batch` puts those rows of a host batch
    on the rank's device;
  * `all_reduce`, `reduce_scatter`, `all_gather_into`, `all_gather_cat`,
    `all_reduce_array`, `broadcast`, `broadcast_object` and `barrier` are the
    collectives the port uses.  A group of one rank makes each of them a
    no-op that leaves the tensor's bits alone; under gloo a tensor on a card
    goes through host memory.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import logger

__all__ = [
    "init_process_group", "destroy_process_group", "rank", "world_size", "Mesh",
    "create_mesh", "current_mesh", "data_coords", "local_batch_slice", "shard_batch",
    "all_reduce", "reduce_scatter", "all_gather_into", "all_gather_cat", "all_reduce_array",
    "broadcast", "broadcast_object", "barrier", "backend_for",
]


def backend_for(device: torch.device, local_ranks: int) -> str:
    """The backend of ``local_ranks`` ranks on this host on ``device``'s
    kind: gloo on the CPU; NCCL when each rank has a card of its own; else
    gloo with the ranks sharing the cards (NCCL refuses two ranks on one
    device), and a warning: gloo stages every collective through host
    memory, which makes a step several times slower than one rank a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    cards = torch.cuda.device_count()
    if local_ranks <= cards:
        return "nccl"
    logger.warning(f"{local_ranks} ranks on {cards} card(s): the ranks share cards over gloo, "
                   "which stages every collective through host memory, a step several "
                   f"times slower than one rank a card; at most {cards} ranks run over NCCL")
    return "gloo"


def init_process_group(device: torch.device, *, rank: int | None = None,
                       world_size: int | None = None, init_method: str | None = None,
                       backend: str | None = None) -> None:
    """Join the world on ``device`` (a no-op when already joined).  Rank and
    size default to torchrun's ``RANK`` / ``WORLD_SIZE``, ``init_method`` to
    ``env://``, the backend to `backend_for` over this host's ranks
    (torchrun's ``LOCAL_WORLD_SIZE``, else the world)."""
    if dist.is_initialized():
        return
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dist.init_process_group(backend or backend_for(device, local),
                            init_method=init_method or "env://", rank=rank,
                            world_size=world_size)


def destroy_process_group() -> None:
    global _MESH
    _MESH = None
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks on named axes: this rank's index on each and each axis's group."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    groups: tuple[Any, ...]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] if axis in self.axis_names else 0

    def group(self, axis: str):
        """The process group of ``axis`` (None for an axis the mesh lacks)."""
        return self.groups[self.axis_names.index(axis)] if axis in self.axis_names else None


_MESH: Mesh | None = None


def create_mesh(axis_names: Sequence[str] = ("data",),
                shape: Sequence[int] | None = None) -> Mesh:
    """All ranks of the world on ``axis_names`` (default: all on the first
    axis), made the current mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    global _MESH
    n = world_size()
    axis_names = tuple(axis_names)
    shape = tuple(shape) if shape is not None else (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} does not hold the {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=axis_names)
    _MESH = Mesh(axis_names, shape, tuple(dm.get_local_rank(a) for a in axis_names),
                 tuple(dm.get_group(a) for a in axis_names))
    return _MESH


def current_mesh() -> Mesh | None:
    return _MESH


def data_coords() -> tuple[int, int]:
    """(index, size) of this rank on the data axis: the current mesh's, else
    the world's, else (0, 1)."""
    if _MESH is not None:
        return _MESH.index("data"), _MESH.size("data")
    return rank(), world_size()


def local_batch_slice(global_batch: int, *, process_index: int | None = None,
                      process_count: int | None = None) -> slice:
    """This rank's slice of a global batch (the reference's per-rank
    DataLoader split).  Explicit index / count simulate a split."""
    i, n = data_coords()
    i = i if process_index is None else process_index
    n = n if process_count is None else process_count
    assert global_batch % n == 0, (global_batch, n)
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: Mapping[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    """This rank's rows of a global host batch, as tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        v = torch.as_tensor(np.asarray(v))
        out[k] = v[local_batch_slice(v.shape[0])].to(device)
    return out


# ---------------------------------------------------------------- collectives

def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _staged(t: torch.Tensor, group) -> bool:
    """gloo takes host tensors here: a tensor on a card goes through the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group=None, mean: bool = False) -> torch.Tensor:
    """Sum (or mean) ``t`` over ``group`` in place; returns it."""
    n = _size(group)
    if n == 1:
        return t
    buf = t.cpu() if _staged(t, group) else t
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    if mean:
        t.div_(n)
    return t


def reduce_scatter(full: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` of this rank's equal slice of flat ``full``."""
    n = _size(group)
    if n == 1:
        return full
    staged = _staged(full, group)
    src = full.cpu() if staged else full
    out = torch.empty(full.numel() // n, dtype=full.dtype, device=src.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(full.device) if staged else out


def all_gather_into(out: torch.Tensor, shard: torch.Tensor, group=None) -> torch.Tensor:
    """Fill flat ``out`` with every rank's equal ``shard`` in rank order."""
    n = _size(group)
    if n == 1:
        if out.data_ptr() != shard.data_ptr():
            out.copy_(shard)
        return out
    staged = _staged(out, group)
    dst = torch.empty(out.shape, dtype=out.dtype) if staged else out
    src = shard.cpu() if staged else shard.contiguous().clone()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(dst, src, group=group)
    if staged:
        out.copy_(dst)
    return out


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank order."""
    n = _size(group)
    if n == 1:
        return t
    staged = _staged(t, group)
    src = t.detach().cpu() if staged else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def all_reduce_array(a: np.ndarray, group=None) -> np.ndarray:
    """The sum over ``group`` of a host array (float64 stays float64): on the
    current card under NCCL, in host memory under gloo."""
    if _size(group) == 1:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dist.get_backend(group) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of ``group``, in place; returns it."""
    if _size(group) == 1:
        return t
    buf = t.cpu() if _staged(t, group) else t
    dist.broadcast(buf, src=src, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Global rank ``src``'s ``obj`` on every rank of ``group``."""
    if _size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier() -> None:
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
