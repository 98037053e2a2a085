"""Rank programs of the port's parallel tests (tests/test_torch_parallel.py,
test_torch_fsdp.py, test_torch_tp.py).

They run in gloo children started by `sgdm_tpu_torch.parallel.launch.spawn`,
so this module imports neither JAX nor the JAX package: each child joins
the world through a ``file://`` store, on one CPU thread, runs the cases
it is given and returns plain numpy results.  `train_case` is one run of
the port's train step on a mesh, which the parent also calls in its own
process for the one-rank reference (``mesh_shape=None``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_FAMILIES = ("unet", "unetca")


def build_model(family: str, cfg: Mapping[str, Any], state_dict=None) -> torch.nn.Module:
    from sgdm_tpu_torch.models.factory import create_denoiser, init_random_params
    from sgdm_tpu_torch.models.unet import UNetCAModel

    assert family in _FAMILIES
    model = create_denoiser(**cfg) if family == "unet" else UNetCAModel(**cfg)
    if state_dict is None:
        init_random_params(model, 1)
    else:
        model.load_state_dict(state_dict)
    return model


def local_draws(draws, rank: int, world: int, accum: int):
    """A rank's draws per micro-batch from the global batch's (t, noise,
    drop_mask over the global rows, micro-batch after micro-batch)."""
    if draws is None:
        return None
    b = len(draws["t"]) // world
    m = b // accum
    rows = lambda i: slice(rank * b + i * m, rank * b + (i + 1) * m)
    return [{k: v[rows(i)] for k, v in draws.items()} for i in range(accum)]


def train_case(rank: int = 0, *, family: str, cfg, state_dict, batch, mesh_shape=None,
               fsdp: bool = False, steps: int = 2, draws=None, seed: int = 0,
               cond_drop: float = 0.0, ema_decay: float = 0.9999, sched=None, opt=None,
               accum: int = 1, num_timesteps: int = 1000, flash: bool = True, ckpt_out: str | None = None,
               ckpt_in: str | None = None, return_grads: bool = False) -> dict[str, Any]:
    """``steps`` train steps of the port on ``mesh_shape`` (data, model) —
    None: one process — from ``state_dict``; ``batch`` the global batch.
    Returns the metrics of each step, this rank's state bytes and the state
    in the one-device layout (``state``; every rank gathers it)."""
    from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
    from sgdm_tpu_torch.models.layers import set_routes
    from sgdm_tpu_torch.parallel import mesh as pm
    from sgdm_tpu_torch.parallel.fsdp import StateSharding, shard_train_state, state_bytes
    from sgdm_tpu_torch.parallel.tp import shard_model
    from sgdm_tpu_torch.training.checkpoints import CheckpointManager, read_state, state_to_host
    from sgdm_tpu_torch.training.optim import create_optimizer
    from sgdm_tpu_torch.training.state import create_train_state, make_train_step

    mesh = pm.create_mesh(("data", "model"), mesh_shape) if mesh_shape else None
    model = build_model(family, cfg, state_dict)
    set_routes(model, flash=flash)
    plan = shard_model(model, mesh) if mesh is not None and mesh.size("model") > 1 else None
    tx = create_optimizer("adamw", scheduler=sched, **(opt or {}))
    state = create_train_state(model, tx, device="cpu")
    if plan is not None:
        state.sharding = StateSharding(tp=plan)
    if fsdp:
        shard_train_state(state, mesh)
    out: dict[str, Any] = {}
    if ckpt_in:  # restore a one-device checkpoint into this layout
        state = CheckpointManager(ckpt_in, writer=False).restore(state, Path(ckpt_in) / "last")
        want = read_state(Path(ckpt_in) / "last")
        got = state_to_host(state)
        out["restored_equal"] = all(torch.equal(got[k], want[k])
                                    for k in ("params", "ema_params", "mu", "nu"))
    step = make_train_step(model, GaussianDiffusion(num_timesteps=num_timesteps), tx,
                           cond_drop_prob=cond_drop, ema_decay=ema_decay,
                           accumulate_grad_batches=accum, device="cpu", mesh=mesh)
    data_i, data_n = (mesh.index("data"), mesh.size("data")) if mesh else (0, 1)
    b = len(batch["image"]) // data_n
    local = {k: v[data_i * b:(data_i + 1) * b] for k, v in batch.items()}
    metrics = []
    for s in range(steps):
        d = local_draws(draws[s], data_i, data_n, accum) if draws is not None else None
        state, met = step(state, local, seed=seed, draws=d, return_grads=return_grads)
        metrics.append({k: v.detach().numpy().copy() for k, v in met.items()})
    host = state_to_host(state)
    out.update(metrics=metrics, bytes=state_bytes(state),
               state={k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                      for k, v in host.items()})
    if ckpt_out:
        mgr = CheckpointManager(ckpt_out, writer=pm.rank() == 0)
        mgr.save_last(state, epoch=0)
        mgr.wait_until_finished()
        pm.barrier()
    return out


def fid_reduce_case(rank: int = 0, *, rows, dim: int) -> dict[str, Any]:
    """`FeatureStats.reduce_across_processes` of this rank's ``rows[rank]``
    (possibly none)."""
    from sgdm_tpu_torch.eval.metrics import FeatureStats

    st = FeatureStats()
    if len(rows[rank]):
        st.append(rows[rank])
    st.reduce_across_processes(dim=dim)
    mu, cov = st.mean_cov()
    return {"n": st.n, "sum": st._sum, "outer": st._outer, "mu": mu, "cov": cov}


def shard_case(rank: int = 0, *, global_batch: int) -> dict[str, Any]:
    """The data module's slice and the loader's rows on this rank."""
    from sgdm_tpu_torch.data.datamodule import _process_shard
    from sgdm_tpu_torch.data.loader import DataLoader
    from sgdm_tpu_torch.parallel import mesh as pm

    pm.create_mesh(("data",))
    shard = _process_shard(global_batch)
    ds = [{"i": np.int64(i)} for i in range(3 * global_batch + 1)]
    dl = DataLoader(ds, batch_size=global_batch, shuffle=True, num_workers=1, seed=4,
                    shard=shard)
    dl.set_epoch(2)
    return {"slice": (shard.start, shard.stop), "rows": [b["i"].tolist() for b in dl]}


def run_cases(rank: int, world: int, store: str, cases) -> dict[str, Any]:
    """Join the world, then run every (name, function name, kwargs) case."""
    torch.set_num_threads(1)
    from sgdm_tpu_torch.parallel import mesh as pm

    pm.init_process_group(torch.device("cpu"), rank=rank, world_size=world,
                          init_method=f"file://{store}", backend="gloo")
    try:
        out = {name: globals()[fn](rank, **kw) for name, fn, kw in cases}
    finally:
        pm.destroy_process_group()
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "flax", "optax", "sgdm_tpu"))
    return out
