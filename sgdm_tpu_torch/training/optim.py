"""Optimizers and LR schedules, optax-exact, over flat f32 buffers.

Port of `sgdm_tpu/training/optim.py`.  The three lambda schedules are
computed in float32 on the host, as the JAX package computes them.
`create_optimizer` returns an `Optimizer` with optax's ``init`` / ``update``
contract and the state of ``optax.adamw``: ``(count, mu, nu)`` of
`ScaleByAdamState` plus the `ScaleByScheduleState` count.  The update
follows optax's order exactly:

    mu = (1−b1)·g + b1·mu;  nu = (1−b2)·g² + b2·nu;  count += 1
    u  = (mu / (1 − b1^count)) / (√(nu / (1 − b2^count)) + eps)
    u += wd·p                                   (adamw: decoupled decay)
    u *= −lr(schedule count, before its increment)

``adam`` adds ``wd·p`` to the gradient first instead (optax's
``add_decayed_weights`` before ``adam``).  Parameters, μ and ν are the
port's flat f32 buffers (see `training/state.py`).  Two knobs, as the JAX
package chains them:

  * ``grad_clip`` c: ``optax.chain(clip_by_global_norm(c), adamw)`` — the
    gradient is kept where its global norm ‖g‖ < c, else replaced by
    ``(g / ‖g‖)·c``, in f32, before everything above;
  * ``mu_dtype="bfloat16"``: μ is stored as bf16.  As optax's
    ``scale_by_adam`` does it, the new μ is ``(1−b1)·g + b1·μ`` with the
    product ``b1·μ`` taken in bf16 (b1 rounded to bf16, as JAX rounds a
    weakly typed scalar to the array's type) and the sum in f32; the
    update uses that f32 μ, which is then cast to bf16 for the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

__all__ = [
    "lambda_linear_schedule",
    "lambda_warmup_cosine_schedule",
    "lambda_warmup_cosine_schedule2",
    "create_optimizer",
    "Optimizer",
    "OptState",
]

_f32 = np.float32
Schedule = Callable[[int], float]


def lambda_linear_schedule(base_lr: float, warm_up_steps: int = 500, f_start: float = 1e-6,
                           f_max: float = 1.0, f_min: float = 1.0,
                           cycle_length: float = 1e13) -> Schedule:
    """Linear warmup f_start → f_max over warm_up_steps, then the linear tail."""
    base_lr, f_start, f_max, f_min, cycle_length = map(
        float, (base_lr, f_start, f_max, f_min, cycle_length))
    warm_up_steps = int(warm_up_steps)

    def schedule(step: int) -> float:
        s = _f32(step)
        if s < warm_up_steps:
            f = _f32((f_max - f_start) / warm_up_steps) * s + _f32(f_start)
        else:
            f = _f32(f_min) + _f32(f_max - f_min) * (_f32(cycle_length) - s) / _f32(cycle_length)
        return float(_f32(base_lr) * f)

    return schedule


def lambda_warmup_cosine_schedule(base_lr: float, warm_up_steps: int, lr_min: float,
                                  lr_max: float, lr_start: float,
                                  max_decay_steps: int) -> Schedule:
    """Linear warmup lr_start → lr_max, then half-cosine decay to lr_min."""
    lr_min, lr_max, lr_start = map(float, (lr_min, lr_max, lr_start))
    warm_up_steps, max_decay_steps = int(warm_up_steps), int(max_decay_steps)

    def schedule(step: int) -> float:
        n = _f32(step)
        if n < warm_up_steps:
            f = _f32((lr_max - lr_start) / warm_up_steps) * n + _f32(lr_start)
        else:
            t = min((n - _f32(warm_up_steps)) / _f32(max_decay_steps - warm_up_steps), _f32(1.0))
            f = _f32(lr_min) + _f32(0.5 * (lr_max - lr_min)) * (
                _f32(1.0) + np.cos(_f32(t) * _f32(np.pi)))
        return float(_f32(base_lr) * f)

    return schedule


def lambda_warmup_cosine_schedule2(base_lr: float, warm_up_steps, f_min, f_max, f_start,
                                   cycle_lengths) -> Schedule:
    """Repeated warmup + cosine cycles; step n belongs to the first cycle with
    n ≤ its cumulative end."""
    warm = [int(w) for w in warm_up_steps]
    fmin, fmax, fstart = ([float(v) for v in vs] for vs in (f_min, f_max, f_start))
    lens = [float(c) for c in cycle_lengths]
    if not len(warm) == len(fmin) == len(fmax) == len(fstart) == len(lens):
        raise ValueError("one entry per cycle in every list")
    cum = np.concatenate([[0.0], np.cumsum(lens)]).astype(np.float32)

    def schedule(step: int) -> float:
        n = _f32(step)
        cyc = min(int(np.sum(n > cum[1:])), len(lens) - 1)
        w, cl = _f32(warm[cyc]), _f32(lens[cyc])
        fm, fx, fs = _f32(fmin[cyc]), _f32(fmax[cyc]), _f32(fstart[cyc])
        nn = n - cum[cyc]
        if nn < w:
            f = (fx - fs) / w * nn + fs
        else:
            t = min((nn - w) / (cl - w), _f32(1.0))
            f = fm + _f32(0.5) * (fx - fm) * (_f32(1.0) + np.cos(t * _f32(np.pi)))
        return float(_f32(base_lr) * f)

    return schedule


_SCHEDULES = {
    "lambda_linear": lambda_linear_schedule,
    "lambda_warmup_cosine": lambda_warmup_cosine_schedule,
    "lambda_warmup_cosine2": lambda_warmup_cosine_schedule2,
}


@dataclasses.dataclass
class OptState:
    """optax.adamw's state: ScaleByAdamState(count, mu, nu) and the
    ScaleByScheduleState count (flat f32 μ and ν)."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    schedule_count: int


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam / AdamW with optax's update order (see the module docstring)."""

    name: str
    lr_schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = None
    mu_dtype: torch.dtype = torch.float32

    def init(self, params: torch.Tensor) -> OptState:
        return OptState(0, torch.zeros_like(params, dtype=self.mu_dtype),
                        torch.zeros_like(params), 0)

    def update(self, grads: torch.Tensor, state: OptState, params: torch.Tensor,
               norm: torch.Tensor | None = None) -> tuple[torch.Tensor, OptState]:
        """(updates, new state); ``p + updates`` applies them.  ``norm``: the
        global norm the clip reads, where ``grads`` is one rank's part of the
        gradient (default: ‖grads‖)."""
        g = grads
        if self.grad_clip:
            if norm is None:
                norm = torch.linalg.vector_norm(g)
            g = torch.where(norm < self.grad_clip, g, (g / norm) * self.grad_clip)
        if self.name == "adam" and self.weight_decay:
            g = g + self.weight_decay * params
        b1, b2 = self.b1, self.b2
        if state.mu.dtype == torch.float32:
            mu = (1.0 - b1) * g + b1 * state.mu
        else:
            b1_low = torch.tensor(b1, dtype=state.mu.dtype, device=state.mu.device)
            mu = (1.0 - b1) * g + (b1_low * state.mu).float()
        nu = (1.0 - b2) * (g * g) + b2 * state.nu
        count = state.count + 1
        bc1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
        bc2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        if self.name == "adamw":
            u = u + self.weight_decay * params
        u = u * float(_f32(-self.lr_schedule(state.schedule_count)))
        return u, OptState(count, mu.to(state.mu.dtype), nu, state.schedule_count + 1)

    def hparams(self) -> dict[str, Any]:
        """The arguments of the fused AdamW+EMA update (`ops.fused_optim`)."""
        return dict(lr_schedule=self.lr_schedule, beta1=self.b1, beta2=self.b2, eps=self.eps,
                    weight_decay=self.weight_decay)


def create_optimizer(name: str = "adamw", lr: float = 1e-4, wd: float = 0.0,
                     beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                     scheduler: Mapping[str, Any] | str | None = "default",
                     grad_clip: float | None = None, mu_dtype: str | None = None) -> Optimizer:
    """Adam/AdamW with the reference warmup schedule.

    ``scheduler``: None → constant lr; "default" or a params dict → the
    lambda-linear schedule (a dict's ``name`` may select
    "lambda_warmup_cosine" or "lambda_warmup_cosine2").  ``grad_clip`` and
    ``mu_dtype`` ("bfloat16", "float32" or None): see the module docstring.
    """
    mu = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}
    if mu_dtype not in mu:
        raise ValueError(f"mu_dtype must be one of {sorted(k for k in mu if k)} or None, "
                         f"got {mu_dtype!r}")
    if name not in ("adam", "adamw"):
        raise ValueError(name)
    if scheduler is None:
        const = float(_f32(lr))
        lr_schedule: Schedule = lambda step: const
    else:
        params = {} if scheduler == "default" else dict(scheduler)
        lr_schedule = _SCHEDULES[params.pop("name", "lambda_linear")](lr, **params)
    return Optimizer(name, lr_schedule, float(beta1), float(beta2), float(eps), float(wd),
                     float(grad_clip) if grad_clip else None, mu[mu_dtype])
