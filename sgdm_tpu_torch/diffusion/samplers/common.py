"""Shared sampler utilities: explicit-generator noise, the starting latent
and the progressive logs.

The JAX package keeps intermediates in a fixed K-slot buffer because its
samplers are `lax.scan` programs.  The port keeps the same buffer, allocated
once: step i writes slot ``min(i // interval, K - 1)``, so each slot holds
the last state of its interval.
"""

from __future__ import annotations

import torch

__all__ = ["ProgressiveLog", "Intermediates", "initial_noise", "noise_like"]


def noise_like(generator: torch.Generator, shape, device, repeat: bool = False,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian noise of ``shape`` drawn from ``generator`` on ``device``;
    ``repeat`` draws one sample and broadcasts it over the batch."""
    if repeat:
        one = torch.randn((1, *shape[1:]), generator=generator, device=device, dtype=dtype)
        return one.expand(tuple(shape))
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def initial_noise(x_T: torch.Tensor | None, generator: torch.Generator, shape,
                  device) -> torch.Tensor:
    """The starting latent: ``x_T`` as float32 on ``device``, else a standard
    normal draw of ``shape`` from ``generator``."""
    if x_T is not None:
        return x_T.to(device=device, dtype=torch.float32)
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)


class ProgressiveLog:
    """A preallocated [K, *shape] buffer written at ``log_num_per_prog`` slots."""

    def __init__(self, num_steps: int, num_slots: int, shape, device,
                 dtype: torch.dtype = torch.float32):
        self.num_steps = max(num_steps, 1)
        self.num_slots = max(min(num_slots, num_steps), 1)
        self.interval = -(-self.num_steps // self.num_slots)  # ceil
        self.buf = torch.zeros((self.num_slots, *shape), device=device, dtype=dtype)

    def write(self, step_idx: int, value: torch.Tensor) -> None:
        self.buf[min(step_idx // self.interval, self.num_slots - 1)].copy_(value)


class Intermediates:
    """The two logs a sampler returns beside its sample: the x0 prediction
    and the state after each step."""

    def __init__(self, num_steps: int, num_slots: int, shape, device):
        self.pred_x0 = ProgressiveLog(num_steps, num_slots, shape, device)
        self.x_inter = ProgressiveLog(num_steps, num_slots, shape, device)

    def write(self, step_idx: int, pred_x0: torch.Tensor, x: torch.Tensor) -> None:
        self.pred_x0.write(step_idx, pred_x0)
        self.x_inter.write(step_idx, x)

    def bufs(self) -> dict[str, torch.Tensor]:
        return {"pred_x0": self.pred_x0.buf, "x_inter": self.x_inter.buf}
