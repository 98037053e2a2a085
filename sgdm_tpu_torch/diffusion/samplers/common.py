"""Shared sampler utilities: explicit-generator noise and the progressive log.

The JAX package keeps intermediates in a fixed K-slot buffer because its
samplers are `lax.scan` programs.  The port keeps the same buffer, allocated
once: step i writes slot ``min(i // interval, K - 1)``, so each slot holds
the last state of its interval.
"""

from __future__ import annotations

import torch

__all__ = ["ProgressiveLog", "noise_like"]


def noise_like(generator: torch.Generator, shape, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian noise of ``shape`` drawn from ``generator`` on ``device``."""
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


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
