"""Exponential moving average of parameters.

Port of `sgdm_tpu/models/ema.py` (LitEma as a pure update):
``e ← e − (1−d)·(e − p)`` with the warmup decay
``d = min(decay, (1 + n) / (10 + n))``, n the post-increment update count.
The decay is computed in float32 on the host, as the JAX package computes it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["ema_decay_schedule", "ema_update"]


def ema_decay_schedule(decay: float, num_updates: int) -> float:
    """Warmup-capped decay (float32 arithmetic)."""
    n = np.float32(num_updates)
    return float(min(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n)))


def ema_update(ema_params, params, num_updates: int, decay: float = 0.9999):
    """One EMA step over a tensor or a mapping of tensors; returns new tensors."""
    one_minus = float(np.float32(1.0) - np.float32(ema_decay_schedule(decay, num_updates)))
    step = lambda e, p: e - one_minus * (e - p)
    if isinstance(ema_params, torch.Tensor):
        return step(ema_params, params)
    if isinstance(ema_params, Mapping):
        return {k: step(e, params[k]) for k, e in ema_params.items()}
    raise TypeError(f"ema_update takes a tensor or a mapping, got {type(ema_params)}")
