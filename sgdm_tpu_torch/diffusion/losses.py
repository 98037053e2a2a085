"""DDPM training loss (eps / x0 parameterization).

Port of `sgdm_tpu/diffusion/losses.py`: draw t ~ U[0, T), noise and the
per-sample condition-drop mask, q_sample to x_t, run the denoiser, regress
noise (eps) or x_start (x0) under l1/l2/huber, reduce per sample then
mean.  Draws come from a `torch.Generator` (t, then noise, then the mask);
``t``, ``noise`` and ``drop_mask`` may be handed in instead, so a test can
give the port the JAX package's draws.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .guidance import prob_mask_like
from .schedule import DiffusionSchedule, q_sample

__all__ = ["pointwise_loss", "p_losses"]


def pointwise_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Elementwise loss: l1, l2, or huber (smooth l1 with beta 1)."""
    if loss_type == "l1":
        return (target - pred).abs()
    if loss_type == "l2":
        return (target - pred) ** 2
    if loss_type == "huber":
        d = (target - pred).abs()
        return torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)
    raise NotImplementedError(f"unknown loss type '{loss_type}'")


def p_losses(
    sched: DiffusionSchedule,
    denoise_fn: Callable[..., torch.Tensor],
    generator: torch.Generator | None,
    x_start: torch.Tensor,
    cond_kwargs: dict[str, Any] | None = None,
    cond_drop_prob: float = 0.0,
    loss_type: str = "l2",
    *,
    t: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    drop_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One training-loss evaluation.  ``denoise_fn(x_t, t, cond_drop_mask=...,
    **cond_kwargs) -> eps_hat``.  Returns (scalar loss, per-sample stats)."""
    cond_kwargs = dict(cond_kwargs or {})
    b, dev = x_start.shape[0], x_start.device
    if t is None:
        t = torch.randint(0, sched.num_timesteps, (b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev, dtype=x_start.dtype)
    x_noisy = q_sample(sched, x_start, t, noise)
    if drop_mask is None:
        drop_mask = prob_mask_like(generator, b, cond_drop_prob, dev)
    model_out = denoise_fn(x_noisy, t, cond_drop_mask=drop_mask, **cond_kwargs)

    if sched.parameterization == "eps":
        target = noise
    elif sched.parameterization == "x0":
        target = x_start
    else:
        raise NotImplementedError(sched.parameterization)
    loss_per_sample = pointwise_loss(model_out, target, loss_type).reshape(b, -1).mean(dim=-1)
    loss = loss_per_sample.mean()
    return loss, {"ddpm_loss": loss, "epoch_stats_x": t, "epoch_stats_y": loss_per_sample}
