"""The native (ancestral) DDPM sampler as a Python loop over the model.

Port of `sgdm_tpu/diffusion/samplers/ddpm.py`: T model calls, from
t = T - 1 down to 0, each followed by the x0 prediction, its clipping and a
draw from the posterior q(x_{t-1} | x_t, x0); no noise is added at t = 0.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..schedule import DiffusionSchedule, clip_x0, predict_start_from_noise, q_posterior
from .common import Intermediates, initial_noise, noise_like

__all__ = ["p_mean_variance", "ancestral_sample"]


def p_mean_variance(
    sched: DiffusionSchedule,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    t: torch.Tensor | int,
    clip_denoised: bool = True,
    dtp: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The model's p(x_{t-1} | x_t): (mean, variance, log variance, x0,
    x0 before clipping).  An int ``t`` is one timestep for the batch: the
    tables are read as host scalars and the variances are floats."""
    t_model = (torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
               if isinstance(t, int) else t)
    model_out = denoise_fn(x, t_model).float()
    if sched.parameterization == "eps":
        x_recon = predict_start_from_noise(sched, x, t, model_out)
    elif sched.parameterization == "x0":
        x_recon = model_out
    else:
        raise NotImplementedError(sched.parameterization)
    x_recon_unclipped = x_recon
    x_recon = clip_x0(x_recon, clip_denoised=clip_denoised, dtp=dtp)
    mean, var, log_var = q_posterior(sched, x_recon, x, t)
    return mean, var, log_var, x_recon, x_recon_unclipped


def ancestral_sample(
    sched: DiffusionSchedule,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    *,
    device: torch.device,
    clip_denoised: bool = True,
    dtp: float = 1.0,
    temperature: float = 1.0,
    repeat_noise: bool = False,
    log_num_per_prog: int = 10,
    x_T: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-T ancestral sampling; returns (x0 in [-1, 1], {pred_x0, x_inter}
    each [K, B, H, W, C])."""
    T = sched.num_timesteps
    img = initial_noise(x_T, generator, shape, device)
    logs = Intermediates(T, log_num_per_prog, shape, device)
    for it in range(T - 1, -1, -1):
        mean, _, log_var, pred_x0, _ = p_mean_variance(
            sched, denoise_fn, img, it, clip_denoised=clip_denoised, dtp=dtp)
        if it > 0:
            noise = noise_like(generator, shape, device, repeat_noise) * temperature
            img = mean + float(np.exp(np.float32(0.5) * np.float32(log_var))) * noise
        else:
            img = mean
        logs.write(T - 1 - it, pred_x0, img)
    return img, logs.bufs()
