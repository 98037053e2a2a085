"""DDIM sampling as a Python loop over the model.

Port of `sgdm_tpu/diffusion/samplers/ddim.py` (DDIM part; PLMS comes with a
later slice).  Per-step scalars are computed on the host from the float32
tables the JAX package uses; the loop body is one guided model call and a
few elementwise ops.  Noise comes from an explicit `torch.Generator`; with
eta = 0 every sigma is zero and no noise is drawn.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..schedule import (
    DiffusionSchedule,
    clip_x0,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)
from .common import ProgressiveLog, noise_like

__all__ = ["DDIMParams", "make_ddim_schedule", "ddim_sample"]


class DDIMParams:
    """Host-side DDIM sub-schedule tables, float32 like the JAX package's."""

    def __init__(self, timesteps, alphas, alphas_prev, sigmas):
        self.timesteps = np.asarray(timesteps)  # [S] int, ascending
        self.alphas = np.asarray(alphas, dtype=np.float32)
        self.alphas_prev = np.asarray(alphas_prev, dtype=np.float32)
        self.sigmas = np.asarray(sigmas, dtype=np.float32)
        self.sqrt_one_minus_alphas = np.sqrt(np.float32(1.0) - self.alphas)
        self.num_steps = len(self.timesteps)


def make_ddim_schedule(
    sched: DiffusionSchedule,
    num_steps: int,
    eta: float = 0.0,
    discr_method: str = "uniform",
) -> DDIMParams:
    # derived from the float32-rounded alphas_cumprod, as in the JAX package
    alphacums = sched.f32("alphas_cumprod").astype(np.float64)
    ddim_timesteps = make_ddim_timesteps(discr_method, num_steps, sched.num_timesteps)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        alphacums, ddim_timesteps, eta)
    return DDIMParams(ddim_timesteps, alphas, alphas_prev, sigmas)


def _ddim_step(
    params: DDIMParams,
    x: torch.Tensor,
    e_t: torch.Tensor,
    index: int,
    generator: torch.Generator,
    *,
    clip_denoised: bool,
    dtp: float,
    temperature: float,
    noise_dropout: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """DDIM eq. 12 update; returns (x_prev, pred_x0)."""
    f32 = np.float32
    a_t = params.alphas[index]
    a_prev = params.alphas_prev[index]
    sigma_t = params.sigmas[index]
    pred_x0 = (x - float(params.sqrt_one_minus_alphas[index]) * e_t) / float(np.sqrt(a_t))
    pred_x0 = clip_x0(pred_x0, clip_denoised=clip_denoised, dtp=dtp)
    dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev - sigma_t * sigma_t, f32(0.0)))
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
    if sigma_t > 0 and temperature != 0:
        noise = noise_like(generator, x.shape, x.device)
        noise = noise * (float(sigma_t) * temperature)
        if noise_dropout > 0.0:
            # torch F.dropout semantics: zero with prob p, keep scaled by 1/(1-p)
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - noise_dropout
            noise = torch.where(keep, noise / (1.0 - noise_dropout), torch.zeros_like(noise))
        x_prev = x_prev + noise
    return x_prev, pred_x0


def ddim_sample(
    sched: DiffusionSchedule,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    *,
    device: torch.device,
    num_steps: int = 50,
    eta: float = 0.0,
    clip_denoised: bool = True,
    dtp: float = 1.0,
    temperature: float = 1.0,
    noise_dropout: float = 0.0,
    log_num_per_prog: int = 10,
    x_T: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Deterministic for eta = 0 given ``x_T``; returns (x_0, intermediates)."""
    params = make_ddim_schedule(sched, num_steps, eta=eta)
    S = params.num_steps
    if x_T is not None:
        img = x_T.to(device=device, dtype=torch.float32)
    else:
        img = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    log_x0 = ProgressiveLog(S, log_num_per_prog, shape, device)
    log_xt = ProgressiveLog(S, log_num_per_prog, shape, device)
    for i, step_val in enumerate(params.timesteps[::-1]):
        index = S - 1 - i
        t = torch.full((shape[0],), int(step_val), dtype=torch.int32, device=device)
        e_t = denoise_fn(img, t)
        img, pred_x0 = _ddim_step(
            params, img, e_t.float(), index, generator,
            clip_denoised=clip_denoised, dtp=dtp,
            temperature=temperature, noise_dropout=noise_dropout,
        )
        log_x0.write(i, pred_x0)
        log_xt.write(i, img)
    return img, {"pred_x0": log_x0.buf, "x_inter": log_xt.buf}
