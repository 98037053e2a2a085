"""DDIM and PLMS sampling as Python loops over the model.

Port of `sgdm_tpu/diffusion/samplers/ddim.py`.  Per-step scalars are
computed on the host from the float32 tables the JAX package uses; the loop
body is one guided model call and a few elementwise ops.  Noise comes from
an explicit `torch.Generator`; with eta = 0 every sigma is zero and no noise
is drawn.

PLMS (pseudo linear multistep) takes DDIM's eta-0 step with an
Adams-Bashforth combination of the eps history: its first step is a
pseudo improved Euler step (a DDIM step, a second model call at the next
timestep, the two eps averaged), so S steps make S + 1 model calls; orders
2-4 read the last three eps.
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
from .common import Intermediates, initial_noise, noise_like

__all__ = ["DDIMParams", "make_ddim_schedule", "ddim_sample", "plms_sample"]


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


def _ddim_loop(
    params: DDIMParams,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    device: torch.device,
    log_num_per_prog: int,
    x_T: torch.Tensor | None,
    **step_kw,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One `_ddim_step` per sub-schedule timestep, from the last down."""
    S = params.num_steps
    img = initial_noise(x_T, generator, shape, device)
    logs = Intermediates(S, log_num_per_prog, shape, device)
    for i, step_val in enumerate(params.timesteps[::-1]):
        t = torch.full((shape[0],), int(step_val), dtype=torch.int32, device=device)
        img, pred_x0 = _ddim_step(params, img, denoise_fn(img, t).float(), S - 1 - i,
                                  generator, **step_kw)
        logs.write(i, pred_x0, img)
    return img, logs.bufs()


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
    return _ddim_loop(make_ddim_schedule(sched, num_steps, eta=eta), denoise_fn, generator,
                      shape, device, log_num_per_prog, x_T, clip_denoised=clip_denoised,
                      dtp=dtp, temperature=temperature, noise_dropout=noise_dropout)


def plms_sample(
    sched: DiffusionSchedule,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    *,
    device: torch.device,
    num_steps: int = 50,
    clip_denoised: bool = True,
    dtp: float = 1.0,
    temperature: float = 1.0,
    noise_dropout: float = 0.0,
    log_num_per_prog: int = 10,
    x_T: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """PLMS over the DDIM sub-schedule (eta 0); deterministic given ``x_T``."""
    params = make_ddim_schedule(sched, num_steps, eta=0.0)
    S = params.num_steps
    img = initial_noise(x_T, generator, shape, device)
    time_range = params.timesteps[::-1]
    logs = Intermediates(S, log_num_per_prog, shape, device)
    step_kw = dict(clip_denoised=clip_denoised, dtp=dtp, temperature=temperature,
                   noise_dropout=noise_dropout)
    old_eps: list[torch.Tensor] = []  # the last three eps, oldest first
    for i, step_val in enumerate(time_range):
        index = S - 1 - i
        t = torch.full((shape[0],), int(step_val), dtype=torch.int32, device=device)
        e_t = denoise_fn(img, t).float()
        if not old_eps:
            # pseudo improved Euler: the step, then eps again at the next timestep
            # (the last step's next timestep is its own)
            x_prev, _ = _ddim_step(params, img, e_t, index, generator, **step_kw)
            t_next = torch.full((shape[0],), int(time_range[min(i + 1, S - 1)]),
                                dtype=torch.int32, device=device)
            e_prime = (e_t + denoise_fn(x_prev, t_next).float()) / 2
        elif len(old_eps) == 1:
            e_prime = (3 * e_t - old_eps[-1]) / 2
        elif len(old_eps) == 2:
            e_prime = (23 * e_t - 16 * old_eps[-1] + 5 * old_eps[-2]) / 12
        else:
            e_prime = (55 * e_t - 59 * old_eps[-1] + 37 * old_eps[-2] - 9 * old_eps[-3]) / 24
        img, pred_x0 = _ddim_step(params, img, e_prime, index, generator, **step_kw)
        old_eps = (old_eps + [e_t])[-3:]
        logs.write(i, pred_x0, img)
    return img, logs.bufs()
