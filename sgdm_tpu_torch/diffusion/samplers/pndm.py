"""PNDM sampler (pseudo numerical methods, arXiv:2202.09778) as a Python loop.

Port of `sgdm_tpu/diffusion/samplers/pndm.py`: 12 Runge-Kutta warm-up model
calls over half-stride timesteps, then S - 3 Adams-Bashforth-4 steps, so S
steps make 12 + (S - 3) model calls.  Two quirks of the reference are kept:

  * the sampler rebuilds its own beta table with HuggingFace's "linear"
    schedule (plain linspace betas in float32), not the LDM sqrt-space one
    the model was trained with, and appends a 0.0 to ``alphas_cumprod`` so
    ``alphas_cumprod[t + 1]`` never runs past the end;
  * the last main step clamps its next timestep to its own, so its transfer
    adds 0 and the chain stops at ``alphas_cumprod[1]``.

The transfer's scalars are float32, as the JAX package computes them.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .common import initial_noise

__all__ = ["pndm_alphas_cumprod", "pndm_time_steps", "pndm_sample"]


def pndm_alphas_cumprod(ddpm_num_timesteps: int, beta_start: float, beta_end: float,
                        beta_schedule: str) -> np.ndarray:
    """float32 [T + 1]: the sampler's own ᾱ table with 0.0 appended."""
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, ddpm_num_timesteps, dtype=np.float32)
    elif beta_schedule == "squaredcos_cap_v2":
        t = np.arange(ddpm_num_timesteps, dtype=np.float64)
        ab = lambda s: np.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = np.minimum(1 - ab((t + 1) / ddpm_num_timesteps) / ab(t / ddpm_num_timesteps),
                           0.999)
    else:
        raise NotImplementedError(beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    return np.asarray(list(alphas_cumprod) + [0.0], dtype=np.float32)


def pndm_time_steps(ddpm_T: int, num_inference_steps: int) -> tuple[list[int], list[int]]:
    """(the 12 warm-up timesteps, the S - 3 main timesteps), both descending."""
    stride = ddpm_T // num_inference_steps
    inference_step_times = list(range(0, ddpm_T, stride))
    w = np.array(inference_step_times[-4:]).repeat(2) + np.tile(np.array([0, stride // 2]), 4)
    warmup = [int(v) for v in reversed(w[:-1].repeat(2)[1:-1])]
    return warmup, list(reversed(inference_step_times[:-3]))


def _transfer(alphas_cumprod: np.ndarray, x: torch.Tensor, t: int, t_next: int,
              et: torch.Tensor) -> torch.Tensor:
    """PNDM paper eq. 9, its scalars in float32."""
    one = np.float32(1.0)
    at, at_next = alphas_cumprod[t + 1], alphas_cumprod[t_next + 1]
    c_x = one / (np.sqrt(at) * (np.sqrt(at) + np.sqrt(at_next)))
    c_e = one / (np.sqrt(at) * (np.sqrt((one - at_next) * at) + np.sqrt((one - at) * at_next)))
    return x + float(at_next - at) * (float(c_x) * x - float(c_e) * et)


def pndm_sample(
    ddpm_num_timesteps: int,
    beta_start: float,
    beta_end: float,
    beta_schedule: str,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    *,
    device: torch.device,
    num_steps: int = 50,
    log_num_per_prog: int = 10,
    x_T: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Deterministic given ``x_T``; the intermediates are the final image
    alone (the reference's PNDM logs nothing else)."""
    del log_num_per_prog
    alphas_cumprod = pndm_alphas_cumprod(ddpm_num_timesteps, beta_start, beta_end,
                                         beta_schedule)
    warmup, main = pndm_time_steps(ddpm_num_timesteps, num_steps)
    img = initial_noise(x_T, generator, shape, device)
    t_of = lambda v: torch.full((shape[0],), v, dtype=torch.int32, device=device)

    # Runge-Kutta warm-up: 12 calls, a pattern of 4
    cur_residual = torch.zeros(shape, dtype=torch.float32, device=device)
    cur_image = img
    ets: list[torch.Tensor] = []
    for t in range(len(warmup)):
        residual = denoise_fn(img, t_of(warmup[t])).float()
        t_prev = warmup[t // 4 * 4]
        t_next = warmup[min(t + 1, len(warmup) - 1)]
        if t % 4 == 0:
            cur_residual = cur_residual + residual / 6.0
            ets.append(residual)
            cur_image = img
        elif t % 4 in (1, 2):
            cur_residual = cur_residual + residual / 3.0
        else:
            residual = cur_residual + residual / 6.0
            cur_residual = torch.zeros_like(cur_residual)
        img = _transfer(alphas_cumprod, cur_image, t_prev, t_next, residual)

    # Adams-Bashforth 4 on the eps history (the warm-up leaves three)
    for i, t_prev in enumerate(main):
        t_next = main[min(i + 1, len(main) - 1)]
        ets = ets[-3:] + [denoise_fn(img, t_of(t_prev)).float()]
        residual = (55 * ets[3] - 59 * ets[2] + 37 * ets[1] - 9 * ets[0]) / 24.0
        img = _transfer(alphas_cumprod, img, t_prev, t_next, residual)
    return img, {"pred_x0": img[None], "x_inter": img[None]}
