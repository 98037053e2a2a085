"""Karras (EDM, arXiv:2206.00364) stochastic sampler, "tero" in the registry.

Port of `sgdm_tpu/diffusion/samplers/edm.py`:

  * the rho-7 sigma ladder sigma_max = 80 → sigma_min = 0.002, divided by
    (N - 1) as the reference does, so its last entry overshoots sigma_min;
  * churn gamma = min(S_churn / N, sqrt 2 - 1) where sigma lies in
    [S_tmin, S_tmax];
  * the eps-model preconditioned with c_in = 1 / sqrt(1 + sigma²),
    c_out = -sigma and, as c_noise, the reversed step index as a float (the
    reference feeds the model the loop index, not a DDPM timestep);
  * a Heun correction on every step, so N steps make 2N model calls.

The per-step scalars are float32, as the JAX package scans over them.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .common import ProgressiveLog, initial_noise, noise_like

__all__ = ["edm_schedule", "edm_sample"]


def edm_schedule(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0, s_churn: float = 80.0, s_tmin: float = 0.05,
                 s_tmax: float = 50.0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """float64 (sigmas [N + 1], gammas [N], c_noise [N + 1])."""
    N = num_steps
    i = np.arange(N + 1, dtype=np.float64)
    t_list = (sigma_max ** (1.0 / rho)
              + i * (sigma_min ** (1.0 / rho) - sigma_max ** (1.0 / rho)) / (N - 1)) ** rho
    gamma_list = np.where((t_list[:N] >= s_tmin) & (t_list[:N] <= s_tmax),
                          min(s_churn / N, math.sqrt(2) - 1), 0.0)
    return t_list, gamma_list, np.arange(N, -1, -1, dtype=np.float64)


def edm_sample(
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    *,
    device: torch.device,
    num_steps: int,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    s_churn: float = 80.0,
    s_tmin: float = 0.05,
    s_tmax: float = 50.0,
    s_noise: float = 1.0,
    log_num_per_prog: int = 10,
    x_T: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (x0, {pred_x0, x_inter}: the same K-slot log of x after each
    step).  A caller's ``x_T`` is a unit-variance latent, scaled here by
    sigma_max's grid value like the drawn one."""
    f32 = np.float32
    N = num_steps
    t_list, gamma_list, time_int = edm_schedule(N, sigma_min, sigma_max, rho, s_churn,
                                                s_tmin, s_tmax)
    ts, gammas, cs = t_list.astype(f32), gamma_list.astype(f32), time_int.astype(f32)
    b = shape[0]

    def denoiser(x, sigma, c_noise):
        c_in = f32(1.0) / np.sqrt(f32(1.0) + sigma * sigma)
        noise_in = torch.full((b,), float(c_noise), dtype=torch.float32, device=device)
        return x - float(sigma) * denoise_fn(float(c_in) * x, noise_in).float()

    x = initial_noise(x_T, generator, shape, device) * float(t_list[0])
    log = ProgressiveLog(N, log_num_per_prog, shape, device)
    tiny = f32(1e-20)
    for step in range(N):
        t_i, t_ip1, gamma = ts[step], ts[step + 1], gammas[step]
        t_hat = t_i + gamma * t_i
        eps = noise_like(generator, shape, device) * s_noise
        x_hat = x + float(np.sqrt(np.maximum(t_hat * t_hat - t_i * t_i, f32(0.0)))) * eps
        d_i = (x_hat - denoiser(x_hat, t_hat, cs[step])) / float(t_hat + tiny)
        x_tmp = x_hat + float(t_ip1 - t_hat) * d_i
        # Heun correction on every step, the last one included
        d_prime = (x_tmp - denoiser(x_tmp, t_ip1, cs[step + 1])) / float(t_ip1 + tiny)
        x = x_hat + float((t_ip1 - t_hat) * f32(0.5)) * (d_i + d_prime)
        log.write(step, x)
    return x, {"pred_x0": log.buf, "x_inter": log.buf}
