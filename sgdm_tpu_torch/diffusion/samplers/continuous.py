"""Continuous-time samplers: the VDM schedules and ancestral sampler, and
DDIM over a continuous ᾱ(t).

Port of `sgdm_tpu/diffusion/samplers/continuous.py`:

  * `beta_linear_log_snr` / `alpha_cosine_log_snr`: closed-form log-SNR of
    the plain-linspace linear and the cosine schedules, float64 on numpy
    input and in the tensor's dtype on a tensor;
  * `LearnedNoiseSchedule`: VDM's learned monotonic log-SNR (a 1→1 linear
    plus a residual sigmoid MLP, every layer applied with |W| and |b|),
    normalised to [log_snr_max, log_snr_min] at t = 0 and 1, with a
    ``frac_gradient`` share of the gradient let through;
  * `vdm_sample`: ancestral sampling in continuous time whose model input
    is the per-sample **log-SNR**, not an integer timestep;
  * `ddim_continuous_sample`: ᾱ(t) evaluated in float32 on
    linspace(0, 1, T) (the JAX package evaluates it so, with x64 off), the
    uniform +1-offset DDIM sub-schedule and eq. 16 sigmas from those values,
    then the DDIM loop (`ddim._ddim_loop`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..schedule import make_ddim_sampling_parameters, make_ddim_timesteps
from .common import Intermediates, initial_noise, noise_like
from .ddim import DDIMParams, _ddim_loop

__all__ = [
    "beta_linear_log_snr",
    "alpha_cosine_log_snr",
    "get_log_snr_fn",
    "LearnedNoiseSchedule",
    "vdm_q_sample",
    "vdm_log_snr_table",
    "vdm_sample",
    "ddim_continuous_sample",
]


def _log(t, eps: float = 1e-20):
    if isinstance(t, torch.Tensor):
        return torch.log(torch.clamp(t, min=eps))
    return np.log(np.clip(t, eps, None))


def beta_linear_log_snr(t):
    """log-SNR of the plain-linspace linear beta schedule."""
    expm1 = torch.expm1 if isinstance(t, torch.Tensor) else np.expm1
    return -_log(expm1(1e-4 + 10.0 * (t ** 2)))


def alpha_cosine_log_snr(t, s: float = 0.008):
    """log-SNR of the cosine schedule."""
    cos = torch.cos if isinstance(t, torch.Tensor) else np.cos
    return -_log(cos((t + s) / (1 + s) * np.pi * 0.5) ** -2 - 1, eps=1e-5)


def get_log_snr_fn(name: str) -> Callable:
    if name == "linear":
        return beta_linear_log_snr
    if name == "cosine":
        return alpha_cosine_log_snr
    raise ValueError(f"unknown continuous noise schedule {name!r}")


class _MonotonicDense(nn.Module):
    """A linear layer applied with |W| and |b|; ``weight`` [out, in]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.kaiming_normal_(self.weight, nonlinearity="linear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.abs().t() + self.bias.abs()


class LearnedNoiseSchedule(nn.Module):
    """VDM's learned monotonic log-SNR, t ∈ [0, 1] → log-SNR, non-increasing
    and equal to ``log_snr_max`` at 0 and ``log_snr_min`` at 1.  Parameters
    ``l0`` (1→1), ``l1`` (1→hidden), ``l2`` (hidden→1) under the flax names
    (`models.convert.noise_schedule_from_flax`)."""

    def __init__(self, log_snr_max: float, log_snr_min: float, hidden_dim: int = 1024,
                 frac_gradient: float = 1.0):
        super().__init__()
        self.log_snr_max, self.log_snr_min = log_snr_max, log_snr_min
        self.frac_gradient = frac_gradient
        self.l0 = _MonotonicDense(1, 1)
        self.l1 = _MonotonicDense(1, hidden_dim)
        self.l2 = _MonotonicDense(hidden_dim, 1)

    def _net(self, x: torch.Tensor) -> torch.Tensor:
        x = self.l0(x[..., None])
        x = x + self.l2(torch.sigmoid(self.l1(x)))
        return x[..., 0]

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        slope = self.log_snr_min - self.log_snr_max
        out_zero = self._net(torch.zeros_like(t))
        out_one = self._net(torch.ones_like(t))
        normed = slope * ((self._net(t) - out_zero) / (out_one - out_zero)) + self.log_snr_max
        f = self.frac_gradient
        return normed * f + normed.detach() * (1.0 - f)


def vdm_q_sample(log_snr_fn, generator: torch.Generator, x_start: torch.Tensor,
                 times: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Continuous-time forward diffusion: (x_t, log_snr(times))."""
    noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                        dtype=x_start.dtype)
    log_snr = log_snr_fn(times)
    pad = log_snr.reshape(log_snr.shape + (1,) * (x_start.ndim - log_snr.ndim))
    return (x_start * torch.sqrt(torch.sigmoid(pad))
            + noise * torch.sqrt(torch.sigmoid(-pad))), log_snr


def _sigmoid(x: np.float32) -> np.float32:
    one = np.float32(1.0)
    return one / (one + np.exp(-x))


def vdm_log_snr_table(log_snr_fn, num_steps: int) -> np.ndarray:
    """float32 [S + 1]: the log-SNR at t = linspace(1, 0, S + 1), step i
    going from entry i to i + 1.  Evaluated once on the host: float64 for
    the closed forms; a module such as `LearnedNoiseSchedule` gets a float32
    tensor."""
    grid = np.linspace(1.0, 0.0, num_steps + 1)
    if isinstance(log_snr_fn, nn.Module):
        with torch.no_grad():
            return log_snr_fn(torch.as_tensor(grid, dtype=torch.float32)).cpu().numpy()
    return np.asarray(log_snr_fn(grid)).astype(np.float32)


def vdm_sample(
    log_snr_fn,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    *,
    device: torch.device,
    num_steps: int = 250,
    clip_denoised: bool = True,
    log_num_per_prog: int = 10,
    x_T: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Ancestral continuous-time sampling (VDM eq. 33 with the corrected
    posterior) over `vdm_log_snr_table`'s ``num_steps`` steps."""
    f32 = np.float32
    ls = vdm_log_snr_table(log_snr_fn, num_steps)
    img = initial_noise(x_T, generator, shape, device)
    logs = Intermediates(num_steps, log_num_per_prog, shape, device)
    one, tiny = f32(1.0), f32(1e-8)
    for i in range(num_steps):
        log_snr, log_snr_next = ls[i], ls[i + 1]
        c = -np.expm1(log_snr - log_snr_next)
        alpha = np.sqrt(_sigmoid(log_snr))
        sigma = np.sqrt(_sigmoid(-log_snr))
        alpha_next = np.sqrt(_sigmoid(log_snr_next))
        alpha_c = np.maximum(alpha, tiny)
        pred_noise = denoise_fn(
            img, torch.full((shape[0],), float(log_snr), dtype=torch.float32,
                            device=device)).float()
        x_start = (img - float(sigma) * pred_noise) / float(alpha_c)
        if clip_denoised:
            mean = float(alpha_next) * (img * float(one - c) / float(alpha_c)
                                        + float(c) * torch.clamp(x_start, -1.0, 1.0))
        else:
            mean = float(alpha_next / alpha_c) * (img - float(c * sigma) * pred_noise)
        if i == num_steps - 1:  # no noise on the last step
            img = mean
        else:
            var = _sigmoid(-log_snr_next) * c
            img = mean + float(np.sqrt(np.maximum(var, f32(0.0)))) * noise_like(
                generator, shape, device)
        logs.write(i, x_start, img)
    return img, logs.bufs()


def ddim_continuous_sample(
    alpha_fn,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    shape: tuple[int, ...],
    *,
    device: torch.device,
    num_ddpm_timesteps: int = 1000,
    num_steps: int = 50,
    eta: float = 0.0,
    clip_denoised: bool = True,
    dtp: float = 1.0,
    temperature: float = 1.0,
    noise_dropout: float = 0.0,
    log_num_per_prog: int = 10,
    x_T: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """DDIM over ``alpha_fn``: t ∈ [0, 1] (a float32 tensor) → ᾱ(t); e.g.
    ``lambda t: torch.sigmoid(beta_linear_log_snr(t))``.  The model is
    called with the integer timesteps of the sub-schedule."""
    tgrid = torch.as_tensor(np.linspace(0.0, 1.0, num_ddpm_timesteps), dtype=torch.float32)
    with torch.no_grad():
        alphacums = alpha_fn(tgrid).double().cpu().numpy()
    ddim_timesteps = make_ddim_timesteps("uniform", num_steps, num_ddpm_timesteps)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(alphacums, ddim_timesteps, eta)
    params = DDIMParams(ddim_timesteps, alphas, alphas_prev, sigmas)
    return _ddim_loop(params, denoise_fn, generator, shape, device, log_num_per_prog, x_T,
                      clip_denoised=clip_denoised, dtp=dtp, temperature=temperature,
                      noise_dropout=noise_dropout)
