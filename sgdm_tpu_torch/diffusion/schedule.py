"""Diffusion noise schedules and the sampling-side schedule math.

The port's own copy of `sgdm_tpu/diffusion/schedule.py`: the table
builders (numpy, float64), the posterior tables and the tensor step math
the samplers use.  Quirks kept:

  * the "linear" beta schedule is linear in *sqrt(beta)* space (LDM),
  * DDIM timesteps carry the reference's +1 offset,
  * the ``x0`` parameterization's ``lvlb_weights`` divide by
    ``2.0 * 1 - alphas_cumprod`` (that is 2 - ᾱ, not 2·(1 - ᾱ)), and
    ``lvlb_weights[0]`` is clamped to ``lvlb_weights[1]``.

Tables stay float64 numpy on the host; `extract` and `q_sample` (the
training side) read them as float32, as the JAX package stores them.
`DiffusionSchedule.f32` rounds one to float32, which is what the JAX
package stores; the DDIM sub-schedule is
derived from those float32 values, as in the JAX package, and enters the
device math as float32 scalars.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "make_beta_schedule",
    "make_ddim_timesteps",
    "make_ddim_sampling_parameters",
    "DiffusionSchedule",
    "clip_x0",
    "normalize_to_neg_one_to_one",
    "unnormalize_to_zero_to_255",
    "extract",
    "q_sample",
    "q_posterior",
    "predict_start_from_noise",
    "predict_noise_from_start",
]


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Return betas [T] float64."""
    if schedule == "linear":
        # LDM convention: linear in sqrt-space.
        betas = (
            np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(
    ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int
) -> np.ndarray:
    """DDIM timestep subset, int [S], including the reference's +1 offset."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization: {ddim_discr_method}")
    # +1 "to get the final alpha values right"
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sigmas / alphas / alphas_prev for the DDIM subset (DDIM eq. 16)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM schedule tables, float64 numpy [T] each, on the host."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int = 1000
    parameterization: str = "eps"
    v_posterior: float = 0.0
    beta_schedule: str = "linear"
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    cosine_s: float = 8e-3

    @classmethod
    def create(
        cls,
        beta_schedule: str = "linear",
        num_timesteps: int = 1000,
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        given_betas: np.ndarray | None = None,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
    ) -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(
                beta_schedule, num_timesteps,
                linear_start=linear_start, linear_end=linear_end, cosine_s=cosine_s,
            )
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        if alphas_cumprod.shape[0] != num_timesteps:
            raise ValueError(
                f"{alphas_cumprod.shape[0]} betas for num_timesteps={num_timesteps}")
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = (1 - v_posterior) * betas * (
            1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod) + v_posterior * betas
        if parameterization == "eps":
            # posterior_variance[0] == 0 makes entry 0 inf; it is clamped below
            with np.errstate(divide="ignore"):
                lvlb_weights = betas ** 2 / (
                    2 * posterior_variance * alphas * (1 - alphas_cumprod))
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
        else:
            raise NotImplementedError(f"parameterization {parameterization}")
        lvlb_weights = lvlb_weights.copy()
        lvlb_weights[0] = lvlb_weights[1]
        return cls(
            betas=betas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
            log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
            posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - alphas_cumprod),
            lvlb_weights=lvlb_weights,
            num_timesteps=num_timesteps,
            parameterization=parameterization,
            v_posterior=v_posterior,
            beta_schedule=beta_schedule,
            linear_start=linear_start,
            linear_end=linear_end,
            cosine_s=cosine_s,
        )

    def f32(self, name: str) -> np.ndarray:
        """Table ``name`` rounded to float32, as the JAX package stores it."""
        return np.asarray(getattr(self, name), dtype=np.float32)

    def time_to_sigma(self, t: torch.Tensor) -> torch.Tensor:
        """sigma(t) = sqrt(1 - alphas_cumprod[t]), float32."""
        return torch.as_tensor(self.f32("sqrt_one_minus_alphas_cumprod"),
                               device=t.device)[t.long()]

    def sigma_to_time_int(self, sigma: torch.Tensor) -> torch.Tensor:
        """The timestep whose sigma is nearest each of ``sigma``, int32."""
        table = torch.as_tensor(self.f32("sqrt_one_minus_alphas_cumprod"), device=sigma.device)
        delta = (table.reshape(1, -1) - sigma.reshape(-1, 1)).abs()
        return delta.argmin(dim=-1).to(torch.int32)


def clip_x0(pred_x0: torch.Tensor, clip_denoised: bool, dtp: float) -> torch.Tensor:
    """Static [-1, 1] clip, or Imagen dynamic thresholding when ``dtp < 1``.

    ``dtp`` is the dynamic-threshold percentile: per sample, s = max(1,
    quantile(|x0|, dtp)), and x0 is clipped to [-s, s] and divided by s.
    """
    if dtp < 1.0:
        flat = pred_x0.reshape(pred_x0.shape[0], -1).abs()
        s = torch.quantile(flat, dtp, dim=-1)
        s = torch.clamp(s, min=1.0)
        s = s.reshape(s.shape[0], *((1,) * (pred_x0.ndim - 1)))
        return torch.maximum(torch.minimum(pred_x0, s), -s) / s
    if clip_denoised:
        return torch.clamp(pred_x0, -1.0, 1.0)
    return pred_x0


def normalize_to_neg_one_to_one(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return img * 2.0 - 1.0


def unnormalize_to_zero_to_255(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 [0, 255] (truncating, as ``astype(uint8)`` does)."""
    return torch.clamp((img + 1.0) * 127.5, 0, 255).to(torch.uint8)


def extract(table, t: torch.Tensor | int, ndim: int) -> torch.Tensor | float:
    """table[t] broadcast to an ndim-rank tensor ([B,1,1,1] for images); a
    numpy table is read as float32.  A Python int ``t`` (one timestep for the
    whole batch) reads the float32 entry as a host scalar, so a sampler on
    the card copies no table there."""
    if isinstance(t, int):
        return float(np.asarray(table, dtype=np.float32)[t])
    if not isinstance(table, torch.Tensor):
        table = torch.as_tensor(np.asarray(table, dtype=np.float32))
    out = table.to(t.device)[t.long()]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion sample x_t ~ q(x_t | x_0)."""
    return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def q_posterior(sched: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor,
                t: torch.Tensor | int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, clipped log variance);
    at an int ``t`` the variances are host floats (`extract`)."""
    mean = (extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    var = extract(sched.posterior_variance, t, x_t.ndim)
    log_var = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, var, log_var


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor | int,
                             noise: torch.Tensor) -> torch.Tensor:
    """x0 = sqrt(1/ᾱ)·x_t − sqrt(1/ᾱ − 1)·eps."""
    return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def predict_noise_from_start(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
                             x0: torch.Tensor) -> torch.Tensor:
    """The inverse of `predict_start_from_noise`."""
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))
