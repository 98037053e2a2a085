"""The diffusion-process object: training loss and the sampler registry.

Port of `sgdm_tpu/diffusion/core.py` `GaussianDiffusion`: the training
loss (`loss`, `losses.p_losses`) and ``sample(name, …)`` over the seven
samplers of the JAX registry:

  * ``native`` — ancestral DDPM, T model calls (`samplers.ddpm`);
  * ``ddim`` and ``plms`` — over the DDIM sub-schedule (`samplers.ddim`);
  * ``pndm`` — Runge-Kutta warm-up then Adams-Bashforth-4 on its own
    plain-linspace beta table (`samplers.pndm`);
  * ``tero`` — the Karras/EDM sampler with churn and Heun (`samplers.edm`);
  * ``vdm`` and ``ddim_continuous`` — continuous time on the closed-form
    log-SNR of ``sqrt_linear`` (the plain-linspace betas) or ``cosine``; any
    other beta schedule raises `ValueError` (`samplers.continuous`).

``num_steps`` defaults to 50 (250 for ``vdm``; ``native`` always takes T).
Any other name raises `KeyError`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .losses import p_losses
from .samplers.continuous import ddim_continuous_sample, get_log_snr_fn, vdm_sample
from .samplers.ddim import ddim_sample, plms_sample
from .samplers.ddpm import ancestral_sample
from .samplers.edm import edm_sample
from .samplers.pndm import pndm_sample
from .schedule import DiffusionSchedule, unnormalize_to_zero_to_255

__all__ = ["GaussianDiffusion", "SAMPLER_REGISTRY"]

SAMPLER_REGISTRY = ("native", "ddim", "plms", "pndm", "tero", "vdm", "ddim_continuous")

# beta schedules with a closed-form log-SNR -> its name in `samplers.continuous`
_LOG_SNR_NAMES = {"sqrt_linear": "linear", "cosine": "cosine"}


class GaussianDiffusion:
    """Pixel-space DDPM process: training loss and sampling dispatch."""

    def __init__(
        self,
        beta_schedule: str = "linear",
        num_timesteps: int = 1000,
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
        loss_type: str = "l2",
        **_unused: Any,
    ):
        self.schedule = DiffusionSchedule.create(
            beta_schedule=beta_schedule,
            num_timesteps=num_timesteps,
            linear_start=linear_start,
            linear_end=linear_end,
            cosine_s=cosine_s,
            v_posterior=v_posterior,
            parameterization=parameterization,
        )
        self.num_timesteps = num_timesteps
        self.loss_type = loss_type
        # PNDM rebuilds its own beta table from these
        self.linear_start = linear_start
        self.linear_end = linear_end
        self.beta_schedule = beta_schedule

    def loss(
        self,
        denoise_fn: Callable[..., torch.Tensor],
        generator: torch.Generator,
        x_start: torch.Tensor,
        cond_kwargs: dict[str, Any] | None = None,
        cond_drop_prob: float = 0.0,
        *,
        t: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        drop_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """`losses.p_losses` with this process's schedule and loss type."""
        return p_losses(self.schedule, denoise_fn, generator, x_start, cond_kwargs=cond_kwargs,
                        cond_drop_prob=cond_drop_prob, loss_type=self.loss_type, t=t,
                        noise=noise, drop_mask=drop_mask)

    def _log_snr_fn(self, sampling_method: str):
        # a log-SNR that is not the trained schedule's would denoise at the
        # wrong alpha/sigma every step: no fallback
        if self.beta_schedule not in _LOG_SNR_NAMES:
            raise ValueError(
                f"continuous sampler {sampling_method!r} has no closed-form log-SNR for "
                f"beta_schedule={self.beta_schedule!r} (supported: sqrt_linear, cosine)")
        return get_log_snr_fn(_LOG_SNR_NAMES[self.beta_schedule])

    def sample(
        self,
        sampling_method: str,
        denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        generator: torch.Generator,
        shape: tuple[int, ...],
        *,
        device: torch.device,
        num_steps: int | None = None,
        ddim_eta: float = 0.0,
        clip_denoised: bool = True,
        dtp: float = 1.0,
        temperature: float = 1.0,
        noise_dropout: float = 0.0,
        log_num_per_prog: int = 10,
        x_T: torch.Tensor | None = None,
        return_uint8: bool = True,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Run the named sampler; by default un-normalize to uint8 [0, 255].

        ``denoise_fn(x, t) -> eps`` has conditioning and guidance baked in
        (`guidance.make_guided_denoiser`); ``t`` is an int32 timestep, but a
        float32 log-SNR for ``vdm`` and a float32 step index for ``tero``.
        """
        common = dict(device=device, log_num_per_prog=log_num_per_prog, x_T=x_T)
        if sampling_method == "native":
            img, inter = ancestral_sample(
                self.schedule, denoise_fn, generator, shape,
                clip_denoised=clip_denoised, dtp=dtp, temperature=temperature, **common)
        elif sampling_method == "ddim":
            img, inter = ddim_sample(
                self.schedule, denoise_fn, generator, shape,
                num_steps=num_steps or 50, eta=ddim_eta,
                clip_denoised=clip_denoised, dtp=dtp, temperature=temperature,
                noise_dropout=noise_dropout, **common)
        elif sampling_method == "plms":
            img, inter = plms_sample(
                self.schedule, denoise_fn, generator, shape, num_steps=num_steps or 50,
                clip_denoised=clip_denoised, dtp=dtp, temperature=temperature,
                noise_dropout=noise_dropout, **common)
        elif sampling_method == "pndm":
            img, inter = pndm_sample(
                self.num_timesteps, self.linear_start, self.linear_end, self.beta_schedule,
                denoise_fn, generator, shape, num_steps=num_steps or 50, **common)
        elif sampling_method == "tero":
            img, inter = edm_sample(denoise_fn, generator, shape, num_steps=num_steps or 50,
                                    **common)
        elif sampling_method == "vdm":
            img, inter = vdm_sample(
                self._log_snr_fn(sampling_method), denoise_fn, generator, shape,
                num_steps=num_steps or 250, clip_denoised=clip_denoised, **common)
        elif sampling_method == "ddim_continuous":
            ls_fn = self._log_snr_fn(sampling_method)
            img, inter = ddim_continuous_sample(
                lambda t: torch.sigmoid(ls_fn(t)), denoise_fn, generator, shape,
                num_ddpm_timesteps=self.num_timesteps, num_steps=num_steps or 50,
                eta=ddim_eta, clip_denoised=clip_denoised, dtp=dtp,
                temperature=temperature, noise_dropout=noise_dropout, **common)
        else:
            raise KeyError(
                f"unknown sampling_method '{sampling_method}'; "
                f"registry: {SAMPLER_REGISTRY}"
            )
        if return_uint8:
            img = unnormalize_to_zero_to_255(img)
            inter = dict(inter)
            inter["pred_x0"] = unnormalize_to_zero_to_255(inter["pred_x0"])
        return img, inter
