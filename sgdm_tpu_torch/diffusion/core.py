"""The diffusion-process object.

Port of `sgdm_tpu/diffusion/core.py` `GaussianDiffusion`: the training
loss (`loss`, `losses.p_losses`) and ``sample("ddim", …)``; every other
sampler name raises `KeyError` as the JAX package does for an unknown one.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .losses import p_losses
from .samplers.ddim import ddim_sample
from .schedule import DiffusionSchedule, unnormalize_to_zero_to_255

__all__ = ["GaussianDiffusion", "SAMPLER_REGISTRY"]

SAMPLER_REGISTRY = ("ddim",)


class GaussianDiffusion:
    """Pixel-space DDPM process: training loss and sampling dispatch."""

    def __init__(
        self,
        beta_schedule: str = "linear",
        num_timesteps: int = 1000,
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
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
            parameterization=parameterization,
        )
        self.num_timesteps = num_timesteps
        self.loss_type = loss_type

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
        """Run the sampler; by default un-normalize to uint8 [0, 255]."""
        if sampling_method != "ddim":
            raise KeyError(
                f"unknown sampling_method '{sampling_method}'; "
                f"registry: {SAMPLER_REGISTRY}"
            )
        img, inter = ddim_sample(
            self.schedule, denoise_fn, generator, shape, device=device,
            num_steps=num_steps or 50, eta=ddim_eta,
            clip_denoised=clip_denoised, dtp=dtp, temperature=temperature,
            noise_dropout=noise_dropout, log_num_per_prog=log_num_per_prog,
            x_T=x_T,
        )
        if return_uint8:
            img = unnormalize_to_zero_to_255(img)
            inter = dict(inter)
            inter["pred_x0"] = unnormalize_to_zero_to_255(inter["pred_x0"])
        return img, inter
