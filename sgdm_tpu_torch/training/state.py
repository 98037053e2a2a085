"""The guided sampling program (sampling side of `sgdm_tpu/training/state.py`).

`make_sample_fn` is the port of the JAX package's `make_sample_fn`:
conditioning plus classifier-free guidance are baked into the denoise
closure that the sampler calls once per step.  The model runs with its
kernels on (the JAX package switches to ``use_pallas=True`` here), under
`torch.inference_mode`.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from ..device import resolve_device
from ..diffusion.core import GaussianDiffusion
from ..diffusion.guidance import make_guided_denoiser

__all__ = ["make_sample_fn"]


def make_sample_fn(
    model: torch.nn.Module,
    diffusion: GaussianDiffusion,
    *,
    sampling_method: str = "ddim",
    num_steps: int = 50,
    cond_scale: float = 2.0,
    scale_type: str = "imagen",
    ddim_eta: float = 0.0,
    clip_denoised: bool = True,
    dtp: float = 1.0,
    temperature: float = 1.0,
    noise_dropout: float = 0.0,
    log_num_per_prog: int = 10,
    return_uint8: bool = True,
    device: str | torch.device = "cuda",
) -> Callable[..., tuple[torch.Tensor, dict[str, torch.Tensor]]]:
    """Returns ``sample(params_or_model, generator, batch_size, image_size,
    channels, cond=None, layout=None, image_batch_ids=None, x_T=None)`` →
    (images NHWC, intermediates).

    ``params_or_model`` is the model to sample (on ``device``) or a
    `state_dict` to load into ``model`` first.  ``generator`` is a
    `torch.Generator` on ``device``.  Raises when ``device`` is CUDA and
    there is none.
    """
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def sample(params_or_model: torch.nn.Module | Mapping[str, Any],
               generator: torch.Generator, batch_size: int, image_size: int,
               channels: int, cond=None, layout=None, image_batch_ids=None, x_T=None):
        net = model
        if isinstance(params_or_model, torch.nn.Module):
            net = params_or_model.to(dev).eval()
        elif params_or_model is not None:
            model.load_state_dict(params_or_model)
        cond_kwargs = {}
        if cond is not None:
            cond_kwargs["cond"] = torch.as_tensor(cond, device=dev)
        if layout is not None:
            cond_kwargs["layout"] = torch.as_tensor(layout, device=dev)
        if image_batch_ids is not None:
            cond_kwargs["image_batch_ids"] = torch.as_tensor(image_batch_ids, device=dev)
        guided = make_guided_denoiser(net, scale_type=scale_type)
        denoise = lambda x, t: guided(x, t, cond_scale=cond_scale, **cond_kwargs)
        shape = (batch_size, image_size, image_size, channels)
        return diffusion.sample(
            sampling_method, denoise, generator, shape, device=dev,
            num_steps=num_steps, ddim_eta=ddim_eta,
            clip_denoised=clip_denoised, dtp=dtp,
            temperature=temperature, noise_dropout=noise_dropout,
            log_num_per_prog=log_num_per_prog, x_T=x_T, return_uint8=return_uint8,
        )

    return sample
