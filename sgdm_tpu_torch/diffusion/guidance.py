"""Classifier-free guidance with the fused concat-double pass.

Port of `sgdm_tpu/diffusion/guidance.py` (`guided_score`,
`make_guided_denoiser`):

  * ``scale_type='imagen'``: eps = (1-w)·eps_uncond + w·eps_cond
  * ``scale_type='cfg'``:    eps = (1+w)·eps_cond − w·eps_uncond
  * w the Python number 1 → one conditional pass; 0 → one unconditional
    pass; any other value → the batch is concat-doubled (conditional half
    first) so ONE model forward computes both branches.

Quirk kept from the reference: the 0/1 fast paths assume the 'imagen'
convention.  Under 'cfg' the full formula at w=1 is 2·zc − z, not zc, so a
cfg model sampled at the Python float 1.0 gets the conditional score while a
tensor 1.0 takes the fused path and gets 2·zc − z.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["guided_score", "make_guided_denoiser", "prob_mask_like"]


def guided_score(z: torch.Tensor, zc: torch.Tensor, w, scale_type: str) -> torch.Tensor:
    """Combine unconditional (z) and conditional (zc) scores; ``w`` scalar or [B]."""
    w = torch.as_tensor(w, dtype=z.dtype, device=z.device)
    if w.ndim > 0:
        w = w.reshape(w.shape[0], *((1,) * (z.ndim - 1)))
    if scale_type == "imagen":
        return (1.0 - w) * z + w * zc
    if scale_type == "cfg":
        return (1.0 + w) * zc - w * z
    raise ValueError(f"unknown scale_type: {scale_type}")


def prob_mask_like(generator: torch.Generator, batch: int, prob,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Per-sample Bernoulli drop mask, True = drop the condition; ``prob`` a
    scalar or a per-sample [B] tensor.  Draws from ``generator``."""
    u = torch.rand((batch,), generator=generator, device=device)
    return u < torch.as_tensor(prob, dtype=u.dtype, device=u.device)


def _is_py_number(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def make_guided_denoiser(
    apply_fn: Callable[..., torch.Tensor],
    scale_type: str = "imagen",
) -> Callable[..., torch.Tensor]:
    """``apply_fn(x, t, cond_drop_mask=..., **cond) -> eps`` becomes
    ``guided(x, t, cond_scale, **cond) -> guided eps``."""

    def _double(v):
        return None if v is None else torch.cat([v, v], dim=0)

    def guided(x: torch.Tensor, t: torch.Tensor, cond_scale=1.0, **cond_kwargs) -> torch.Tensor:
        b = x.shape[0]
        if _is_py_number(cond_scale) and cond_scale == 1:
            mask = torch.zeros((b,), dtype=torch.bool, device=x.device)
            return apply_fn(x, t, cond_drop_mask=mask, **cond_kwargs)
        if _is_py_number(cond_scale) and cond_scale == 0:
            mask = torch.ones((b,), dtype=torch.bool, device=x.device)
            return apply_fn(x, t, cond_drop_mask=mask, **cond_kwargs)
        doubled = {k: _double(v) for k, v in cond_kwargs.items()}
        mask = torch.cat([torch.zeros((b,), dtype=torch.bool, device=x.device),
                          torch.ones((b,), dtype=torch.bool, device=x.device)])
        eps_cat = apply_fn(_double(x), _double(t), cond_drop_mask=mask, **doubled)
        eps_zc, eps_z = eps_cat[:b], eps_cat[b:]
        return guided_score(z=eps_z, zc=eps_zc, w=cond_scale, scale_type=scale_type)

    return guided
