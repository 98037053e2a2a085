"""crowsonkb's v-objective samplers and schedules as Python loops.

Port of `sgdm_tpu/diffusion/samplers/v_objective.py` (v-diffusion-pytorch's
``sampling.py`` and ``utils.py``).  Models here predict v:
``model_fn(x, t) -> v`` with a per-sample continuous t in [0, 1],
α = cos(tπ/2), σ = sin(tπ/2).

* the cosine time ↔ (α, σ) ↔ log-SNR conversions and the DDPM /
  spliced-DDPM-cosine / log schedules;
* `v_sample` (DDIM, or ancestral with η > 0), `v_cond_sample` (a guidance
  gradient folded into v as −g·σ/α while t < 1), `v_reverse_sample` (DDIM
  inversion);
* the pseudo-numerical family over the v parameterisation: PRK4, PLMS4
  (three PRK warm-up steps), PIE2, PLMS2 (one PIE warm-up step) and IPLMS
  with its order 1 → 2 → 3 → 4 ramp, forward and reverse.

Each sampler is one loop over the (t₁, t₂) pairs of ``steps``, computed in
float32 on ``x``'s device.  η-noise is drawn from an explicit
`torch.Generator` (one normal draw a step), so an η > 0 run matches the JAX
package's in distribution, not value for value; with η = 0 no noise is drawn.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = [
    "t_to_alpha_sigma", "alpha_sigma_to_t", "log_snr_to_alpha_sigma",
    "alpha_sigma_to_log_snr", "get_ddpm_schedule",
    "get_spliced_ddpm_cosine_schedule", "get_log_schedule",
    "v_sample", "v_cond_sample", "v_reverse_sample",
    "prk_sample", "plms_sample", "pie_sample", "plms2_sample",
    "iplms_sample",
]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _f32(t, device=None) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# schedules (utils.py:39-91)
# ---------------------------------------------------------------------------

def t_to_alpha_sigma(t):
    """α = cos(tπ/2), σ = sin(tπ/2)."""
    t = _f32(t)
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


def alpha_sigma_to_t(alpha, sigma):
    return torch.atan2(sigma, alpha) / math.pi * 2


def log_snr_to_alpha_sigma(log_snr):
    log_snr = _f32(log_snr)
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))


def alpha_sigma_to_log_snr(alpha, sigma):
    return torch.log(alpha ** 2 / sigma ** 2)


def get_ddpm_schedule(ddpm_t):
    """The DDPM paper's noise schedule as cosine time."""
    log_snr = -torch.log(torch.expm1(1e-4 + 10 * _f32(ddpm_t) ** 2))
    return alpha_sigma_to_t(*log_snr_to_alpha_sigma(log_snr))


def get_spliced_ddpm_cosine_schedule(t):
    """Cosine time up to the crossover, the DDPM schedule after it."""
    ddpm_crossover = 0.48536712
    cosine_crossover = 0.80074257
    big_t = _f32(t) * (1 + cosine_crossover - ddpm_crossover)
    ddpm_part = get_ddpm_schedule(big_t + ddpm_crossover - cosine_crossover)
    return torch.where(big_t < cosine_crossover, big_t, ddpm_part)


def get_log_schedule(t, min_log_snr=-10.0, max_log_snr=10.0):
    """A schedule linear in log-SNR."""
    log_snr = _f32(t) * (min_log_snr - max_log_snr) + max_log_snr
    return alpha_sigma_to_t(*log_snr_to_alpha_sigma(log_snr))


def _rows(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] → [B, 1, …] with ``ndim`` axes."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


# ---------------------------------------------------------------------------
# DDIM / ancestral (sampling.py:9-135)
# ---------------------------------------------------------------------------

def v_sample(model_fn: ModelFn, x: torch.Tensor, steps, eta: float = 0.0,
             rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDIM (η = 0) or ancestral sampling down ``steps``; returns the final
    denoised prediction."""
    return _v_sample_impl(model_fn, x, steps, eta, rng, cond_fn=None)


def v_cond_sample(model_fn: ModelFn, x: torch.Tensor, steps, cond_fn, eta: float = 0.0,
                  rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """`v_sample` guided by ``cond_fn(x, t, pred) -> grad`` (the gradient
    w.r.t. x), folded in as v ← v − g·σ/α where t < 1."""
    return _v_sample_impl(model_fn, x, steps, eta, rng, cond_fn=cond_fn)


def _v_sample_impl(model_fn, x, steps, eta, rng, cond_fn):
    steps = _f32(steps, x.device)
    n, b = steps.shape[0], x.shape[0]
    alphas, sigmas = t_to_alpha_sigma(steps)
    if eta and rng is None:
        rng = torch.Generator(device=x.device)
        rng.manual_seed(0)

    def model_v(x, i):
        t = steps[i].expand(b)
        v = model_fn(x, t).float()
        if cond_fn is not None:
            a, s = alphas[i], sigmas[i]
            g = cond_fn(x, t, x * a - v * s).detach()
            v = torch.where(steps[i] < 1.0, v - g * (s / a), v)
        return v

    for i in range(n - 1):
        a1, s1, a2, s2 = alphas[i], sigmas[i], alphas[i + 1], sigmas[i + 1]
        v = model_v(x, i)
        pred = x * a1 - v * s1
        eps = x * s1 + v * a1
        ddim_sigma = eta * torch.sqrt(s2 ** 2 / s1 ** 2) * torch.sqrt(1 - a1 ** 2 / a2 ** 2)
        adjusted = torch.sqrt(torch.clamp(s2 ** 2 - ddim_sigma ** 2, min=0.0))
        x = pred * a2 + eps * adjusted
        if eta:
            x = x + torch.randn(x.shape, generator=rng, device=x.device,
                                dtype=x.dtype) * ddim_sigma
    v = model_v(x, n - 1)
    return x * alphas[n - 1] - v * sigmas[n - 1]


def v_reverse_sample(model_fn: ModelFn, x: torch.Tensor, steps) -> torch.Tensor:
    """DDIM inversion: the latent that produces ``x``; ``steps`` ascends
    toward 1."""
    steps = _f32(steps, x.device)
    b = x.shape[0]
    alphas, sigmas = t_to_alpha_sigma(steps)
    for i in range(steps.shape[0] - 1):
        v = model_fn(x, steps[i].expand(b)).float()
        pred = x * alphas[i] - v * sigmas[i]
        eps = x * sigmas[i] + v * alphas[i]
        x = pred * alphas[i + 1] + eps * sigmas[i + 1]
    return x


# ---------------------------------------------------------------------------
# pseudo-numerical methods over the v parameterisation (sampling.py:140-311)
# ---------------------------------------------------------------------------

def _eps_model(model_fn: ModelFn):
    """The v-model as an ε-model."""

    def eps_fn(x, t):
        alphas, sigmas = t_to_alpha_sigma(t)
        v = model_fn(x, t).float()
        return x * _rows(sigmas, x.ndim) + v * _rows(alphas, x.ndim)

    return eps_fn


def _transfer(x, eps, t_1, t_2):
    """Move x from t₁ to t₂ along the ε estimate."""
    alphas, sigmas = t_to_alpha_sigma(t_1)
    next_alphas, next_sigmas = t_to_alpha_sigma(t_2)
    pred = (x - eps * _rows(sigmas, x.ndim)) / _rows(alphas, x.ndim)
    return pred * _rows(next_alphas, x.ndim) + eps * _rows(next_sigmas, x.ndim)


def _prk_step(eps_fn, x, t_1, t_2):
    """One 4th-order pseudo Runge-Kutta step → (x, ε′)."""
    t_mid = (t_2 + t_1) / 2
    eps_1 = eps_fn(x, t_1)
    eps_2 = eps_fn(_transfer(x, eps_1, t_1, t_mid), t_mid)
    eps_3 = eps_fn(_transfer(x, eps_2, t_1, t_mid), t_mid)
    eps_4 = eps_fn(_transfer(x, eps_3, t_1, t_2), t_2)
    eps_prime = (eps_1 + 2 * eps_2 + 2 * eps_3 + eps_4) / 6
    return _transfer(x, eps_prime, t_1, t_2), eps_prime


def _pie_step(eps_fn, x, t_1, t_2):
    """One 2nd-order pseudo improved Euler step → (x, ε′)."""
    eps_1 = eps_fn(x, t_1)
    eps_2 = eps_fn(_transfer(x, eps_1, t_1, t_2), t_2)
    eps_prime = (eps_1 + eps_2) / 2
    return _transfer(x, eps_prime, t_1, t_2), eps_prime


def _pairs(steps, x: torch.Tensor, is_reverse: bool):
    """The (t₁, t₂) pairs, each broadcast to the batch; a forward run ends
    at t = 0."""
    steps = _f32(steps, x.device)
    if not is_reverse:
        steps = torch.cat([steps, steps.new_zeros(1)])
    b = x.shape[0]
    return [(steps[i].expand(b), steps[i + 1].expand(b)) for i in range(steps.shape[0] - 1)]


def prk_sample(model_fn: ModelFn, x: torch.Tensor, steps,
               is_reverse: bool = False) -> torch.Tensor:
    """PRK4 sampler."""
    eps_fn = _eps_model(model_fn)
    for t1, t2 in _pairs(steps, x, is_reverse):
        x, _ = _prk_step(eps_fn, x, t1, t2)
    return x


def pie_sample(model_fn: ModelFn, x: torch.Tensor, steps,
               is_reverse: bool = False) -> torch.Tensor:
    """PIE2 sampler."""
    eps_fn = _eps_model(model_fn)
    for t1, t2 in _pairs(steps, x, is_reverse):
        x, _ = _pie_step(eps_fn, x, t1, t2)
    return x


def _ab4(eps, hist):
    """4th-order Adams-Bashforth over ε and the last three (most recent last)."""
    return (55 * eps - 59 * hist[-1] + 37 * hist[-2] - 9 * hist[-3]) / 24


def plms_sample(model_fn: ModelFn, x: torch.Tensor, steps,
                is_reverse: bool = False) -> torch.Tensor:
    """PLMS4: three PRK warm-up steps, then AB4 over the ε history."""
    eps_fn = _eps_model(model_fn)
    hist: list[torch.Tensor] = []
    for i, (t1, t2) in enumerate(_pairs(steps, x, is_reverse)):
        if i < 3:
            x, eps = _prk_step(eps_fn, x, t1, t2)
        else:
            eps = eps_fn(x, t1)
            x = _transfer(x, _ab4(eps, hist), t1, t2)
        hist = (hist + [eps])[-3:]
    return x


def plms2_sample(model_fn: ModelFn, x: torch.Tensor, steps,
                 is_reverse: bool = False) -> torch.Tensor:
    """PLMS2: one PIE warm-up step, then AB2."""
    eps_fn = _eps_model(model_fn)
    old_eps = None
    for i, (t1, t2) in enumerate(_pairs(steps, x, is_reverse)):
        if i == 0:
            x, eps = _pie_step(eps_fn, x, t1, t2)
        else:
            eps = eps_fn(x, t1)
            x = _transfer(x, (3 * eps - old_eps) / 2, t1, t2)
        old_eps = eps
    return x


# IPLMS's warm-up: Adams-Bashforth of orders 1, 2, 3 (coefficients of ε and
# the history, most recent first)
_IPLMS_RAMP = ((1.0,), (3 / 2, -1 / 2), (23 / 12, -16 / 12, 5 / 12))


def iplms_sample(model_fn: ModelFn, x: torch.Tensor, steps,
                 is_reverse: bool = False) -> torch.Tensor:
    """Improved PLMS: orders 1, 2, 3 on the first three steps, then AB4."""
    eps_fn = _eps_model(model_fn)
    hist: list[torch.Tensor] = []
    for i, (t1, t2) in enumerate(_pairs(steps, x, is_reverse)):
        eps = eps_fn(x, t1)
        if i < 3:
            c = _IPLMS_RAMP[i]
            eps_prime = c[0] * eps
            for j in range(1, len(c)):
                eps_prime = eps_prime + c[j] * hist[-j]
        else:
            eps_prime = _ab4(eps, hist)
        x = _transfer(x, eps_prime, t1, t2)
        hist = (hist + [eps])[-3:]
    return x
