"""The v-objective samplers and schedules of the port
(`sgdm_tpu_torch/diffusion/samplers/v_objective.py`) against
`sgdm_tpu/diffusion/samplers/v_objective.py`, in float32 on the CPU.

  * every schedule and conversion on a grid of t, to rtol 1e-6;
  * every η = 0 sampler, forward and reverse (PRK, PIE, PLMS, PLMS2, IPLMS
    at 1-8 steps, through their warm-ups; DDIM, its inversion, the guided
    DDIM), on a fixed analytic v-model, value for value at rtol 1e-5.  The
    JAX samplers run op by op (`jax.disable_jit`): XLA fuses the body of a
    compiled scan and rounds otherwise, and a first step from t ≈ 1 divides
    by α ≈ 0.007, which turns those ulps into 1e-4 of the output (as far
    apart as the JAX package's own scanned PRK and unrolled PLMS warm-up);
  * η > 0 and ``ddpm`` (ancestral) by distribution: the two packages draw
    their noise from different generators, so the samples' mean and
    standard deviation are held against each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.diffusion.samplers import v_objective as jvo
from sgdm_tpu_torch.diffusion.samplers import v_objective as tvo

RTOL = 1e-5
T_GRID = np.linspace(0.0, 1.0, 41, dtype=np.float32)


def analytic_v(sd: float, wiggle: float = 0.05):
    """The v of data N(0, sd²) plus a fixed nonlinear term, for both
    packages: v = a·s·(1 − sd²)/(a²sd² + s²)·x + wiggle·tanh(x)."""

    def make(xp, cos, sin):
        def model_fn(x, t):
            a, s = cos(t * np.pi / 2), sin(t * np.pi / 2)
            k = a * s * (1 - sd ** 2) / (a ** 2 * sd ** 2 + s ** 2)
            return k.reshape(-1, *[1] * (x.ndim - 1)) * x + wiggle * xp.tanh(x)
        return model_fn

    return make(jnp, jnp.cos, jnp.sin), make(torch, torch.cos, torch.sin)


def inputs(seed: int = 0, shape=(3, 2, 4, 4)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def eager(fn, *args, **kw):
    """``fn`` op by op; a scan of length zero (one DDIM step) runs compiled,
    as disable_jit cannot type it and it has no body to fuse."""
    try:
        with jax.disable_jit():
            return np.asarray(fn(*args, **kw))
    except ValueError as e:
        if "zero-length scan" not in str(e):
            raise
        return np.asarray(fn(*args, **kw))


def close(got: torch.Tensor, want, rtol: float = RTOL, atol: float = 1e-6) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["get_ddpm_schedule", "get_spliced_ddpm_cosine_schedule",
                                  "get_log_schedule", "t_to_alpha_sigma"])
def test_schedules_match(name):
    got, want = getattr(tvo, name)(torch.as_tensor(T_GRID)), getattr(jvo, name)(T_GRID)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        close(g, w, rtol=1e-6, atol=1e-7)


def test_conversions_round_trip_and_match():
    a, s = jvo.t_to_alpha_sigma(T_GRID[1:-1])
    ta, ts = tvo.t_to_alpha_sigma(torch.as_tensor(T_GRID[1:-1]))
    close(tvo.alpha_sigma_to_t(ta, ts), jvo.alpha_sigma_to_t(a, s), rtol=1e-6)
    close(tvo.alpha_sigma_to_t(ta, ts), T_GRID[1:-1], rtol=1e-5)
    lsnr = jvo.alpha_sigma_to_log_snr(a, s)
    close(tvo.alpha_sigma_to_log_snr(ta, ts), np.asarray(lsnr), rtol=1e-5, atol=1e-5)
    for g, w in zip(tvo.log_snr_to_alpha_sigma(torch.as_tensor(np.array(lsnr))),
                    jvo.log_snr_to_alpha_sigma(lsnr)):
        close(g, w, rtol=1e-6)


def forward_steps(n: int) -> np.ndarray:
    return np.asarray(jvo.get_spliced_ddpm_cosine_schedule(jnp.linspace(1, 0, n + 1)[:-1]))


def reverse_steps(n: int) -> np.ndarray:
    return np.asarray(jvo.get_spliced_ddpm_cosine_schedule(jnp.linspace(0, 1, n + 1)))


PN = ["prk", "pie", "plms", "plms2", "iplms"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", PN)
def test_pseudo_numerical_forward_matches(name, n):
    jfn, tfn = analytic_v(0.5)
    jx, tx = inputs(n)
    steps = forward_steps(n)
    want = eager(getattr(jvo, f"{name}_sample"), jfn, jx, jnp.asarray(steps))
    close(getattr(tvo, f"{name}_sample")(tfn, tx, torch.as_tensor(steps)), want)


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("name", PN)
def test_pseudo_numerical_reverse_matches(name, n):
    jfn, tfn = analytic_v(0.5)
    jx, tx = inputs(10 + n)
    steps = reverse_steps(n)
    want = eager(getattr(jvo, f"{name}_sample"), jfn, jx, jnp.asarray(steps), is_reverse=True)
    close(getattr(tvo, f"{name}_sample")(tfn, tx, torch.as_tensor(steps), is_reverse=True),
          want)


@pytest.mark.parametrize("n", [1, 6])
def test_ddim_and_its_inversion_match(n):
    jfn, tfn = analytic_v(0.5)
    jx, tx = inputs(20 + n)
    steps = forward_steps(n)
    close(tvo.v_sample(tfn, tx, torch.as_tensor(steps)), eager(jvo.v_sample, jfn, jx, steps))
    rev = reverse_steps(n)
    close(tvo.v_reverse_sample(tfn, tx, torch.as_tensor(rev)),
          eager(jvo.v_reverse_sample, jfn, jx, rev))


def test_guided_ddim_matches():
    """cond_fn's gradient folded in as −g·σ/α while t < 1 (the schedule
    starts at t = 1 here, where the guidance is off)."""
    jfn, tfn = analytic_v(0.5)
    jx, tx = inputs(30)
    target = np.random.default_rng(31).standard_normal(jx.shape).astype(np.float32)
    jcond = lambda x, t, pred: 0.3 * (pred - target) + t[:, None, None, None]  # noqa: E731
    tcond = lambda x, t, pred: 0.3 * (pred - torch.as_tensor(target)) \
        + t[:, None, None, None]  # noqa: E731
    steps = np.concatenate([[1.0], forward_steps(5)[1:]]).astype(np.float32)
    close(tvo.v_cond_sample(tfn, tx, torch.as_tensor(steps), tcond),
          eager(jvo.v_cond_sample, jfn, jx, steps, jcond))


def _moments(x) -> tuple[float, float]:
    x = np.asarray(x, np.float64).ravel()
    return float(x.mean()), float(x.std())


@pytest.mark.parametrize("eta", [0.5, 1.0])
@pytest.mark.parametrize("sd", [1.0, 0.5])
def test_ancestral_distribution_matches(eta, sd):
    """η > 0 (η = 1 is the CLI's ``ddpm``): on 16384 values the port's mean
    and standard deviation agree with the JAX package's within 0.03."""
    jfn, tfn = analytic_v(sd, wiggle=0.0)
    jx, tx = inputs(40, shape=(64, 16, 16))
    steps = forward_steps(25)
    gen = torch.Generator().manual_seed(0)
    got = _moments(tvo.v_sample(tfn, tx, torch.as_tensor(steps), eta, gen))
    want = _moments(jvo.v_sample(jfn, jx, steps, eta, jax.random.PRNGKey(0)))
    assert abs(got[0] - want[0]) < 0.03 and abs(got[1] - want[1]) < 0.03, (got, want)


def test_eta_noise_comes_from_the_generator():
    """Same generator seed → same sample; another seed → another sample."""
    _, tfn = analytic_v(0.5)
    _, tx = inputs(50)
    steps = torch.as_tensor(forward_steps(4))
    run = lambda seed: tvo.v_sample(tfn, tx, steps, 1.0,  # noqa: E731
                                    torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
