"""Sampler trajectories of the tiny UNet (B = 2, 16 px, cond_scale 2, a
shared x_T, the same weights in both packages), the port against
`sgdm_tpu`, in float32 on the CPU:

  * deterministic: plms, pndm (12 warm-up calls and 1 main step),
    ddim_continuous at eta 0, and EDM without churn;
  * stochastic, with the noise of both packages replaced by one fixed array
    (the JAX scans draw once a step): native on 8 timesteps, tero with
    churn, vdm and ddim_continuous at eta 0.5.

Float images within 1e-3 · max(1, max|ref|), uint8 within 1, as
`tests/test_torch_sampling.py` holds DDIM; the model calls counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.diffusion.core import GaussianDiffusion as JDiffusion
from sgdm_tpu.diffusion.guidance import make_guided_denoiser as jguided
from sgdm_tpu.diffusion.samplers import continuous as jcont
from sgdm_tpu.diffusion.samplers import ddim as jddim
from sgdm_tpu.diffusion.samplers import ddpm as jddpm
from sgdm_tpu.diffusion.samplers import edm as jedm
from sgdm_tpu.models.unet import UNetModel as JUNetModel
from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
from sgdm_tpu_torch.diffusion.guidance import make_guided_denoiser
from sgdm_tpu_torch.diffusion.samplers import continuous as tcont
from sgdm_tpu_torch.diffusion.samplers import ddim as tddim
from sgdm_tpu_torch.diffusion.samplers import ddpm as tddpm
from sgdm_tpu_torch.diffusion.samplers import edm as tedm
from sgdm_tpu_torch.models.convert import from_flax
from sgdm_tpu_torch.models.factory import create_denoiser

from torch_port_common import SMALL_UNET, one_torch_thread, perturbed_flat, unflatten  # noqa: F401

B, PX = 2, 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def unet(one_torch_thread):
    """The tiny UNet in both packages with the same weights, its guided
    denoisers at cond_scale 2, a shared x_T and a fixed noise array."""
    jm = JUNetModel(use_pallas=False, **SMALL_UNET)
    rng = np.random.default_rng(11)
    x_T = rng.standard_normal((B, PX, PX, 3)).astype(np.float32)
    noise = rng.standard_normal((B, PX, PX, 3)).astype(np.float32)
    cond = np.eye(10, dtype=np.float32)[[3, 7]]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x_T),
                            jnp.zeros((B,), jnp.int32), cond=jnp.asarray(cond))["params"]
    flat = perturbed_flat(shapes, seed=12)
    jparams = unflatten(flat)
    jg = jguided(lambda x, t, cond_drop_mask=None, **kw: jm.apply(
        {"params": jparams}, x, t, cond_drop_mask=cond_drop_mask, **kw), scale_type="imagen")
    jitted = jax.jit(lambda x, t: jg(x, t, cond_scale=2.0, cond=jnp.asarray(cond)))

    def jdenoise(x, t):
        # the samplers' loops run op by op (no compile of a whole scan); the
        # UNet itself compiles once, faster than op by op (its time embedding
        # takes float32: an int32 timestep converts exactly)
        with jax.disable_jit(False):
            return jitted(x, jnp.asarray(t, jnp.float32))

    tm = create_denoiser(**SMALL_UNET)
    tm.load_state_dict(from_flax(flat, tm))
    tm.eval()
    tg = make_guided_denoiser(tm, scale_type="imagen")
    calls = []

    def tdenoise(x, t):
        calls.append(int(x.shape[0]))
        return tg(x, t, cond_scale=2.0, cond=torch.from_numpy(cond))

    return dict(x_T=x_T, noise=noise, calls=calls, tdenoise=tdenoise, jdenoise=jdenoise)


def _compare(want, got):
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (B, PX, PX, 3) and np.isfinite(got).all()
    ref_max = np.abs(want).max()
    assert ref_max > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * max(1.0, ref_max))
    u8 = lambda a: np.clip((a + 1.0) * 127.5, 0, 255).astype(np.uint8).astype(np.int32)
    assert np.abs(u8(got) - u8(want)).max() <= 1


def _fix_noise(monkeypatch, unet, jax_targets, torch_targets):
    fixed = unet["noise"]
    for mod, attr in jax_targets:
        monkeypatch.setattr(mod, attr, lambda *a, **k: jnp.asarray(fixed))
    for mod in torch_targets:
        monkeypatch.setattr(mod, "noise_like", lambda *a, **k: torch.from_numpy(fixed))


def _sample_both(unet, name, steps, diffusion_kw, **kw):
    with jax.disable_jit():   # the few-step scans run op by op: no compile
        want, _ = JDiffusion(**diffusion_kw).sample(
            name, unet["jdenoise"], jax.random.PRNGKey(1), (B, PX, PX, 3), num_steps=steps,
            x_T=jnp.asarray(unet["x_T"]), return_uint8=False, **kw)
    unet["calls"].clear()
    with torch.no_grad():
        got, inter = GaussianDiffusion(**diffusion_kw).sample(
            name, unet["tdenoise"], torch.Generator().manual_seed(0), (B, PX, PX, 3),
            device=CPU, num_steps=steps, x_T=torch.from_numpy(unet["x_T"]),
            return_uint8=False, **kw)
    _compare(want, got)
    return len(unet["calls"]), inter


# (name, steps, GaussianDiffusion kwargs, sample kwargs, model calls)
DETERMINISTIC = [
    ("plms", 4, {}, {}, 5),
    ("pndm", 4, {}, {}, 13),
    ("ddim_continuous", 4, {"beta_schedule": "cosine"}, {}, 4),
]


@pytest.mark.parametrize("name,steps,diff_kw,kw,calls", DETERMINISTIC,
                         ids=[c[0] for c in DETERMINISTIC])
def test_deterministic_trajectory_matches(unet, name, steps, diff_kw, kw, calls):
    n_calls, inter = _sample_both(unet, name, steps, diff_kw, **kw)
    assert n_calls == calls
    slots = 1 if name == "pndm" else steps
    assert tuple(inter["x_inter"].shape) == (slots, B, PX, PX, 3)


def test_edm_without_churn_matches(unet):
    with jax.disable_jit():
        want, _ = jedm.edm_sample(unet["jdenoise"], jax.random.PRNGKey(1), (B, PX, PX, 3),
                                  num_steps=4, s_churn=0.0, x_T=jnp.asarray(unet["x_T"]))
    unet["calls"].clear()
    with torch.no_grad():
        got, inter = tedm.edm_sample(unet["tdenoise"], torch.Generator(), (B, PX, PX, 3),
                                     device=CPU, num_steps=4, s_churn=0.0,
                                     x_T=torch.from_numpy(unet["x_T"]))
    _compare(want, got)
    assert len(unet["calls"]) == 8   # Heun on every step
    np.testing.assert_array_equal(inter["x_inter"][-1].numpy(), got.numpy())


# (name, steps, GaussianDiffusion kwargs, sample kwargs, JAX noise sources, port modules)
STOCHASTIC = [
    ("native", None, {"num_timesteps": 8}, {}, [(jddpm, "noise_like")], [tddpm]),
    ("tero", 4, {}, {}, [(jax.random, "normal")], [tedm]),
    ("vdm", 4, {"beta_schedule": "cosine"}, {}, [(jcont, "noise_like")], [tcont]),
    ("ddim_continuous", 4, {"beta_schedule": "cosine"}, {"ddim_eta": 0.5},
     [(jddim, "noise_like")], [tddim]),
]


@pytest.mark.parametrize("name,steps,diff_kw,kw,jax_noise,torch_noise", STOCHASTIC,
                         ids=[c[0] for c in STOCHASTIC])
def test_stochastic_trajectory_matches_under_fixed_noise(monkeypatch, unet, name, steps, diff_kw,
                                                         kw, jax_noise, torch_noise):
    _fix_noise(monkeypatch, unet, jax_noise, torch_noise)
    n_calls, _ = _sample_both(unet, name, steps, diff_kw, **kw)
    assert n_calls == {"native": 8, "tero": 8}.get(name, steps)
    monkeypatch.undo()
    # the noise enters: a different draw moves the sample
    with torch.no_grad():
        a, _ = GaussianDiffusion(**diff_kw).sample(
            name, unet["tdenoise"], torch.Generator().manual_seed(0), (B, PX, PX, 3),
            device=CPU, num_steps=steps, x_T=torch.from_numpy(unet["x_T"]), **kw)
        b, _ = GaussianDiffusion(**diff_kw).sample(
            name, unet["tdenoise"], torch.Generator().manual_seed(1), (B, PX, PX, 3),
            device=CPU, num_steps=steps, x_T=torch.from_numpy(unet["x_T"]), **kw)
    assert not torch.equal(a, b)
