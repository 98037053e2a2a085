"""Schedule, DDIM tables, x0 clipping and guidance of the port against the
JAX package (`sgdm_tpu.diffusion`).  Tables to rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.diffusion import guidance as jguid
from sgdm_tpu.diffusion import schedule as jsched
from sgdm_tpu.diffusion.samplers import ddim as jddim
from sgdm_tpu_torch.diffusion import guidance as tguid
from sgdm_tpu_torch.diffusion import schedule as tsched
from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
from sgdm_tpu_torch.diffusion.samplers import ddim as tddim


@pytest.mark.parametrize("beta_schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_tables_match(beta_schedule):
    js = jsched.DiffusionSchedule.create(beta_schedule=beta_schedule)
    ts = tsched.DiffusionSchedule.create(beta_schedule=beta_schedule)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_allclose(ts.f32(name),
                                   np.asarray(getattr(js, name)), rtol=1e-6, err_msg=name)


def test_linear_is_sqrt_space_and_ddim_offset():
    betas = tsched.make_beta_schedule("linear", 10, 1e-4, 2e-2)
    np.testing.assert_allclose(np.sqrt(betas), np.linspace(1e-2, np.sqrt(2e-2), 10))
    steps = tsched.make_ddim_timesteps("uniform", 50, 1000)
    assert steps[0] == 1 and steps[-1] == 981
    np.testing.assert_array_equal(steps, jsched.make_ddim_timesteps("uniform", 50, 1000))
    np.testing.assert_array_equal(tsched.make_ddim_timesteps("quad", 20, 1000),
                                  jsched.make_ddim_timesteps("quad", 20, 1000))


@pytest.mark.parametrize("steps,eta", [(50, 0.0), (25, 1.0), (4, 0.5)])
def test_ddim_tables_match(steps, eta):
    js = jsched.DiffusionSchedule.create()
    ts = tsched.DiffusionSchedule.create()
    jp = jddim.make_ddim_schedule(js, steps, eta=eta)
    tp = tddim.make_ddim_schedule(ts, steps, eta=eta)
    np.testing.assert_array_equal(tp.timesteps, jp.timesteps)
    for name in ("alphas", "alphas_prev", "sigmas", "sqrt_one_minus_alphas"):
        np.testing.assert_allclose(getattr(tp, name), np.asarray(getattr(jp, name)),
                                   rtol=1e-6, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("clip,dtp", [(True, 1.0), (False, 1.0), (True, 0.9)])
def test_clip_x0(clip, dtp):
    x = (np.random.default_rng(0).standard_normal((3, 4, 4, 3)) * 2.0).astype(np.float32)
    ref = jsched.clip_x0(jnp.asarray(x), clip, dtp)
    got = tsched.clip_x0(torch.from_numpy(x), clip, dtp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_unnormalize_to_uint8():
    x = np.linspace(-1.2, 1.2, 97, dtype=np.float32)
    ref = jsched.unnormalize_to_zero_to_255(jnp.asarray(x))
    got = tsched.unnormalize_to_zero_to_255(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("scale_type", ["imagen", "cfg"])
@pytest.mark.parametrize("w", [2.0, "per_sample"])
def test_guided_score(scale_type, w):
    rng = np.random.default_rng(1)
    z, zc = (rng.standard_normal((3, 2, 2, 3)).astype(np.float32) for _ in range(2))
    ww = np.asarray([0.5, 2.0, 3.0], np.float32) if w == "per_sample" else w
    ref = jguid.guided_score(jnp.asarray(z), jnp.asarray(zc), ww, scale_type)
    got = tguid.guided_score(torch.from_numpy(z), torch.from_numpy(zc),
                             torch.as_tensor(ww), scale_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _toy_apply(lib):
    """eps = x·(1 + t/1000) + 3·(cond visible), with the mask and batch recorded."""
    calls = []

    def apply(x, t, cond_drop_mask=None, cond=None):
        calls.append((int(x.shape[0]), np.asarray(cond_drop_mask).tolist()))
        keep = 1.0 - lib.asarray(cond_drop_mask).astype(lib.float32) \
            if lib is jnp else 1.0 - cond_drop_mask.float()
        scale = 1.0 + t.reshape(-1, 1, 1, 1) / 1000.0
        return x * scale + 3.0 * (cond[:, :1, None, None] * keep.reshape(-1, 1, 1, 1))

    return apply, calls


@pytest.mark.parametrize("scale_type", ["imagen", "cfg"])
@pytest.mark.parametrize("cond_scale", [0, 1, 1.0, 2.0, "tensor_one"])
def test_guided_denoiser_fast_paths_and_cfg_quirk(scale_type, cond_scale):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2, 2, 1)).astype(np.float32)
    t = np.asarray([10, 500], np.int32)
    cond = rng.standard_normal((2, 3)).astype(np.float32)
    japply, jcalls = _toy_apply(jnp)
    tapply, tcalls = _toy_apply(torch)
    jw = jnp.asarray(1.0) if cond_scale == "tensor_one" else cond_scale
    tw = torch.tensor(1.0) if cond_scale == "tensor_one" else cond_scale
    ref = jguid.make_guided_denoiser(japply, scale_type)(
        jnp.asarray(x), jnp.asarray(t), cond_scale=jw, cond=jnp.asarray(cond))
    got = tguid.make_guided_denoiser(tapply, scale_type)(
        torch.from_numpy(x), torch.from_numpy(t), cond_scale=tw, cond=torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert tcalls == jcalls
    if cond_scale in (0, 1, 1.0):
        assert len(tcalls) == 1 and tcalls[0][0] == 2  # one single-batch pass
    else:
        # concat-double: conditional half first
        assert tcalls == [(4, [False, False, True, True])]


def test_unknown_sampler_raises_keyerror():
    with pytest.raises(KeyError, match="euler"):
        GaussianDiffusion().sample("euler", lambda x, t: x, torch.Generator(), (1, 4, 4, 3),
                                   device=torch.device("cpu"))
