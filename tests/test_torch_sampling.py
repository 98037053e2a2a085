"""Guided DDIM sampling of the port against the JAX package: the tiny UNet,
4 steps, eta 0, cond_scale 2.0, 'imagen', from a shared x_T.  float32
images within 1e-3 abs, uint8 within 1.  Also `generate(device="cpu")`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.diffusion.core import GaussianDiffusion as JDiffusion
from sgdm_tpu.diffusion.guidance import make_guided_denoiser as jguided
from sgdm_tpu.diffusion.schedule import unnormalize_to_zero_to_255
from sgdm_tpu.models.unet import UNetModel as JUNetModel
from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
from sgdm_tpu_torch.generate import generate
from sgdm_tpu_torch.models.convert import from_flax
from sgdm_tpu_torch.models.factory import UNET_FAST_IN64, create_denoiser
from sgdm_tpu_torch.training.state import make_sample_fn

from torch_port_common import SMALL_UNET, perturbed_flat, unflatten

B, PX, STEPS = 2, 16, 4


@pytest.fixture(scope="module")
def trajectories():
    jm = JUNetModel(use_pallas=False, **SMALL_UNET)
    rng = np.random.default_rng(5)
    x_T = rng.standard_normal((B, PX, PX, 3)).astype(np.float32)
    cond = np.eye(10, dtype=np.float32)[[2, 8]]
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x_T),
                            jnp.zeros((B,), jnp.int32), cond=jnp.asarray(cond))["params"]
    flat = perturbed_flat(params, seed=6)
    jparams = unflatten(flat)

    def apply_fn(x, t, cond_drop_mask=None, **kw):
        return jm.apply({"params": jparams}, x, t, cond_drop_mask=cond_drop_mask, **kw)

    guided = jguided(apply_fn, scale_type="imagen")
    denoise = lambda x, t: guided(x, t, cond_scale=2.0, cond=jnp.asarray(cond))
    out = {}
    with jax.disable_jit():  # the 4-step scan runs op by op: no compile
        img, _ = JDiffusion().sample("ddim", denoise, jax.random.PRNGKey(1),
                                     x_T.shape, num_steps=STEPS, x_T=jnp.asarray(x_T),
                                     return_uint8=False)
    out[("jax", False)] = np.asarray(img)
    # the uint8 result of the same trajectory (what return_uint8=True applies)
    out[("jax", True)] = np.asarray(unnormalize_to_zero_to_255(img))

    tm = create_denoiser(**SMALL_UNET)
    tm.load_state_dict(from_flax(flat, tm))
    for uint8 in (False, True):
        sample = make_sample_fn(tm, GaussianDiffusion(), num_steps=STEPS, cond_scale=2.0,
                                scale_type="imagen", return_uint8=uint8, device="cpu")
        img, inter = sample(tm, torch.Generator().manual_seed(0), B, PX, 3,
                            cond=torch.from_numpy(cond), x_T=torch.from_numpy(x_T))
        out[("torch", uint8)] = img.numpy()
        out[("inter", uint8)] = inter
    return out


def test_float_trajectory_matches(trajectories):
    ref, got = trajectories[("jax", False)], trajectories[("torch", False)]
    assert got.shape == ref.shape == (B, PX, PX, 3)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_uint8_trajectory_matches(trajectories):
    ref, got = trajectories[("jax", True)], trajectories[("torch", True)]
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_progressive_log_holds_last_state(trajectories):
    inter = trajectories[("inter", False)]
    assert tuple(inter["x_inter"].shape) == (STEPS, B, PX, PX, 3)
    np.testing.assert_array_equal(inter["x_inter"][-1].numpy(), trajectories[("torch", False)])


def test_generate_on_cpu_returns_uint8_images():
    cfg = dict(UNET_FAST_IN64, image_size=PX, **SMALL_UNET)
    imgs = generate(cfg, n=3, batch_size=2, steps=STEPS, cond_scale=2.0, labels=[1, 4],
                    seed=0, device="cpu", dtype=torch.float32)
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (3, PX, PX, 3)
    again = generate(cfg, n=3, batch_size=2, steps=STEPS, cond_scale=2.0, labels=[1, 4],
                     seed=0, device="cpu", dtype=torch.float32)
    torch.testing.assert_close(imgs, again, rtol=0, atol=0)
