"""The cross-attention slice as a whole against the JAX package, float32 on
the CPU: a tiny `UNetCAModel` (model_channels 32, channel_mult (1, 2), one
res block, `AttentionLR` at 8×8, 16×16 images, ``stegoclusterlayout``: n-hot
``cond`` and a one-hot ``layout`` 5 classes deep) with every flax leaf
perturbed and bridged.

  * Guided DDIM: 4 steps, eta 0, cond_scale 2.0, 'imagen', from a shared
    x_T, so the CFG double carries the layout and the model zeroes the
    unconditional half's.  float32 images within 1e-3 abs, uint8 within 1
    (the tolerances of the `UNetModel` trajectory test).
  * Two `make_train_step` steps (fused AdamW+EMA update, condition drop 0.5)
    with the JAX package's loss draws handed to the port, the layout shipped
    once as f32 one-hot maps and once as uint8 id masks: loss and grad_norm
    1e-4 relative; params and EMA 1e-4, μ and ν 1e-3 of each tree's largest
    value.  As in `test_torch_train_step.py`, biases that feed a GroupNorm
    with one channel per group have vanishing gradients (f32 noise on both
    sides) and are held to Adam's bound, 2·lr per step.
  * `generate` and `python -m sgdm_tpu_torch.train --family unetca` on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sgdm_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from sgdm_tpu.diffusion.guidance import make_guided_denoiser as jguided
from sgdm_tpu.diffusion.schedule import unnormalize_to_zero_to_255
from sgdm_tpu.models.unet import UNetCAModel as JUNetCAModel
from sgdm_tpu.training import optim as joptim
from sgdm_tpu.training.state import create_train_state as jax_create_train_state
from sgdm_tpu.training.state import make_train_step as jax_make_train_step
from sgdm_tpu_torch import train as train_cli
from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
from sgdm_tpu_torch.generate import generate
from sgdm_tpu_torch.models.convert import from_flax, train_state_to_flax
from sgdm_tpu_torch.models.factory import UNETCA_FAST_VOC64, create_denoiser
from sgdm_tpu_torch.training import optim as toptim
from sgdm_tpu_torch.training.state import create_train_state, make_sample_fn, make_train_step

from torch_port_common import perturbed_flat, unflatten

K = 5
CFG = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
           num_heads=4, context_dim=8, cond_token_num=1, cond_dim=K,
           condition_method="stegoclusterlayout", dropout=0.0)
B, PX, STEPS = 4, 16, 2
SCHED = dict(warm_up_steps=2, f_start=0.5)
OPT = dict(lr=1e-3, wd=0.01)
DROP = 0.5


def _conditions(rng, b):
    ids = rng.integers(0, K, (b, PX, PX))
    layout = np.eye(K, dtype=np.float32)[ids]
    cond = (layout.max(axis=(1, 2)) > 0).astype(np.float32)
    return cond, layout, ids.astype(np.uint8)


def _models(example):
    jm = JUNetCAModel(use_pallas=False, **CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(example["image"]),
                            jnp.zeros((example["image"].shape[0],), jnp.int32),
                            cond=jnp.asarray(example["cond"]),
                            layout=jnp.asarray(example["layout"]))["params"]
    flat = perturbed_flat(shapes, seed=6)
    rng = np.random.default_rng(7)
    for key in flat:  # the leaves perturbed_flat knows no rule for
        if key.endswith("gamma"):
            flat[key] = (1 + 0.1 * rng.standard_normal(flat[key].shape)).astype(np.float32)
        elif key.endswith("null_kv"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(np.float32)
    tm = create_denoiser(**CFG, layout_dim=K)
    tm.load_state_dict(from_flax(flat, tm))
    return jm, tm, flat


@pytest.fixture(scope="module")
def trajectories():
    rng = np.random.default_rng(5)
    x_T = rng.standard_normal((2, PX, PX, 3)).astype(np.float32)
    cond, layout, ids = _conditions(rng, 2)
    jm, tm, flat = _models({"image": x_T, "cond": cond, "layout": layout})
    jparams = unflatten(flat)

    def apply_fn(x, t, cond_drop_mask=None, **kw):
        return jm.apply({"params": jparams}, x, t, cond_drop_mask=cond_drop_mask, **kw)

    guided = jguided(apply_fn, scale_type="imagen")
    denoise = lambda x, t: guided(x, t, cond_scale=2.0, cond=jnp.asarray(cond),
                                  layout=jnp.asarray(layout))
    out = {}
    with jax.disable_jit():  # the 4-step scan runs op by op: no compile
        img, _ = JGaussianDiffusion().sample("ddim", denoise, jax.random.PRNGKey(1), x_T.shape,
                                             num_steps=4, x_T=jnp.asarray(x_T),
                                             return_uint8=False)
    out["jax"] = np.asarray(img)
    out["jax_uint8"] = np.asarray(unnormalize_to_zero_to_255(img))
    for name, uint8, lay in (("torch", False, layout), ("torch_uint8", True, layout),
                             ("torch_ids", False, ids)):
        sample = make_sample_fn(tm, GaussianDiffusion(), num_steps=4, cond_scale=2.0,
                                scale_type="imagen", return_uint8=uint8, device="cpu")
        img, _ = sample(tm, torch.Generator().manual_seed(0), 2, PX, 3,
                        cond=torch.from_numpy(cond), layout=lay, x_T=torch.from_numpy(x_T))
        out[name] = img.numpy()
    return out


def test_float_trajectory_matches(trajectories):
    ref, got = trajectories["jax"], trajectories["torch"]
    assert got.shape == ref.shape == (2, PX, PX, 3)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_uint8_trajectory_matches(trajectories):
    ref, got = trajectories["jax_uint8"], trajectories["torch_uint8"]
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_id_mask_layout_gives_the_same_trajectory(trajectories):
    np.testing.assert_array_equal(trajectories["torch_ids"], trajectories["torch"])


def _jax_draws(rng, step):
    loss_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    t_key, noise_key, drop_key = jax.random.split(loss_rng, 3)
    return [{"t": np.array(jax.random.randint(t_key, (B,), 0, 1000)),
             "noise": np.array(jax.random.normal(noise_key, (B, PX, PX, 3))),
             "drop_mask": np.array(jax.random.uniform(drop_key, (B,)) < DROP)}]


def _flatten_state(state):
    adam = state.opt_state[0]
    f = lambda tree: {k: np.asarray(v) for k, v in
                      traverse_util.flatten_dict(jax.tree.map(np.asarray, tree), sep="/").items()}
    return {"params": f(state.params), "ema_params": f(state.ema_params), "mu": f(adam.mu),
            "nu": f(adam.nu)}


@pytest.mark.parametrize("wire", ["onehot", "uint8-ids"])
def test_two_train_steps_match_jax(wire):
    rng = np.random.default_rng(0)
    cond, layout, ids = _conditions(rng, B)
    batch = {"image": rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32), "cond": cond,
             "layout": layout}
    jm, tm, flat = _models(batch)
    jtx = joptim.create_optimizer("adamw", scheduler=SCHED, **OPT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jax_create_train_state(jm, jtx, jax.random.PRNGKey(0), jb,
                                    {"cond": jb["cond"], "layout": jb["layout"]})
    params = unflatten(flat)
    jstate = jstate.replace(params=params, ema_params=jax.tree.map(jnp.copy, params))
    hp = dict(lr_schedule=joptim.lambda_linear_schedule(OPT["lr"], **SCHED), beta1=0.9,
              beta2=0.999, eps=1e-8, weight_decay=OPT["wd"])
    jstep = jax_make_train_step(jm, JGaussianDiffusion(), jtx, cond_drop_prob=DROP,
                                ema_decay=0.99, fast_dropout_rng=False, fused_optim=True,
                                optim_hparams=hp)
    ttx = toptim.create_optimizer("adamw", scheduler=SCHED, **OPT)
    tstate = create_train_state(tm, ttx, device="cpu")
    tstep = make_train_step(tm, GaussianDiffusion(), ttx, cond_drop_prob=DROP, ema_decay=0.99,
                            fused_optim=True, device="cpu")
    tbatch = dict(batch, layout=ids) if wire == "uint8-ids" else batch
    key = jax.random.PRNGKey(7)
    dropped = 0
    for s in range(STEPS):
        draws = _jax_draws(key, s)
        jstate, jmet = jstep(jstate, jb, key)
        tstate, tmet = tstep(tstate, tbatch, draws=draws)
        dropped += int(draws[0]["drop_mask"].sum())
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(tmet[name].item(), float(jmet[name]), rtol=1e-4,
                                       err_msg=f"step {s} {name}")
    assert 0 < dropped < STEPS * B  # some layouts were zeroed, some kept
    ref, got = _flatten_state(jstate), train_state_to_flax(tstate, tm)
    mu_scale = max(np.abs(v).max() for v in ref["mu"].values())
    noise = {k for k, v in ref["mu"].items() if np.abs(v).max() < 1e-5 * mu_scale}
    assert all(k.endswith("/bias") for k in noise), noise
    for name, rel in (("params", 1e-4), ("ema_params", 1e-4), ("mu", 1e-3), ("nu", 1e-3)):
        scale = max(np.abs(v).max() for v in ref[name].values())
        assert got[name].keys() == ref[name].keys()
        for leaf, r in ref[name].items():
            atol = 2 * OPT["lr"] * STEPS if leaf in noise else rel * scale
            np.testing.assert_allclose(got[name][leaf], r, rtol=0, atol=atol,
                                       err_msg=f"{name} {leaf}")
    moved = max(np.abs(got["params"][k] - v).max() for k, v in flat.items())
    assert moved > 1e-4  # the steps did move the parameters


def test_generate_ca_on_cpu():
    cfg = dict(UNETCA_FAST_VOC64, image_size=PX, **CFG, layout_dim=K)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, K, (2, PX, PX))
    kw = dict(n=3, batch_size=2, steps=4, cond_scale=2.0, seed=0, device="cpu",
              dtype=torch.float32)
    imgs = generate(cfg, layout=ids, **kw)
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (3, PX, PX, 3)
    onehot = np.eye(K, dtype=np.float32)[ids]
    cond = (onehot.max(axis=(1, 2)) > 0).astype(np.float32)  # what generate derives itself
    torch.testing.assert_close(generate(cfg, layout=onehot, cond=cond, **kw), imgs, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="needs layouts"):
        generate(cfg, **kw)
    with pytest.raises(ValueError, match="outside"):
        generate(cfg, layout=ids + K, **kw)


def test_train_cli_ca_on_cpu(capsys):
    result = train_cli.main(["--family", "unetca", "--batch-size", "2", "--steps", "2",
                             "--image-size", "16", "--model-channels", "32", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [json.loads(line) for line in lines[:2]]
    assert len(lines) == 3 and [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) and s["grad_norm"] > 0 for s in steps)
    assert result["timed_steps"] == 1 and result["samples_per_s"] > 0
