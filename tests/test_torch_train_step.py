"""The port's training step (`training/state.py make_train_step`) against the
JAX package's, float32 on the CPU.

A tiny `UNetModel` (model_channels 32, channel_mult (1, 2), one res block,
attention at 8×8, 16×16 images, B = 4, dropout 0, cond_dim 10) starts from
the same perturbed weights (every leaf nonzero, so every gradient is) and
takes 2 steps on both sides with the JAX package's loss draws handed to the
port (`make_train_step(..., fast_dropout_rng=False)` draws them with
`fold_in(rng, step)`, `split`, then `p_losses`' three keys).  Compared:
loss and grad_norm (1e-4 relative), params, EMA, μ, ν (relative to each
tree's largest value: 1e-4 for the params and the EMA after lr-1e-3 steps,
1e-3 for μ and ν, which hold the gradients the UNet computes to ~1e-4).
One exception: a bias that feeds a GroupNorm whose groups hold one channel
(32 channels: the conv1 biases of the 32-channel blocks, and the last
block's output biases before the final GroupNorm) has a vanishing gradient,
because the GroupNorm removes any per-channel constant.  Both sides hold
f32 noise there and Adam turns it into steps of up to lr; for those leaves
(reference μ below 1e-5 of the tree's largest, biases only) the parameters
are held to Adam's bound, 2·lr per step.
Plus: the train-state bridge round trip, the eval step, and
`python -m sgdm_tpu_torch.train` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sgdm_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from sgdm_tpu.models.unet import UNetModel as JUNetModel
from sgdm_tpu.training import optim as joptim
from sgdm_tpu.training.state import create_train_state as jax_create_train_state
from sgdm_tpu.training.state import make_eval_step as jax_make_eval_step
from sgdm_tpu.training.state import make_train_step as jax_make_train_step
from sgdm_tpu_torch import train as train_cli
from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
from sgdm_tpu_torch.models.convert import from_flax, train_state_from_flax, train_state_to_flax
from sgdm_tpu_torch.models.factory import create_denoiser
from sgdm_tpu_torch.training import optim as toptim
from sgdm_tpu_torch.training.state import (create_train_state, make_eval_step,
                                           make_train_step)

from torch_port_common import perturbed_flat, unflatten

CFG = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
           num_heads=4, cond_dim=10, resblock_updown=True, dropout=0.0)
B, PX, STEPS = 4, 16, 2
SCHED = dict(warm_up_steps=2, f_start=0.5)
OPT = dict(lr=1e-3, wd=0.01)
DROP = 0.5


def _batch():
    rng = np.random.default_rng(0)
    return {"image": rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32),
            "cond": np.eye(10, dtype=np.float32)[[1, 4, 7, 9]]}


def _jax_draws(rng, step, k):
    """The loss draws of the JAX train step at ``step`` (fast_dropout_rng=False)."""
    loss_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    out = []
    for i in range(k):
        r = loss_rng if k == 1 else jax.random.fold_in(loss_rng, i)
        t_key, noise_key, drop_key = jax.random.split(r, 3)
        m = B // k
        out.append({"t": np.array(jax.random.randint(t_key, (m,), 0, 1000)),
                    "noise": np.array(jax.random.normal(noise_key, (m, PX, PX, 3))),
                    "drop_mask": np.array(jax.random.uniform(drop_key, (m,)) < DROP)})
    return out


def _flatten_state(state):
    adam = state.opt_state[0]
    f = lambda tree: {k: np.asarray(v) for k, v in
                      traverse_util.flatten_dict(jax.tree.map(np.asarray, tree), sep="/").items()}
    return {"step": int(state.step), "count": int(adam.count),
            "schedule_count": int(state.opt_state[2].count),
            "ema_updates": int(state.ema_updates), "params": f(state.params),
            "ema_params": f(state.ema_params), "mu": f(adam.mu), "nu": f(adam.nu)}


def _setup():
    batch = _batch()
    jm = JUNetModel(use_pallas=False, **CFG)
    jtx = joptim.create_optimizer("adamw", scheduler=SCHED, **OPT)
    jstate = jax_create_train_state(jm, jtx, jax.random.PRNGKey(0),
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    {"cond": jnp.asarray(batch["cond"])})
    flat = perturbed_flat(jstate.params, seed=1)
    params = unflatten(flat)
    jstate = jstate.replace(params=params, ema_params=jax.tree.map(jnp.copy, params))
    tm = create_denoiser(**CFG)
    tm.load_state_dict(from_flax(flat, tm))
    return batch, jm, jtx, jstate, tm


def _assert_tree_close(got, ref, rel, what, noise_leaves=()):
    scale = max(np.abs(v).max() for v in ref.values())
    assert got.keys() == ref.keys(), what
    for key, r in ref.items():
        atol = 2 * OPT["lr"] * STEPS if key in noise_leaves else rel * scale
        np.testing.assert_allclose(got[key], r, rtol=0, atol=atol, err_msg=f"{what} {key}")


@pytest.mark.parametrize("accum,fused", [(1, True), (2, True), (2, False)],
                         ids=["accum1-fused", "accum2-fused", "accum2-optax"])
def test_two_steps_match_jax(accum, fused):
    batch, jm, jtx, jstate, tm = _setup()
    rng = jax.random.PRNGKey(7)
    hp = dict(lr_schedule=joptim.lambda_linear_schedule(OPT["lr"], **SCHED), beta1=0.9,
              beta2=0.999, eps=1e-8, weight_decay=OPT["wd"])
    jstep = jax_make_train_step(jm, JGaussianDiffusion(), jtx, cond_drop_prob=DROP,
                                ema_decay=0.99, accumulate_grad_batches=accum,
                                fast_dropout_rng=False, fused_optim=fused, optim_hparams=hp)
    ttx = toptim.create_optimizer("adamw", scheduler=SCHED, **OPT)
    tstate = create_train_state(tm, ttx, device="cpu")
    tstep = make_train_step(tm, GaussianDiffusion(), ttx, cond_drop_prob=DROP, ema_decay=0.99,
                            accumulate_grad_batches=accum, fused_optim=fused, device="cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for s in range(STEPS):
        draws = _jax_draws(rng, s, accum)
        jstate, jmet = jstep(jstate, jb, rng)
        tstate, tmet = tstep(tstate, batch, draws=draws)
        for key in ("loss", "ddpm_loss", "grad_norm"):
            np.testing.assert_allclose(tmet[key].item(), float(jmet[key]), rtol=1e-4,
                                       err_msg=f"step {s} {key}")
        np.testing.assert_array_equal(tmet["epoch_stats_x"].numpy(),
                                      np.asarray(jmet["epoch_stats_x"]))
        np.testing.assert_allclose(tmet["epoch_stats_y"].numpy(),
                                   np.asarray(jmet["epoch_stats_y"]), rtol=1e-4)
    ref, got = _flatten_state(jstate), train_state_to_flax(tstate, tm)
    for key in ("step", "count", "schedule_count", "ema_updates"):
        assert got[key] == ref[key] == STEPS, key
    mu_scale = max(np.abs(v).max() for v in ref["mu"].values())
    noise = {k for k, v in ref["mu"].items() if np.abs(v).max() < 1e-5 * mu_scale}
    assert noise and all(k.endswith("/bias") for k in noise), noise
    for key, rel in (("params", 1e-4), ("ema_params", 1e-4), ("mu", 1e-3), ("nu", 1e-3)):
        _assert_tree_close(got[key], ref[key], rel, key, noise)
    moved = max(np.abs(got["params"][k] - v).max() for k, v in
                _flatten_state(_setup()[3])["params"].items())
    assert moved > 1e-4  # the steps did move the parameters


def test_train_state_bridge_round_trip():
    _, _, _, jstate, tm = _setup()
    tree = _flatten_state(jstate)
    # a state part-way through training: every tree distinct, counts nonzero
    for i, key in enumerate(("ema_params", "mu", "nu")):
        tree[key] = perturbed_flat(unflatten(tree[key]), seed=10 + i)
    tree.update(step=5, count=5, schedule_count=5, ema_updates=4)
    state = train_state_from_flax(tree, tm, device="cpu")
    assert (state.step, state.opt_state.count, state.ema_updates) == (5, 5, 4)
    back = train_state_to_flax(state, tm)
    for key in ("params", "ema_params", "mu", "nu"):
        assert back[key].keys() == tree[key].keys()
        for leaf, v in tree[key].items():
            np.testing.assert_array_equal(back[key][leaf], v)
    # the model's parameters are views of the state's flat buffer
    p = dict(tm.named_parameters())["backbone.in_conv.weight"]
    np.testing.assert_array_equal(p.detach().numpy().transpose(2, 3, 1, 0),
                                  tree["params"]["backbone/in_conv/kernel"])
    with pytest.raises(KeyError, match="left over"):
        train_state_from_flax(dict(tree, stray=0), tm, device="cpu")
    bad = dict(tree, mu={k: v for k, v in tree["mu"].items() if not k.endswith("qkv/bias")})
    with pytest.raises(KeyError, match="missing"):
        train_state_from_flax(bad, tm, device="cpu")


def test_eval_step_matches_jax():
    batch, jm, jtx, jstate, tm = _setup()
    rng = jax.random.PRNGKey(5)
    ref = jax_make_eval_step(jm, JGaussianDiffusion())(
        jstate.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng, cond_drop_prob=DROP)
    t_key, noise_key, drop_key = jax.random.split(rng, 3)
    draws = {"t": np.array(jax.random.randint(t_key, (B,), 0, 1000)),
             "noise": np.array(jax.random.normal(noise_key, (B, PX, PX, 3))),
             "drop_mask": np.array(jax.random.uniform(drop_key, (B,)) < DROP)}
    tstate = create_train_state(tm, toptim.create_optimizer("adamw"), device="cpu")
    got = make_eval_step(tm, GaussianDiffusion(), device="cpu")(
        tstate.ema_params, tstate, batch, cond_drop_prob=DROP, draws=draws)
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-4)


def test_train_cli_on_cpu(capsys):
    result = train_cli.main(["--batch-size", "2", "--steps", "2", "--image-size", "16",
                             "--model-channels", "32", "--cond-dim", "10", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    import json

    steps = [json.loads(line) for line in lines[:2]]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) and s["grad_norm"] > 0 for s in steps)
    assert result["timed_steps"] == 1 and result["samples_per_s"] > 0
