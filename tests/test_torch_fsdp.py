"""FSDP over the port's flat train state (`sgdm_tpu_torch/parallel/fsdp.py`)
against the JAX package's (`sgdm_tpu/parallel/fsdp.py`), on the CPU.

Four gloo ranks run in spawned children that import nothing of JAX (one
spawn for the module); JAX runs in this process on the 8 CPU devices of
`tests/conftest.py`.  The setup is tests/test_fsdp.py's (model_channels
32, channel_mult (1, 2), cond_dim 16, 50 diffusion steps, AdamW at lr 1e-3
without a schedule, a batch of 8 normal images), with every leaf perturbed
nonzero (the zero-initialised output convs would zero every upstream
gradient) and the JAX draws handed to the port.

  * FSDP over a 4-rank data axis against the JAX FSDP step on its 8-device
    mesh (tests/test_fsdp.py:124), 2 steps: loss and grad_norm within 1e-4
    relative, the state at tests/test_torch_train_step.py's tolerances
    (`torch_port_common.assert_state_trees_close`: an element whose
    first gradient in the JAX run is nonzero f32 rounding, below 2^-23 of
    the largest, is held to Adam's bound, 2·lr a step; such elements are
    printed, and outside the qkv biases' key thirds they may be at most
    0.5 % of a leaf and 0.1 % of the tree);
  * the hybrid FSDP + tensor-parallel step on a (data 2, model 2) mesh
    against the JAX hybrid step on (4, 2) (tests/test_fsdp.py:158), the same;
  * FSDP with 2 accumulated micro-batches against the port's one-rank step
    (the generators' draws): losses within 1e-4, the same state tolerances;
  * each rank's μ, ν and EMA are a quarter of the whole (padded to
    aligned shards), the params whole;
  * a hybrid checkpoint restores at world 1 bit for bit, and a world-1
    checkpoint restores bit for bit into the FSDP and the hybrid layouts.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sgdm_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from sgdm_tpu.models import UNetModel as JUNetModel
from sgdm_tpu.parallel.fsdp import state_sharding as jax_state_sharding
from sgdm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from sgdm_tpu.parallel.mesh import shard_batch as jax_shard_batch
from sgdm_tpu.training.optim import create_optimizer as jax_create_optimizer
from sgdm_tpu.training.state import create_train_state as jax_create_train_state
from sgdm_tpu.training.state import make_train_step as jax_make_train_step
from sgdm_tpu_torch.models.convert import from_flax
from sgdm_tpu_torch.parallel.fsdp import ALIGN
from sgdm_tpu_torch.parallel.launch import spawn
from sgdm_tpu_torch.training.checkpoints import CheckpointManager

import torch_ranks
from torch_port_common import (assert_state_trees_close, host_state_tree,
                               jax_draws, jax_state_tree, perturbed_flat, unflatten)

CFG = dict(model_channels=32, out_channels=3, num_res_blocks=1, channel_mult=(1, 2),
           attention_resolutions=(2,), num_heads=4, resblock_updown=True, cond_dim=16)
B, PX, T, STEPS, WORLD = 8, 16, 50, 2, 4
OPT = dict(lr=1e-3)


def _jax_setup():
    model = JUNetModel(**CFG)
    tx = jax_create_optimizer("adamw", lr=1e-3, scheduler=None)
    batch = {"image": jax.random.normal(jax.random.PRNGKey(7), (B, PX, PX, 3)),
             "cond": jax.nn.one_hot(jnp.arange(B) % 16, 16)}
    state = jax_create_train_state(model, tx, jax.random.PRNGKey(0), batch,
                                   {"cond": batch["cond"]})
    flat = perturbed_flat(state.params, seed=2)
    params = unflatten(flat)
    return model, tx, state.replace(params=params, ema_params=jax.tree.map(jnp.copy, params)), \
        batch, flat


def _jax_steps(model, tx, state, batch, mesh, sh, rng):
    step = jax_make_train_step(model, JGaussianDiffusion(num_timesteps=T), tx,
                               cond_drop_prob=0.0, fast_dropout_rng=False, mesh=mesh,
                               state_shardings=sh)
    state = jax.device_put(jax.tree.map(jnp.copy, state), sh)  # the step donates its state
    mets, mu1 = [], None
    for _ in range(STEPS):
        state, met = step(state, jax_shard_batch(batch, mesh), rng)
        mets.append(jax.tree.map(np.asarray, met))
        if mu1 is None:  # (1 − β1)·g of the first step
            mu1 = {k: np.array(v) for k, v in jax_state_tree(state)["mu"].items()}
    return jax_state_tree(state), mets, mu1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    jm, jtx, jstate, jbatch, flat = _jax_setup()
    tm = torch_ranks.build_model("unet", CFG)
    sd = {k: v.clone() for k, v in from_flax(flat, tm).items()}
    batch = {k: np.array(v) for k, v in jbatch.items()}
    rng = jax.random.PRNGKey(1)
    draws = [jax_draws(rng, s, 1, B, PX, 0.0, T) for s in range(STEPS)]
    common = dict(family="unet", cfg=CFG, state_dict=sd, batch=batch, opt=OPT, num_timesteps=T)
    torch_ranks.train_case(steps=1, ckpt_out=str(tmp / "ck1"), **common)
    cases = [
        ("fsdp", "train_case", dict(mesh_shape=(WORLD, 1), fsdp=True, draws=draws, **common)),
        ("hybrid", "train_case", dict(mesh_shape=(2, 2), fsdp=True, draws=draws,
                                      ckpt_out=str(tmp / "ck_hybrid"), **common)),
        ("accum", "train_case", dict(mesh_shape=(WORLD, 1), fsdp=True, accum=2, seed=3,
                                     **common)),
        ("restore_fsdp", "train_case", dict(mesh_shape=(WORLD, 1), fsdp=True, steps=0,
                                            ckpt_in=str(tmp / "ck1"), **common)),
        ("restore_hybrid", "train_case", dict(mesh_shape=(2, 2), fsdp=True, steps=0,
                                              ckpt_in=str(tmp / "ck1"), **common)),
    ]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn, torch_ranks.run_cases, WORLD, (WORLD, str(tmp / "store"), cases),
                        timeout=300)
        devs = jax.devices("cpu")
        mesh = jax_create_mesh(devs)  # tests/test_fsdp.py:124: ('data',) × 8
        fsdp = _jax_steps(jm, jtx, jstate, jbatch, mesh, jax_state_sharding(jstate, mesh), rng)
        mesh2 = Mesh(np.asarray(devs[:8]).reshape(4, 2), ("data", "model"))  # :158
        hybrid = _jax_steps(jm, jtx, jstate, jbatch, mesh2, jax_state_sharding(jstate, mesh2),
                            rng)
        accum1 = torch_ranks.train_case(accum=2, seed=3, **common)
        ranks = fut.result()
    return dict(ranks=ranks, jax={"fsdp": fsdp, "hybrid": hybrid}, accum1=accum1,
                model=tm, tmp=tmp)


def test_ranks_import_nothing_of_jax(runs):
    assert [r["jax_modules"] for r in runs["ranks"]] == [[]] * WORLD


@pytest.mark.parametrize("case", ["fsdp", "hybrid"])
def test_step_matches_jax(runs, case):
    """FSDP (data 4) against tests/test_fsdp.py:124, hybrid FSDP + TP (2 × 2)
    against :158; tolerances of tests/test_torch_train_step.py."""
    ref, jmets, mu1 = runs["jax"][case]
    for r in runs["ranks"]:
        got = r[case]
        for s, jmet in enumerate(jmets):
            for key in ("loss", "ddpm_loss", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][s][key], jmet[key], rtol=1e-4,
                                           err_msg=f"{case} step {s} {key}")
    state = runs["ranks"][0][case]["state"]
    assert_state_trees_close(host_state_tree(state, runs["model"]), ref, lr=OPT["lr"],
                             steps=STEPS, what=case, first_grads=mu1)
    for r in runs["ranks"][1:]:  # every rank gathers the same whole state
        for key in ("params", "ema_params", "mu", "nu"):
            np.testing.assert_array_equal(r[case]["state"][key], state[key])


def test_accumulation_matches_one_rank(runs):
    got, ref = runs["ranks"][0]["accum"], runs["accum1"]
    for s in range(STEPS):
        for key in ("loss", "ddpm_loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][s][key], ref["metrics"][s][key], rtol=1e-4)
    assert_state_trees_close(host_state_tree(got["state"], runs["model"]),
                             host_state_tree(ref["state"], runs["model"]), lr=OPT["lr"],
                             steps=STEPS, what="accumulation")


def test_state_bytes_drop_by_the_data_axis(runs):
    """Each rank's shard: a quarter of the parameters, rounded up to
    `fsdp.ALIGN` elements (aligned starts); the params whole, padded."""
    whole = runs["accum1"]["bytes"]
    n = whole["params"] // 4
    per = -(-(-(-n // WORLD)) // ALIGN) * ALIGN
    for r in runs["ranks"]:
        got = r["fsdp"]["bytes"]
        assert got["params"] == per * WORLD * 4
        assert got["mu"] == got["nu"] == got["ema_params"] == per * 4
        assert per * 4 <= whole["mu"] / WORLD + 4 * ALIGN


def test_checkpoints_restore_across_layouts(runs):
    from sgdm_tpu_torch.training.optim import create_optimizer
    from sgdm_tpu_torch.training.state import create_train_state

    model = torch_ranks.build_model("unet", CFG)
    template = create_train_state(model, create_optimizer("adamw", **OPT), device="cpu")
    restored = CheckpointManager(runs["tmp"] / "ck_hybrid").restore(template)
    want = runs["ranks"][0]["hybrid"]["state"]
    for key, flat in (("params", restored.params), ("ema_params", restored.ema_params),
                      ("mu", restored.opt_state.mu), ("nu", restored.opt_state.nu)):
        np.testing.assert_array_equal(flat.numpy(), want[key], err_msg=key)
    for case in ("restore_fsdp", "restore_hybrid"):
        assert [r[case]["restored_equal"] for r in runs["ranks"]] == [True] * WORLD, case
