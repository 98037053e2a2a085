"""Tensor parallelism of the port (`sgdm_tpu_torch/parallel/tp.py`) against
the JAX package's (`sgdm_tpu/parallel/tp.py`), on the CPU.

Two gloo ranks on a (data 1, model 2) mesh run in spawned children that
import nothing of JAX (one spawn for the module); JAX runs in this process
on the 8 CPU devices of `tests/conftest.py`.  The setups are
tests/test_tensor_parallel.py's (model_channels 32, channel_mult (1, 2),
cond_dim 16, 50 diffusion steps, AdamW at lr 1e-3 without a schedule, a
batch of 8), every leaf perturbed nonzero and the JAX draws handed to the
port.

  * the rule table, leaf by leaf, against `unet_param_pspecs` for the
    UNet and the cross-attention UNet at 2, 4 and 7 ranks (7: every leaf
    replicated), the sharded dim read in the port's layout;
  * the port's TP step against the JAX TP step on a (2, 4) mesh, 2 steps:
    UNet (tests/test_tensor_parallel.py:165) and the cross-attention UNet
    (:193): loss and grad_norm within 1e-4 relative, the state at
    tests/test_torch_train_step.py's tolerances
    (`torch_port_common.assert_state_trees_close`: an element whose
    first gradient in the JAX run is nonzero f32 rounding, below 2^-23 of
    the largest, is held to Adam's bound, 2·lr a step; such elements are
    printed, and outside the qkv biases' key thirds they may be at most
    0.5 % of a leaf and 0.1 % of the tree);
  * TP against the port's one-rank step on the same (plain) route with
    dropout 0.1, the generators' draws, 2 steps: the same tolerances (the
    row split's partial sums reorder the f32 sums as JAX's do);
  * a TP checkpoint restores at world 1 bit for bit, and a world-1
    checkpoint restores bit for bit into the TP layout.
"""

from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from sgdm_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from sgdm_tpu.models import UNetCAModel as JUNetCAModel
from sgdm_tpu.models import UNetModel as JUNetModel
from sgdm_tpu.parallel.mesh import shard_batch as jax_shard_batch
from sgdm_tpu.parallel.tp import state_sharding as jax_state_sharding
from sgdm_tpu.parallel.tp import unet_param_pspecs as jax_unet_param_pspecs
from sgdm_tpu.training.optim import create_optimizer as jax_create_optimizer
from sgdm_tpu.training.state import create_train_state as jax_create_train_state
from sgdm_tpu.training.state import make_train_step as jax_make_train_step
from sgdm_tpu_torch.models.convert import flax_key_to_torch, from_flax
from sgdm_tpu_torch.models.layers import ResBlock
from sgdm_tpu_torch.parallel.launch import spawn
from sgdm_tpu_torch.parallel.tp import unet_param_pspecs
from sgdm_tpu_torch.training.checkpoints import CheckpointManager

import torch_ranks
from torch_port_common import (assert_state_trees_close, first_step_grads, host_state_tree,
                               jax_draws, jax_state_tree, perturbed_flat, unflatten)

BASE = dict(model_channels=32, out_channels=3, num_res_blocks=1, channel_mult=(1, 2),
            attention_resolutions=(2,), num_heads=4, cond_dim=16)
FAMILIES = {"unet": (JUNetModel, dict(BASE, resblock_updown=True)),
            "unetca": (JUNetCAModel, dict(BASE, cond_token_num=1))}
B, PX, T, STEPS, WORLD = 8, 16, 50, 2, 2
OPT = dict(lr=1e-3)


def _jax_setup(family: str):
    cls, cfg = FAMILIES[family]
    model = cls(**cfg)
    tx = jax_create_optimizer("adamw", lr=1e-3, scheduler=None)
    batch = {"image": jax.random.normal(jax.random.PRNGKey(3), (B, PX, PX, 3)),
             "cond": jax.nn.one_hot(jnp.arange(B) % 16, 16)}
    state = jax_create_train_state(model, tx, jax.random.PRNGKey(0), batch,
                                   {"cond": batch["cond"]})
    flat = perturbed_flat(state.params, seed=4)
    params = unflatten(flat)
    return model, tx, state.replace(params=params, ema_params=jax.tree.map(jnp.copy, params)), \
        batch, flat


def _flax_dim(path: str, spec, shape) -> int | None:
    """The port-layout dim a JAX spec shards: HWIO → OIHW, [in, out] → [out, in]."""
    dims = [d for d, a in enumerate(tuple(spec)) if a == "model"]
    if not dims:
        return None
    d = dims[0]
    if path.endswith("/kernel"):
        return {4: {3: 0, 2: 1}, 2: {1: 0, 0: 1}}[len(shape)][d]
    return d


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("size", [2, 4, 7])
def test_rule_table_matches_jax(family, size):
    cls, cfg = FAMILIES[family]
    batch = {"image": jnp.zeros((2, PX, PX, 3)), "cond": jnp.zeros((2, 16))}
    shapes = jax.eval_shape(lambda: cls(**cfg).init(
        jax.random.PRNGKey(0), batch["image"], jnp.zeros((2,), jnp.int32),
        cond=batch["cond"])["params"])
    specs = jax_unet_param_pspecs(shapes, axis_size=size)
    flat_specs = {"/".join(str(k.key) for k in path): spec for path, spec in
                  jax.tree_util.tree_flatten_with_path(
                      specs, is_leaf=lambda x: isinstance(x, P))[0]}
    flat_shapes = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf in
                   jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {flax_key_to_torch(k): _flax_dim(k, spec, flat_shapes[k])
            for k, spec in flat_specs.items()}
    model = torch_ranks.build_model(family, cfg)
    got = unet_param_pspecs({n: p.shape for n, p in model.named_parameters()}, axis_size=size)
    assert got == want
    assert any(d is not None for d in got.values()) == (size != 7)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    setups, cases, models, drop = {}, [], {}, None
    for family in FAMILIES:
        jm, jtx, jstate, jbatch, flat = setups[family] = _jax_setup(family)
        cfg = FAMILIES[family][1]
        models[family] = torch_ranks.build_model(family, cfg)
        sd = {k: v.clone() for k, v in from_flax(flat, models[family]).items()}
        batch = {k: np.array(v) for k, v in jbatch.items()}
        draws = [jax_draws(jax.random.PRNGKey(1), s, 1, B, PX, 0.0, T) for s in range(STEPS)]
        common = dict(family=family, cfg=cfg, state_dict=sd, batch=batch, opt=OPT,
                      num_timesteps=T, flash=False)
        cases.append((family, "train_case", dict(mesh_shape=(1, WORLD), draws=draws, **common)))
        if family == "unet":
            drop = dict(common, cfg=dict(cfg, dropout=0.1), seed=5, cond_drop=0.5)
            torch_ranks.train_case(steps=1, ckpt_out=str(tmp / "ck1"), **common)
            cases += [("dropout", "train_case", dict(mesh_shape=(1, WORLD),
                                                     ckpt_out=str(tmp / "ck_tp"), **drop)),
                      ("restore", "train_case", dict(mesh_shape=(1, WORLD), steps=0,
                                                     ckpt_in=str(tmp / "ck1"), **common))]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn, torch_ranks.run_cases, WORLD, (WORLD, str(tmp / "store"), cases),
                        timeout=300)
        mesh = Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(2, 4), ("data", "model"))
        ref = {}
        for family, (jm, jtx, jstate, jbatch, _) in setups.items():
            sh = jax_state_sharding(jstate, mesh)
            step = jax_make_train_step(jm, JGaussianDiffusion(num_timesteps=T), jtx,
                                       cond_drop_prob=0.0, fast_dropout_rng=False, mesh=mesh,
                                       state_shardings=sh)
            state = jax.device_put(jstate, sh)
            mets, mu1 = [], None
            for _ in range(STEPS):
                state, met = step(state, jax_shard_batch(jbatch, mesh), jax.random.PRNGKey(1))
                mets.append(jax.tree.map(np.asarray, met))
                if mu1 is None:  # (1 − β1)·g of the first step
                    mu1 = {k: np.array(v) for k, v in jax_state_tree(state)["mu"].items()}
            ref[family] = (jax_state_tree(state), mets, mu1)
        # world 1 on TP's plain route: the ResBlock composition, as a shard takes it
        with mock.patch.object(ResBlock, "fused_route", lambda self, x, train: False):
            one = torch_ranks.train_case(return_grads=True, **drop)
        ranks = fut.result()
    return dict(ranks=ranks, ref=ref, one=one, models=models, tmp=tmp)


def test_ranks_import_nothing_of_jax(runs):
    assert [r["jax_modules"] for r in runs["ranks"]] == [[], []]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp_step_matches_jax(runs, family):
    """tests/test_tensor_parallel.py:165 (unet) and :193 (unetca) with the
    tolerances of tests/test_torch_train_step.py."""
    ref, jmets, mu1 = runs["ref"][family]
    for r in runs["ranks"]:
        for s, jmet in enumerate(jmets):
            for key in ("loss", "ddpm_loss", "grad_norm"):
                np.testing.assert_allclose(r[family]["metrics"][s][key], jmet[key], rtol=1e-4,
                                           err_msg=f"{family} step {s} {key}")
    state = runs["ranks"][0][family]["state"]
    assert_state_trees_close(host_state_tree(state, runs["models"][family]), ref,
                             lr=OPT["lr"], steps=STEPS, what=family,
                             first_grads=mu1)
    np.testing.assert_array_equal(runs["ranks"][1][family]["state"]["params"], state["params"])


def test_tp_with_dropout_matches_one_rank(runs):
    got, one = runs["ranks"][0]["dropout"], runs["one"]
    for s in range(STEPS):
        for key in ("loss", "ddpm_loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][s][key], one["metrics"][s][key],
                                       rtol=1e-4, err_msg=f"step {s} {key}")
    model = runs["models"]["unet"]
    assert_state_trees_close(host_state_tree(got["state"], model),
                             host_state_tree(one["state"], model), lr=OPT["lr"], steps=STEPS,
                             what="tp dropout", first_grads=first_step_grads(one, model))


def test_checkpoints_restore_across_layouts(runs):
    from sgdm_tpu_torch.training.optim import create_optimizer
    from sgdm_tpu_torch.training.state import create_train_state

    model = torch_ranks.build_model("unet", dict(FAMILIES["unet"][1], dropout=0.1))
    template = create_train_state(model, create_optimizer("adamw", **OPT), device="cpu")
    restored = CheckpointManager(runs["tmp"] / "ck_tp").restore(template)
    want = runs["ranks"][0]["dropout"]["state"]
    for key, flat in (("params", restored.params), ("ema_params", restored.ema_params),
                      ("mu", restored.opt_state.mu), ("nu", restored.opt_state.nu)):
        np.testing.assert_array_equal(flat.numpy(), want[key], err_msg=key)
    assert [r["restore"]["restored_equal"] for r in runs["ranks"]] == [True, True]
