"""Data parallelism of the port (`sgdm_tpu_torch/parallel/mesh.py`, the
train step over a ``('data',)`` mesh) against the JAX package, on the CPU.

Two gloo ranks run in spawned children that import nothing of JAX
(`torch_ranks.run_cases`, one spawn for the module); JAX runs in this
process on the CPU devices of `tests/conftest.py`.  The model is
tests/test_torch_train_step.py's (model_channels 32, channel_mult (1, 2),
16 px, every leaf perturbed nonzero), at a global batch of 8.

  * the port's 2-rank step against the JAX step on a 2-device data mesh,
    2 steps on the same draws (each rank handed its rows of the JAX
    draws): loss and grad_norm within 1e-4 relative, the per-sample
    statistics (t exact), and the state at test_torch_train_step's
    tolerances (`torch_port_common.assert_state_trees_close`: an element whose
    first gradient in the JAX run is nonzero f32 rounding, below 2^-23 of
    the largest, is held to Adam's bound, 2·lr a step; such elements are
    printed, and outside the qkv biases' key thirds they may be at most
    0.5 % of a leaf and 0.1 % of the tree);
  * world 2 against world 1 of the port, 3 steps with dropout 0.1 and the
    generators' own draws (every rank draws the global batch's and takes
    its rows; K4's plain dropout hash gets ``seed + row``): the same
    tolerances (after the first step Adam's steps on the vanishing-gradient
    biases move the losses by ~1e-5); the two ranks' states bit-equal;
  * a checkpoint written by rank 0 of world 2 restores at world 1 bit for
    bit, and one written at world 1 restores on both ranks bit for bit;
  * `FeatureStats.reduce_across_processes` with an empty rank equals one
    process's statistics of the other rank's rows (float64 sums of the same
    numbers and zeros: exact), and with rows on both ranks those of the
    concatenation within 1e-12;
  * `local_batch_slice` as the JAX package's, the data module's per-rank
    slice and the loader's rows of each shuffled global batch.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sgdm_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from sgdm_tpu.models.unet import UNetModel as JUNetModel
from sgdm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from sgdm_tpu.parallel.mesh import local_batch_slice as jax_local_batch_slice
from sgdm_tpu.parallel.mesh import shard_batch as jax_shard_batch
from sgdm_tpu.training import optim as joptim
from sgdm_tpu.training.state import create_train_state as jax_create_train_state
from sgdm_tpu.training.state import make_train_step as jax_make_train_step
from sgdm_tpu_torch.data.loader import DataLoader
from sgdm_tpu_torch.eval.metrics import FeatureStats
from sgdm_tpu_torch.models.convert import from_flax
from sgdm_tpu_torch.parallel.launch import spawn
from sgdm_tpu_torch.parallel.mesh import local_batch_slice
from sgdm_tpu_torch.training.checkpoints import CheckpointManager, read_state

import torch_ranks
from torch_port_common import (assert_state_trees_close, host_state_tree,
                               jax_draws, jax_state_tree, perturbed_flat, unflatten)

CFG = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
           num_heads=4, cond_dim=10, resblock_updown=True, dropout=0.0)
B, PX, STEPS, WORLD = 8, 16, 2, 2
SCHED = dict(warm_up_steps=2, f_start=0.5)
OPT = dict(lr=1e-3, wd=0.01)
DROP = 0.5
FID_DIM = 64


def _batch():
    rng = np.random.default_rng(0)
    return {"image": rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32),
            "cond": np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]}


def _fid_rows():
    rng = np.random.default_rng(3)
    return rng.standard_normal((7, FID_DIM)), rng.standard_normal((4, FID_DIM))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    batch = _batch()
    jm = JUNetModel(use_pallas=False, **CFG)
    jtx = joptim.create_optimizer("adamw", scheduler=SCHED, **OPT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jax_create_train_state(jm, jtx, jax.random.PRNGKey(0), jb, {"cond": jb["cond"]})
    flat = perturbed_flat(jstate.params, seed=1)
    params = unflatten(flat)
    jstate = jstate.replace(params=params, ema_params=jax.tree.map(jnp.copy, params))
    tm = torch_ranks.build_model("unet", CFG)
    sd = {k: v.clone() for k, v in from_flax(flat, tm).items()}
    rng = jax.random.PRNGKey(7)
    draws = [jax_draws(rng, s, 1, B, PX, DROP) for s in range(STEPS)]
    common = dict(family="unet", state_dict=sd, batch=batch, sched=SCHED, opt=OPT,
                  ema_decay=0.99, cond_drop=DROP)
    drop_cfg = dict(CFG, dropout=0.1)

    # a world-1 checkpoint for the ranks to restore
    torch_ranks.train_case(cfg=CFG, steps=1, ckpt_out=str(tmp / "ck1"), **common)
    rows0, rows1 = _fid_rows()
    cases = [
        ("ddp_jax", "train_case", dict(cfg=CFG, mesh_shape=(WORLD, 1), draws=draws, **common)),
        ("ddp_dropout", "train_case", dict(cfg=drop_cfg, mesh_shape=(WORLD, 1), steps=3, seed=11,
                                           ckpt_out=str(tmp / "ck2"), **common)),
        ("restore", "train_case", dict(cfg=CFG, mesh_shape=(WORLD, 1), steps=0,
                                       ckpt_in=str(tmp / "ck1"), **common)),
        ("fid_empty", "fid_reduce_case", dict(rows=[rows0, rows0[:0]], dim=FID_DIM)),
        ("fid_split", "fid_reduce_case", dict(rows=[rows0, rows1], dim=FID_DIM)),
        ("shard", "shard_case", dict(global_batch=B)),
    ]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn, torch_ranks.run_cases, WORLD, (WORLD, str(tmp / "store"), cases),
                        timeout=300)
        mesh = jax_create_mesh(jax.devices("cpu")[:WORLD])
        jstep = jax_make_train_step(jm, JGaussianDiffusion(), jtx, cond_drop_prob=DROP,
                                    ema_decay=0.99, fast_dropout_rng=False, mesh=mesh)
        js = jax.device_put(jstate, NamedSharding(mesh, P()))
        jmets, jmu1 = [], None
        for _ in range(STEPS):
            js, jmet = jstep(js, jax_shard_batch(jb, mesh), rng)
            jmets.append(jax.tree.map(np.asarray, jmet))
            if jmu1 is None:  # (1 − β1)·g of JAX's first step
                jmu1 = {k: np.array(v) for k, v in jax_state_tree(js)["mu"].items()}
        world1 = torch_ranks.train_case(cfg=drop_cfg, steps=3, seed=11, **common)
        no_dropout = torch_ranks.train_case(cfg=CFG, steps=1, seed=11, **common)
        ranks = fut.result()
    return dict(ranks=ranks, jax_state=jax_state_tree(js), jax_metrics=jmets, world1=world1,
                no_dropout=no_dropout, jax_mu1=jmu1, model=tm, tmp=tmp)


def test_ranks_import_nothing_of_jax(runs):
    assert [r["jax_modules"] for r in runs["ranks"]] == [[], []]


def test_ddp_step_matches_jax_data_parallel_step(runs):
    """Tolerances of tests/test_torch_train_step.py (see the module docstring)."""
    r0, r1 = (r["ddp_jax"] for r in runs["ranks"])
    for s, jmet in enumerate(runs["jax_metrics"]):
        for key in ("loss", "ddpm_loss", "grad_norm"):
            for r in (r0, r1):  # every rank holds the mean over the ranks
                np.testing.assert_allclose(r["metrics"][s][key], jmet[key], rtol=1e-4,
                                           err_msg=f"step {s} {key}")
        np.testing.assert_array_equal(
            np.concatenate([r0["metrics"][s]["epoch_stats_x"], r1["metrics"][s]["epoch_stats_x"]]),
            jmet["epoch_stats_x"])
        np.testing.assert_allclose(
            np.concatenate([r0["metrics"][s]["epoch_stats_y"], r1["metrics"][s]["epoch_stats_y"]]),
            jmet["epoch_stats_y"], rtol=1e-4)
    got = host_state_tree(r0["state"], runs["model"])
    assert_state_trees_close(got, runs["jax_state"], lr=OPT["lr"], steps=STEPS, what="ddp",
                             first_grads=runs["jax_mu1"])


def test_world2_equals_world1_with_dropout(runs):
    """3 steps, dropout 0.1 on both ResBlock routes, cond drop 0.5, the
    draws of the generators: world 2 takes the global batch's draws and
    masks, so it is world 1 up to the order of the sums."""
    r0 = runs["ranks"][0]["ddp_dropout"]
    w1 = runs["world1"]
    for s in range(3):
        for key in ("loss", "ddpm_loss", "grad_norm"):
            np.testing.assert_allclose(r0["metrics"][s][key], w1["metrics"][s][key], rtol=1e-4,
                                       err_msg=f"step {s} {key}")
    model = runs["model"]
    assert_state_trees_close(host_state_tree(r0["state"], model),
                             host_state_tree(w1["state"], model), lr=OPT["lr"], steps=3,
                             what="world 2 vs world 1")
    # the masks matter: the same step without dropout has another loss
    loss, plain = float(w1["metrics"][0]["loss"]), float(runs["no_dropout"]["metrics"][0]["loss"])
    assert abs(loss - plain) > 1e-3 * plain


def test_ranks_hold_bit_equal_states(runs):
    for case in ("ddp_jax", "ddp_dropout"):
        a, b = (r[case]["state"] for r in runs["ranks"])
        for key in ("params", "ema_params", "mu", "nu"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{case} {key}")


def test_checkpoints_restore_across_world_sizes(runs):
    # world 2 → world 1
    from sgdm_tpu_torch.training.optim import create_optimizer
    from sgdm_tpu_torch.training.state import create_train_state

    model = torch_ranks.build_model("unet", dict(CFG, dropout=0.1))
    template = create_train_state(model, create_optimizer("adamw", **OPT), device="cpu")
    restored = CheckpointManager(runs["tmp"] / "ck2").restore(template)
    want = runs["ranks"][0]["ddp_dropout"]["state"]
    for key, flat in (("params", restored.params), ("ema_params", restored.ema_params),
                      ("mu", restored.opt_state.mu), ("nu", restored.opt_state.nu)):
        np.testing.assert_array_equal(flat.numpy(), want[key], err_msg=key)
    assert (restored.step, restored.opt_state.count) == (3, 3)
    # world 1 → world 2
    assert [r["restore"]["restored_equal"] for r in runs["ranks"]] == [True, True]
    assert read_state(runs["tmp"] / "ck1" / "last")["step"] == 1


def test_fid_reduce_with_an_empty_rank(runs):
    rows0, rows1 = _fid_rows()
    one = FeatureStats()
    one.append(rows0)
    for r in runs["ranks"]:
        got = r["fid_empty"]
        assert got["n"] == one.n
        np.testing.assert_array_equal(got["sum"], one._sum)
        np.testing.assert_array_equal(got["outer"], one._outer)
    both = FeatureStats()
    both.append(np.concatenate([rows0, rows1]))
    mu, cov = both.mean_cov()
    for r in runs["ranks"]:
        got = r["fid_split"]
        assert got["n"] == both.n
        np.testing.assert_allclose(got["mu"], mu, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["cov"], cov, rtol=0, atol=1e-12)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_local_batch_slice_matches_jax(count):
    for i in range(count):
        assert local_batch_slice(16, process_index=i, process_count=count) == \
            jax_local_batch_slice(16, process_index=i, process_count=count)
    with pytest.raises(AssertionError):
        local_batch_slice(6, process_index=0, process_count=4)


def test_data_shards_are_rows_of_the_global_batches(runs):
    ds = [{"i": np.int64(i)} for i in range(3 * B + 1)]
    dl = DataLoader(ds, batch_size=B, shuffle=True, num_workers=1, seed=4)
    dl.set_epoch(2)
    whole = [b["i"].tolist() for b in dl]
    got = [r["shard"] for r in runs["ranks"]]
    assert [g["slice"] for g in got] == [(0, B // 2), (B // 2, B)]
    for g in got:
        lo, hi = g["slice"]
        assert g["rows"] == [w[lo:hi] for w in whole]


@pytest.mark.parametrize("device,world,cards,want", [
    ("cpu", 2, 0, (["cpu", "cpu"], "gloo")),
    ("cuda", 2, 2, (["cuda:0", "cuda:1"], "nccl")),
    ("cuda", 4, 4, (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl")),
    ("cuda", 4, 2, (["cuda:0", "cuda:1", "cuda:0", "cuda:1"], "gloo")),
    ("cuda", 2, 1, (["cuda:0", "cuda:0"], "gloo")),
], ids=["cpu", "nccl2", "nccl4", "shared4on2", "shared2on1"])
def test_rank_devices_and_backend(monkeypatch, device, world, cards, want):
    """One rank a card runs over NCCL; more ranks than cards share them over
    gloo, and `mesh.backend_for` (which decides for the launcher and for
    `init_process_group`) says so in a warning naming gloo and the host."""
    from unittest import mock

    from sgdm_tpu_torch.parallel import mesh as pm
    from sgdm_tpu_torch.parallel.launch import rank_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with mock.patch.object(pm.logger, "warning") as warn:
        devs, backend = rank_devices(device, world)
        assert ([str(d) for d in devs], backend) == want
        assert pm.backend_for(devs[0], world) == backend
    shared = device == "cuda" and world > cards
    assert warn.call_count == 2 * shared
    if shared:
        msg = warn.call_args[0][0]
        assert "gloo" in msg and "host memory" in msg and f"{world} ranks on {cards}" in msg


def test_rank_devices_refuse_cuda_without_a_card(monkeypatch):
    from sgdm_tpu_torch.parallel.launch import rank_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        rank_devices("cuda", 2)
