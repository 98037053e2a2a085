"""The WRN validator (`sgdm_tpu_torch/data/wrn_validate.py`) against the JAX
package's, float32 on the CPU, at n = 1, k = 1, 16 px, 10 classes.

  * The forward in train mode (batch statistics) and eval mode (running
    ones), one SGD step (momentum, L2 on the kernels only) and the BN
    running statistics after it, from the JAX initialisation bridged by
    `models/convert.py wrn_from_flax`: within 1e-5 (of each tree's largest
    value for the parameters and velocity).
  * The data pipeline (flip doubling, train-mean subtraction, shuffle and
    pad-4 crops from one ``np.random.RandomState``): equal arrays.
  * Each package resumes the other's checkpoint pickle (params,
    batch_stats, velocity, epoch as numpy under flax's names): the weights
    read back equal, the LR drops replayed.
  * The CLI end to end on written pickles (1 epoch, a checkpoint).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.data import wrn_validate as jw
from sgdm_tpu_torch.data import wrn_validate as tw
from sgdm_tpu_torch.models.convert import wrn_from_flax

from torch_port_common import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

PX, NOUT, TOL = 16, 10, 1e-5


def _pickles(d, n_files=2, n=6, seed=0):
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(1, n_files + 1):
        data = rng.integers(0, 256, (n, 3 * PX * PX), dtype=np.uint8)
        with open(d / f"train_data_batch_{i}", "wb") as f:
            pickle.dump({"data": data, "labels": list(rng.integers(1, NOUT + 1, n)),
                         "mean": data.mean(0)}, f)
    with open(d / "val_data", "wb") as f:
        pickle.dump({"data": rng.integers(0, 256, (8, 3 * PX * PX), dtype=np.uint8),
                     "labels": list(rng.integers(1, NOUT + 1, 8))}, f)
    return d


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _close_trees(got, want, tol=TOL, what=""):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= tol, (what, k, err)


@pytest.fixture(scope="module")
def bridged():
    jm = jw.WideResNet(nout=NOUT, n=1, k=1, img_size=PX)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)), train=False)
    tm = tw.WideResNet(nout=NOUT, n=1, k=1, img_size=PX)
    tm.load_state_dict(wrn_from_flax(variables["params"], variables["batch_stats"], tm))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, PX, PX, 3)).astype(np.float32)
    y = rng.integers(0, NOUT, 4).astype(np.int32)
    return jm, variables, tm, x, y


def test_forward_matches_jax_in_both_modes(bridged):
    jm, variables, tm, x, _ = bridged
    want_eval = np.asarray(jm.apply(variables, x, train=False))
    want_train, mut = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.eval()
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x)).numpy()
        tm.train()
        got_train = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_eval, want_eval, atol=TOL * np.abs(want_eval).max())
    np.testing.assert_allclose(got_train, np.asarray(want_train),
                               atol=TOL * np.abs(np.asarray(want_train)).max())
    _close_trees(tw.wrn_to_flax(tm)["batch_stats"], jax.tree.map(np.asarray,
                                                                 mut["batch_stats"]),
                 what="running statistics")
    tm.load_state_dict(state)


def test_one_sgd_step_matches_jax(bridged):
    jm, variables, tm, x, y = bridged
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    train_step, _ = jw.make_wrn_steps(jm, reg_fac=5e-4)
    params = jax.tree.map(jnp.array, variables["params"])
    bn = jax.tree.map(jnp.array, variables["batch_stats"])
    vel = jax.tree.map(lambda p: 0.1 * jnp.ones_like(p), params)    # a non-zero velocity
    params, bn, vel, ce = train_step(params, bn, vel, jnp.asarray(x), jnp.asarray(y),
                                     jnp.float32(0.05), jax.random.PRNGKey(2))
    port_vel = {k: 0.1 * torch.ones_like(p) for k, p in tm.named_parameters()}
    t_step, _ = tw.make_wrn_steps(tm, reg_fac=5e-4)
    t_ce = t_step(port_vel, torch.from_numpy(x), torch.from_numpy(y), 0.05)
    assert float(t_ce) == pytest.approx(float(ce), rel=TOL)
    got = tw.wrn_to_flax(tm, port_vel)
    _close_trees(got["params"], jax.tree.map(np.asarray, params), what="params")
    _close_trees(got["velocity"], jax.tree.map(np.asarray, vel), what="velocity")
    _close_trees(got["batch_stats"], jax.tree.map(np.asarray, bn), what="batch_stats")
    tm.load_state_dict(state)


def test_data_pipeline_equals_jax(tmp_path):
    d = _pickles(tmp_path / "data")
    a, b = tw.load_databatch(d, 1, PX), jw.load_databatch(d, 1, PX)
    assert all(np.array_equal(a[k], b[k]) for k in ("X", "Y", "mean"))
    va, vb = tw.load_validation_data(d, a["mean"], PX), jw.load_validation_data(d, b["mean"], PX)
    assert np.array_equal(va["X"], vb["X"]) and np.array_equal(va["Y"], vb["Y"])
    ra, rb = np.random.RandomState(4), np.random.RandomState(4)
    got = list(tw.iterate_minibatches(a["X"], a["Y"], 4, ra, augment=True, img_size=PX))
    want = list(jw.iterate_minibatches(b["X"], b["Y"], 4, rb, augment=True, img_size=PX))
    assert len(got) == len(want) == 3
    assert all(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
               for g, w in zip(got, want))


def test_checkpoints_resume_across_packages(tmp_path):
    d = _pickles(tmp_path / "data")
    kw = dict(img_size=PX, n=1, k=1, nout=NOUT, batch_size=4, num_train_batches=2,
              lr_drops=(1,))
    jw.train_wrn(str(d), num_epochs=1, ckpt_path=str(tmp_path / "jax.p"), **kw)
    with open(tmp_path / "jax.p", "rb") as f:
        jnet = pickle.load(f)
    # the port resumes JAX's: at its last epoch it trains nothing, so its
    # model and the checkpoint's velocity are the pickle's
    out = tw.train_wrn(str(d), num_epochs=1, cont=str(tmp_path / "jax.p"), device="cpu", **kw)
    back = tw.wrn_to_flax(out["model"])
    _close_trees(back["params"], jnet["params"], tol=0.0, what="params")
    _close_trees(back["batch_stats"], jnet["batch_stats"], tol=0.0, what="batch_stats")
    velocity, epoch = tw._load_checkpoint(out["model"], str(tmp_path / "jax.p"), "cpu")
    _close_trees(tw.wrn_to_flax(out["model"], velocity)["velocity"], jnet["velocity"], tol=0.0)
    assert epoch == jnet["epoch"] == 1
    # a port epoch from JAX's checkpoint, then JAX resumes the port's
    logs = []
    tw.train_wrn(str(d), num_epochs=2, cont=str(tmp_path / "jax.p"), device="cpu",
                 ckpt_path=str(tmp_path / "port.p"), report=logs.append, **kw)
    assert [r["epoch"] for r in logs] == [2] and logs[0]["lr"] == pytest.approx(0.01 * 0.2)
    with open(tmp_path / "port.p", "rb") as f:
        pnet = pickle.load(f)
    assert pnet["epoch"] == 2 and set(pnet) == set(jnet)
    res = jw.train_wrn(str(d), num_epochs=2, cont=str(tmp_path / "port.p"), **kw)
    _close_trees(jax.tree.map(np.asarray, res["params"]), pnet["params"], tol=0.0)
    _close_trees(jax.tree.map(np.asarray, res["batch_stats"]), pnet["batch_stats"], tol=0.0)


def test_cli_end_to_end(tmp_path):
    d = _pickles(tmp_path / "data", n_files=3)
    out = tw.main(["-df", str(d), "-s", str(PX), "-n", "1", "-e", "1", "--batch-size", "4",
                   "--nout", str(NOUT), "--num-train-batches", "3", "--ckpt",
                   str(tmp_path / "w.p"), "--device", "cpu"])
    assert np.isfinite(out["loss"]) and 0.0 <= out["top1"] <= out["top5"] <= 1.0
    with open(tmp_path / "w.p", "rb") as f:
        net = pickle.load(f)
    assert net["epoch"] == 1 and set(net) == {"params", "batch_stats", "velocity", "epoch"}
    assert net["params"]["stem"]["kernel"].shape == (3, 3, 3, 16)
    assert net["batch_stats"]["stack1_block0"]["bn_pre"]["bn"]["var"].shape == (16,)
