"""The noisy-image classifier of the port against the JAX package's, float32
on the CPU.

  * `models/encoder_unet.py EncoderUNetModel` against `sgdm_tpu.models.
    encoder_unet` with every flax leaf perturbed (`convert.from_flax`),
    in both pools, forward logits and the gradient of a fixed projection of
    them with respect to every parameter and the input, in training and in
    eval: 1e-4 of the largest value of each (f32 summation order only).
    One configuration puts attention at 16×16 with head dim 64, where the
    flash gate passes: the port takes K9 (its plain f32 version, exact f32
    arithmetic) in training and in eval, where the JAX package on the CPU
    takes its einsum path; the other (the CLI's network) attention at 8×8,
    the einsum path on both.  Neither touches K1-K6.
  * Two `make_classifier_train_step` steps against the JAX step with its
    draws (t, noise from ``fold_in(rng, 0)``) handed in: loss 1e-4
    relative, logits 1e-4 of their largest, and the trees by
    `torch_port_common.assert_state_trees_close`, the tolerances of
    tests/test_torch_train_step.py (params 1e-4, μ and ν 1e-3 of each
    tree's largest value; what Adam turns from f32 noise into a step of
    up to lr held to Adam's bound, 2·lr a step).
  * The per-noise-level accuracy table against the JAX eval step's, on the
    same noise: equal.
  * The checkpoint: the port's bytes equal ``flax.serialization.to_bytes``
    of the same tree; a JAX tree written by flax loads into the port, and
    the port CLI's file loads into the JAX model, with equal logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization, traverse_util

from sgdm_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from sgdm_tpu.models.encoder_unet import EncoderUNetModel as JEncoder
from sgdm_tpu.training import classifier as jcls
from sgdm_tpu_torch.diffusion.schedule import DiffusionSchedule
from sgdm_tpu_torch.models import layers
from sgdm_tpu_torch.models.convert import from_flax, to_flax
from sgdm_tpu_torch.models.encoder_unet import EncoderUNetModel
from sgdm_tpu_torch.training import classifier as tcls
from sgdm_tpu_torch.training.optim import create_optimizer
from sgdm_tpu_torch.utils import msgpack

from torch_port_common import NOISE, assert_state_trees_close, perturbed_flat, unflatten

B, CLASSES = 4, 10
# flash: attention at 16x16, 64 channels, one head (d = 64): the gate passes
CONFIGS = {
    "flash": dict(model_channels=64, channel_mult=(1,), num_res_blocks=2,
                  attention_resolutions=(1,), num_heads=1),
    "einsum": dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(2,), num_heads=4),
}
PX = 16
TOL = 1e-4


def _setup(config, pool, seed=1):
    cfg = dict(CONFIGS[config], num_classes=CLASSES, pool=pool)
    jm = JEncoder(**cfg)
    x = np.random.default_rng(0).uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
    t = np.asarray([0, 3, 50, 99], np.int32)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(t))["params"]
    flat = perturbed_flat(params, seed=seed)
    tm = EncoderUNetModel(**cfg)
    tm.load_state_dict(from_flax(flat, tm))
    return jm, tm, flat, x, t


def _close(got, ref, what):
    scale = max(np.abs(v).max() for v in ref.values())
    assert got.keys() == ref.keys(), what
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=TOL * scale, err_msg=f"{what} {k}")


class _Spy:
    """Counts the port's calls of K9 (packed) and of the kernels the encoder must not take."""

    def __init__(self, monkeypatch):
        self.calls = {"flash": 0, "other": 0}

        def count(name, fn):
            def wrapped(*a, **k):
                self.calls[name] += 1
                return fn(*a, **k)
            return wrapped

        monkeypatch.setattr(layers, "_packed_flash_attention",
                            count("flash", layers._packed_flash_attention))
        for fn in ("fused_self_attention", "fused_groupnorm_silu", "fused_resblock",
                   "fused_resblock_train", "resblock_plain", "self_attention_plain"):
            monkeypatch.setattr(layers, fn, count("other", getattr(layers, fn)))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("pool", ["adaptive", "spatial"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_encoder_forward_and_grad(config, pool, train, monkeypatch):
    jm, tm, flat, x, t = _setup(config, pool)
    proj = np.random.default_rng(2).standard_normal((B, CLASSES)).astype(np.float32)

    def jloss(p, xx):
        return (jm.apply({"params": p}, xx, jnp.asarray(t), train=train) * proj).sum()

    jp = unflatten(flat)
    ref_logits = np.asarray(jm.apply({"params": jp}, jnp.asarray(x), jnp.asarray(t), train=train))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    ref = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jg, sep="/").items()}

    spy = _Spy(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    logits = tm(xt, torch.from_numpy(t), train=train)
    (logits * torch.from_numpy(proj)).sum().backward()
    assert spy.calls == {"flash": 3 if config == "flash" else 0, "other": 0}, spy.calls
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0,
                               atol=TOL * np.abs(ref_logits).max())
    got = to_flax({n: p.grad for n, p in tm.named_parameters()}, tm)
    _close(got, ref, "grad")
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=TOL * np.abs(np.asarray(jgx)).max())


def test_bridge_checks_both_pools():
    for pool in ("adaptive", "spatial"):
        _, tm, flat, _, _ = _setup("einsum", pool)
        other = "spatial" if pool == "adaptive" else "adaptive"
        with pytest.raises(KeyError):
            from_flax(flat, EncoderUNetModel(**CONFIGS["einsum"], num_classes=CLASSES,
                                                     pool=other))
        with pytest.raises(KeyError):
            from_flax({k: v for k, v in flat.items() if "out/" not in k}, tm)


def _jax_draws(rng, x_shape, num_timesteps):
    t_rng, n_rng = jax.random.split(jax.random.fold_in(rng, 0))
    return {"t": np.asarray(jax.random.randint(t_rng, (x_shape[0],), 0, num_timesteps)),
            "noise": np.asarray(jax.random.normal(n_rng, x_shape))}


@pytest.mark.parametrize("pool", ["adaptive", "spatial"])
def test_two_train_steps_match_jax(pool):
    lr, wd, steps, T = 1e-3, 1e-2, 2, 100
    jm, tm, flat, x, _ = _setup("einsum", pool)
    labels = np.asarray([1, 4, 7, 9])
    tx = optax.adamw(lr, weight_decay=wd)
    jp = unflatten(flat)
    jopt = tx.init(jp)
    jstep = jcls.make_classifier_train_step(jm, JSchedule.create(num_timesteps=T), tx)
    ttx = create_optimizer("adamw", lr=lr, wd=wd, scheduler=None)
    state = tcls.create_classifier_state(tm, ttx, device="cpu")
    tstep = tcls.make_classifier_train_step(tm, DiffusionSchedule.create(num_timesteps=T), ttx,
                                            device="cpu")
    flat_of = lambda tree: {k: np.asarray(v) for k, v in
                            traverse_util.flatten_dict(tree, sep="/").items()}
    rng = jax.random.PRNGKey(3)
    first = None
    for s in range(steps):
        key = jax.random.fold_in(rng, s + 1)
        jp, jopt, jloss, jlogits = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(labels), key)
        state, loss, logits = tstep(state, x, labels, draws=_jax_draws(key, x.shape, T))
        first = {k: v.copy() for k, v in flat_of(jopt[0].mu).items()} if first is None else first
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg=f"step {s}")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                                   atol=TOL * np.abs(np.asarray(jlogits)).max())

    def tree(flatbuf):
        parts = torch.split(flatbuf, [int(np.prod(shape)) for _, shape in state.layout])
        return to_flax({n: v.reshape(shape) for (n, shape), v in zip(state.layout, parts)}, tm)

    counts = dict(step=steps, count=steps, schedule_count=steps, ema_updates=0)
    got = dict(counts, count=state.opt.count, params=tree(state.params),
               ema_params=tree(state.params), mu=tree(state.opt.mu), nu=tree(state.opt.nu))
    ref = dict(counts, count=int(jopt[0].count), params=flat_of(jp), ema_params=flat_of(jp),
               mu=flat_of(jopt[0].mu), nu=flat_of(jopt[0].nu))
    # the key third of a qkv bias has an identically vanishing gradient (a
    # constant added to every key shifts a query's logits by a constant):
    # marked as rounding noise, so it is held to Adam's bound
    g_scale = max(np.abs(v).max() for v in first.values())
    for leaf, g in first.items():
        if leaf.endswith("qkv/bias"):
            third = g.size // 3
            g[third:2 * third] = NOISE * g_scale / 2
    assert_state_trees_close(got, ref, lr=lr, steps=steps, what=f"classifier {pool}",
                             first_grads=first)


def test_noise_accuracy_table_matches_jax():
    T, log_steps = 100, 5
    jm, tm, flat, x, _ = _setup("einsum", "adaptive", seed=4)
    val = [{"image": x, "label": np.eye(CLASSES, dtype=np.float32)[[1, 4, 7, 9]]},
           {"image": -x, "label": np.eye(CLASSES, dtype=np.float32)[[0, 2, 2, 5]]}]
    key = jax.random.fold_in(jax.random.PRNGKey(0), 999)
    jeval = jcls.make_classifier_eval_step(jm, JSchedule.create(num_timesteps=T))
    jp = unflatten(flat)
    grid = tcls.timestep_grid(T, log_steps)
    want = {}
    for t in grid:
        accs = []
        for raw in val:
            labels = np.argmax(raw["label"], -1)
            _, logits = jeval(jp, jnp.asarray(raw["image"]), jnp.asarray(labels), key,
                              jnp.full((B,), t, jnp.int32))
            accs.append(jcls.compute_top_k(np.asarray(logits), labels, 1))
        want[t] = float(np.mean(accs))
    teval = tcls.make_classifier_eval_step(tm, DiffusionSchedule.create(num_timesteps=T),
                                           device="cpu")
    noise = lambda shape: np.array(jax.random.normal(key, shape))
    got = tcls.noise_accuracy_table(teval, val, T, log_steps, noise)
    assert got == want
    for t in (grid[0], grid[-1]):  # the logits the table reads
        labels = np.argmax(val[0]["label"], -1)
        _, ref = jeval(jp, jnp.asarray(x), jnp.asarray(labels), key, jnp.full((B,), t, jnp.int32))
        _, out = teval(x, labels, np.full((B,), t), noise=noise(x.shape))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL * np.abs(np.asarray(ref)).max())
    assert tcls.compute_top_k(np.eye(3)[[0, 2, 1]], np.asarray([0, 1, 1]), 1) == \
        jcls.compute_top_k(np.eye(3)[[0, 2, 1]], np.asarray([0, 1, 1]), 1)


def test_checkpoint_bytes_and_round_trips(tmp_path):
    jm, tm, flat, x, t = _setup("einsum", "spatial")
    jp = unflatten(flat)
    want = serialization.to_bytes(jax.tree.map(np.asarray, jp))
    path = tcls.save_checkpoint(tm, tmp_path / "port.msgpack")
    assert path.read_bytes() == want
    # JAX → port: flax's bytes into a freshly built port model
    (tmp_path / "jax.msgpack").write_bytes(want)
    fresh = EncoderUNetModel(**CONFIGS["einsum"], num_classes=CLASSES, pool="spatial")
    tcls.load_checkpoint(fresh, tmp_path / "jax.msgpack")
    for (n, a), b in zip(fresh.named_parameters(), tm.parameters()):
        assert torch.equal(a, b), n
    assert msgpack.unpack_params(want).keys() == flat.keys()


def test_cli_checkpoint_loads_into_jax(tmp_path):
    out = tmp_path / "c.msgpack"
    records = []
    args = tcls.build_argparser().parse_args(
        ["--device", "cpu", "--out", str(out), "--data-len", "32", "--batch-size", "8",
         "--workers", "2", "--log-every", "1", "--log-steps", "4", "--pool", "spatial"])
    assert tcls.train_classifier(args, report=records.append) == out
    steps = [r for r in records if "loss" in r]
    assert len(steps) == 4 and all(np.isfinite(r["loss"]) for r in steps)
    table = next(r["acc1_by_noise_level"] for r in records if "acc1_by_noise_level" in r)
    assert list(table) == [0, 25, 50, 75]
    # the JAX model reads the file and computes the port model's logits
    jm = JEncoder(num_classes=10, model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
                  attention_resolutions=(2,), num_heads=4, pool="spatial")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    t = np.asarray([5, 60], np.int32)
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    jp = serialization.from_bytes(template, out.read_bytes())
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(x), jnp.asarray(t)))
    tm = tcls.load_checkpoint(tcls.build_model(args), out)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-3))
