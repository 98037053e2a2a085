"""Optimizer side of the port (`training/optim.py`, `ops/fused_optim.py` K8's
plain version, `models/ema.py`) against the JAX package, float32 on the CPU.

  * the lambda schedules vs `sgdm_tpu.training.optim` at steps around their
    boundaries: 1e-6 relative (both compute in float32);
  * `adamw_ema_plain` over 3 steps (one flat buffer of mixed leaf shapes) vs
    `make_fused_adamw_ema(use_pallas=False)` and vs the unfused
    optax.adamw → apply_updates → ema_update chain, with the LitEma warmup
    decay and with ``use_ema=False``: 2e-6 relative (the fused form and
    optax's divide in another order: a few ulps);
  * the port's unfused `Optimizer.update` (adamw and adam) vs optax over 3
    steps: 2e-6 relative;
  * ``grad_clip`` vs ``optax.chain(clip_by_global_norm, adamw)`` over steps
    whose gradient norm lies below and above the clip: 2e-6 relative (the
    port takes one flat norm, optax sums per leaf);
  * ``mu_dtype="bfloat16"`` vs optax over 4 steps: μ bit-equal as bf16,
    params and ν 2e-6 relative; the fused update (K8) refuses either knob.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgdm_tpu.models.ema import ema_update as jax_ema_update
from sgdm_tpu.ops.pallas.fused_optim import make_fused_adamw_ema
from sgdm_tpu.training import optim as joptim
from sgdm_tpu_torch.models.ema import ema_decay_schedule, ema_update
from sgdm_tpu_torch.ops.fused_optim import adamw_ema_plain, adamw_ema_scalars, fused_adamw_ema
from sgdm_tpu_torch.training import optim as toptim

HP = dict(b1=0.9, b2=0.98, eps=1e-8, weight_decay=0.03)
RTOL = 2e-6


def jax_lr(t):
    return 1e-2 * (1.0 + 0.1 * jnp.asarray(t, jnp.float32))


def port_lr(t):
    return float(np.float32(1e-2) * (np.float32(1.0) + np.float32(0.1) * np.float32(t)))


SCHEDULES = {
    "linear-default": (dict(base_lr=1e-4), [0, 1, 250, 499, 500, 501, 10_000]),
    "linear-tail": (dict(base_lr=3e-4, warm_up_steps=10, f_start=0.1, f_max=1.0, f_min=0.5,
                         cycle_length=1000), [0, 5, 9, 10, 11, 500, 999]),
    "warmup-cosine": (dict(base_lr=1.0, warm_up_steps=10, lr_min=1e-5, lr_max=1e-3,
                           lr_start=1e-6, max_decay_steps=100), [0, 3, 10, 11, 55, 100, 200]),
    "warmup-cosine2": (dict(base_lr=2.0, warm_up_steps=[5, 3], f_min=[0.1, 0.2],
                            f_max=[1.0, 0.8], f_start=[0.01, 0.05], cycle_lengths=[20, 30]),
                       [0, 2, 5, 19, 20, 21, 24, 49, 50, 80]),
}
_FN = {"linear-default": "lambda_linear_schedule", "linear-tail": "lambda_linear_schedule",
       "warmup-cosine": "lambda_warmup_cosine_schedule",
       "warmup-cosine2": "lambda_warmup_cosine_schedule2"}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    kw, steps = SCHEDULES[name]
    j = getattr(joptim, _FN[name])(**kw)
    t = getattr(toptim, _FN[name])(**kw)
    for s in steps:
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6, err_msg=f"step {s}")


def _tree(rng):
    return {"conv": {"kernel": rng.standard_normal((3, 3, 16, 8)).astype(np.float32)},
            "dense": {"bias": rng.standard_normal(17).astype(np.float32),
                      "kernel": rng.standard_normal((32, 16)).astype(np.float32)}}


def _flat(tree):
    return np.concatenate([np.asarray(a).reshape(-1) for a in jax.tree.leaves(tree)])


def _jax_runs(params, grads_seq, ema_decay, use_ema):
    tx = optax.adamw(jax_lr, **HP)
    upd = make_fused_adamw_ema(jax_lr, ema_decay=ema_decay, use_ema=use_ema, use_pallas=False,
                               **HP)
    p_f, s_f, e_f = params, tx.init(params), jax.tree.map(jnp.copy, params)
    p_u, s_u, e_u = params, tx.init(params), jax.tree.map(jnp.copy, params)
    n = jnp.zeros((), jnp.int32)
    for i, g in enumerate(grads_seq):
        p_f, s_f, e_f = upd(g, s_f, p_f, e_f, n)
        n = n + 1 if use_ema else n
        u, s_u = tx.update(g, s_u, p_u)
        p_u = optax.apply_updates(p_u, u)
        e_u = (jax_ema_update(e_u, p_u, jnp.asarray(i + 1), ema_decay) if use_ema
               else jax.tree.map(jnp.copy, p_u))
    return (p_f, s_f[0].mu, s_f[0].nu, e_f), (p_u, s_u[0].mu, s_u[0].nu, e_u)


@pytest.mark.parametrize("ema_decay,use_ema", [(0.9, True), (0.2, True), (0.9999, False)],
                         ids=["warmup-decay", "decay-caps-warmup", "no-ema"])
def test_adamw_ema_plain_matches_fused_and_optax(ema_decay, use_ema):
    rng = np.random.default_rng(0)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    grads_seq = [jax.tree.map(jnp.asarray, _tree(rng)) for _ in range(3)]
    fused, unfused = _jax_runs(params, grads_seq, ema_decay, use_ema)

    p = torch.from_numpy(_flat(params))
    mu, nu, e = torch.zeros_like(p), torch.zeros_like(p), p.clone()
    hp = dict(b1=HP["b1"], b2=HP["b2"], eps=HP["eps"], weight_decay=HP["weight_decay"])
    for i, g in enumerate(grads_seq):
        sc = adamw_ema_scalars(port_lr, i, i if use_ema else 0, ema_decay=ema_decay,
                               use_ema=use_ema, **hp)
        fused_adamw_ema(p, torch.from_numpy(_flat(g)), mu, nu, e, sc)
    got = [p, mu, nu, e]
    for ref in (fused, unfused):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), _flat(r), rtol=RTOL, atol=1e-7)
    if not use_ema:
        assert torch.equal(e, p)


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_unfused_update_matches_optax(name):
    rng = np.random.default_rng(1)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    grads_seq = [jax.tree.map(jnp.asarray, _tree(rng)) for _ in range(3)]
    sched = dict(warm_up_steps=2, f_start=0.25)
    jtx = joptim.create_optimizer(name, lr=1e-2, wd=0.05, beta2=0.98, scheduler=sched)
    ttx = toptim.create_optimizer(name, lr=1e-2, wd=0.05, beta2=0.98, scheduler=sched)
    js, jp = jtx.init(params), params
    tp = torch.from_numpy(_flat(params))
    ts = ttx.init(tp)
    for g in grads_seq:
        u, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update(torch.from_numpy(_flat(g)), ts, tp)
        tp = tp + tu
    np.testing.assert_allclose(tp.numpy(), _flat(jp), rtol=RTOL, atol=1e-7)
    adam_state = js[0] if name == "adamw" else js[1][0]
    np.testing.assert_allclose(ts.mu.numpy(), _flat(adam_state.mu), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(ts.nu.numpy(), _flat(adam_state.nu), rtol=RTOL, atol=1e-9)
    assert ts.count == int(adam_state.count) == 3 and ts.schedule_count == 3


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    e, p = (rng.standard_normal(50).astype(np.float32) for _ in range(2))
    for n, decay in [(1, 0.9999), (7, 0.9999), (100_000, 0.9999), (5, 0.2)]:
        ref = jax_ema_update({"a": jnp.asarray(e)}, {"a": jnp.asarray(p)}, jnp.asarray(n), decay)
        got = ema_update({"a": torch.from_numpy(e)}, {"a": torch.from_numpy(p)}, n, decay)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(ref["a"]), rtol=1e-6, atol=1e-7)
        assert ema_decay_schedule(decay, n) == pytest.approx(min(decay, (1 + n) / (10 + n)),
                                                             rel=1e-6)


def test_adamw_ema_plain_is_in_place():
    bufs = [torch.randn(10, generator=torch.Generator().manual_seed(i)) for i in range(5)]
    bufs[3] = bufs[3].abs()
    ptrs = [b.data_ptr() for b in bufs]
    adamw_ema_plain(*bufs, **adamw_ema_scalars(lambda c: 1e-3, 0, 0))
    assert [b.data_ptr() for b in bufs] == ptrs
    assert torch.isfinite(torch.stack(bufs)).all()


def _optax_vs_port(grads_scale, **kw):
    rng = np.random.default_rng(3)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    grads_seq = [jax.tree.map(lambda a: jnp.asarray(a * s), _tree(rng)) for s in grads_scale]
    sched = dict(warm_up_steps=2, f_start=0.25)
    jtx = joptim.create_optimizer("adamw", lr=1e-2, wd=0.05, scheduler=sched, **kw)
    ttx = toptim.create_optimizer("adamw", lr=1e-2, wd=0.05, scheduler=sched, **kw)
    js, jp = jtx.init(params), params
    tp = torch.from_numpy(_flat(params))
    ts = ttx.init(tp)
    for g in grads_seq:
        u, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update(torch.from_numpy(_flat(g)), ts, tp)
        tp = tp + tu
    np.testing.assert_allclose(tp.numpy(), _flat(jp), rtol=RTOL, atol=1e-7)
    return js, ts, grads_seq


def test_grad_clip_matches_optax_chain():
    # the _tree gradients have a global norm of about 41: scaled by 0.01 they
    # pass unclipped, by 1 and 10 they are clipped to norm 5
    js, ts, grads_seq = _optax_vs_port([0.01, 1.0, 10.0, 0.01], grad_clip=5.0)
    norms = [float(optax.global_norm(g)) for g in grads_seq]
    assert min(norms) < 5.0 < max(norms)
    adam = js[1][0]  # chain(clip, adamw) -> (clip state, (adam, decay, schedule))
    np.testing.assert_allclose(ts.mu.numpy(), _flat(adam.mu), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(ts.nu.numpy(), _flat(adam.nu), rtol=RTOL, atol=1e-9)
    assert ts.count == int(adam.count) == 4


def test_bf16_mu_matches_optax():
    js, ts, _ = _optax_vs_port([1.0, 0.5, 2.0, 1.0], mu_dtype="bfloat16")
    adam = js[0]
    assert ts.mu.dtype == torch.bfloat16 and all(
        a.dtype == jnp.bfloat16 for a in jax.tree.leaves(adam.mu))
    ref_mu = np.concatenate([np.asarray(a.astype(jnp.float32)).reshape(-1)
                             for a in jax.tree.leaves(adam.mu)])
    np.testing.assert_array_equal(ts.mu.float().numpy(), ref_mu)
    np.testing.assert_allclose(ts.nu.numpy(), _flat(adam.nu), rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("kw", [dict(grad_clip=1.0), dict(mu_dtype="bfloat16")],
                         ids=["grad_clip", "bf16-mu"])
def test_fused_train_step_refuses_what_it_would_drop(kw):
    from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
    from sgdm_tpu_torch.models.factory import create_denoiser
    from sgdm_tpu_torch.training.state import make_train_step

    model = create_denoiser(model_channels=32, channel_mult=[1], num_res_blocks=1,
                            attention_resolutions=[])
    tx = toptim.create_optimizer("adamw", **kw)
    with pytest.raises(NotImplementedError, match="fused_optim"):
        make_train_step(model, GaussianDiffusion(), tx, fused_optim=True, device="cpu")
    make_train_step(model, GaussianDiffusion(), tx, device="cpu")  # tx.update applies both
    with pytest.raises(ValueError, match="mu_dtype"):
        toptim.create_optimizer("adamw", mu_dtype="float16")
