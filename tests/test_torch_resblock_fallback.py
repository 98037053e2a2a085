"""The port's `ResBlock` where the JAX package's fused gate fails: the unfused
composition against the flax `ResBlock` (use_pallas=False, float32, CPU) with
every leaf perturbed and bridged by `convert.from_flax`, and the gate itself
against `sgdm_tpu/models/layers.py` ``ResBlock.__call__``.

Forward ≤ 1e-5 of max|ref| in both routes of the port: sampling (K6's plain
version: the whole GN+FiLM+SiLU chain in f32) and training (the non-kernel
GroupNorm); in float32 they are the same function up to rounding.  Gradients
of every parameter, the input and the embedding in the training route ≤ 1e-4
of each one's max|ref|.  Channel counts are 64 and 96 so that every
GroupNorm group holds more than one channel: with one channel per group the
norm removes any per-channel constant and the biases before it have
vanishing gradients that are f32 noise on both sides.

The gate: the flax block's own decision is read by running it with
`_pallas_ok` forced true and its two kernel entries replaced by markers
(`_fused` for K1/K2/K4, `fused_groupnorm_silu` for K6), over widths,
resampling, scale-shift or additive conditioning, skip kinds and channel
counts, in both Pallas modes; the port's `fused_route` must agree case by
case, and its unfused route must call K6's entry twice in sampling and never
in training.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import sgdm_tpu.models.layers as jlayers
import sgdm_tpu.ops.pallas.groupnorm as jgroupnorm
import sgdm_tpu_torch.models.layers as tlayers
from sgdm_tpu_torch.models.convert import from_flax, to_flax

from torch_port_common import perturbed_flat, unflatten

B, EMB = 2, 24
CASES = {
    "additive-emb": dict(cin=64, cout=64, hw=(8, 8), kw=dict(use_scale_shift_norm=False)),
    "additive-emb-proj": dict(cin=64, cout=96, hw=(8, 8), kw=dict(use_scale_shift_norm=False)),
    "conv-skip": dict(cin=64, cout=96, hw=(8, 8), kw=dict(use_conv_skip=True)),
    "width4": dict(cin=64, cout=64, hw=(4, 4), kw={}),
    "width4-proj": dict(cin=64, cout=96, hw=(4, 4), kw={}),
    "up": dict(cin=64, cout=64, hw=(4, 4), kw=dict(up=True)),
    "down": dict(cin=64, cout=64, hw=(8, 8), kw=dict(down=True)),
    "down-odd-proj": dict(cin=64, cout=96, hw=(7, 9), kw=dict(down=True)),
    "up-additive-convskip": dict(cin=64, cout=96, hw=(6, 6),
                                 kw=dict(up=True, use_scale_shift_norm=False,
                                         use_conv_skip=True)),
}


def _build(case):
    c = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, *c["hw"], c["cin"])).astype(np.float32)
    emb = rng.standard_normal((B, EMB)).astype(np.float32)
    jm = jlayers.ResBlock(out_channels=c["cout"], use_pallas=False, **c["kw"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(emb))["params"]
    flat = perturbed_flat(shapes, seed=1)
    tm = tlayers.ResBlock(c["cin"], c["cout"], EMB, **c["kw"])
    tm.load_state_dict(from_flax(flat, tm))
    return jm, tm, flat, x, emb


@pytest.mark.parametrize("case", CASES)
def test_unfused_forward_and_gradients_match_flax(case):
    jm, tm, flat, x, emb = _build(case)
    assert not tm.fused_route(torch.from_numpy(x), False)

    def f(params, xin, e):
        return jm.apply({"params": params}, xin, e)

    ref, vjp = jax.vjp(f, unflatten(flat), jnp.asarray(x), jnp.asarray(emb))
    ref = np.asarray(ref)
    g = np.random.default_rng(2).standard_normal(ref.shape).astype(np.float32)
    gparams, gx, gemb = vjp(jnp.asarray(g))

    with torch.no_grad():
        sampled = tm(torch.from_numpy(x), torch.from_numpy(emb)).numpy()
    assert sampled.shape == ref.shape
    assert np.abs(sampled - ref).max() <= 1e-5 * np.abs(ref).max()

    tx, te = torch.from_numpy(x).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    out = tm(tx, te, train=True)
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    out.backward(torch.from_numpy(g))
    got = to_flax({k: p.grad for k, p in tm.named_parameters()}, tm)
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(gparams, sep="/").items()}
    assert got.keys() == want.keys() == flat.keys()
    for key, r in want.items():
        assert np.abs(got[key] - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-3), key
    for name, a, r in (("dx", tx.grad, gx), ("demb", te.grad, gemb)):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= 1e-4 * np.abs(r).max(), name


def test_sampling_route_backward_recomputes_through_the_plain_version():
    """The sampling route's K6 entry has a backward too (a recompute): its
    gradients agree with the training route's autograd."""
    _, tm, _, x, emb = _build("width4")
    grads = []
    for train in (False, True):
        tx = torch.from_numpy(x).requires_grad_()
        tm(tx, torch.from_numpy(emb), train=train).square().sum().backward()
        grads.append(tx.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4,
                               atol=1e-4 * np.abs(grads[1]).max())


class _Fused(Exception):
    pass


class _GroupNormKernel(Exception):
    pass


def _jax_route(monkeypatch, kw, x, emb, use_pallas):
    """'fused', 'unfused+K6' or 'unfused' as the flax block itself decides."""
    def fused_marker(self, *a, **k):
        raise _Fused()

    def gn_marker(*a, **k):
        raise _GroupNormKernel()

    monkeypatch.setattr(jlayers, "_pallas_ok", lambda u: bool(u))
    monkeypatch.setattr(jlayers.ResBlock, "_fused", fused_marker)
    monkeypatch.setattr(jgroupnorm, "fused_groupnorm_silu", gn_marker)
    jm = jlayers.ResBlock(use_pallas=use_pallas, **kw)
    try:
        jax.eval_shape(partial(jm.init, jax.random.PRNGKey(0)), x, emb)
    except _Fused:
        return "fused"
    except _GroupNormKernel:
        return "unfused+K6"
    return "unfused"


@pytest.mark.parametrize("scale_shift", [True, False], ids=["scale-shift", "additive"])
@pytest.mark.parametrize("train", [False, True], ids=["sampling", "training"])
@pytest.mark.parametrize("resample", [None, "up", "down"], ids=["same", "up", "down"])
def test_fused_gate_matches_the_jax_package(monkeypatch, resample, train, scale_shift):
    seen = {"fused": 0, "unfused": 0}
    calls = []
    monkeypatch.setattr(tlayers, "fused_groupnorm_silu",
                        lambda x, *a, **k: calls.append(1) or torch.nn.functional.silu(x))
    for hw in ((8, 8), (4, 4), (8, 12), (16, 16), (7, 16), (16, 4)):
        for cin, cout in ((16, 16), (16, 32)):
            for conv_skip in (False, True):
                kw = dict(use_scale_shift_norm=scale_shift, use_conv_skip=conv_skip,
                          up=resample == "up", down=resample == "down")
                x = jnp.zeros((B, *hw, cin))
                want = _jax_route(monkeypatch, dict(kw, out_channels=cout), x,
                                  jnp.zeros((B, EMB)), "fused" if train else True)
                tm = tlayers.ResBlock(cin, cout, EMB, **kw)
                tx = torch.zeros(B, *hw, cin)
                fused = tm.fused_route(tx, train)
                case = (hw, cin, cout, conv_skip)
                assert fused == (want == "fused"), (case, want)
                seen["fused" if fused else "unfused"] += 1
                if not fused:
                    del calls[:]
                    with torch.no_grad():
                        tm(tx, torch.zeros(B, EMB), train=train)
                    # K6 in the sampling mode only, for both norms of the block
                    assert want == ("unfused" if train else "unfused+K6"), (case, want)
                    assert len(calls) == (0 if train else 2), case
    assert seen["unfused"] > 0
    if scale_shift and not (train and resample):
        assert seen["fused"] > 0
