"""The port's `AttentionLR` (and its `GammaLayerNorm`) against the flax
module (use_pallas=False, float32, CPU): every flax leaf perturbed and
carried over by `convert.from_flax`; forward and the gradient of every
parameter and of the input, with and without context tokens, in the sampling
route (K7's plain version with its recompute backward) and in the training
route (the einsum path under autograd).

Tolerances: forward 1e-5 of max|ref|; gradients 1e-4 of each leaf's max|ref|
(f32 summation order through two matmuls, a softmax and two LayerNorms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sgdm_tpu.models.attention_lr import AttentionLR as JAttentionLR
from sgdm_tpu.models.attention_lr import GammaLayerNorm as JGammaLayerNorm
from sgdm_tpu_torch.models.attention_lr import AttentionLR, GammaLayerNorm
from sgdm_tpu_torch.models.convert import from_flax, to_flax

from torch_port_common import perturbed_flat, unflatten

B, HW, C, HEADS, DH, CTX, TOK = 2, 4, 24, 3, 7, 10, 5


def _setup(with_context):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    ctx = rng.standard_normal((B, TOK, CTX)).astype(np.float32) if with_context else None
    g = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    jm = JAttentionLR(heads=HEADS, dim_head=DH, context_dim=CTX if with_context else None)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            None if ctx is None else jnp.asarray(ctx))["params"]
    flat = perturbed_flat(shapes, seed=4)
    for key in flat:  # the leaves perturbed_flat knows no rule for
        if key.endswith("gamma"):
            flat[key] = (1 + 0.1 * rng.standard_normal(flat[key].shape)).astype(np.float32)
        elif key.endswith("null_kv"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(np.float32)
    tm = AttentionLR(C, HEADS, DH, CTX if with_context else None)
    tm.load_state_dict(from_flax(flat, tm))
    return jm, tm, flat, x, ctx, g


@pytest.mark.parametrize("train", [False, True], ids=["sampling-route", "training-route"])
@pytest.mark.parametrize("with_context", [True, False], ids=["context", "no-context"])
def test_forward_and_gradients_match_flax(with_context, train):
    jm, tm, flat, x, ctx, g = _setup(with_context)
    jctx = None if ctx is None else jnp.asarray(ctx)

    def f(params, xin):
        return jm.apply({"params": params}, xin, jctx)

    ref, vjp = jax.vjp(f, unflatten(flat), jnp.asarray(x))
    gparams, gx = vjp(jnp.asarray(g))
    ref = np.asarray(ref)

    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, None if ctx is None else torch.from_numpy(ctx), train=train)
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    out.backward(torch.from_numpy(g))
    got = to_flax({k: p.grad for k, p in tm.named_parameters()}, tm)
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(gparams, sep="/").items()}
    assert got.keys() == want.keys() == flat.keys()
    for key, r in want.items():
        assert np.abs(got[key] - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-3), key
    gx = np.asarray(gx)
    assert np.abs(tx.grad.numpy() - gx).max() <= 1e-4 * np.abs(gx).max()


def test_kv_order_is_context_null_self():
    """Keys and values reach the attention as [context ‖ null ‖ self]: the
    null key and value sit right after the context tokens."""
    _, tm, flat, x, ctx, _ = _setup(True)
    seen = {}

    def spy(q, k, v, kernels=True):
        seen["k"], seen["v"] = k, v
        return torch.zeros_like(q)

    import sgdm_tpu_torch.models.attention_lr as mod

    orig, mod.fused_null_kv_attention = mod.fused_null_kv_attention, spy
    try:
        with torch.no_grad():
            tm(torch.from_numpy(x), torch.from_numpy(ctx))
    finally:
        mod.fused_null_kv_attention = orig
    assert seen["k"].shape == (B, TOK + 1 + HW * HW, DH)
    np.testing.assert_array_equal(seen["k"][:, TOK].numpy(),
                                  np.broadcast_to(flat["null_kv"][0], (B, DH)))
    np.testing.assert_array_equal(seen["v"][:, TOK].numpy(),
                                  np.broadcast_to(flat["null_kv"][1], (B, DH)))


def test_gamma_layer_norm_matches_flax_in_bf16():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    ref = JGammaLayerNorm().apply({"params": {"gamma": jnp.asarray(gamma)}},
                                  jnp.asarray(x, jnp.bfloat16))
    tm = GammaLayerNorm(16)
    tm.load_state_dict({"gamma": torch.from_numpy(gamma)})
    got = tm(torch.from_numpy(x).to(torch.bfloat16)).detach()
    assert got.dtype == torch.bfloat16
    # both normalise in f32 and round once: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2.0 ** -7, atol=2.0 ** -8)


def test_context_without_context_dim_raises():
    tm = AttentionLR(C, HEADS, DH, None)
    with pytest.raises(ValueError, match="context_dim"):
        tm(torch.zeros(1, 2, 2, C), torch.zeros(1, 3, CTX))
