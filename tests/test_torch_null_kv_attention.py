"""K7's plain version and autograd entry (`ops/attention.py`) against the
Pallas TPU kernel `fused_null_kv_attention` run in interpret mode on the CPU,
forward and the three gradients (the kernel's custom VJP), at shapes no tile
fits: M = 27 keys (not a multiple of 8), D = 21, H = 3, N = 10.

float32: forward 2e-5, gradients 1e-4 (absolute and relative; the two sides
differ in f32 summation order only).  bfloat16: both sides round the weights
to bf16 before the PV product and the output once, so they differ by bf16
flips: 2^-7 of max|ref| forward, 2^-5 of each gradient's max (the backward
rounds weights and products to bf16 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.ops.pallas.attention import fused_null_kv_attention as jax_null_kv
from sgdm_tpu_torch.ops.attention import fused_null_kv_attention, null_kv_attention_plain

B, N, H, D, M = 2, 10, 3, 21, 27


def _inputs():
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((B, N, H, D)) * D ** -0.5).astype(np.float32)
    k, v, g = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, M, D), (B, M, D), (B, N, H, D)))
    return q, k, v, g


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 2e-5), (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)],
    ids=["f32", "bf16"])
def test_forward_matches_pallas_interpret(dtype, jdtype, tol):
    q, k, v, _ = _inputs()
    ref = np.asarray(jax_null_kv(*(jnp.asarray(a, jdtype) for a in (q, k, v)), True),
                     np.float32)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    plain = _np(null_kv_attention_plain(tq, tk, tv))
    fused = _np(fused_null_kv_attention(tq, tk, tv))
    assert plain.shape == ref.shape == (B, N, H, D)
    np.testing.assert_array_equal(plain, fused)  # on the CPU the entry runs the plain version
    assert np.abs(plain - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 1e-4), (torch.bfloat16, jnp.bfloat16, 2.0 ** -5)],
    ids=["f32", "bf16"])
def test_gradients_match_pallas_vjp(dtype, jdtype, tol):
    q, k, v, g = _inputs()
    jq, jk, jv, jg = (jnp.asarray(a, jdtype) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jax_null_kv(a, b, c, True), jq, jk, jv)
    ref = [np.asarray(t, np.float32) for t in vjp(jg)]
    leaves = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    out = fused_null_kv_attention(*leaves)
    got = torch.autograd.grad(out, leaves, _torch(g, dtype))
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == dtype
        err = np.abs(_np(a) - r).max()
        assert err <= tol * max(np.abs(r).max(), 1.0), f"d{name}: {err}"


def test_no_context_and_single_key():
    """M = N + 1 (no context tokens) and M = 1 (softmax over one key gives v itself)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 5, 8)).astype(np.float32))
            for _ in range(2))
    ref = np.asarray(jax_null_kv(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()), True))
    np.testing.assert_allclose(null_kv_attention_plain(q, k, v).numpy(), ref, atol=2e-5)
    one = null_kv_attention_plain(q, k[:, :1], v[:, :1])
    np.testing.assert_allclose(one.numpy(), np.broadcast_to(v[:, None, :1].numpy(), one.shape),
                               atol=1e-6)
