"""K6's plain version and autograd entry (`ops/groupnorm.py`) against the
Pallas TPU kernel `fused_groupnorm_silu` run in interpret mode on the CPU and
against its `_reference`, with and without FiLM, forward and gradients, at
C = 20 (4 groups of 5 channels) on a 6×4 map, and at C = 64 on 8×8.

float32: forward 2e-5, gradients 1e-4 (absolute and relative): the sides
differ in summation order and in the variance form (E[x²] − mean² in the
kernel and the plain version, the two-pass variance in `_reference`).
bfloat16 forward: one rounding of an f32 chain on both sides, 2^-7 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.ops.pallas.groupnorm import _reference, fused_groupnorm_silu as jax_gn_silu
from sgdm_tpu_torch.ops.groupnorm import fused_groupnorm_silu, group_stats, groupnorm_silu_plain

SHAPES = {"c20": (3, 6, 4, 20, 4), "c64": (2, 8, 8, 64, 32)}


def _inputs(shape, film):
    b, hh, ww, c, _ = shape
    rng = np.random.default_rng(2)
    x = (1.5 * rng.standard_normal((b, hh, ww, c)) + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    fs = fsh = None
    if film:
        fs, fsh = ((0.2 * rng.standard_normal((b, c))).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, hh, ww, c)).astype(np.float32)
    return (x, gamma, beta, fs, fsh), g


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("film", [False, True], ids=["plain-gn", "film"])
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_forward_matches_pallas_interpret_and_reference(shape, film):
    ops, _ = _inputs(shape, film)
    groups = shape[-1]
    kernel = np.asarray(jax_gn_silu(*map(_j, ops), groups, 1e-5, True))
    reference = np.asarray(_reference(*map(_j, ops), groups, 1e-5))
    plain = groupnorm_silu_plain(*map(_t, ops), groups, 1e-5).numpy()
    fused = fused_groupnorm_silu(*map(_t, ops), groups, 1e-5).numpy()
    np.testing.assert_array_equal(plain, fused)  # on the CPU the entry runs the plain version
    np.testing.assert_allclose(plain, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain, reference, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("film", [False, True], ids=["plain-gn", "film"])
def test_forward_bf16(film):
    ops, _ = _inputs(SHAPES["c20"], film)
    jops = [_j(ops[0], jnp.bfloat16), _j(ops[1]), _j(ops[2]), _j(ops[3], jnp.bfloat16),
            _j(ops[4], jnp.bfloat16)]
    tops = [_t(ops[0], torch.bfloat16), _t(ops[1]), _t(ops[2]), _t(ops[3], torch.bfloat16),
            _t(ops[4], torch.bfloat16)]
    ref = np.asarray(jax_gn_silu(*jops, 4, 1e-5, True), np.float32)
    got = fused_groupnorm_silu(*tops, 4, 1e-5)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("film", [False, True], ids=["plain-gn", "film"])
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_gradients_match_pallas_vjp(shape, film):
    ops, g = _inputs(shape, film)
    groups = shape[-1]
    live = [a for a in ops if a is not None]
    fn = (lambda x, gm, bt, fs, fsh: jax_gn_silu(x, gm, bt, fs, fsh, groups, 1e-5, True)) \
        if film else (lambda x, gm, bt: jax_gn_silu(x, gm, bt, None, None, groups, 1e-5, True))
    _, vjp = jax.vjp(fn, *map(_j, live))
    ref = [np.asarray(t) for t in vjp(_j(g))]
    leaves = [_t(a).requires_grad_() for a in live]
    out = fused_groupnorm_silu(*leaves, *([] if film else [None, None]), groups, 1e-5)
    got = torch.autograd.grad(out, leaves, _t(g))
    names = ["dx", "dgamma", "dbeta", "dfilm_scale", "dfilm_shift"]
    for name, a, r in zip(names, got, ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-4 * max(np.abs(r).max(), 1.0),
                                   err_msg=name)


def test_group_stats_clamp_a_negative_variance():
    """A constant map has E[x²] − mean² = 0 up to rounding, possibly below 0:
    the statistics clamp it, so rstd is 1/sqrt(eps), not NaN."""
    x = torch.full((1, 4, 4, 8), 3.3)
    mean, rstd = group_stats(x, 2, 1e-5)
    assert torch.allclose(mean, torch.full((1, 2), 3.3))
    assert torch.isfinite(rstd).all() and (rstd <= 1e-5 ** -0.5 * (1 + 1e-6)).all()
    out = groupnorm_silu_plain(x, torch.ones(8), torch.zeros(8), None, None, 2)
    assert torch.isfinite(out).all()
