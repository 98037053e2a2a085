"""Training ResBlock of the port (K4 forward, K5 backward; `ops/resblock.py`)
against the JAX package, float32 on the CPU.

  * `resblock_bwd_plain` and the autograd entry `fused_resblock_train` vs
    `jax.grad` of `resblock_reference` (no dropout): all 13 gradients,
    identity and projection skips; tolerance 2e-4 of each gradient's
    max |value| (f32 summation order over the batch and pixels);
  * the dropout mask and forward vs the Pallas kernel in interpret mode at
    rate 0.5 (the mask is bit-exact, so the outputs agree to 2e-4 like the
    forward without dropout);
  * 64 output channels in the gradient checks: two per GroupNorm group, so no
    gradient vanishes (with one channel per group dc1 is zero up to f32 noise);
  * the backward with dropout vs `jax.grad` of the Pallas custom VJP in
    interpret mode (2e-4 of max |grad|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from sgdm_tpu.ops.pallas.resblock import resblock_reference
from sgdm_tpu_torch.ops import launch_counts
from sgdm_tpu_torch.ops.resblock import (dropout_mask, fused_resblock_train, resblock_bwd_cuda,
                                         resblock_bwd_plain, resblock_plain, resblock_train_cuda)

TOL = 2e-4
NAMES = ["x", "gn1_scale", "gn1_bias", "w1", "b1", "film_scale", "film_shift", "gn2_scale",
         "gn2_bias", "w2", "b2", "skip_w", "skip_b"]


def _operands(B, H, W, cin, cout, proj, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ops = [f(B, H, W, cin), f(cin) * 0.1 + 1, f(cin) * 0.1, f(3, 3, cin, cout) * 0.1,
           f(cout) * 0.1, f(B, cout) * 0.1, f(B, cout) * 0.1, f(cout) * 0.1 + 1,
           f(cout) * 0.1, f(3, 3, cout, cout) * 0.1, f(cout) * 0.1]
    ops += [f(1, 1, cin, cout) * 0.1, f(cout) * 0.1] if proj else [None, None]
    return ops, f(B, H, W, cout)


def _jax_grads(fn, ops, gout):
    idx = [i for i, o in enumerate(ops) if o is not None]

    def loss(*live):
        full = list(ops)
        for i, v in zip(idx, live):
            full[i] = v
        return jnp.sum(fn(*full) * gout)

    grads = jax.grad(loss, argnums=tuple(range(len(idx))))(*[jnp.asarray(ops[i]) for i in idx])
    return {NAMES[i]: np.asarray(g) for i, g in zip(idx, grads)}


def _assert_close(got, ref):
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        scale = max(np.abs(r).max(), 1e-6)
        assert np.abs(g - r).max() <= TOL * scale, (name, np.abs(g - r).max(), scale)


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_backward_matches_jax_grad(proj):
    # 64 output channels: two per GroupNorm group, so that dc1 does not vanish
    # (GN2 would remove any per-channel constant of a one-channel group)
    cin, cout = (32, 64) if proj else (64, 64)
    ops, gout = _operands(2, 8, 8, cin, cout, proj, seed=1)
    ref = _jax_grads(lambda *a: resblock_reference(*a), ops, jnp.asarray(gout))

    # the autograd Function (CPU: the plain K4 forward, resblock_bwd_plain backward)
    live = {n: torch.from_numpy(o).requires_grad_() for n, o in zip(NAMES, ops) if o is not None}
    out = fused_resblock_train(*[live.get(n) for n in NAMES])
    grads = torch.autograd.grad(out, list(live.values()), torch.from_numpy(gout))
    _assert_close({n: g.numpy() for n, g in zip(live, grads)}, ref)

    # resblock_bwd_plain called directly on K4's residuals
    t = [None if o is None else torch.from_numpy(o) for o in ops]
    res = resblock_plain(*t, save_res=True)
    got = resblock_bwd_plain(t[0], torch.from_numpy(gout), *res[1:], t[1], t[2], t[3], t[5], t[6],
                             t[7], t[8], t[9], t[11])
    _assert_close({n: g.numpy() for n, g in zip(NAMES, got) if g is not None}, ref)


def test_dropout_mask_and_forward_match_pallas_interpret():
    ops, _ = _operands(2, 8, 8, 16, 16, False, seed=2)
    for seed in (7, -5, 2 ** 31 - 1):
        ref = jax_fused_resblock(*[None if o is None else jnp.asarray(o) for o in ops],
                                 jnp.asarray([seed], jnp.int32), dropout_rate=0.5, interpret=True)
        got = resblock_plain(*[None if o is None else torch.from_numpy(o) for o in ops],
                             dropout_rate=0.5, seed=seed)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    mask = dropout_mask(3, 64, 16, 7, 0.5)
    assert set(np.unique(mask.numpy())) == {0.0, 2.0}
    assert 0.4 < (mask == 0).float().mean().item() < 0.6


def test_backward_with_dropout_matches_pallas_vjp():
    ops, gout = _operands(2, 8, 8, 64, 64, False, seed=3)
    seed = 12345
    ref = _jax_grads(
        lambda *a: jax_fused_resblock(*a, jnp.asarray([seed], jnp.int32), dropout_rate=0.5,
                                      interpret=True), ops, jnp.asarray(gout))
    live = {n: torch.from_numpy(o).requires_grad_() for n, o in zip(NAMES, ops) if o is not None}
    out = fused_resblock_train(*[live.get(n) for n in NAMES], seed=seed, dropout_rate=0.5)
    grads = torch.autograd.grad(out, list(live.values()), torch.from_numpy(gout))
    _assert_close({n: g.numpy() for n, g in zip(live, grads)}, ref)


def test_cpu_path_counts_no_launch_and_kernel_wrappers_refuse_cpu():
    ops, gout = _operands(2, 8, 8, 16, 16, False, seed=4)
    t = [None if o is None else torch.from_numpy(o) for o in ops]
    before = launch_counts()
    x = t[0].clone().requires_grad_()
    fused_resblock_train(x, *t[1:], seed=1, dropout_rate=0.1).sum().backward()
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CPU tensor"):
        resblock_train_cuda(*t)
    res = resblock_plain(*t, save_res=True)
    with pytest.raises(ValueError, match="CPU tensor"):
        resblock_bwd_cuda(t[0], torch.from_numpy(gout), *res[1:], t[1], t[2], t[3], t[5], t[6],
                          t[7], t[8], t[9])
