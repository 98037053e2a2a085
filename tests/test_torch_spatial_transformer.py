"""Item 7d of the port against the JAX package, float32 on the CPU:
`models/attention_lr.py CrossAttentionLR` (null-KV and the queries appended
to the keys and values, with and without the context LayerNorm) and
`models/spatial_transformer.py SpatialTransformer` (depth 2, with a
context and without one), every flax leaf perturbed (the zero-initialised
``proj_out`` included) and bridged by `convert.from_flax`.  Compared: the
output and the gradient of a fixed projection of it with respect to every
parameter, the input and the context, each within 1e-4 of its largest
value (f32 summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sgdm_tpu.models.attention_lr import CrossAttentionLR as JCrossAttentionLR
from sgdm_tpu.models.spatial_transformer import SpatialTransformer as JSpatialTransformer
from sgdm_tpu_torch.models import CrossAttentionLR
from sgdm_tpu_torch.models.convert import from_flax, to_flax
from sgdm_tpu_torch.models.spatial_transformer import SpatialTransformer

from torch_port_common import perturbed_flat, unflatten

B, PX, C, M, CTX = 2, 4, 32, 5, 12
TOL = 1e-4


def _perturb(flat, seed):
    """perturbed_flat, and the null-KV (a leaf it leaves at N(0, 1/fan)) N(0, 1)."""
    out = perturbed_flat(flat, seed)
    rng = np.random.default_rng(seed + 100)
    for k in out:
        if k.endswith("null_kv"):
            out[k] = rng.standard_normal(out[k].shape).astype(np.float32)
    return out


def _check(jm, tm, x, context, seed=1):
    jargs = [jnp.asarray(x)] + ([] if context is None else [jnp.asarray(context)])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jargs)["params"]
    flat = _perturb(shapes, seed)
    tm.load_state_dict(from_flax(flat, tm))
    out_shape = jax.eval_shape(lambda p: jm.apply({"params": p}, *jargs), shapes).shape
    proj = np.random.default_rng(seed + 1).standard_normal(out_shape).astype(np.float32)

    def jloss(p, *a):
        return (jm.apply({"params": p}, *a) * proj).sum()

    jp = unflatten(flat)
    ref = np.asarray(jm.apply({"params": jp}, *jargs))
    grads = jax.grad(jloss, argnums=tuple(range(len(jargs) + 1)))(jp, *jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in
             ([x] + ([] if context is None else [context]))]
    out = tm(*targs)
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=TOL * np.abs(ref).max())
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(grads[0], sep="/").items()}
    got = to_flax({n: p.grad for n, p in tm.named_parameters()}, tm)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=TOL * np.abs(w).max(), err_msg=k)
    for t, g in zip(targs, grads[1:]):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=TOL * np.abs(g).max())


@pytest.mark.parametrize("norm_context", [False, True])
def test_cross_attention_lr(norm_context):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, PX, PX, C)).astype(np.float32)
    context = rng.standard_normal((B, M, CTX)).astype(np.float32)
    jm = JCrossAttentionLR(heads=2, dim_head=16, norm_context=norm_context)
    tm = CrossAttentionLR(C, heads=2, dim_head=16, context_dim=CTX, norm_context=norm_context)
    _check(jm, tm, x, context)


@pytest.mark.parametrize("with_context", [True, False], ids=["context", "self"])
def test_spatial_transformer(with_context):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, PX, PX, C)).astype(np.float32)
    context = rng.standard_normal((B, M, CTX)).astype(np.float32) if with_context else None
    jm = JSpatialTransformer(heads=2, dim_head=16, depth=2)
    tm = SpatialTransformer(C, heads=2, dim_head=16, depth=2,
                            context_dim=CTX if with_context else None)
    _check(jm, tm, x, context)
