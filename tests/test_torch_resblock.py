"""Fused-ResBlock port (`sgdm_tpu_torch/ops/resblock.py`) against the JAX
package: the plain version vs the Pallas kernel in interpret mode, and the
`ResBlock` module vs `sgdm_tpu.models.layers.ResBlock` with converted weights.
Float32 on the CPU; tolerance 2e-4, the JAX suite's own for this kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import layers as jlayers
from sgdm_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from sgdm_tpu_torch.models import layers as tlayers
from sgdm_tpu_torch.models.convert import from_flax
from sgdm_tpu_torch.ops import launch_counts
from sgdm_tpu_torch.ops.resblock import fused_resblock, resblock_cuda, resblock_plain

from torch_port_common import perturbed_flat, t32, unflatten

TOL = dict(rtol=2e-4, atol=2e-4)


def _operands(B, H, W, cin, cout, proj, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ops = [f(B, H, W, cin), f(cin) * 0.1 + 1, f(cin) * 0.1, f(3, 3, cin, cout) * 0.1,
           f(cout) * 0.1, f(B, cout) * 0.1, f(B, cout) * 0.1, f(cout) * 0.1 + 1,
           f(cout) * 0.1, f(3, 3, cout, cout) * 0.1, f(cout) * 0.1]
    ops += [f(1, 1, cin, cout) * 0.1, f(cout) * 0.1] if proj else [None, None]
    return ops


@pytest.mark.parametrize("case", [
    dict(cin=32, cout=32, proj=False, resample=None),
    dict(cin=32, cout=64, proj=True, resample=None),
    dict(cin=32, cout=32, proj=False, resample="up"),
    dict(cin=32, cout=32, proj=False, resample="down"),
], ids=["identity", "proj", "up", "down"])
def test_plain_matches_pallas_interpret(case):
    H = W = 16 if case["resample"] == "down" else 8
    ops = _operands(2, H, W, case["cin"], case["cout"], case["proj"], seed=3)
    ref = jax_fused_resblock(*[None if o is None else jnp.asarray(o) for o in ops],
                             resample=case["resample"], interpret=True)
    got = resblock_plain(*[None if o is None else torch.from_numpy(o) for o in ops],
                         resample=case["resample"])
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_dispatch_takes_plain_path_without_launches():
    ops = [None if o is None else torch.from_numpy(o)
           for o in _operands(2, 8, 8, 32, 64, True, seed=4)]
    before = launch_counts()
    out = fused_resblock(*ops)
    torch.testing.assert_close(out, resblock_plain(*ops), rtol=0, atol=0)
    assert launch_counts() == before


def test_kernel_wrapper_refuses_cpu_tensors():
    ops = [None if o is None else torch.from_numpy(o)
           for o in _operands(2, 8, 8, 32, 32, False, seed=5)]
    with pytest.raises(ValueError, match="CPU tensor"):
        resblock_cuda(*ops)


@pytest.mark.parametrize("kind", ["identity", "proj", "up", "down"])
def test_module_matches_flax_resblock(kind):
    B, H, cin, emb_dim = 2, 16, 32, 48
    cout = 64 if kind == "proj" else cin
    kw = {"up": dict(up=True), "down": dict(down=True)}.get(kind, {})
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, H, H, cin)).astype(np.float32)
    emb = rng.standard_normal((B, emb_dim)).astype(np.float32)
    jblk = jlayers.ResBlock(out_channels=cout, use_pallas=False, **kw)
    params = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(emb))["params"]
    flat = perturbed_flat(params, seed=12)
    ref = jblk.apply({"params": unflatten(flat)}, jnp.asarray(x), jnp.asarray(emb))

    tblk = tlayers.ResBlock(cin, cout, emb_dim, **kw)
    tblk.load_state_dict(from_flax(flat, tblk))
    with torch.no_grad():
        got = tblk(t32(x), t32(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
