"""Sampling-attention port (`sgdm_tpu_torch/ops/attention.py`) against the JAX
package: the plain version vs the Pallas kernel in interpret mode (1e-5),
and `SelfAttentionBlock` vs the flax block with converted weights (1e-4).
Float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import layers as jlayers
from sgdm_tpu.ops.pallas.attention import fused_self_attention as jax_attention
from sgdm_tpu_torch.models import layers as tlayers
from sgdm_tpu_torch.models.convert import from_flax
from sgdm_tpu_torch.ops import launch_counts
from sgdm_tpu_torch.ops.attention import fused_self_attention, self_attention_plain

from torch_port_common import perturbed_flat, t32, unflatten


@pytest.mark.parametrize("shape", [(2, 4, 64, 16), (1, 2, 24, 32)])
def test_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    got = self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_takes_plain_path_without_launches():
    q, k, v = (torch.randn(1, 2, 16, 8, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    before = launch_counts()
    torch.testing.assert_close(fused_self_attention(q, k, v), self_attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert launch_counts() == before


@pytest.mark.parametrize("heads,head_channels", [(4, -1), (8, 16)])
def test_module_matches_flax_block(heads, head_channels):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    jblk = jlayers.SelfAttentionBlock(num_heads=heads, num_head_channels=head_channels,
                                      use_pallas=False)
    params = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    flat = perturbed_flat(params, seed=4)
    ref = jblk.apply({"params": unflatten(flat)}, jnp.asarray(x))
    tblk = tlayers.SelfAttentionBlock(64, heads, head_channels)
    tblk.load_state_dict(from_flax(flat, tblk))
    with torch.no_grad():
        got = tblk(t32(x))
    assert not np.allclose(np.asarray(ref), x)  # proj_out perturbed: attention contributes
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
