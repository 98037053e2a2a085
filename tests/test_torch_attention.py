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
from sgdm_tpu_torch.ops.attention import (flash_attention_fwd_cuda, fused_self_attention,
                                          self_attention_cuda, self_attention_plain)

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


@pytest.mark.parametrize("shape", [(2, 16, 4, 8), (1, 24, 2, 32), (3, 64, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_strided_views_of_packed_qkv_equal_contiguous_call(shape, dtype):
    """`SelfAttentionBlock` hands the attention the permuted thirds of its
    [B, N, 3, H, D] projection without copying them: the result must be the
    contiguous call's, bit for bit."""
    b, n, h, d = shape
    qkv = torch.randn(b, n, 3, h, d, generator=torch.Generator().manual_seed(n + d)).to(dtype)
    views = tuple(qkv.permute(2, 0, 3, 1, 4))          # [b, h, n, d] each, no copy
    assert not any(t.is_contiguous() for t in views)
    assert all(t.data_ptr() == qkv[:, :, i].data_ptr() for i, t in enumerate(views))
    got = fused_self_attention(*views)
    want = fused_self_attention(*(t.contiguous() for t in views))
    assert got.shape == (b, h, n, d) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_wrapper_raises_on_a_cpu_tensor():
    q, k, v = (torch.zeros(1, 2, 16, 32, dtype=torch.bfloat16) for _ in range(3))
    with pytest.raises(ValueError, match="CPU tensor"):
        self_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CPU tensor"):
        flash_attention_fwd_cuda(q, k, v)


@pytest.mark.parametrize("train", [False, True], ids=["sampling", "training"])
def test_module_on_views_matches_flax_block_both_routes(train):
    """The block no longer copies q, k, v out of the projection: the sampling
    route (fused attention) and the training route (here the einsum path: 64
    positions) still match the flax block."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    jblk = jlayers.SelfAttentionBlock(num_heads=2, num_head_channels=-1, use_pallas=False)
    params = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    flat = perturbed_flat(params, seed=12)
    ref = jblk.apply({"params": unflatten(flat)}, jnp.asarray(x))   # one route in flax: einsum
    tblk = tlayers.SelfAttentionBlock(32, 2, -1)
    tblk.load_state_dict(from_flax(flat, tblk))
    with torch.no_grad():
        got = tblk(t32(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
