"""Training attention of the port (K9; `ops/attention.py`) against the JAX
package's einsum path (`sgdm_tpu/models/layers.py:433-442`), float32 on the CPU.

  * `flash_attention_plain` + `flash_attention_bwd_plain` vs the einsum
    attention and its `jax.vjp`: 1e-5 of max |value| (the same f32 softmax,
    summed in another order);
  * `SelfAttentionBlock` in training mode (N = 256 ≥ 128, d = 64: the flash
    route) and below the gate (N = 64: the einsum route) vs `jax.grad` of
    the flax block with converted weights: 1e-4 of each gradient's max |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import layers as jlayers
from sgdm_tpu_torch.models import layers as tlayers
from sgdm_tpu_torch.models.convert import from_flax, to_flax
from sgdm_tpu_torch.ops import launch_counts
from sgdm_tpu_torch.ops.attention import (flash_attention, flash_attention_bwd_cuda,
                                          flash_attention_bwd_plain, flash_attention_fwd_cuda,
                                          flash_attention_plain)

from torch_port_common import perturbed_flat, t32, unflatten


def _einsum_attention(q, k, v):
    """layers.py:433-442 on [B, H, N, D] operands."""
    d = q.shape[-1]
    scale = 1.0 / np.sqrt(np.sqrt(d))
    logits = jnp.einsum("bhnd,bhmd->bhnm", q * scale, k * scale,
                        preferred_element_type=jnp.float32)
    weights = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("bhnm,bhmd->bhnd", weights, v)


@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 3, 40, 128)])
def test_plain_forward_backward_match_einsum_vjp(shape):
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    ref, vjp = jax.vjp(_einsum_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = [np.asarray(ref)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv)
    got = [out] + list(flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo))
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    logits = np.einsum("bhnd,bhmd->bhnm", q, k) / np.sqrt(shape[-1])
    m = logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), m + np.log(np.exp(logits - m[..., None]).sum(-1)),
                               rtol=1e-6, atol=1e-5)


def test_autograd_entry_and_wrappers():
    q, k, v = (torch.randn(1, 2, 32, 64, generator=torch.Generator().manual_seed(i),
                           requires_grad=True) for i in range(3))
    before = launch_counts()
    out = flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    ref_o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach())
    ref = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), ref_o, lse,
                                    torch.ones_like(out))
    torch.testing.assert_close(out.detach(), ref_o, rtol=0, atol=0)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert launch_counts() == before
    qb = q.detach().bfloat16()
    with pytest.raises(ValueError, match="CPU tensor"):
        flash_attention_fwd_cuda(qb, qb, qb)
    with pytest.raises(ValueError, match="CPU tensor"):
        flash_attention_bwd_cuda(qb, qb, qb, qb, lse, qb)


@pytest.mark.parametrize("side", [16, 8], ids=["flash-route", "einsum-route"])
def test_training_block_grads_match_flax(side):
    c, heads = 64, 1   # d = 64
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, side, side, c)).astype(np.float32)
    gout = rng.standard_normal(x.shape).astype(np.float32)
    jblk = jlayers.SelfAttentionBlock(num_heads=heads, use_pallas=False)
    params = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    flat = perturbed_flat(params, seed=6)

    def loss(p, xx):
        return jnp.sum(jblk.apply({"params": p}, xx) * gout)

    gp, gx = jax.grad(loss, argnums=(0, 1))(unflatten(flat), jnp.asarray(x))
    tblk = tlayers.SelfAttentionBlock(c, heads)
    tblk.load_state_dict(from_flax(flat, tblk))
    xt = t32(x).requires_grad_()
    out = tblk(xt, train=True)
    names = [n for n, _ in tblk.named_parameters()]
    grads = torch.autograd.grad(out, [xt] + list(tblk.parameters()), torch.from_numpy(gout))
    ref = {"x": np.asarray(gx)}
    from flax import traverse_util

    ref.update(traverse_util.flatten_dict(jax.tree.map(np.asarray, gp), sep="/"))
    got = {"x": grads[0].numpy()}
    got.update(to_flax(dict(zip(names, grads[1:])), tblk))
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=key)


def test_packed_projection_takes_the_packed_route():
    """`SelfAttentionBlock` hands K9 its [B, N, 3, H, D] qkv projection through
    `_packed_flash_attention`, whose backward returns the projection's gradient
    in that layout; its result equals `flash_attention` on the three views."""
    from sgdm_tpu_torch.ops import attention as att

    b, n, h, d = 2, 32, 2, 64
    gen = torch.Generator().manual_seed(11)
    proj = torch.randn(b, n, 3 * h * d, generator=gen, requires_grad=True)
    out = att._packed_flash_attention(proj.reshape(b, n, 3, h, d))
    assert type(out.grad_fn).__name__ == "_PackedFlashAttentionBackward"
    g = torch.randn(out.shape, generator=gen)
    (got,) = torch.autograd.grad(out, proj, g)
    views = proj.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    leaves = [t.detach().requires_grad_() for t in views]
    ref_out = flash_attention(*leaves)
    assert type(ref_out.grad_fn).__name__ == "_FlashAttentionBackward"
    want = torch.stack(torch.autograd.grad(ref_out, leaves, g), 2).permute(0, 3, 2, 1, 4)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(got, want.reshape(b, n, 3 * h * d), rtol=0, atol=0)
    block = tlayers.SelfAttentionBlock(h * d, h)
    x = torch.randn(b, 16, 8, h * d, generator=gen)  # N = 128: the flash gate passes
    assert _reaches(block(x, train=True).grad_fn, "_PackedFlashAttentionBackward")


def _reaches(fn, name, depth=12):
    """Whether the autograd graph below ``fn`` holds a node called ``name``."""
    if fn is None or depth == 0:
        return False
    return type(fn).__name__ == name or any(_reaches(f, name, depth - 1)
                                            for f, _ in fn.next_functions)


def test_kernel_layout_copies_only_what_the_kernels_cannot_read():
    """The K9 wrappers read the views of a packed projection in place and copy
    a transposed q or the stride-0 dO of ``out.sum().backward()``."""
    from sgdm_tpu_torch.ops.attention import _kernel_layout

    b, n, h, d = 2, 16, 2, 64
    proj = torch.zeros(b, n, 3, h, d)
    for t in proj.permute(2, 0, 3, 1, 4):
        assert _kernel_layout(t) is t
    for t in (torch.zeros(b, h, d, n).transpose(-1, -2), torch.ones(()).expand(b, h, n, d),
              torch.zeros(b * h * n * d + 1)[1:].view(b, h, n, d)):
        c = _kernel_layout(t)
        assert c is not t and c.is_contiguous() and c.data_ptr() % 16 == 0
        torch.testing.assert_close(c, t, rtol=0, atol=0)
