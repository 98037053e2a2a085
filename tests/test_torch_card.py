"""Tests of the port that need the card: the CUDA kernels have no CPU mode.

They import torch and the port only (no JAX), skip without a card, and run
on one with

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

(`--noconftest`: the suite's conftest configures JAX, which the card's
machine does not have).  Tolerance: K9_TOL of chip_smoke.py, 2^-6 of each
gradient's max |value|.
"""

import pytest
import torch

from sgdm_tpu_torch.models.factory import init_random_params
from sgdm_tpu_torch.models.layers import SelfAttentionBlock
from sgdm_tpu_torch.ops import attention as att

K9_TOL = 2.0 ** -6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
def test_flash_attention_takes_any_layout(card):
    """`flash_attention(q, k, v).sum().backward()`: a transposed q and the
    stride-0 dO of the sum are copied for the kernels, and the gradients agree
    with the plain version's."""
    gen = torch.Generator(device=card).manual_seed(0)
    b, h, n, d = 2, 2, 256, 64
    q = torch.randn(b, h, d, n, generator=gen, device=card).bfloat16().transpose(-1, -2)
    k, v = (torch.randn(b, h, n, d, generator=gen, device=card).bfloat16() for _ in range(2))
    grads = []
    for kernels in (True, False):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = att.flash_attention_bwd_cuda.launches
        att.flash_attention(*leaves, kernels=kernels).sum().backward()
        assert att.flash_attention_bwd_cuda.launches - before == int(kernels)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.isfinite(got.float()).all() and _rel_err(got, want) <= K9_TOL


@pytest.mark.cuda
def test_training_block_packed_route_matches_views(card):
    """The training `SelfAttentionBlock` (K9 on its qkv projection, gradient
    written in the projection's layout) against `flash_attention` on the
    three views of the same projection."""
    torch.manual_seed(0)
    # random nonzero weights: the zero-initialised proj_out would zero every gradient
    block = init_random_params(SelfAttentionBlock(128, 2, dtype=torch.bfloat16), 1).to(card)
    x = torch.randn(2, 16, 16, 128, device=card, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(x.shape, device=card, dtype=torch.bfloat16)

    def on_views():
        h = block.norm(x).reshape(2, 256, 128)
        q, k, v = block.qkv(h).reshape(2, 256, 3, 2, 64).permute(2, 0, 3, 1, 4)
        out = att.flash_attention(q, k, v).permute(0, 2, 1, 3).reshape(2, 256, 128)
        return x + block.proj_out(out).reshape(x.shape)

    leaves = [x] + list(block.parameters())
    got = torch.autograd.grad(block(x, train=True), leaves, g)
    want = torch.autograd.grad(on_views(), leaves, g)
    for a, w in zip(got, want):
        assert _rel_err(a, w) <= K9_TOL


@pytest.mark.cuda
def test_resblock_bwd_matches_plain_at_an_odd_shape(card):
    """K5 (the redesigned backward: data gradients on the forward's convolution,
    weight gradients on wgmma over runs of spatial tiles) against its plain
    version on K4's residuals, at a ragged 13 x 21 image, channels that fill
    no 64-wide block (Cin 44, Cout 52: a projection skip), B = 3, dropout
    0.1.  Tolerance: K5_TOL of chip_smoke.py, 2^-5 of each gradient's max."""
    import math

    from sgdm_tpu_torch.ops import resblock as rb

    gen = torch.Generator(device=card).manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    b, h, w, cin, cout = 3, 13, 21, 44, 52
    x = r(b, h, w, cin).bfloat16()
    args = [1 + 0.1 * r(cin), 0.1 * r(cin), r(3, 3, cin, cout) / math.sqrt(9 * cin),
            0.1 * r(cout), (0.1 * r(b, cout)).bfloat16(), (0.1 * r(b, cout)).bfloat16(),
            1 + 0.1 * r(cout), 0.1 * r(cout), r(3, 3, cout, cout) / math.sqrt(9 * cout),
            0.1 * r(cout)]
    skw = r(1, 1, cin, cout) / math.sqrt(cin)
    kw = dict(dropout_rate=0.1, seed=1234)
    res = rb.resblock_train_cuda(x, *args, skw, None, **kw)
    dout = r(*res[0].shape).bfloat16()
    bargs = (x, dout, *res[1:], args[0], args[1], args[2], args[4], args[5], args[6], args[7],
             args[8], skw)
    before = rb.resblock_bwd_cuda.launches
    got = rb.resblock_bwd_cuda(*bargs, **kw)
    assert rb.resblock_bwd_cuda.launches - before == 1
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:                                   # the plain side in full f32
        want = rb.resblock_bwd_plain(*bargs, **kw)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for a, ref in zip(got, want):
        if ref is None:
            assert a is None
            continue
        assert torch.isfinite(a.float()).all() and _rel_err(a, ref) <= 2.0 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 64, 64, 384), (3, 5, 7, 36)], ids=["in64", "odd"])
def test_groupnorm_silu_both_routes_match_plain(card, shape):
    """K6 on its cluster route (one launch, the sample resident in a cluster's
    shared memory) and on its split route (statistics, then apply), with FiLM,
    against its plain version, at the largest shape of the unfused IN64 model
    (a 16-block cluster a sample) and at an odd one (C % 8 != 0); two calls
    give the same bits.  Tolerance: K6_TOL of chip_smoke.py, 2^-7 of max|plain|
    (one bf16 rounding of an f32 chain on both sides)."""
    import math

    from sgdm_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device=card).manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=gen, device=card)
    b, h, w, c = shape
    x = (1.5 * r(b, h, w, c) + 0.5).bfloat16()
    ops = (x, 1 + 0.1 * r(c), 0.1 * r(c), (0.1 * r(b, c)).bfloat16(), (0.1 * r(b, c)).bfloat16())
    groups = math.gcd(32, c)
    want = gn.groupnorm_silu_plain(*ops, groups)
    scale = want.float().abs().max().item()
    for route in ("cluster", "split"):
        before = gn.groupnorm_silu_cuda.launches
        got = gn.groupnorm_silu_cuda(*ops, groups, route=route)
        assert gn.groupnorm_silu_cuda.launches - before == 1
        assert torch.isfinite(got.float()).all()
        assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -7 * max(scale, 1.0)
        assert torch.equal(got, gn.groupnorm_silu_cuda(*ops, groups, route=route))


K9_F32_TOL = 1e-4   # chip_smoke.py's: both sides exact f32, apart in summation order


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 256, 64), (3, 2, 100, 64), (1, 3, 17, 128),
                                   (2, 2, 300, 128), (2, 1, 1024, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_f32_matches_plain(card, shape):
    """K9 on f32 operands (forward with its lse, backward) and K3's f32
    forward against the plain versions in full f32 (TF32 off), on the
    strided views of a packed [B, N, 3, H, D] projection as the classifier's
    block hands them over; the backward's second run gives the same bits."""
    b, h, n, d = shape
    gen = torch.Generator(device=card).manual_seed(n + d)
    q, k, v = torch.randn(b, n, 3, h, d, generator=gen, device=card).permute(2, 0, 3, 1, 4)
    do = torch.randn(b, h, n, d, generator=gen, device=card)
    before = (att.flash_attention_fwd_f32_cuda.launches, att.flash_attention_bwd_f32_cuda.launches)
    out, lse = att.flash_attention_fwd_f32_cuda(q, k, v)
    grads = att.flash_attention_bwd_f32_cuda(q, k, v, out, lse, do)
    again = att.flash_attention_bwd_f32_cuda(q, k, v, out, lse, do)
    assert (att.flash_attention_fwd_f32_cuda.launches - before[0],
            att.flash_attention_bwd_f32_cuda.launches - before[1]) == (1, 2)
    k3 = att.self_attention_cuda(q, k, v)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref, ref_lse = att.flash_attention_plain(q, k, v)
        want = att.flash_attention_bwd_plain(q, k, v, out, lse, do)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for got, ref_t in [(out, ref), (k3, ref), (lse, ref_lse)] + list(zip(grads, want)):
        assert torch.isfinite(got).all() and _rel_err(got, ref_t) <= K9_F32_TOL
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
