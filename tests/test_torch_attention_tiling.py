"""Step-by-step rehearsal, in plain PyTorch on the CPU, of the tiling the two
attention forward kernels use on the card (`sgdm_tpu_torch/csrc/
attention_core.cuh`), held against the plain versions the kernels are held to
there (`self_attention_plain`, `flash_attention_plain`,
`null_kv_attention_plain`).

The rehearsal follows the kernel's arithmetic, not its threads: 64-row query
tiles; keys in chunks of 256 (128 at head dim 128), each chunk as wide as the
wgmma that takes it (32, 64, 128 or 256 columns; tail keys are zero rows masked
to -inf before the row maximum); head dim padded with zero columns to 32, 64 or
128; a base-2 exponent with scale*log2(e) folded into one multiply-add; with one
chunk the weights are normalised in f32 and then rounded to bf16, with more
chunks the running maximum and sum are carried, the unnormalised weights are
what is rounded, and the division comes last; the log-sum-exp is converted
back to natural log.  What it shows, before the card is asked, is that this
rounding stays inside the tolerance the kernels are held to (`ATTENTION_TOL`,
2^-6 of max|plain|, and 1e-5 for the log-sum-exp), at the shapes of the model
paths (N, M, D as on the card; batch and heads cut) and at every odd shape the
chip script checks."""

import math

import pytest
import torch

from sgdm_tpu_torch.ops.attention import (flash_attention_plain, null_kv_attention_plain,
                                          self_attention_plain)

ATTENTION_TOL = 2.0 ** -6   # of max(max|plain|, 1), as on the card
LSE_TOL = 1e-5              # max|lse - plain| / max|plain|
BM = 64                     # query rows per tile
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)


def chunk_keys(dp: int) -> int:
    return 128 if dp > 64 else 256


def width_class(n: int) -> int:
    return 32 if n <= 32 else 64 if n <= 64 else 128 if n <= 128 else 256


def padded_dim(d: int) -> int:
    return 32 if d <= 32 else 64 if d <= 64 else 128


def f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def rehearse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """q [G, R, D], k, v [G, M, D] in bf16 → (out bf16 [G, R, D], lse f32
    [G, R]) by the kernel's tiling; `scale` multiplies q·k."""
    g, r, d = q.shape
    m = k.shape[1]
    dp = padded_dim(d)
    bn = chunk_keys(dp)
    nc = -(-m // bn)
    single = nc == 1
    sl2 = f32(scale) * f32(LOG2E)           # the one f32 factor the kernel is given
    pad_d = lambda t: torch.nn.functional.pad(t.float(), (0, dp - d))
    qf, kf, vf = pad_d(q), pad_d(k), pad_d(v)
    out = torch.empty(g, r, d, dtype=torch.bfloat16)
    lse = torch.empty(g, r, dtype=torch.float32)
    for row0 in range(0, r, BM):
        rows = min(BM, r - row0)
        qt = torch.zeros(g, BM, dp)
        qt[:, :rows] = qf[:, row0:row0 + rows]      # rows beyond R are zero-filled
        o = torch.zeros(g, BM, dp)
        run_m = torch.full((g, BM), -math.inf)
        run_l = torch.zeros(g, BM)
        for c in range(nc):
            nvalid = min(bn, m - c * bn)
            nw = width_class(nvalid)
            kc, vc = torch.zeros(g, nw, dp), torch.zeros(g, nw, dp)   # tail keys: zero rows
            kc[:, :nvalid] = kf[:, c * bn:c * bn + nvalid]
            vc[:, :nvalid] = vf[:, c * bn:c * bn + nvalid]
            s = qt @ kc.transpose(1, 2)                               # f32 accumulators
            s[:, :, nvalid:] = -math.inf                              # before the row maximum
            new_m = torch.maximum(run_m, s.amax(-1))
            alpha = torch.exp2((run_m - new_m) * sl2)                 # 0 at the first chunk
            p = torch.exp2(s * sl2 - (new_m * sl2)[..., None])        # one exponent an element
            run_l = run_l * alpha + p.sum(-1)
            run_m = new_m
            if single:
                p = p * (1.0 / run_l)[..., None]                      # normalise, then round
            else:
                o = o * alpha[..., None]
            assert (p[:, :, nvalid:] == 0).all()                      # pad keys: exact zeros
            o = o + p.to(torch.bfloat16).float() @ vc
        if not single:
            o = o * (1.0 / run_l)[..., None]                          # the division comes last
        out[:, row0:row0 + rows] = o[:, :rows, :d].to(torch.bfloat16)
        lse[:, row0:row0 + rows] = (run_m * sl2 * LN2 + torch.log(run_l))[:, :rows]
    return out, lse


def operands(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=gen).to(torch.bfloat16) for _ in range(3)]


def within_tol(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= ATTENTION_TOL * max(scale, 1.0), (err, scale)


# [B, H, N, D]: the IN64 sampling shape (batch cut), then the chip script's odd shapes
SELF_SHAPES = [(1, 2, 256, 64), (3, 2, 100, 32), (1, 3, 17, 128), (2, 1, 1024, 64),
               (2, 2, 256, 32), (2, 2, 256, 128), (1, 1, 2048, 64)]


@pytest.mark.parametrize("shape", SELF_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_self_attention_tiling_matches_plain(shape):
    b, h, n, d = shape
    q, k, v = operands(shape, seed=n + d)
    got, _ = rehearse(*(t.reshape(b * h, n, d) for t in (q, k, v)), scale=(d ** -0.25) ** 2)
    within_tol(got.reshape(shape), self_attention_plain(q, k, v))


# the training shape (batch cut) and the chip script's odd shapes of the training kernel
FLASH_SHAPES = [(1, 2, 256, 64), (3, 2, 100, 64), (1, 3, 17, 128), (2, 1, 1024, 64)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_forward_tiling_matches_plain_with_lse(shape):
    b, h, n, d = shape
    q, k, v = operands(shape, seed=7 + n + d)
    got, lse = rehearse(*(t.reshape(b * h, n, d) for t in (q, k, v)), scale=(d ** -0.25) ** 2)
    ref, ref_lse = flash_attention_plain(q, k, v)
    within_tol(got.reshape(shape), ref)
    lse_err = (lse.reshape(b, h, n) - ref_lse).abs().max() / ref_lse.abs().max()
    assert lse_err <= LSE_TOL, lse_err


# [B, N, H, D, M]: the VOC64 shape (batch and heads cut: M = 273 is a chunk of
# 256 keys and one of 17 in a 32-wide wgmma), then the chip script's odd shapes
# (1041 keys: batch and heads cut)
NULL_KV_SHAPES = [(1, 256, 2, 64, 273), (3, 49, 32, 21, 66), (2, 64, 32, 28, 81),
                  (1, 1024, 2, 32, 1041), (2, 256, 8, 64, 257), (1, 17, 3, 128, 34),
                  (2, 5, 1, 8, 1), (2, 256, 8, 64, 256), (2, 256, 8, 64, 280)]


@pytest.mark.parametrize("shape", NULL_KV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_null_kv_tiling_matches_plain(shape):
    b, n, h, d, m = shape
    gen = torch.Generator().manual_seed(m + d)
    q = (torch.randn(b, n, h, d, generator=gen) * d ** -0.5).to(torch.bfloat16)
    k, v = (torch.randn(b, m, d, generator=gen).to(torch.bfloat16) for _ in range(2))
    # the kernel's view: an item's rows are its pixels x heads, read in place
    got, _ = rehearse(q.reshape(b, n * h, d), k, v, scale=1.0)
    within_tol(got.reshape(b, n, h, d), null_kv_attention_plain(q, k, v))


@pytest.mark.parametrize("m,widths", [(273, [256, 32]), (256, [256]), (257, [256, 32]),
                                      (280, [256, 32]), (17, [32]), (100, [128]),
                                      (1041, [256, 256, 256, 256, 32])])
def test_key_chunks_are_as_wide_as_their_keys_need(m, widths):
    bn = chunk_keys(64)
    got = [width_class(min(bn, m - c * bn)) for c in range(-(-m // bn))]
    assert got == widths
    assert sum(got) >= m and sum(got) - m < 32   # never more than one wgmma step of padding


def test_single_chunk_keeps_the_normalise_then_round_order():
    """At N <= 256 the rehearsal's weights are the plain version's bit for bit
    up to the exponent's rounding: the outputs differ by at most one bf16 ulp."""
    q, k, v = operands((2, 128, 64), seed=5)
    got, _ = rehearse(q, k, v, scale=0.125)
    ref = self_attention_plain(q[None], k[None], v[None])[0]
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -8 * max(ref.float().abs().max().item(), 1.0), err


# ------------------------------------------- the warp-specialised forward's schedule
# `attn_core::pingpong_block` (head dim 64, at most 256 keys): a block takes a
# run of whole heads; two producer threads issue the loads by TMA into rings
# behind mbarriers, one the K and V (two stages, a head ahead), one each
# consumer's Q tiles (four stages, handed back one unit after use, once the
# tile's output, written over it, has been stored); two consumer warpgroups
# take the two 64-row tiles of a unit and alternate their products on the
# tensor cores through two named barriers.  The rehearsal runs the four roles
# as coroutines over a model of the barriers, in random orders the barriers
# allow, and checks that no order deadlocks, that every consumer reads the
# stage holding its head's K and V and its own Q tile, and that the products
# alternate consumer by consumer.
KV_STAGES, Q_STAGES = 2, 4


class MBarrier:
    """An mbarrier: `count` arrivals (and the expected TMA bytes) complete a
    phase; a wait on parity p passes once the phase of parity p is complete
    (on a fresh barrier, at phase 0, a wait on parity 1 passes at once)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self):
        assert self.pending > 0
        self.pending -= 1
        self._check()

    def expect_tx(self, nbytes):
        self.tx += nbytes
        self.arrive()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._check()

    def passed(self, parity):
        return (self.phase & 1) != parity


class NamedBarrier:
    """bar.sync / bar.arrive of two warpgroups (one unit each): complete when
    both have come; an arrival by the same warpgroup twice in one generation
    would complete it early, which the schedule must never do."""

    def __init__(self):
        self.units, self.gen = [], 0

    def arrive(self, who):
        assert who not in self.units, "a warpgroup arrived twice in one generation"
        self.units.append(who)
        if len(self.units) == 2:
            self.units, self.gen = [], self.gen + 1


class Ring:
    def __init__(self, stages):
        self.stages, self.stage, self.phase = stages, 0, 0

    def advance(self):
        self.stage += 1
        if self.stage == self.stages:
            self.stage, self.phase = 0, self.phase ^ 1


def pingpong_schedule(heads, nq, blocks, order_seed):
    """Run every block (heads [heads*g/G, heads*(g+1)/G)) with the four roles
    interleaved at random (seeded); returns the tiles the consumers computed
    and the order in which they issued their products."""
    import random

    pairs = -(-(-(-nq // 64)) // 2)
    done, issues = [], []
    for g in range(blocks):
        h0 = heads * g // blocks
        nh = heads * (g + 1) // blocks - h0
        n = nh * pairs
        kv_full = [MBarrier(1) for _ in range(KV_STAGES)]
        kv_empty = [MBarrier(2) for _ in range(KV_STAGES)]
        q_full = [[MBarrier(1) for _ in range(2)] for _ in range(Q_STAGES)]
        q_empty = [[MBarrier(1) for _ in range(2)] for _ in range(Q_STAGES)]
        kv_stage, q_stage = [None] * KV_STAGES, [[None, None] for _ in range(Q_STAGES)]
        turn = [NamedBarrier(), NamedBarrier()]    # ids 1, 2: the first's, the second's

        def producer_kv():
            kv = Ring(KV_STAGES)
            for head in range(h0, h0 + nh):
                yield lambda s=kv.stage, ph=kv.phase: kv_empty[s].passed(ph ^ 1)
                kv_full[kv.stage].expect_tx(2)
                kv_stage[kv.stage] = head
                kv_full[kv.stage].complete_tx(2)   # TMA lands (at once in the model)
                kv.advance()

        def producer_q():
            q = Ring(Q_STAGES)
            for head in range(h0, h0 + nh):
                for pair in range(pairs):
                    for c in range(2):
                        yield lambda s=q.stage, c=c, ph=q.phase: q_empty[s][c].passed(ph ^ 1)
                        q_full[q.stage][c].expect_tx(1)
                        q_stage[q.stage][c] = (head, 2 * pair + c)
                        q_full[q.stage][c].complete_tx(1)
                    q.advance()

        def consumer(c):
            kv, q, head, pair, last_q = Ring(KV_STAGES), Ring(Q_STAGES), h0, 0, None
            mine, other = turn[c], turn[1 - c]
            if c == 1:
                turn[0].arrive(1)
            for i in range(n):
                last_of_head = pair == pairs - 1
                for phase in ("S", "PV"):
                    gen = mine.gen
                    mine.arrive(c)
                    yield lambda gen=gen: mine.gen > gen                 # named_sync(mine)
                    if phase == "S":
                        if pair == 0:
                            yield lambda s=kv.stage, ph=kv.phase: kv_full[s].passed(ph)
                        yield lambda s=q.stage, ph=q.phase: q_full[s][c].passed(ph)
                        assert kv_stage[kv.stage] == head
                        assert q_stage[q.stage][c] == (head, 2 * pair + c)
                    issues.append((g, c, phase))
                    if not (phase == "PV" and c == 1 and i == n - 1):
                        other.arrive(c)                                   # named_arrive(other)
                if last_of_head:
                    kv_empty[kv.stage].arrive()
                    kv.advance()
                done.append((head, 2 * pair + c))
                if last_q is not None:           # the last unit's stage, its store read
                    q_empty[last_q][c].arrive()
                last_q = q.stage
                q.advance()
                pair += 1
                if pair == pairs:
                    pair, head = 0, head + 1

        rng = random.Random(order_seed * 1000 + g)
        roles = [producer_kv(), producer_q(), consumer(0), consumer(1)]
        waits = [lambda: True] * len(roles)
        while roles:
            ready = [j for j in range(len(roles)) if waits[j]()]
            assert ready, f"deadlock in block {g}"
            j = rng.choice(ready)
            try:
                waits[j] = next(roles[j])
            except StopIteration:
                del roles[j], waits[j]
        assert not turn[0].units and not turn[1].units, "a turn left half taken"
    return done, issues


# (heads, N, blocks, seed of the interleaving): the IN64 shape on 132 SMs, odd
# tile counts, one tile, more heads than stages, two orders each
@pytest.mark.parametrize("heads,nq,blocks,order_seed", [
    (1024, 256, 132, 0), (6, 100, 4, 0), (6, 100, 4, 1), (5, 17, 5, 0), (5, 17, 3, 1),
    (7, 256, 1, 0), (7, 256, 2, 1), (3, 192, 2, 0), (3, 192, 1, 1), (9, 256, 4, 0)])
def test_pingpong_schedule_covers_every_tile_without_deadlock(heads, nq, blocks, order_seed):
    done, issues = pingpong_schedule(heads, nq, blocks, order_seed)
    tiles = -(-nq // 64)
    want = sorted((h, t) for h in range(heads) for t in range(2 * -(-tiles // 2)))
    assert sorted(done) == want          # tile `tiles` (odd tile counts) is all rows past nq
    for g in range(blocks):                # products alternate consumer by consumer
        mine = [c for gg, c, _ in issues if gg == g]
        assert mine == [0, 1] * (len(mine) // 2)
