"""Step-by-step rehearsal, in plain PyTorch on the CPU, of the training
attention backward (K9 bwd) as its two kernels compute it on the card
(`sgdm_tpu_torch/csrc/attention.cu` `bwd_block`), held against the plain
version the kernels are held to there (`flash_attention_bwd_plain`).

The arithmetic follows the kernels, not their threads: the dq kernel takes
64-row query tiles against chunks of 64 keys, the dk/dv kernel 64-row key
tiles against chunks of 64 queries with each query's lse and Dr; rows and
columns beyond N are zero rows, and the weights of columns beyond N are
zeroed; P = exp2(S·scale·log2(e) − lse·log2(e)) with the one f32 factor the
kernels are given; P and dS are rounded to bf16 where the kernels round them
(the A registers of the accumulating products); dQ, dK and dV are summed in
f32 chunk by chunk in the kernels' order, scaled and rounded once.  The
tolerance is the card's (`K9_TOL`, 2^-6 of each gradient's max|plain|), at the
training shape (N = 256, D = 64; batch and heads cut) and at every odd shape
the chip script checks.

The load schedule is rehearsed too: a block's steps, the slots its column
chunks go to (a head's chunks stay when they fit, else a ring), the cp.async
groups it commits and the count each step waits for, replayed step by step
to show that every step reads the head and chunk it needs from a group that
has landed, for both head dims and any split of the tiles over the grid."""

import math

import pytest
import torch

from sgdm_tpu_torch.ops.attention import flash_attention_bwd_plain, flash_attention_plain

K9_TOL = 2.0 ** -6   # of max|plain gradient|, as on the card
BM = BC = 64         # rows of a tile, columns of a chunk
LOG2E = math.log2(math.e)


def f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def rows_of(t: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of t [G, N, ...] as f32, zero rows beyond N."""
    out = torch.zeros((t.shape[0], n) + tuple(t.shape[2:]))
    part = t[:, r0:r0 + n].float()
    out[:, :part.shape[1]] = part
    return out


def rehearse(q, k, v, o, do, lse, scale: float):
    """q, k, v, o, do bf16 [G, N, D], lse f32 [G, N] → (dq, dk, dv) bf16, by
    the two kernels' tiling and rounding."""
    g, n, d = q.shape
    sl2 = f32(scale) * f32(LOG2E)
    lse2 = lse.float() * f32(LOG2E)
    dr = (do.float() * o.float()).sum(-1)            # the dq kernel writes it
    dq, dk, dv = (torch.empty(g, n, d, dtype=torch.bfloat16) for _ in range(3))
    nc = -(-n // BC)
    for r0 in range(0, n, BM):                       # dq kernel: query tiles
        rows = min(BM, n - r0)
        qt, dot = rows_of(q, r0, BM), rows_of(do, r0, BM)
        lt, drt = rows_of(lse2, r0, BM)[..., None], rows_of(dr, r0, BM)[..., None]
        acc = torch.zeros(g, BM, d)
        for c in range(nc):                          # chunks of keys
            kc, vc = rows_of(k, c * BC, BC), rows_of(v, c * BC, BC)
            s = qt @ kc.transpose(1, 2)
            dp = dot @ vc.transpose(1, 2)
            p = torch.exp2(s * sl2 - lt)
            p[:, :, min(BC, n - c * BC):] = 0.0      # keys beyond N
            ds = p * (dp - drt)
            acc = acc + bf16(ds) @ kc
        dq[:, r0:r0 + rows] = (acc * f32(scale))[:, :rows].to(torch.bfloat16)
    for r0 in range(0, n, BM):                       # dk/dv kernel: key tiles
        rows = min(BM, n - r0)
        kt, vt = rows_of(k, r0, BM), rows_of(v, r0, BM)
        acc_k, acc_v = torch.zeros(g, BM, d), torch.zeros(g, BM, d)
        for c in range(nc):                          # chunks of queries, with their lse and Dr
            qc, doc = rows_of(q, c * BC, BC), rows_of(do, c * BC, BC)
            lc, drc = rows_of(lse2, c * BC, BC)[:, None], rows_of(dr, c * BC, BC)[:, None]
            st = kt @ qc.transpose(1, 2)             # S^T: keys x queries
            dpt = vt @ doc.transpose(1, 2)
            pt = torch.exp2(st * sl2 - lc)
            pt[:, :, min(BC, n - c * BC):] = 0.0     # queries beyond N
            dst = pt * (dpt - drc)
            acc_v = acc_v + bf16(pt) @ doc
            acc_k = acc_k + bf16(dst) @ qc
        dk[:, r0:r0 + rows] = (acc_k * f32(scale))[:, :rows].to(torch.bfloat16)
        dv[:, r0:r0 + rows] = acc_v[:, :rows].to(torch.bfloat16)
    return dq, dk, dv


# [B, H, N, D]: the IN64 training shape (batch and heads cut), then the chip
# script's odd shapes of the training kernel
SHAPES = [(1, 2, 256, 64), (3, 2, 100, 64), (1, 3, 17, 128), (2, 1, 1024, 64),
          (2, 2, 256, 128)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_tiling_matches_plain(shape):
    b, h, n, d = shape
    gen = torch.Generator().manual_seed(n + d)
    q, k, v, do = (torch.randn(*shape, generator=gen).to(torch.bfloat16) for _ in range(4))
    out, lse = flash_attention_plain(q, k, v)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do)
    scale = (d ** -0.25) ** 2
    flat = lambda t: t.reshape(b * h, n, -1)
    got = rehearse(*(flat(t) for t in (q, k, v, out, do)), lse.reshape(b * h, n), scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        err = (a.reshape(shape).float() - w.float()).abs().max().item()
        assert err <= K9_TOL * w.float().abs().max().item(), (name, err)


def replay_schedule(n: int, heads: int, d: int, grid: int) -> int:
    """Replay every block's steps as `bwd_block` takes them; returns the
    number of steps replayed.  A group is a list entry (its payload, or None
    for an empty commit); a step that waits marks every group but the newest
    `pending` as landed."""
    ns = 2 if d > 64 else 4
    tiles = -(-n // BM)
    nc = -(-n // BC)
    total = heads * tiles
    resident = nc <= ns
    period = nc if resident else ns
    slot_of = lambda u: u % nc if resident else u % ns
    replayed = 0
    for blk in range(grid):
        g0, g1 = total * blk // grid, total * (blk + 1) // grid
        steps = (g1 - g0) * nc
        head = lambda u: (g0 + u // nc) // tiles      # head of the block's step u
        groups, slots, row_bufs = [], {}, {}
        landed = -1

        row_bufs[0] = (g0, len(groups))
        groups.append("rows")
        for i in range(period):                       # the prologue's column loads
            if i < steps:
                slots[slot_of(i)] = (head(i), i % nc, len(groups))
            groups.append("cols" if i < steps else None)
        fresh = True
        for s in range(steps):
            ti, c = divmod(s, nc)
            if c == 0 and ti > 0:
                fresh = not resident or head(s) != head(s - nc)
            if c == 0 or fresh or not resident:
                pending = period - 1 + ((c > 0) if resident else (1 <= c < ns))
                assert 0 <= pending <= 4
                landed = max(landed, len(groups) - 1 - pending)
            want_head, want_chunk, gi = slots[slot_of(s)]
            assert (want_head, want_chunk) == (head(s), c), (blk, s)
            assert gi <= landed, (blk, s, gi, landed)
            if c == 0:
                tile, gi = row_bufs[ti & 1]
                assert tile == g0 + ti and gi <= landed, (blk, s)
                if g0 + ti + 1 < g1:
                    row_bufs[(ti + 1) & 1] = (g0 + ti + 1, len(groups))
                groups.append("rows" if g0 + ti + 1 < g1 else None)
            u = s + period                            # the next step to use this slot
            if u < steps and (not resident or head(u) != head(s)):
                assert all(slot_of(x) != slot_of(s) for x in range(s + 1, u))
                slots[slot_of(s)] = (head(u), u % nc, len(groups))
                groups.append("cols")
            else:
                groups.append(None)
            replayed += 1
    return replayed


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [17, 64, 100, 128, 192, 256, 300, 1024])
def test_load_schedule_reads_landed_chunks(n, d):
    for heads in (1, 3, 8):
        tiles = heads * -(-n // BM)
        for grid in sorted({1, 2, 5, tiles}):
            if grid <= tiles:
                assert replay_schedule(n, heads, d, grid) == tiles * -(-n // BC)


def test_resident_heads_load_once_per_run():
    """At the training shape a head's 256 keys fit the four slots: a block whose
    run holds whole heads loads each head's columns once, not once per tile."""
    n, heads, tiles = 256, 4, 4
    loads = 0
    nc, period = 4, 4
    steps = heads * tiles * nc
    for s in range(steps):
        u = s + period
        if u < steps and (u // nc) // tiles != (s // nc) // tiles:
            loads += 1
    assert loads == (heads - 1) * nc     # the first head's chunks come with the prologue
