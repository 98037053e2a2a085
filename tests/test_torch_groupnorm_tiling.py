"""Step-by-step rehearsal, in plain PyTorch on the CPU, of K6's CUDA kernels
(`sgdm_tpu_torch/csrc/groupnorm.cu`) and of the launch plan the card runs
(`ops/groupnorm.py plan_groupnorm`), held against the plain version the
kernels are held to on the card (`groupnorm_silu_plain`).

The rehearsal follows the kernels' order of operations, not their threads.
Thread (j, r) of a block owns channels [j*V, j*V + V) (V = 8, or 1 when
C % 8 != 0) of pixels r, r + R, ... of the block's run, R = threads / (C / V),
and sums them in increasing pixel order in f32 (x², an exact product of bf16
values, added with one rounding, as fmaf does).  The block sums its R rows in
row order per channel, then each group's channels in channel order.

- Cluster route: rank r of a cluster of n owns pixels ``plan.runs[r]`` of a
  sample; after the first cluster barrier every block adds the n ranks' group
  partials in rank order, so every block derives the same bits whatever order
  the ranks finished in.
- Split route: slice s writes its per-channel sums; every apply block adds a
  sample's S slices in slice order, per channel, then folds the groups.

Both then fold γ, β and FiLM into a per-channel (A, Bc) and apply
bf16(silu(x·A + Bc)).  What this shows before the card is asked: the plans
cover every pixel once and fit the card's shared memory at every shape the
unfused IN64 model gives K6 (chip_smoke.py `k6_shapes`) and at its odd
shapes, and the kernels' order of operations stays inside K6_TOL (2^-7 of
max|plain|, one bf16 rounding of an f32 chain on both sides).

Statistics at two cluster sizes are not bit-identical to each other: the
ranks' partials group the same f32 additions differently.  They agree to a
few f32 ulps, which the tests hold too.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sgdm_tpu_torch.ops import groupnorm as gn
from sgdm_tpu_torch.ops.groupnorm import cluster_smem, group_stats, groupnorm_silu_plain, \
    plan_groupnorm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the shapes and tolerance the card is held to)

K6_TOL = chip_smoke.K6_TOL
BATCH = chip_smoke.MODEL_BATCH
SMS, MAX_SMEM = 132, 232_448          # one H100: SMs, shared memory a block may opt in to
ODD = [(3, 4, 4, 20), (2, 5, 7, 36), (2, 1, 16, 24), (1, 3, 3, 7)]
EPS = 1e-5
IN64 = sorted(chip_smoke.k6_shapes())


def _inputs(b, h, w, c, film, seed=0):
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    x = bf(1.5 * rng.standard_normal((b, h, w, c)) + 0.5)
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    fs = fsh = None
    if film:
        fs, fsh = (bf(0.1 * rng.standard_normal((b, c))) for _ in range(2))
    return x, gamma, beta, fs, fsh


# ------------------------------------------------------------------ replay

def _layout(c, threads):
    v = 8 if c % 8 == 0 else 1
    return threads // (c // v)


def _channel_sums(run: torch.Tensor, rows: int):
    """A block's per-channel (Σx, Σx²) over run [np, C] (f32, bf16-valued):
    each thread row r over pixels r, r + rows, ... in order, then the rows in
    order."""
    c = run.shape[1]
    s, q = torch.zeros(rows, c), torch.zeros(rows, c)
    for k in range(0, run.shape[0], rows):
        blk = run[k:k + rows]
        s[:blk.shape[0]] += blk
        q[:blk.shape[0]] += blk * blk      # exact square, one rounding: fmaf
    cs, cq = torch.zeros(c), torch.zeros(c)
    for r in range(rows):
        cs += s[r]
        cq += q[r]
    return cs, cq


def _group_fold(cs, cq, groups):
    gs = cs.shape[0] // groups
    ss, qq = torch.zeros(groups), torch.zeros(groups)
    for i in range(gs):
        ss += cs[i::gs]
        qq += cq[i::gs]
    return ss, qq


def _moments(ss, qq, count):
    mean = ss / count
    var = qq / count - mean * mean
    return mean, torch.rsqrt(torch.clamp(var, min=0.0) + EPS)


def _apply(xb, mean, rstd, gamma, beta, fs, fsh):
    """bf16(silu(x·A + Bc)) of one sample xb [HW, C] from its group moments."""
    gs = xb.shape[1] // mean.shape[0]
    a = rstd.repeat_interleave(gs) * gamma
    bc = beta - mean.repeat_interleave(gs) * a
    if fs is not None:
        f = 1.0 + fs.float()
        a, bc = a * f, bc * f + fsh.float()
    h = (xb.double() * a.double() + bc.double()).float()     # fmaf: one rounding
    return (h / (1.0 + torch.exp(-h))).to(torch.bfloat16)


def cluster_partials(xb, groups, plan):
    """Each rank's group partials [n, 2, G] for one sample xb [HW, C]."""
    rows = _layout(xb.shape[1], plan.threads)
    return torch.stack([torch.stack(_group_fold(*_channel_sums(xb[p0:p1].float(), rows),
                                                groups)) for p0, p1 in plan.runs])


def cluster_statistics(parts, count, order=None):
    """The (mean, rstd) [G] one block derives: the ranks' partials added in rank
    order.  ``order`` is the order in which the ranks finished; the block
    still reads them in rank order."""
    ready = {}
    for k in (order if order is not None else range(parts.shape[0])):
        ready[k] = parts[k]
    ss, qq = torch.zeros(parts.shape[2]), torch.zeros(parts.shape[2])
    for k in range(parts.shape[0]):
        ss += ready[k][0]
        qq += ready[k][1]
    return _moments(ss, qq, count)


def replay_cluster(x, gamma, beta, fs, fsh, groups, plan):
    b, h, w, c = x.shape
    xf = x.reshape(b, h * w, c)
    out = torch.empty_like(xf)
    for i in range(b):
        parts = cluster_partials(xf[i], groups, plan)
        mean, rstd = cluster_statistics(parts, float(h * w * (c // groups)))
        out[i] = _apply(xf[i].float(), mean, rstd, gamma, beta,
                        None if fs is None else fs[i], None if fsh is None else fsh[i])
    return out.reshape(x.shape)


def replay_split(x, gamma, beta, fs, fsh, groups, plan):
    b, h, w, c = x.shape
    xf = x.reshape(b, h * w, c)
    rows = _layout(c, plan.threads)
    out = torch.empty_like(xf)
    for i in range(b):
        part = [_channel_sums(xf[i, s * plan.per:(s + 1) * plan.per].float(), rows)
                for s in range(plan.slices)]
        cs, cq = torch.zeros(c), torch.zeros(c)
        for ps, pq in part:                 # slice order, per channel
            cs += ps
            cq += pq
        mean, rstd = _moments(*_group_fold(cs, cq, groups), float(h * w * (c // groups)))
        for k in range(plan.chunks):        # every apply block derives the same bits
            p0, p1 = k * plan.per_chunk, min(h * w, (k + 1) * plan.per_chunk)
            out[i, p0:p1] = _apply(xf[i, p0:p1].float(), mean, rstd, gamma, beta,
                                   None if fs is None else fs[i],
                                   None if fsh is None else fsh[i])
    return out.reshape(x.shape)


def _within_tol(got, want):
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() <= K6_TOL * max(scale, 1.0)


# ------------------------------------------------------------------ plans

def h100_blocks(threads, smem):
    """Blocks of the cluster kernel one H100 SM holds, as the card's
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them (chip_smoke.py's
    K6 rows print them as ``blocks_per_sm``): by registers three of 256
    consumers and one of 512, fewer where shared memory runs out."""
    fit = (MAX_SMEM + gn.SM_RESERVED) // (smem + gn.SM_RESERVED)
    return min(3 if threads == 256 else 1, fit)


def h100_plan(B, HW, C, sms, max_smem, **kw):
    """`plan_groupnorm` with the card's answer on blocks an SM modelled."""
    return plan_groupnorm(B, HW, C, sms, max_smem, blocks=kw.pop("blocks", h100_blocks), **kw)


def _covers(spans, hw):
    seen = torch.zeros(hw, dtype=torch.int32)
    for p0, p1 in spans:
        assert p1 > p0, "an empty span"
        seen[p0:p1] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("b, h, w, c", [(BATCH, *s) for s in IN64] + ODD,
                         ids=lambda v: str(v))
def test_plan_covers_every_pixel_once_within_shared_memory(b, h, w, c):
    groups = math.gcd(32, c)
    plan = h100_plan(b, h * w, c, SMS, MAX_SMEM, num_groups=groups)
    assert plan.route == "cluster"          # every IN64 shape and the odd ones
    assert len(plan.runs) == plan.cluster and plan.cluster in gn.CLUSTER_SIZES
    assert _covers(plan.runs, h * w)
    assert all(p1 - p0 == plan.per for p0, p1 in plan.runs[:-1])  # only the last is shorter
    assert plan.smem == cluster_smem(plan.per, c, groups, plan.threads) <= MAX_SMEM
    assert 1 <= plan.stages <= gn.MAX_STAGES
    assert plan.blocks_per_sm * (plan.smem + gn.SM_RESERVED) <= MAX_SMEM + gn.SM_RESERVED
    # the smallest cluster that leaves room for a second block on an SM (256
    # consumer threads, registers for three blocks), else the smallest that
    # fits alone, then with 512 consumers where those fit
    v = 8 if c % 8 == 0 else 1
    base = 256 if c // v <= 256 else 512
    two, one = [], []
    for n in gn.CLUSTER_SIZES:
        per = -(-h * w // n)
        if (n - 1) * per >= h * w:
            continue
        smem = cluster_smem(per, c, groups, base)
        if smem > MAX_SMEM:
            continue
        (two if h100_blocks(base, smem) >= 2 else one).append(n)
    assert plan.cluster == (two[0] if two else one[0])
    assert (plan.blocks_per_sm >= 2) == bool(two)
    wide = not two and base == 256 and cluster_smem(plan.per, c, groups, 512) <= MAX_SMEM
    assert plan.threads == (512 if wide else base)
    assert 1 <= plan.grid <= b
    split = h100_plan(b, h * w, c, SMS, MAX_SMEM, num_groups=groups, route="split")
    assert split.route == "split"
    slices = [(s * split.per, min(h * w, (s + 1) * split.per)) for s in range(split.slices)]
    chunks = [(k * split.per_chunk, min(h * w, (k + 1) * split.per_chunk))
              for k in range(split.chunks)]
    assert _covers(slices, h * w) and _covers(chunks, h * w)
    assert 1 <= split.slices <= gn.MAX_SLICES


def test_in64_plans_as_expected():
    """The largest sample (64×64×384, 3 MB) takes a 16-block cluster, one block
    an SM; the 64×64×128 sample a 16-block cluster at three blocks an SM."""
    big = h100_plan(BATCH, 64 * 64, 384, SMS, MAX_SMEM)
    assert (big.cluster, big.per, big.blocks_per_sm) == (16, 256, 1)
    assert big.smem <= MAX_SMEM
    small = h100_plan(BATCH, 64 * 64, 128, SMS, MAX_SMEM)
    assert (small.cluster, small.blocks_per_sm) == (16, 3)


def test_plan_takes_the_next_cluster_size_the_card_schedules():
    """cudaOccupancyMaxActiveClusters decides: a size the card cannot hold is
    skipped for the next, and with none left the route is split."""
    asked = []

    def clusters(n, threads, smem):
        asked.append(n)
        return 0 if n < 8 else 3
    plan = h100_plan(BATCH, 16 * 16, 512, SMS, MAX_SMEM, clusters=clusters)
    assert plan.route == "cluster" and plan.cluster == 8 and asked[0] < 8
    plan = h100_plan(BATCH, 64 * 64, 384, SMS, MAX_SMEM, clusters=lambda *a: 0)
    assert plan.route == "split"
    with pytest.raises(ValueError):
        h100_plan(BATCH, 64 * 64, 384, SMS, MAX_SMEM, route="cluster",
                       clusters=lambda *a: 0)


def test_plan_takes_what_the_card_says_an_sm_holds():
    """Blocks an SM are the card's answer: where it holds one block of 256
    consumers at every size, the smallest cluster that fits alone is taken,
    with 512 consumers; where it holds none, the route is split; and without
    an answer, shared memory alone decides."""
    one = h100_plan(BATCH, 16 * 16, 256, SMS, MAX_SMEM, blocks=lambda t, smem: 1)
    assert (one.route, one.cluster, one.threads, one.blocks_per_sm) == ("cluster", 1, 512, 1)
    assert one.grid == min(BATCH, SMS)
    none = h100_plan(BATCH, 16 * 16, 256, SMS, MAX_SMEM, blocks=lambda t, smem: 0)
    assert none.route == "split"
    by_smem = plan_groupnorm(BATCH, 64 * 64, 128, SMS, MAX_SMEM)
    assert by_smem.blocks_per_sm == (MAX_SMEM + gn.SM_RESERVED) // (by_smem.smem + gn.SM_RESERVED)


def test_plan_takes_large_samples_on_the_split_route_and_raises_beyond_the_layout():
    plan = h100_plan(BATCH, 128 * 128, 512, SMS, MAX_SMEM)   # 16 MB a sample
    assert plan.route == "split" and plan.slices >= 1 and plan.chunks >= 1
    for c in (3072, 512, 7):               # what the kernel took before, still taken
        assert h100_plan(2, 9, c, SMS, MAX_SMEM, num_groups=1).route in ("cluster", "split")
    with pytest.raises(ValueError):
        h100_plan(2, 9, 513, SMS, MAX_SMEM, num_groups=1)   # C % 8 != 0 beyond 512
    with pytest.raises(ValueError):
        h100_plan(2, 9, 36, SMS, MAX_SMEM, num_groups=5)    # groups do not divide C
    with pytest.raises(ValueError):
        h100_plan(2, 9, 36, SMS, MAX_SMEM, num_groups=4, route="tiles")


# ------------------------------------------------------------------ replays

REPLAY = {"in64-64x64x384": (2, 64, 64, 384), "in64-32x32x256": (2, 32, 32, 256),
          "in64-16x16x512": (2, 16, 16, 512), **{f"odd-{s}": s for s in ODD}}


@pytest.mark.parametrize("film", [False, True], ids=["gn", "film"])
@pytest.mark.parametrize("shape", REPLAY.values(), ids=REPLAY.keys())
def test_cluster_replay_matches_plain(shape, film):
    b, h, w, c = shape
    groups = math.gcd(32, c)
    ops = _inputs(b, h, w, c, film)
    # the plan the model batch gets: the cluster size depends on the sample only
    plan = h100_plan(BATCH, h * w, c, SMS, MAX_SMEM, num_groups=groups)
    got = replay_cluster(*ops, groups, plan)
    assert got.dtype == torch.bfloat16 and _within_tol(got, groupnorm_silu_plain(*ops, groups))


@pytest.mark.parametrize("film", [False, True], ids=["gn", "film"])
@pytest.mark.parametrize("shape", REPLAY.values(), ids=REPLAY.keys())
def test_split_replay_matches_plain(shape, film):
    b, h, w, c = shape
    groups = math.gcd(32, c)
    ops = _inputs(b, h, w, c, film, seed=1)
    plan = h100_plan(b, h * w, c, SMS, MAX_SMEM, num_groups=groups, route="split")
    got = replay_split(*ops, groups, plan)
    assert _within_tol(got, groupnorm_silu_plain(*ops, groups))


@pytest.mark.parametrize("n", [2, 4])
def test_cluster_statistics_are_the_same_bits_in_every_rank(n):
    """At cluster sizes 2 and 4: whatever order the ranks finish in, every rank
    adds the partials in rank order and derives the same bits; the statistics
    match the plain version's `group_stats` to a few f32 ulps, and those of
    the two sizes match each other as closely."""
    b, h, w, c, groups = 1, 16, 16, 128, 32
    x = _inputs(b, h, w, c, False, seed=3)[0]
    plan = h100_plan(b, h * w, c, SMS, MAX_SMEM, num_groups=groups, route="cluster",
                          cluster=n)
    assert plan.cluster == n
    parts = cluster_partials(x.reshape(h * w, c), groups, plan)
    count = float(h * w * (c // groups))
    first = cluster_statistics(parts, count)
    rng = np.random.default_rng(n)
    for _ in range(4):
        again = cluster_statistics(parts, count, order=rng.permutation(n).tolist())
        assert all(torch.equal(a, f) for a, f in zip(again, first))
    mean, rstd = group_stats(x, groups, EPS)
    torch.testing.assert_close(first[0], mean[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(first[1], rstd[0], rtol=1e-5, atol=0)
    other = h100_plan(b, h * w, c, SMS, MAX_SMEM, num_groups=groups, route="cluster",
                           cluster=2 * n)
    second = cluster_statistics(cluster_partials(x.reshape(h * w, c), groups, other), count)
    torch.testing.assert_close(second[0], first[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(second[1], first[1], rtol=1e-5, atol=0)


def test_split_statistics_are_the_same_bits_in_every_apply_block():
    """The apply blocks of one sample each add the S slice partials in slice
    order: their statistics are identical, so chunk borders never show."""
    b, h, w, c, groups = 1, 8, 9, 40, 8
    ops = _inputs(b, h, w, c, True, seed=4)
    plan = h100_plan(b, h * w, c, SMS, MAX_SMEM, num_groups=groups, route="split")
    assert plan.chunks > 1 and plan.slices > 1
    whole = replay_split(*ops, groups, plan)
    one_chunk = replay_split(*ops, groups, gn.GnPlan(
        "split", plan.threads, plan.per, plan.smem, slices=plan.slices, chunks=1,
        per_chunk=h * w))
    assert torch.equal(whole, one_chunk)
