"""Step-by-step rehearsal, in plain f32 PyTorch on the CPU, of K9's f32
kernels as they compute on the card (`sgdm_tpu_torch/csrc/attention_f32.cuh`),
held against the plain versions the kernels are held to there
(`flash_attention_plain`, `flash_attention_bwd_plain` on f32 tensors).

Head dim 64 (`f32_fwd_kernel`, `f32_bwd_kernel`): the forward takes 256 query
rows a block against chunks of 64 keys, zero rows beyond N, the keys beyond N
at -inf, the online softmax in natural exponent with each thread's partial
row sum (its 8 keys of a chunk) rescaled by the running maximum and the row's
8 partials summed at the end, O / l and lse = m + log(l); P V sums the chunk's
keys in the permuted order the kernel stores them.  The backward is one block
a head: key tiles of 128 and, in each, query chunks of 64 (Dr = rowsum(dO o)
as 16 four-wide partials summed by a butterfly); P^T and dS^T from S^T = K
Q^T and dP^T = V dO^T, dV and dK summed chunk by chunk in permuted query
order, dQ's share of the key tile summed by key quarters, the quarters
pairwise, and added to the sum of the tiles before it, in tile order, then
scaled once at the last tile.  Head dim 128 keeps the simple blocks (64-row
tiles, chunks of 64, the backward's two launches), rehearsed likewise.  The
tolerance is the card's (`K9_F32_TOL`, 1e-4 of each output's max|plain|); the
rehearsal reads ~1e-6, summation order only.

The rest pins the design's claims on the CPU: the thread maps cover every
tile once and the permuted positions map back; each warp's 16-byte shared
accesses take the fewest 128-byte wavefronts their bytes need (no bank
conflicts); the shared memory the constants give fits a block; and the
cp.async ring of both kernels, replayed operation by operation, reads only
chunks that have landed and become visible, and refills or rewrites a
buffer only after a barrier has closed its last reads."""

import math
import re
from pathlib import Path

import pytest
import torch

from sgdm_tpu_torch.ops.attention import _scale, flash_attention_bwd_plain, flash_attention_plain

K9_F32_TOL = 1e-4
SRC = Path(__file__).resolve().parents[1] / "sgdm_tpu_torch" / "csrc" / "attention_f32.cuh"
LD, CH, FROWS, KT, NT = 68, 64, 256, 128, 256   # attention_f32.cuh's constants
SMEM_MAX = 232_448                               # bytes a block may use on the H100


def rows_of(t: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of t [G, N, ...], zero rows beyond N."""
    out = torch.zeros((t.shape[0], n) + tuple(t.shape[2:]), dtype=t.dtype)
    part = t[:, r0:r0 + n]
    out[:, :part.shape[1]] = part
    return out


def of_position(u: int) -> int:
    """The key (forward: P) or query (backward: P^T, dS^T) of a chunk whose
    value sits at position u: column j + 8c of a thread's tile at 8j + c."""
    return (u >> 3) + 8 * (u & 7)


def butterfly(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as the kernels' xor shuffles
    take it: lane l adds lane l ^ o for o = 1, 2, 4, ...; every lane ends
    with the same bits, lane 0's returned."""
    idx = torch.arange(parts.shape[-1])
    o = 1
    while o < parts.shape[-1]:
        parts = parts + parts[..., idx ^ o]
        o <<= 1
    return parts[..., 0]


def rehearse_fwd64(q, k, v, scale: float):
    """q, k, v f32 [G, N, 64] -> (out, lse) by f32_fwd_kernel's order."""
    g, n, d = q.shape
    out, lse = torch.empty(g, n, d), torch.empty(g, n)
    perm = [of_position(u) for u in range(CH)]
    for r0 in range(0, n, FROWS):
        rows = min(FROWS, n - r0)
        qt = rows_of(q, r0, FROWS)
        m = torch.full((g, FROWS), -math.inf)
        l_part = torch.zeros(g, FROWS, 8)          # a thread's partial sum, lane j = key % 8
        acc = torch.zeros(g, FROWS, d)
        for c0 in range(0, n, CH):
            kc, vc = rows_of(k, c0, CH), rows_of(v, c0, CH)
            s = (qt @ kc.transpose(1, 2)) * torch.tensor(scale)
            s[:, :, max(0, n - c0):] = -math.inf  # keys beyond N
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            l_part = l_part * alpha[..., None] + p.reshape(g, FROWS, 8, 8).sum(-2)
            m = mn
            acc = acc * alpha[..., None] + p[:, :, perm] @ vc[:, perm]
        lr = butterfly(l_part)
        out[:, r0:r0 + rows] = (acc / lr[..., None])[:, :rows]
        lse[:, r0:r0 + rows] = (m + torch.log(lr))[:, :rows]
    return out, lse


def rehearse_bwd64(q, k, v, o, do, lse, scale: float):
    """f32 [G, N, 64] operands, lse [G, N] -> (dq, dk, dv) by f32_bwd_kernel."""
    g, n, d = q.shape
    sc = torch.tensor(scale)
    dr = butterfly((do * o).reshape(g, n, 16, 4).sum(-1))   # 16 four-wide partials a row
    dq, dk, dv = torch.zeros(g, n, d), torch.empty(g, n, d), torch.empty(g, n, d)
    perm = [of_position(u) for u in range(CH)]
    for k0 in range(0, n, KT):
        keys = min(KT, n - k0)
        kt, vt = rows_of(k, k0, KT), rows_of(v, k0, KT)
        dka, dva = torch.zeros(g, KT, d), torch.zeros(g, KT, d)
        last = k0 + KT >= n
        for q0 in range(0, n, CH):
            qs = min(CH, n - q0)
            qc, doc = rows_of(q, q0, CH), rows_of(do, q0, CH)
            lc, drc = rows_of(lse, q0, CH), rows_of(dr, q0, CH)
            st = kt @ qc.transpose(1, 2)                        # [keys][queries]
            dpt = vt @ doc.transpose(1, 2)
            pt = torch.exp(st * sc - lc[:, None])
            pt[:, keys:] = 0.0                                  # keys beyond N
            pt[:, :, qs:] = 0.0                                 # queries beyond N
            dst = pt * (dpt - drc[:, None])
            dva = dva + pt[:, :, perm] @ doc[:, perm]
            dka = dka + dst[:, :, perm] @ qc[:, perm]
            # dQ of this key tile: each key quarter (keys = q mod 4) summed alone,
            # the quarters then pairwise as the xor shuffles meet them
            quarter = [dst[:, k::4].transpose(1, 2) @ kt[:, k::4] for k in range(4)]
            share = (quarter[0] + quarter[1]) + (quarter[2] + quarter[3])
            total = dq[:, q0:q0 + qs] + share[:, :qs]
            dq[:, q0:q0 + qs] = total * sc if last else total
        dk[:, k0:k0 + keys] = (dka * sc)[:, :keys]
        dv[:, k0:k0 + keys] = dva[:, :keys]
    return dq, dk, dv


def rehearse_fwd128(q, k, v, scale: float):
    """The D = 128 route's forward: 64-row tiles, chunks of 64, row sums per chunk."""
    g, n, d = q.shape
    out, lse = torch.empty(g, n, d), torch.empty(g, n)
    for r0 in range(0, n, 64):
        rows = min(64, n - r0)
        qt = rows_of(q, r0, 64)
        m, l, acc = torch.full((g, 64), -math.inf), torch.zeros(g, 64), torch.zeros(g, 64, d)
        for c0 in range(0, n, 64):
            s = (qt @ rows_of(k, c0, 64).transpose(1, 2)) * torch.tensor(scale)
            s[:, :, max(0, n - c0):] = -math.inf
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            l = l * alpha + p.sum(-1)
            m = mn
            acc = acc * alpha[..., None] + p @ rows_of(v, c0, 64)
        out[:, r0:r0 + rows] = (acc / l[..., None])[:, :rows]
        lse[:, r0:r0 + rows] = (m + torch.log(l))[:, :rows]
    return out, lse


def rehearse_bwd128(q, k, v, o, do, lse, scale: float):
    """The D = 128 route's backward: dq over key chunks, then dk / dv over query chunks."""
    g, n, d = q.shape
    sc = torch.tensor(scale)
    dr = (do * o).sum(-1)
    dq, dk, dv = (torch.empty(g, n, d) for _ in range(3))
    for r0 in range(0, n, 64):
        rows = min(64, n - r0)
        qt, dot = rows_of(q, r0, 64), rows_of(do, r0, 64)
        lt, drt = rows_of(lse, r0, 64)[..., None], rows_of(dr, r0, 64)[..., None]
        acc = torch.zeros(g, 64, d)
        for c0 in range(0, n, 64):
            kc, vc = rows_of(k, c0, 64), rows_of(v, c0, 64)
            p = torch.exp((qt @ kc.transpose(1, 2)) * sc - lt)
            p[:, :, max(0, n - c0):] = 0.0
            acc = acc + (p * (dot @ vc.transpose(1, 2) - drt)) @ kc
        dq[:, r0:r0 + rows] = (acc * sc)[:, :rows]
        kt, vt = rows_of(k, r0, 64), rows_of(v, r0, 64)
        acc_k, acc_v = torch.zeros(g, 64, d), torch.zeros(g, 64, d)
        for c0 in range(0, n, 64):
            qc, doc = rows_of(q, c0, 64), rows_of(do, c0, 64)
            pt = torch.exp((kt @ qc.transpose(1, 2)) * sc - rows_of(lse, c0, 64)[:, None])
            pt[:, :, max(0, n - c0):] = 0.0
            acc_v = acc_v + pt @ doc
            acc_k = acc_k + (pt * (vt @ doc.transpose(1, 2) - rows_of(dr, c0, 64)[:, None])) @ qc
        dk[:, r0:r0 + rows] = (acc_k * sc)[:, :rows]
        dv[:, r0:r0 + rows] = acc_v[:, :rows]
    return dq, dk, dv


# [B, H, N, D]: the classifier's shape (batch and heads cut), the D = 64
# route across its tile edges, then the chip script's odd shapes
SHAPES = [(2, 2, 256, 64), (1, 1, 1, 64), (1, 2, 320, 64), (3, 2, 100, 64), (1, 3, 17, 128),
          (2, 2, 300, 128), (2, 1, 1024, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_kernels_arithmetic_matches_plain(shape):
    b, h, n, d = shape
    gen = torch.Generator().manual_seed(n + d)
    # the classifier's operands are views of its packed [B, N, 3, H, D] projection
    q, k, v = torch.randn(b, n, 3, h, d, generator=gen).permute(2, 0, 3, 1, 4)
    do = torch.randn(b, h, n, d, generator=gen)
    out, lse = flash_attention_plain(q, k, v)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do)
    flat = lambda t: t.reshape(b * h, n, -1)
    fwd, bwd = (rehearse_fwd64, rehearse_bwd64) if d == 64 else (rehearse_fwd128, rehearse_bwd128)
    got_out, got_lse = fwd(flat(q), flat(k), flat(v), _scale(d))
    got = bwd(*(flat(t) for t in (q, k, v, out, do)), lse.reshape(b * h, n), _scale(d))
    pairs = [("out", got_out, out), ("lse", got_lse, lse)]
    pairs += list(zip(("dq", "dk", "dv"), got, want))
    for name, a, w in pairs:
        assert torch.isfinite(a).all(), name
        scale = w.abs().max().item()
        err = (a.reshape(w.shape) - w).abs().max().item()
        assert err <= K9_F32_TOL * max(scale, 1e-6 if n > 1 else 1.0), (name, err, scale)


def test_source_constants_and_shared_memory():
    """The rehearsal's constants are the kernels', and the forward (Q, two
    stages of K and V, P) and backward (K, V, two stages of Q and dO, P^T,
    dS^T, a chunk of o) fit one block's shared memory with no room for a
    third stage."""
    text = SRC.read_text()
    for name, value in (("NT", NT), ("LD", LD), ("CH", CH), ("FROWS", FROWS), ("KT", KT)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    fwd = (FROWS * LD + 2 * CH * (LD + 64) + FROWS * LD) * 4
    bwd = (2 * KT * LD + 4 * CH * LD + 2 * KT * LD + CH * 64) * 4
    assert (fwd, bwd) == (206_848, 225_280)
    assert fwd <= SMEM_MAX < fwd + CH * LD * 4 + CH * 64 * 4     # a third K/V stage
    assert bwd <= SMEM_MAX < bwd + 2 * CH * LD * 4               # a third Q/dO stage


def lanes():
    return [(lane >> 3, lane & 7) for lane in range(32)]


def test_thread_maps_cover_every_tile_once():
    fwd_s, fwd_o = {}, {}
    for w in range(8):
        for i, j in lanes():
            for r in range(8):
                row = 32 * w + i + 4 * r
                for c in range(8):
                    fwd_s[(row, j + 8 * c)] = fwd_s.get((row, j + 8 * c), 0) + 1
                for col in [4 * j + e for e in range(4)] + [32 + 4 * j + e for e in range(4)]:
                    fwd_o[(row, col)] = fwd_o.get((row, col), 0) + 1
    assert set(fwd_s.values()) == {1} and len(fwd_s) == FROWS * CH
    assert set(fwd_o.values()) == {1} and len(fwd_o) == FROWS * 64
    assert sorted(of_position(u) for u in range(CH)) == list(range(CH))
    assert all(of_position(8 * j + c) == j + 8 * c for j in range(8) for c in range(8))
    # backward: each role's S^T / dP^T tile and its dV / dK tile, then dQ
    tiles = [{}, {}]
    kv = [{}, {}]
    dq = {}
    for w in range(8):
        g, role = w & 3, w >> 2
        for i, j in lanes():
            for r in range(8):
                key = 32 * g + i + 4 * r
                for c in range(8):
                    tiles[role][(key, j + 8 * c)] = tiles[role].get((key, j + 8 * c), 0) + 1
                for col in [4 * j + e for e in range(4)] + [32 + 4 * j + e for e in range(4)]:
                    kv[role][(key, col)] = kv[role].get((key, col), 0) + 1
            k4 = i                                   # the lane's quarter of the keys
            rows = [w + 8 * (4 * (k4 & 1) + 2 * (k4 >> 1) + e) for e in range(2)]
            for row in rows:                         # what the lane stores after the shuffles
                for col in [4 * j + f for f in range(4)] + [32 + 4 * j + f for f in range(4)]:
                    dq[(row, col)] = dq.get((row, col), 0) + 1
            assert all(of_position(8 * w + e) == w + 8 * e for e in range(8))
    for role in range(2):
        assert set(tiles[role].values()) == {1} and len(tiles[role]) == KT * CH
        assert set(kv[role].values()) == {1} and len(kv[role]) == KT * 64
    assert set(dq.values()) == {1} and len(dq) == CH * 64


def wavefronts(addrs) -> int:
    """128-byte shared-memory wavefronts of one warp-wide 16-byte access: the
    most distinct 16-byte addresses (float offsets) in one of the 8 slots."""
    slots = {}
    for a in set(addrs):
        assert a % 4 == 0, "a float4 access must be 16-byte aligned"
        slots.setdefault((a // 4) % 8, set()).add(a)
    return max(len(s) for s in slots.values())


def test_shared_accesses_take_the_fewest_wavefronts():
    """Every float4 access of the products, at every step and register index,
    takes as many 128-byte wavefronts as its distinct bytes need and no more
    (no bank conflict): one for the broadcast reads of the register tiles,
    four for the P / P^T / dS^T stores and dQ's K reads (512 bytes)."""
    access = {}
    for w in range(8):
        g = w & 3
        for r in range(8):
            for c in range(8):
                for d in range(0, 64, 4):
                    # S (forward): Q rows i + 4r of the warp, K rows j + 8c; S^T / dP^T
                    # (backward): K or V rows 32g + i + 4r, Q or dO rows j + 8c
                    access.setdefault(("q rows", w, r, d), []).extend(
                        (32 * w + i + 4 * r) * LD + d for i, j in lanes())
                    access.setdefault(("k rows", c, d), []).extend(
                        (j + 8 * c) * LD + d for i, j in lanes())
                    access.setdefault(("bwd k rows", g, r, d), []).extend(
                        (32 * g + i + 4 * r) * LD + d for i, j in lanes())
                for u in range(0, 64, 4):  # P (forward), P^T / dS^T (backward) by positions
                    access.setdefault(("fwd p", w, r, u), []).extend(
                        (32 * w + i + 4 * r) * LD + u for i, j in lanes())
                    access.setdefault(("bwd pt", g, r, u), []).extend(
                        (32 * g + i + 4 * r) * LD + u for i, j in lanes())
            for half in range(2):  # the stores of P, P^T, dS^T (and the partner's P^T read)
                access[("fwd p store", w, r, half)] = [
                    (32 * w + i + 4 * r) * LD + 8 * j + 4 * half for i, j in lanes()]
                access[("bwd pt store", w, r, half)] = [
                    (32 * g + i + 4 * r) * LD + 8 * j + 4 * half for i, j in lanes()]
        for row in range(64):  # V (forward, unpadded), dO / Q (backward) by columns
            for m in range(2):
                access[("fwd v", row, m)] = [row * 64 + 32 * m + 4 * j for i, j in lanes()]
                access[("bwd do", row, m)] = [row * LD + 32 * m + 4 * j for i, j in lanes()]
        for kk in range(KT // 4):  # dQ: lane quarter i takes key 4 kk + i
            for half in range(2):
                access[("dq ds", w, kk, half)] = [(4 * kk + i) * LD + 8 * w + 4 * half
                                                  for i, j in lanes()]
                access[("dq k", w, kk, half)] = [(4 * kk + i) * LD + 32 * half + 4 * j
                                                 for i, j in lanes()]
    fewest = {name: -(-len(set(a)) * 16 // 128) for name, a in access.items()}
    assert {name: wavefronts(a) for name, a in access.items()} == fewest
    assert {fewest[name] for name in access if "store" in name[0]} == {4}
    assert {fewest[name] for name in access if name[0] == "dq k"} == {4}
    assert {fewest[name] for name in access
            if "store" not in name[0] and name[0] != "dq k"} == {1}


class Ring:
    """One block's shared buffers under cp.async: issue / commit / wait, the
    block barrier, reads and plain writes, executed in program order (every
    thread of the block takes the same branch).  A copy is visible to the
    block once its group has landed (a wait) and a barrier has followed."""

    def __init__(self):
        self.barriers = 0
        self.groups = []                # each: list of (buffer, tag)
        self.open = []
        self.held = {}                  # buffer -> [tag, group, landed at barrier or None, last read]
        self.reads = 0

    def issue(self, buf, tag):
        old = self.held.get(buf)
        if old is not None and old[3] is not None:
            assert old[3] < self.barriers, f"{buf} refilled before a barrier closed its reads"
        self.open.append((buf, tag))
        self.held[buf] = [tag, None, None, None]

    def commit(self):
        self.groups.append(self.open)
        for buf, _ in self.open:
            self.held[buf][1] = len(self.groups) - 1
        self.open = []

    def wait(self, pending: int):
        for buf, h in self.held.items():
            if h[1] is not None and h[1] < len(self.groups) - pending and h[2] is None:
                h[2] = self.barriers

    def barrier(self):
        self.barriers += 1

    def write(self, buf, tag):
        old = self.held.get(buf)
        if old is not None and old[3] is not None:
            assert old[3] < self.barriers, f"{buf} written before a barrier closed its reads"
        self.held[buf] = [tag, -1, self.barriers, None]

    def read(self, buf, tag):
        h = self.held.get(buf)
        assert h is not None and h[0] == tag, (buf, tag, h)
        assert h[2] is not None and h[2] < self.barriers, f"{buf} {tag} read before it was visible"
        h[3] = self.barriers
        self.reads += 1

    def rewrite(self, buf, tag, new_tag):
        """The threads that read ``buf`` overwrite their own part of it."""
        self.read(buf, tag)
        self.held[buf] = [new_tag, -1, self.barriers, None]


def replay_fwd(n: int) -> Ring:
    ring = Ring()
    nc = -(-n // CH)
    ring.issue("Q", 0)
    ring.issue("K0", 0)
    ring.issue("V0", 0)
    ring.commit()
    for c in range(nc):
        ring.wait(0)
        ring.barrier()
        if c + 1 < nc:
            ring.issue(f"K{(c + 1) & 1}", c + 1)
            ring.issue(f"V{(c + 1) & 1}", c + 1)
        ring.commit()
        ring.read("Q", 0)
        ring.read(f"K{c & 1}", c)
        ring.read(f"V{c & 1}", c)
    return ring


def replay_bwd(n: int) -> Ring:
    """The backward's block-wide buffers, and P^T handed between the warps of
    a pair through their two named barriers (replayed as barriers: they order
    the pair as __syncthreads orders the block); P^T's rows 0-3 and 4-7 of
    each thread are separate buffers."""
    ring = Ring()
    nq = -(-n // CH)
    steps = -(-n // KT) * nq
    for buf in ("K", "V", "Q0", "dO0", "O"):
        ring.issue(buf, 0)
    ring.commit()
    for s in range(steps):
        kt, c = divmod(s, nq)
        if c == 0 and kt > 0:
            ring.barrier()
            ring.issue("K", kt)
            ring.issue("V", kt)
            ring.commit()
        ring.wait(0)
        ring.barrier()
        if kt == 0:                              # Dr of the chunk from dO and o
            ring.read(f"dO{s & 1}", c)
            ring.read("O", c)
            ring.write(f"dr{c}", c)
            ring.barrier()
        if s + 1 < steps:
            ring.issue(f"Q{(s + 1) & 1}", (s + 1) % nq)
            ring.issue(f"dO{(s + 1) & 1}", (s + 1) % nq)
            if s + 1 < nq:
                ring.issue("O", s + 1)
        ring.commit()
        ring.read(f"dr{c}", c)
        for buf, tag in (("K", kt), ("V", kt), (f"Q{s & 1}", c), (f"dO{s & 1}", c)):
            ring.read(buf, tag)                  # S^T (role 0), dP^T (role 1)
        ring.write("P47", ("x", s))              # role 0: exponents of rows 4-7
        ring.barrier()                           # named barrier 1 + g
        ring.rewrite("P47", ("x", s), ("p", s))  # role 1: their exp
        ring.write("P03", ("p", s))              # role 0: rows 0-3
        ring.barrier()                           # named barrier 5 + g
        ring.read("P03", ("p", s))               # role 1 forms dS^T
        ring.write("dSt", s)
        ring.barrier()
        for buf, tag in (("P03", ("p", s)), ("P47", ("p", s)), ("dSt", s), (f"Q{s & 1}", c),
                         (f"dO{s & 1}", c), ("K", kt)):
            ring.read(buf, tag)                  # dV, dK, dQ
    return ring


@pytest.mark.parametrize("n", [1, 17, 64, 65, 100, 128, 129, 256, 300, 1024])
def test_copy_rings_read_landed_chunks(n):
    fwd = replay_fwd(n)
    assert fwd.reads == 3 * -(-n // CH)                 # every chunk of keys read once
    bwd = replay_bwd(n)
    nq = -(-n // CH)                                     # every (key tile, query chunk)
    assert bwd.reads == 13 * -(-n // KT) * nq + 2 * nq


def test_ring_replay_catches_a_missing_barrier():
    """The replay is not vacuous: a refill issued before the barrier that
    closes the last chunk's reads is refused."""
    with pytest.raises(AssertionError, match="refilled before a barrier"):
        ring = Ring()
        ring.issue("K0", 0)
        ring.commit()
        ring.wait(0)
        ring.barrier()
        ring.read("K0", 0)
        ring.issue("K0", 2)
