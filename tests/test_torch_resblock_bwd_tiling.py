"""Step-by-step rehearsal, in plain PyTorch on the CPU, of K5, the ResBlock
backward on the card (`sgdm_tpu_torch/csrc/resblock_bwd.cu`), held against
the plain version the kernels are held to on the card (`resblock_bwd_plain`).

The rehearsal follows the kernels' order and rounding points, not their
threads:
  * data gradients (`conv_core.cuh` KIND 0): dh3d = conv3x3(g, flipped W2),
    dh1 = conv3x3(bf16 dh2, flipped W1), the skip's g @ W_skipᵀ, over 16 x 16
    output tiles whose haloed input tile is zero outside the image, nine
    windows of it per 32-channel chunk;
  * the GroupNorm-backward rows, which also write h3d and h1 in bf16 with the
    forward's folded coefficients, once per element;
  * weight gradients (`wgrad_kernel`): runs of 16 x 16 spatial tiles, each
    split a partial, summed by the column pass in split order.

It also decodes the weight-gradient kernel's wgmma descriptors byte for byte
(the MN-major no-swizzle activation tile, whose tap windows start
((py + dy) * 18 + dx) pixels in, and the 128-byte-swizzled g tile), and
checks that its grid, its splits, its tile cursor and its one-tap row split
cover every (tap, Cin, Cout, pixel) product exactly once."""

import math

import pytest
import torch

from sgdm_tpu_torch.ops.resblock import (WGRAD_BLOCK, WGRAD_TILE, _flip_taps, dropout_mask,
                                         resblock_bwd_plain, resblock_plain, wgrad_splits)

K5_TOL = 2.0 ** -5            # of max|plain gradient|, as on the card
T = WGRAD_TILE                # 16
HW_ = T + 2                   # side of the haloed tile
HPX = HW_ * HW_               # 324
PLANE = HPX * 16              # bytes of one 8-channel group of the halo tile
SMS = 132                     # SMs of an H100 SXM


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def silu(z: torch.Tensor) -> torch.Tensor:
    return z / (1.0 + torch.exp(-z))


# ------------------------------------------------------------ the rehearsal

def halo(t: torch.Tensor, b: int, y0: int, x0: int) -> torch.Tensor:
    """[18, 18, C] of sample b around the tile at (y0, x0), zero outside."""
    _, h, w, c = t.shape
    out = torch.zeros(HW_, HW_, c)
    ys, xs = max(y0 - 1, 0), max(x0 - 1, 0)
    ye, xe = min(y0 + T + 1, h), min(x0 + T + 1, w)
    out[ys - y0 + 1:ye - y0 + 1, xs - x0 + 1:xe - x0 + 1] = t[b, ys:ye, xs:xe].float()
    return out


def own(t: torch.Tensor, b: int, y0: int, x0: int) -> torch.Tensor:
    """[16, 16, C] of sample b at the tile's own pixels, zero beyond the image."""
    _, h, w, c = t.shape
    out = torch.zeros(T, T, c)
    part = t[b, y0:y0 + T, x0:x0 + T].float()
    out[:part.shape[0], :part.shape[1]] = part
    return out


def dgrad_rehearsal(src, wf, x=None, wskip=None):
    """KIND 0: out f32 [B,H,W,Co] = Σ_tap windows of the zero-padded haloed
    src tile (bf16 values) @ wf[tap] [Ci, Co], chunk by chunk of 32 input
    channels, then x's one-tap chunks @ wskip [Cx, Co]."""
    bsz, h, w = src.shape[:3]
    co = wf.shape[-1] if wf is not None else wskip.shape[-1]
    out = torch.zeros(bsz, h, w, co)
    for b in range(bsz):
        for y0 in range(0, h, T):
            for x0 in range(0, w, T):
                acc = torch.zeros(T, T, co)
                if wf is not None:
                    tile = halo(src, b, y0, x0)
                    for c0 in range(0, src.shape[-1], 32):
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            acc += tile[dy:dy + T, dx:dx + T, c0:c0 + 32] @ wf[tap, c0:c0 + 32]
                if wskip is not None:
                    xt = own(x, b, y0, x0)
                    for c0 in range(0, x.shape[-1], 32):
                        acc += xt[..., c0:c0 + 32] @ wskip[c0:c0 + 32]
                ty, tx = min(T, h - y0), min(T, w - x0)
                out[b, y0:y0 + ty, x0:x0 + tx] = acc[:ty, :tx]
    return out


def tile_order(bsz, h, w):
    """The spatial tiles (b, y0, x0) in the kernel's order: b, tile row, tile column."""
    return [(b, ty * T, tx * T) for b in range(bsz) for ty in range(-(-h // T))
            for tx in range(-(-w // T))]


def split_runs(tiles: int, splits: int):
    """Run s sums the tiles [s*T/splits, (s+1)*T/splits): `wgrad_kernel`'s t0, nrun."""
    return [(s * tiles // splits, (s + 1) * tiles // splits) for s in range(splits)]


def wgrad_partials(act, g, taps, splits):
    """The partials `wgrad_kernel` writes: [splits][9][K][N] (taps 9) or
    [3 * splits][1][K][N] (taps 1: warpgroup wg takes tile rows py % 3 == wg)."""
    bsz, h, w, k = act.shape
    n = g.shape[-1]
    order = tile_order(bsz, h, w)
    part = torch.zeros(splits * (1 if taps == 9 else 3), taps, k, n)
    for s, (t0, t1) in enumerate(split_runs(len(order), splits)):
        for b, y0, x0 in order[t0:t1]:
            a, gt = halo(act, b, y0, x0), own(g, b, y0, x0)
            for py in range(T):              # a k16 step: one row of the tile
                if taps == 9:
                    for dy in range(3):
                        for dx in range(3):
                            part[s, 3 * dy + dx] += a[py + dy, dx:dx + T].T @ gt[py]
                else:
                    part[3 * s + py % 3, 0] += a[py + 1, 1:1 + T].T @ gt[py]
    return part


def colsum(part: torch.Tensor) -> torch.Tensor:
    """`colsum_kernel`: out[n] = Σ_p part[p][n], added in order p = 0, 1, ..."""
    out = torch.zeros(part.shape[1:])
    for p in range(part.shape[0]):
        out = out + part[p]
    return out


def k5_rehearsal(x, dout, res, o, rate, seed):
    """K5's launches in order, rounding where the kernels round."""
    h2, mean1, rstd1, mean2, rstd2 = res
    bsz, h, w, cin = x.shape
    cout = o["w1"].shape[-1]
    hw = h * w
    g_in, g_out = math.gcd(32, cin), math.gcd(32, cout)
    taps = lambda wt: bf16(_flip_taps(wt).reshape(9, wt.shape[3], wt.shape[2]))
    gb = bf16(dout)

    def rows(u, src, mean, rstd, gamma, beta, groups, fs=None, fsh=None, mask=None):
        """gn_bwd reduce + apply: h = bf16(silu(z) * mask) and the GN backward."""
        s = src.float().reshape(bsz, hw, -1)
        m, r = mean[:, None], rstd[:, None]
        sc = r * gamma
        sh = beta.expand_as(sc)
        if fs is not None:
            f = 1.0 + fs.float()[:, None]
            sc, sh = sc * f, sh * f + fsh.float()[:, None]
        else:
            f = torch.ones_like(sc)
        z = s * sc + (sh - m * sc)
        mk = mask if mask is not None else torch.ones(())
        act = bf16(silu(z) * mk)
        xhat = (s - m) * r
        sg = torch.sigmoid(z)
        dpre = u.reshape(bsz, hw, -1) * mk * sg * (1 + z * (1 - sg))
        s1, s2 = dpre.sum(1), (dpre * xhat).sum(1)
        c = s.shape[-1]
        gs = c // groups
        grp = lambda t: t.reshape(bsz, groups, gs).sum(-1).repeat_interleave(gs, -1)
        fg = f[:, 0] * gamma
        k1 = r[:, 0] * fg
        k0 = -r[:, 0] * grp(fg * s1) / (hw * gs)
        kx = -r[:, 0] * grp(fg * s2) / (hw * gs)
        out = k1[:, None] * dpre + k0[:, None] + kx[:, None] * xhat
        return act, out, s1, s2, f[:, 0]

    dh3d = dgrad_rehearsal(gb, taps(o["w2"]))
    mask = dropout_mask(bsz, hw, cout, seed, rate) if rate > 0 else None
    h3d, dh2, s1, s2, f2 = rows(dh3d, h2, mean2, rstd2, o["gn2_scale"], o["gn2_bias"], g_out,
                                o["film_scale"], o["film_shift"], mask)
    dfs = o["gn2_scale"] * s2 + o["gn2_bias"] * s1
    dfsh = s1
    dg2, db2 = (f2 * s2).sum(0), (f2 * s1).sum(0)
    dc1 = dh2.sum((0, 1))
    dh2b = bf16(dh2).reshape(bsz, h, w, cout)
    dh1 = dgrad_rehearsal(dh2b, taps(o["w1"]))
    skw = o.get("skip_w")
    skip = 0.0
    if skw is not None:
        skip = dgrad_rehearsal(gb, None, gb, bf16(skw.reshape(cin, cout).T)).reshape(bsz, hw, cin)
    h1, dxg, t1, t2, _ = rows(dh1, x, mean1, rstd1, o["gn1_scale"], o["gn1_bias"], g_in)
    dx = dxg + (gb.reshape(bsz, hw, cout) if skw is None else skip)
    dc2 = gb.sum((0, 1, 2))

    def wgrad(act, g, t):
        part = wgrad_partials(act.reshape(bsz, h, w, -1), g, t,
                              wgrad_splits(bsz, h, w, act.shape[-1], g.shape[-1], SMS))
        return colsum(part)

    dw2 = wgrad(h3d, gb, 9).reshape(3, 3, cout, cout)
    dw1 = wgrad(h1, dh2b, 9).reshape(3, 3, cin, cout)
    dskw = wgrad(bf16(x), gb, 1).reshape(1, 1, cin, cout) if skw is not None else None
    return (bf16(dx).reshape(bsz, h, w, cin), t2.sum(0), t1.sum(0), dw1, dc1, dfs, dfsh, dg2,
            db2, dw2, dc2, dskw, dc2 if skw is not None else None)


def operands(b, h, w, cin, cout, seed):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)
    x = r(b, h, w, cin).to(torch.bfloat16)
    o = dict(gn1_scale=1 + 0.1 * r(cin), gn1_bias=0.1 * r(cin),
             w1=r(3, 3, cin, cout) / math.sqrt(9 * cin), b1=0.1 * r(cout),
             film_scale=0.1 * r(b, cout), film_shift=0.1 * r(b, cout),
             gn2_scale=1 + 0.1 * r(cout), gn2_bias=0.1 * r(cout),
             w2=r(3, 3, cout, cout) / math.sqrt(9 * cout), b2=0.1 * r(cout))
    if cin != cout:
        o["skip_w"] = r(1, 1, cin, cout) / math.sqrt(cin)
    dout = r(b, h, w, cout).to(torch.bfloat16)
    return x, o, dout


NAMES = ("dx", "dg1", "db1", "dw1", "dc1", "dfs", "dfsh", "dg2", "db2", "dw2", "dc2", "dskw",
         "dskb")
# (B, H, W, Cin, Cout, dropout): ragged tiles (5 x 7 inside one tile, 20 x 18
# across four), C % 8 != 0 (20, 24 and 136 against 64-channel blocks),
# projection and identity skips
CASES = [(3, 5, 7, 20, 24, 0.1), (3, 20, 18, 136, 64, 0.1), (3, 20, 18, 24, 24, 0.0),
         (3, 5, 7, 64, 64, 0.1)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_k5_tiling_matches_plain(case):
    b, h, w, cin, cout, rate = case
    x, o, dout = operands(b, h, w, cin, cout, seed=h * w + cin)
    args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale", "film_shift",
                           "gn2_scale", "gn2_bias", "w2", "b2")]
    _, h2, m1, r1, m2, r2 = resblock_plain(x, *args, o.get("skip_w"), None, dropout_rate=rate,
                                           seed=7, save_res=True)
    want = resblock_bwd_plain(x, dout, h2, m1, r1, m2, r2, args[0], args[1], args[2], args[4],
                              args[5], args[6], args[7], args[8], o.get("skip_w"),
                              dropout_rate=rate, seed=7)
    got = k5_rehearsal(x, dout, (h2, m1, r1, m2, r2), o, rate, seed=7)
    for name, a, ref in zip(NAMES, got, want):
        if ref is None:
            assert a is None, name
            continue
        assert a.shape == ref.shape, (name, a.shape, ref.shape)
        assert torch.isfinite(a.float()).all(), name
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= K5_TOL * ref.float().abs().max().item(), (name, err)


# ------------------------------------------------------ the kernel's addressing

def test_activation_descriptors_yield_each_tap_window():
    """The MN-major no-swizzle A of tap (dy, dx) at tile row py: start
    ((py + dy) * 18 + dx) * 16 bytes into the stage, LBO 128 (its K halves,
    8 pixels each), SBO one plane (its 8-channel groups).  Element (m, k) is
    channel m of halo pixel (py + dy, dx + k)."""
    mem = {}
    for pix in range(HPX):                  # the loads: [group][halo pixel][8 channels]
        for c in range(64):
            mem[(c // 8) * PLANE + pix * 16 + (c % 8) * 2] = (pix, c)
    assert len(mem) == 64 * HPX
    lbo, sbo = 128, PLANE
    for dy in range(3):
        for py in range(T):
            for dx in range(3):
                start = ((py + dy) * HW_ + dx) * 16
                assert start % 16 == 0 and (start + 7 * sbo + 2 * lbo) < (1 << 18)
                for m in range(64):
                    for k in range(16):
                        addr = start + (m // 8) * sbo + (k // 8) * lbo + (k % 8) * 16 + (m % 8) * 2
                        assert mem[addr] == ((py + dy) * HW_ + dx + k, m)


def test_halo_loads_pad_in_activation_space():
    """What the cp.async loads put in a stage (zero-filled where the source is
    outside the image or beyond the padded channels), decoded through the tap
    windows, is each tap's shifted window of the activation with zero padding."""
    gen = torch.Generator().manual_seed(0)
    bsz, h, w, lda = 2, 20, 18, 16
    act = torch.randn(bsz, h, w, lda, generator=gen)
    padded = torch.nn.functional.pad(act, (0, 0, 1, 1, 1, 1))
    for b, y0, x0 in tile_order(bsz, h, w):
        stage = torch.zeros(8, HPX, 8)           # [group][halo pixel][8 channels]
        for i in range(HPX * 8):
            grp, pix = i % 8, i // 8
            hy, hx = divmod(pix, HW_)
            y, x, c = y0 - 1 + hy, x0 - 1 + hx, 8 * grp
            if 0 <= y < h and 0 <= x < w and c < lda:
                stage[grp, pix] = act[b, y, x, c:c + 8]
        flat = stage.permute(1, 0, 2).reshape(HPX, 64)     # halo pixel -> 64 channels
        for dy in range(3):
            for dx in range(3):
                for py in range(T):
                    win = flat[(py + dy) * HW_ + dx:(py + dy) * HW_ + dx + T, :lda]
                    y, xs = y0 + py + dy, x0 + dx
                    want = torch.zeros(T, lda)
                    if y < h + 2:                # rows past the padding: none valid
                        part = padded[b, y, xs:min(xs + T, w + 2)]
                        want[:part.shape[0]] = part
                    # pixels beyond the image's last column or row are zero
                    # in the tile and contribute nothing: their g rows are zero
                    valid = [k for k in range(T) if x0 + k < w and y0 + py < h]
                    assert torch.equal(win[valid], want[valid])


def test_g_descriptors_find_what_the_loads_put():
    """The g tile: row r = pixel (r / 16, r % 16) of the tile, 64 channels in
    128 bytes, 16-byte chunk ch at swz(r, ch); a k16 step (tile row py) is the
    128-byte-swizzled MN-major descriptor starting py * 2048 bytes in."""
    swz = lambda r, ch: r * 128 + ((ch ^ (r & 7)) << 4)
    placed = {}
    for r in range(T * T):
        for n in range(64):
            placed[swz(r, n // 8) + 2 * (n % 8)] = (r, n)
    assert len(placed) == T * T * 64
    for py in range(T):
        start = py * 2048
        assert start % 1024 == 0
        for k in range(16):
            for n in range(64):
                addr = start + (k // 8) * 1024 + (k % 8) * 128 + ((((n // 8) ^ (k % 8))) << 4) \
                    + (n % 8) * 2
                assert placed[addr] == (16 * py + k, n)


def test_fragments_cover_each_warpgroup_tile_once():
    """acc[d][4j + 2h + e] of thread (warp, lane): input channel 16 warp +
    lane / 4 + 8 h, output channel 8 j + 2 (lane % 4) + e: the 64 x 64 tile once."""
    seen = torch.zeros(WGRAD_BLOCK, WGRAD_BLOCK, dtype=torch.int32)
    for warp in range(4):
        for lane in range(32):
            for i in range(32):
                j, h, e = i // 4, (i // 2) % 2, i % 2
                seen[16 * warp + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + e] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", [(128, 64, 64, 128, 128), (128, 16, 16, 1024, 512),
                                   (128, 32, 32, 768, 256), (3, 5, 7, 20, 24),
                                   (3, 20, 18, 136, 64), (1, 17, 33, 72, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_grid_and_runs_cover_every_product_once(shape):
    """Blocks (nt fastest, mt, split) x runs of tiles x (3 tap rows x 3 taps,
    or the one tap's rows py % 3): every (tap, Cin tile, Cout tile, pixel
    tile, tile row) product once; the kernel's counting cursor visits the
    tiles of its run in the order that divmod gives."""
    bsz, h, w, k, n = shape
    splits = wgrad_splits(bsz, h, w, k, n, SMS)
    assert 1 <= splits <= 64
    nnt, nmt = -(-n // 64), -(-k // 64)
    ntx, nty = -(-w // T), -(-h // T)
    per_b = ntx * nty
    tiles = bsz * per_b
    seen = {}
    for bid in range(nnt * nmt * splits):
        nt, rest = bid % nnt, bid // nnt
        mt, split = rest % nmt, rest // nmt
        t0 = split * tiles // splits
        nrun = (split + 1) * tiles // splits - t0
        cb = t0 // per_b
        cty = (t0 - cb * per_b) // ntx
        ctx = t0 - cb * per_b - cty * ntx
        for t in range(t0, t0 + nrun):
            assert (cb, cty, ctx) == (t // per_b, (t % per_b) // ntx, t % ntx)
            key = (mt, nt, t)
            seen[key] = seen.get(key, 0) + 1
            ctx += 1
            if ctx == ntx:
                ctx = 0
                cty += 1
                if cty == nty:
                    cty, cb = 0, cb + 1
    assert len(seen) == nmt * nnt * tiles and set(seen.values()) == {1}
    # inside a block: nine taps, three warpgroups of three; the one-tap
    # product's 16 rows, each warpgroup every third
    assert sorted(3 * dy + dx for dy in range(3) for dx in range(3)) == list(range(9))
    rows = sorted(py for wg in range(3) for py in range(T) if py % 3 == wg)
    assert rows == list(range(T))


def test_partials_are_summed_in_split_order():
    """The weight gradient is the column pass over the partials, added in
    order p = 0, 1, ...: bit for bit the same on every call, and the sum the
    rehearsal takes; every split writes its whole partial (zeros for a run
    without tiles)."""
    gen = torch.Generator().manual_seed(1)
    act = bf16(torch.randn(2, 9, 11, 16, generator=gen))
    g = bf16(torch.randn(2, 9, 11, 8, generator=gen))
    part = wgrad_partials(act, g, 9, 2)
    once, twice = colsum(part), colsum(part.clone())
    assert torch.equal(once, twice)
    assert torch.equal(once, torch.zeros_like(once) + part[0] + part[1])
    ap = torch.nn.functional.pad(act, (0, 0, 1, 1, 1, 1))
    want = torch.stack([torch.einsum("bhwk,bhwn->kn", ap[:, dy:dy + 9, dx:dx + 11], g)
                        for dy in range(3) for dx in range(3)])
    assert torch.allclose(once, want, rtol=1e-5, atol=1e-5)
    # more runs than tiles: the runs without a tile write zeros
    empty = wgrad_partials(act, g, 9, 3)[[s for s, (a, b) in enumerate(split_runs(2, 3))
                                          if a == b]]
    assert (empty == 0).all()

