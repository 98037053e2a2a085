"""Step-by-step rehearsal, in plain PyTorch on the CPU, of the ResBlock
convolution kernel that K1, K2 and K4 share (`sgdm_tpu_torch/csrc/resblock.cu`
`conv_kernel`), held against the plain version the kernels are held to on the
card (`resblock_plain`).

The rehearsal follows the kernel's order, not its threads.  A block owns one
sample's 16 x 16 output tile and 128 output channels.  For each chunk of 32
input channels it activates the haloed tile (18 x 18 pixels, in output
coordinates) once: GN(+FiLM)+SiLU, through the nearest-up index map or the 2x2
pool of the activated pixels in f32, times the dropout mask, zero outside the
image (the padding is in h1 / h3 space) and beyond Ci, rounded to bf16.  The
nine taps are nine windows of that one tile; the projection skip is one more
chunk series on x itself at the tile's own pixels; bias (and the identity
skip, resampled) come in the epilogue.  What it shows, before the card is
asked, is that this order stays inside RESBLOCK_TOL (2^-5 of max|plain|) at
small widths, ragged H and W, C % 8 != 0, up, down, projection and dropout.

The kernel addresses each tap's window with a wgmma shared-memory descriptor
(no swizzle, K-major: start, leading and stride byte offsets) into the haloed
tile, and its weights as MN-major 128-byte-swizzled tiles; the tests decode
both descriptors on the CPU, byte for byte, and check that they yield each
tap's window and each weight where the loads put it, and that the
accumulator fragments cover every output of a block once."""

import math

import pytest
import torch

from sgdm_tpu_torch.ops.resblock import _group_stats, dropout_mask, resblock_plain

RESBLOCK_TOL = 2.0 ** -5      # of max(max|plain|, 1), as on the card
TH = TW = 16                  # output tile
HH, HWD = TH + 2, TW + 2      # haloed tile
HPX = HH * HWD
CK = 32                       # input channels per chunk
BN = 128                      # output channels per block
PLANE = HPX * 16              # bytes of one 8-channel group of the haloed tile
B_SUB = CK * 128              # one tap's 64-wide weight sub-tile
EPS = 1e-5


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def silu(z: torch.Tensor) -> torch.Tensor:
    return z / (1.0 + torch.exp(-z))


def activated_halo(kind, rs, src, coef, b, y0, x0, c0, h, w, drop):
    """The chunk's haloed tile [HH, HWD, CK], activated once, bf16-valued."""
    mean, sc, sh = (t[b, c0:c0 + CK] for t in coef)
    nc = mean.shape[0]
    ys = torch.arange(y0 - 1, y0 - 1 + HH)[:, None].expand(HH, HWD)
    xs = torch.arange(x0 - 1, x0 - 1 + HWD)[None, :].expand(HH, HWD)
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    yc, xc = ys.clamp(0, h - 1), xs.clamp(0, w - 1)
    act = lambda v: silu((v - mean) * sc + sh)
    if kind == 1 and rs == 2:       # the 2x2 pool of the activated source pixels, in f32
        v = sum(act(src[b, 2 * yc + dy, 2 * xc + dx, c0:c0 + nc].float())
                for dy in range(2) for dx in range(2)) * 0.25
    elif kind == 1:                 # rs 1: the nearest source pixel
        yy, xx = (yc >> 1, xc >> 1) if rs == 1 else (yc, xc)
        v = act(src[b, yy, xx, c0:c0 + nc].float())
    else:
        v = act(src[b, yc, xc, c0:c0 + nc].float())
        if drop is not None:        # the mask at pixel y * W + x, channel c
            v = v * drop[b, (yc * w + xc), c0:c0 + nc]
    tile = torch.zeros(HH, HWD, CK)
    tile[:, :, :nc] = torch.where(inside[..., None], v, torch.zeros(()))
    return bf16(tile)


def conv_rehearsal(kind, rs, src, coef, w, bias, h, w_, x=None, wskip=None, drop=None):
    """One launch of the kernel: KIND 1 (src = x at Hs x Ws, resampled by rs),
    KIND 2 (src = h2, identity skip x resampled by rs), KIND 3 (projection
    skip).  w [9, Ci, Co] and wskip [Cx, Co] bf16-valued f32."""
    bsz, ci, co = src.shape[0], src.shape[-1], w.shape[-1]
    out = torch.zeros(bsz, h, w_, co)
    for b in range(bsz):
        for y0 in range(0, h, TH):
            for x0 in range(0, w_, TW):
                for n0 in range(0, co, BN):
                    nn = min(BN, co - n0)
                    acc = torch.zeros(TH, TW, BN)
                    for c0 in range(0, ci, CK):
                        tile = activated_halo(kind, rs, src, coef, b, y0, x0, c0, h, w_, drop)
                        wc = torch.zeros(9, CK, BN)
                        kc = min(CK, ci - c0)
                        wc[:, :kc, :nn] = w[:, c0:c0 + kc, n0:n0 + nn]
                        for tap in range(9):            # nine windows of the one tile
                            dy, dx = divmod(tap, 3)
                            acc += tile[dy:dy + TH, dx:dx + TW] @ wc[tap]
                    if kind == 3:                       # x itself, at the tile's pixels
                        cx = x.shape[-1]
                        for c0 in range(0, cx, CK):
                            kc = min(CK, cx - c0)
                            xt = torch.zeros(TH, TW, CK)
                            part = x[b, y0:y0 + TH, x0:x0 + TW, c0:c0 + kc].float()
                            xt[:part.shape[0], :part.shape[1], :kc] = part
                            wc = torch.zeros(CK, BN)
                            wc[:kc, :nn] = wskip[c0:c0 + kc, n0:n0 + nn]
                            acc += xt @ wc
                    ty, tx = min(TH, h - y0), min(TW, w_ - x0)
                    res = acc[:ty, :tx, :nn] + bias[n0:n0 + nn]
                    if kind == 2:
                        ys = torch.arange(y0, y0 + ty)[:, None]
                        xs = torch.arange(x0, x0 + tx)[None, :]
                        xf = x[b].float()[..., n0:n0 + nn]
                        if rs == 2:
                            res = res + sum(xf[2 * ys + dy, 2 * xs + dx]
                                            for dy in range(2) for dx in range(2)) * 0.25
                        else:
                            yy, xx = (ys >> 1, xs >> 1) if rs == 1 else (ys, xs)
                            res = res + xf[yy, xx]
                    out[b, y0:y0 + ty, x0:x0 + tx, n0:n0 + nn] = res
    return out


def gn_coef(t, gamma, beta, groups, fs=None, fsh=None):
    """Per-channel (mean, scale, shift) with gamma/beta (and FiLM) folded in."""
    bsz, c = t.shape[0], t.shape[-1]
    mean, rstd = _group_stats(t.float().reshape(bsz, -1, c), groups, EPS)
    sc, sh = rstd[:, 0] * gamma, beta.expand(bsz, c)
    if fs is not None:
        f = 1.0 + fs.float()
        sc, sh = sc * f, sh * f + fsh.float()
    return mean[:, 0], sc, sh


def rehearse_block(x, o, resample, rate, seed):
    bsz, hi, wi, cin = x.shape
    cout = o["w1"].shape[-1]
    rs = {None: 0, "up": 1, "down": 2}[resample]
    ho, wo = (hi // 2, wi // 2) if rs == 2 else ((2 * hi, 2 * wi) if rs == 1 else (hi, wi))
    taps = lambda w: bf16(w.reshape(9, w.shape[2], w.shape[3]))
    coef1 = gn_coef(x, o["gn1_scale"], o["gn1_bias"], math.gcd(32, cin))
    h2 = conv_rehearsal(1, rs, x, coef1, taps(o["w1"]), o["b1"], ho, wo)
    coef2 = gn_coef(h2, o["gn2_scale"], o["gn2_bias"], math.gcd(32, cout), o["film_scale"],
                    o["film_shift"])
    drop = dropout_mask(bsz, ho * wo, cout, seed, rate) if rate > 0 else None
    if "skip_w" in o:
        out = conv_rehearsal(3, 0, h2, coef2, taps(o["w2"]), o["b2"], ho, wo, x=x,
                             wskip=bf16(o["skip_w"].reshape(cin, cout)), drop=drop)
    else:
        out = conv_rehearsal(2, rs, h2, coef2, taps(o["w2"]), o["b2"], ho, wo, x=x, drop=drop)
    return out.to(torch.bfloat16), h2


def operands(b, h, w, cin, cout, seed):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)
    x = r(b, h, w, cin).to(torch.bfloat16)
    o = dict(gn1_scale=1 + 0.1 * r(cin), gn1_bias=0.1 * r(cin),
             w1=r(3, 3, cin, cout) / math.sqrt(9 * cin), b1=0.1 * r(cout),
             film_scale=(0.1 * r(b, cout)).to(torch.bfloat16),
             film_shift=(0.1 * r(b, cout)).to(torch.bfloat16),
             gn2_scale=1 + 0.1 * r(cout), gn2_bias=0.1 * r(cout),
             w2=r(3, 3, cout, cout) / math.sqrt(9 * cout), b2=0.1 * r(cout))
    if cin != cout:
        o["skip_w"] = r(1, 1, cin, cout) / math.sqrt(cin)
    return x, o


# (B, H, W, Cin, Cout, resample, dropout): ragged H and W (tiles overhang),
# C % 8 != 0, up, down, projection, dropout, Ci across chunks, Co across tiles
CASES = [(2, 10, 6, 40, 40, None, 0.0), (2, 5, 7, 20, 20, "up", 0.0),
         (2, 12, 10, 24, 24, "down", 0.0), (2, 8, 24, 36, 20, None, 0.0),
         (2, 10, 6, 40, 48, None, 0.1), (1, 17, 19, 44, 52, None, 0.1),
         (1, 20, 18, 72, 136, None, 0.0), (1, 18, 34, 40, 40, "down", 0.0)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_conv_tiling_matches_plain(case):
    b, h, w, cin, cout, resample, rate = case
    x, o = operands(b, h, w, cin, cout, seed=h * w + cin)
    args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale", "film_shift",
                           "gn2_scale", "gn2_bias", "w2", "b2")]
    want = resblock_plain(x, *args, o.get("skip_w"), None, resample=resample,
                          dropout_rate=rate, seed=7, save_res=True)
    got, h2 = rehearse_block(x, o, resample, rate, seed=7)
    ref = want[0].float()
    err = (got.float() - ref).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= RESBLOCK_TOL * max(ref.abs().max().item(), 1.0), err
    h2_err = (h2 - want[1]).abs().max().item()
    assert h2_err <= 1e-4 * max(want[1].abs().max().item(), 1.0), h2_err


def test_zero_padding_is_in_activation_space():
    """An out-of-image tap reads 0, not silu(GN(0)): the halo ring of a tile at
    the image's corner is exactly zero, though silu(shift) is not."""
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    coef = (torch.zeros(1, 8), torch.ones(1, 8), torch.full((1, 8), 2.0))
    tile = activated_halo(1, 0, x, coef, 0, 0, 0, 0, 4, 4, None)
    assert (tile[0] == 0).all() and (tile[:, 0] == 0).all() and (tile[5:] == 0).all()
    assert torch.allclose(tile[1:5, 1:5, :8], bf16(silu(torch.tensor(2.0))).expand(4, 4, 8))


# ------------------------------------------------------ the kernel's addressing

def a_desc(u: int, wg: int, dy: int, dx: int, kk: int):
    """(start, LBO, SBO) of the A operand of tap (dy, dx), k16 slice kk, unit u
    of warpgroup wg, as `conv_kernel` builds them (bytes from the tile)."""
    return 2 * kk * PLANE + ((8 * u + dy) * HWD + 8 * wg + dx) * 16, PLANE, HWD * 16


def decode_plain_k_major(start: int, lbo: int, sbo: int, m: int, k: int) -> int:
    """Byte address of element (m, k) of a 64 x 16 bf16 operand under a
    no-swizzle K-major wgmma descriptor: core matrices of 8 rows x 16 bytes
    (128 contiguous bytes), 8-row groups `sbo` apart, the two 8-wide K halves
    `lbo` apart."""
    return start + (m // 8) * sbo + (m % 8) * 16 + (k // 8) * lbo + (k % 8) * 2


def test_tap_descriptors_yield_each_window():
    # a haloed tile holding its own coordinates: channel c of halo pixel p is
    # encoded as p * 64 + c, stored as the kernel stores it, [group][pixel][8]
    mem = torch.empty(4 * PLANE // 2, dtype=torch.int64)
    for p in range(HPX):
        for c in range(CK):
            mem[((c // 8) * PLANE + p * 16 + (c % 8) * 2) // 2] = p * 64 + c
    for wg in range(2):
        for u in range(2):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for kk in range(CK // 16):
                    start, lbo, sbo = a_desc(u, wg, dy, dx, kk)
                    assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
                    assert max(start, lbo, sbo) < (1 << 18)        # 14 bits of 16-byte units
                    for m in range(64):
                        py, px = 8 * u + m // 8, 8 * wg + m % 8   # output pixel of row m
                        for k in range(16):
                            addr = decode_plain_k_major(start, lbo, sbo, m, k)
                            want = ((py + dy) * HWD + px + dx) * 64 + 16 * kk + k
                            assert mem[addr // 2] == want


def decode_sw128_mn_major(start: int, lbo: int, k: int, n: int) -> int:
    """Byte address of element (k, n) of a 16 x 128 bf16 B operand under a
    128-byte-swizzled MN-major descriptor: 64-wide blocks `lbo` apart, rows of
    128 bytes, 8-row groups 1024 bytes apart, 16-byte chunks XOR the row."""
    row = k % 8
    return (start + (n // 64) * lbo + (k // 8) * 1024 + row * 128
            + ((((n % 64) // 8) ^ row) << 4) + (n % 8) * 2)


def test_weight_descriptors_find_what_the_loads_put():
    swz = lambda r, ch: r * 128 + ((ch ^ (r & 7)) << 4)
    # the loads: weight (tap, ci = c0 + r, co = n0 + 64 s + 8 ch + e) goes to
    # tap * 2 * B_SUB + s * B_SUB + swz(r, ch) + 2 e
    placed = {}
    for tap in range(9):
        for r in range(CK):
            for n in range(BN):
                s, ch, e = n // 64, (n % 64) // 8, n % 8
                placed[tap * 2 * B_SUB + s * B_SUB + swz(r, ch) + 2 * e] = (tap, r, n)
    assert len(placed) == 9 * CK * BN                    # no two weights share a byte pair
    for tap in range(9):
        for kk in range(CK // 16):
            start = tap * 2 * B_SUB + kk * 2048
            assert start % 1024 == 0                     # the swizzle atom's alignment
            for k in range(16):
                for n in range(BN):
                    assert placed[decode_sw128_mn_major(start, B_SUB, k, n)] == \
                        (tap, 16 * kk + k, n)


def test_fragments_cover_the_block_once():
    """acc[u][4j + 2h + e] of thread (wg, warp, lane): pixel (8u + 2 warp + h,
    8 wg + lane / 4), channel 8j + 2 (lane % 4) + e: every output of the 16 x 16
    x 128 block once."""
    seen = torch.zeros(TH, TW, BN, dtype=torch.int32)
    for wg in range(2):
        for warp in range(4):
            for lane in range(32):
                for u in range(2):
                    for i in range(64):
                        j, h, e = i // 4, (i // 2) % 2, i % 2
                        m = 16 * warp + lane // 4 + 8 * h          # wgmma D row
                        assert (m // 8, m % 8) == (2 * warp + h, lane // 4)
                        seen[8 * u + 2 * warp + h, 8 * wg + lane // 4,
                             8 * j + 2 * (lane % 4) + e] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,h,w,co", [(128, 64, 64, 128), (3, 5, 7, 20), (2, 20, 18, 136)])
def test_grid_covers_every_tile_once(b, h, w, co):
    ntx, nty, nco = -(-w // TW), -(-h // TH), -(-co // BN)
    seen = set()
    for bid in range(b * nty * ntx * nco):
        rest = bid
        ct, rest = rest % nco, rest // nco
        tx, rest = rest % ntx, rest // ntx
        ty, bb = rest % nty, rest // nty
        seen.add((bb, ty, tx, ct))
    assert len(seen) == b * nty * ntx * nco and max(s[0] for s in seen) == b - 1
