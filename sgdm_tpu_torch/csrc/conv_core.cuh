// The implicit-GEMM convolution on wgmma shared by the ResBlock kernels:
// K1, K2 and K4 (resblock.cu: KIND 1-3, the conv with its GN(+FiLM)+SiLU
// prologue) and K5's data gradients (resblock_bwd.cu: KIND 0, a plain
// convolution of g or dh2 with the flipped taps).  See resblock.cu's header
// for the design and what bounds it.  One block per (sample, 16x16 output
// tile, 128 output channels).

#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace conv {

using sgdm::dropout_scale;
using sgdm::load8;
using sgdm::pack8;
using sgdm::silu_fast;

constexpr int TH = 16, TW = 16;            // output pixels of a block's spatial tile
constexpr int HH = TH + 2, HWD = TW + 2;   // the haloed tile: one pixel more on each side
constexpr int HPX = HH * HWD;              // 324 halo pixels
constexpr int CK = 32;                     // input channels per chunk: 4 groups of 8
constexpr int BN = 128;                    // output channels per block: two 64-wide sub-tiles
constexpr int NT = 256;                    // two warpgroups, each 16 x 8 output pixels
constexpr int PLANE = HPX * 16;            // bytes of one 8-channel group of the haloed tile
constexpr int A_BYTES = 4 * PLANE;         // one activated tile (20.25 KB)
constexpr int B_SUB = CK * 128;            // a tap's 64-wide weight sub-tile: 32 rows x 128 B
constexpr int B_BYTES = 9 * 2 * B_SUB;     // a chunk's weights, nine taps (72 KB)
constexpr int UNITS = 4 * HPX;             // (pixel, channel group) pairs of a haloed tile
// 1 KB of alignment for the swizzled weight tiles, two of them, two activated tiles
constexpr size_t SMEM_CONV = 1024 + 2 * (size_t)B_BYTES + 2 * (size_t)A_BYTES;

// 8 bf16 from p (nv of them valid; 16-byte loads when vec), as loaded
__device__ __forceinline__ uint4 ld8_bf16(const bf16* p, int nv, bool vec) {
  if (vec && nv >= 8) return *reinterpret_cast<const uint4*>(p);
  uint4 r = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < nv) e[i] = p[i];
  return r;
}
__device__ __forceinline__ void unpack8(uint4 r, float out[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

struct ConvArgs {
  const void* src;     // KIND 0/1: bf16 [B,Hs,Ws,Ci]; KIND 2/3: h2 f32 [B,H,W,Ci]
  const float* coef;   // [B,3,Ci]: mean, scale, shift
  const bf16* w;       // [9,Ci,Co8]: taps dy*3+dx, output channels padded to Co8 with zeros
  const float* bias;   // [Co]
  const bf16* x;       // KIND 2: [B,Hs,Ws,Co]; KIND 0/3: [B,H,W,Cx]
  const bf16* wskip;   // KIND 0/3: [Cx,Co8]
  void* out;           // KIND 0/1: f32 [B,H,W,Co]; KIND 2/3: bf16 [B,H,W,Co]
  int B, H, W, Ci, Co, Hs, Ws, Cx;
  int vec_a, vec_b;    // Ci (and Cx) % 8 == 0; Co % 8 == 0
  float rate, inv_keep;  // DROP: dropout rate and 1/(1-rate)
  uint32_t seed;         // DROP: the block's dropout seed (sample b hashes seed + b)
};

// KIND 0: a plain convolution of a bf16 src (no activation, no bias, f32
//         out; RS 0): K5's data gradients, src = g or dh2 and w = the
//         flipped taps; Cx > 0 adds one-tap chunks of x [B,H,W,Cx] times
//         wskip [Cx,Co8] as KIND 3 does (Ci = 0: that product alone).
// KIND 1: conv1, A = act(x) resampled by RS (0 none, 1 up, 2 down).
// KIND 2: conv2 with identity skip, x resampled by RS.
// KIND 3: conv2 with the 1x1 projection skip (RS = 0): after the Ci chunks
//         come the Cx chunks of x itself, one tap (the tile's own pixels).
// DROP (KIND 2/3): h3 is multiplied by the dropout mask (K4).
template <int KIND, int RS, bool DROP>
__global__ void __launch_bounds__(NT, 1) conv_kernel(const ConvArgs a) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* Bs = smem;                 // [2][tap][64-wide sub-tile][32 rows, swizzled]
  unsigned char* As = Bs + 2 * B_BYTES;     // [2][group][halo pixel][8 channels]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // block -> (sample, tile row, tile column, channel tile), the channel tile fastest
  const int ntx = (a.W + TW - 1) / TW, nty = (a.H + TH - 1) / TH, nco = (a.Co + BN - 1) / BN;
  int rest = blockIdx.x;
  const int ct = rest % nco;
  rest /= nco;
  const int tx = rest % ntx;
  rest /= ntx;
  const int ty = rest % nty, b = rest / nty;
  const int n0 = ct * BN, y0 = ty * TH, x0 = tx * TW;
  const int co8 = (a.Co + 7) & ~7;
  const int KC = (a.Ci + CK - 1) / CK;
  const int NCH = KC + (KIND == 3 || KIND == 0 ? (a.Cx + CK - 1) / CK : 0);
  // a thread's units are i = tid + NT * (UPP * part + k): always channel group g
  const int g = tid & 3;

  // the weights of chunk j (nine taps of CK input channels, or the skip's one) -> B[buf]
  auto load_b = [&](int j, int buf) {
    const bool skip = j >= KC;
    const int ntap = skip ? 1 : 9, rows = skip ? a.Cx : a.Ci, c0 = (skip ? j - KC : j) * CK;
    const bf16* w = skip ? a.wskip : a.w;
    unsigned char* dst = Bs + buf * B_BYTES;
    for (int i = tid; i < ntap * 2 * CK * 8; i += NT) {
      const int ch = i & 7, r = (i >> 3) & (CK - 1), ts = i >> 8;  // ts = tap * 2 + sub-tile
      const int ci = c0 + r, co = n0 + 64 * (ts & 1) + 8 * ch;
      const bool in = ci < rows && co < co8;
      const bf16* p = in ? w + ((long long)(ts >> 1) * rows + ci) * co8 + co : w;
      cp_async16(smem_u32(dst + ts * B_SUB + swz(r, ch)), p, in);
    }
  };

  // The activation of chunk j, in PARTS parts, into A[buf]: unit i is halo
  // pixel i / 4, channel group i % 4; zero outside the image (the padding is in
  // h1 / h3 space) and beyond Ci.  A part loads all of its units' sources
  // first (a store through a generic pointer may alias the next load, so the
  // compiler would not move that load above it), then activates and stores.
  // a thread's units of a chunk: PARTS parts of UPP (six; one a part where
  // registers are short: the 2x2 pool, whose unit reads four source pixels,
  // and KIND 3, which has the skip chunks beside)
  constexpr int NSRC = (KIND == 1 && RS == 2) ? 4 : 1;  // source pixels of a unit
  constexpr int UPP = (NSRC == 4 || KIND == 3) ? 1 : 2, PARTS = 6 / UPP;
  static_assert(PARTS * UPP * NT >= UNITS, "every unit has a thread");
  struct Raw {
    uint4 h[UPP][KIND == 1 ? NSRC : 1];  // bf16 sources (KIND 1)
    float f[UPP][KIND == 1 ? 1 : 8];     // f32 sources (h2; x of a skip chunk, KIND 3)
    bool live[UPP];
  };
  // GN(+FiLM) of the thread's channel group in the chunk, the mean folded in:
  // act(v) = silu(v * sc + sh), sh = shift - mean * scale
  float sc[8], sh[8];
  auto load_coef = [&](int j) {
    if constexpr (KIND == 0) return;
    const int c = j * CK + 8 * g, nv = a.Ci - c;
    if (j < KC && nv > 0) {
      float mean[8];
      const float* cf = a.coef + (size_t)b * 3 * a.Ci + c;
      load8(cf, nv, a.vec_a, mean);
      load8(cf + a.Ci, nv, a.vec_a, sc);
      load8(cf + 2 * a.Ci, nv, a.vec_a, sh);
#pragma unroll
      for (int e = 0; e < 8; ++e) sh[e] = fmaf(-mean[e], sc[e], sh[e]);
    }
  };
  auto load_part = [&](int j, int part, Raw& r) {
    const bool skip = j >= KC;
    const int c = (skip ? j - KC : j) * CK + 8 * g, nv = (skip ? a.Cx : a.Ci) - c;
#pragma unroll
    for (int k = 0; k < UPP; ++k) {
      const int i = tid + NT * (UPP * part + k), p = i >> 2, hy = p / HWD, hx = p - hy * HWD;
      const int y = y0 - 1 + hy, x = x0 - 1 + hx;
      r.live[k] = i < UNITS && nv > 0 && y >= 0 && y < a.H && x >= 0 && x < a.W &&
                  (!skip || (hy >= 1 && hy <= TH && hx >= 1 && hx <= TW));
      if (!r.live[k]) continue;
      if constexpr (KIND == 0) {  // bf16 as it is: src, or x in a skip chunk
        const bf16* s = skip ? a.x : static_cast<const bf16*>(a.src);
        r.h[k][0] = ld8_bf16(s + (((size_t)b * a.H + y) * a.W + x) * (skip ? a.Cx : a.Ci) + c, nv,
                             a.vec_a);
        continue;
      }
      if constexpr (KIND == 3) {
        if (skip) {  // a skip chunk: x itself, at the tile's own pixels (the halo's inside)
          load8(a.x + (((size_t)b * a.H + y) * a.W + x) * a.Cx + c, nv, a.vec_a, r.f[k]);
          continue;
        }
      }
      if constexpr (KIND == 1) {
        const bf16* xs = static_cast<const bf16*>(a.src);
#pragma unroll
        for (int q = 0; q < NSRC; ++q) {
          const int yy = RS == 2 ? 2 * y + (q >> 1) : (RS == 1 ? y >> 1 : y);
          const int xx = RS == 2 ? 2 * x + (q & 1) : (RS == 1 ? x >> 1 : x);
          r.h[k][q] = ld8_bf16(xs + (((size_t)b * a.Hs + yy) * a.Ws + xx) * a.Ci + c, nv,
                               a.vec_a);
        }
      } else {
        load8(static_cast<const float*>(a.src) + (((size_t)b * a.H + y) * a.W + x) * a.Ci + c,
              nv, a.vec_a, r.f[k]);
      }
    }
  };
  auto store_part = [&](int j, int buf, int part, const Raw& r) {
    const bool skip = j >= KC;
    const int c = (skip ? j - KC : j) * CK + 8 * g;
#pragma unroll
    for (int k = 0; k < UPP; ++k) {
      const int i = tid + NT * (UPP * part + k);
      if (i >= UNITS) break;
      const int p = i >> 2;
      if constexpr (KIND == 0) {
        *reinterpret_cast<uint4*>(As + buf * A_BYTES + g * PLANE + p * 16) =
            r.live[k] ? r.h[k][0] : make_uint4(0, 0, 0, 0);
        continue;
      }
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (r.live[k]) {
        if (skip) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = r.f[k][KIND == 1 ? 0 : e];
        } else {
#pragma unroll
          for (int q = 0; q < NSRC; ++q) {  // RS 2: the 2x2 average of the activated pixels, in f32
            float t[8];
            if (KIND == 1) unpack8(r.h[k][KIND == 1 ? q : 0], t);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] += silu_fast(fmaf(KIND == 1 ? t[e] : r.f[k][KIND == 1 ? 0 : e], sc[e], sh[e]));
          }
          if (NSRC == 4) {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] *= 0.25f;
          }
          if (DROP) {
            const int hy = p / HWD, hx = p - hy * HWD;
            const uint32_t pixel = (uint32_t)((y0 - 1 + hy) * a.W + x0 - 1 + hx);
            const uint32_t s = a.seed + (uint32_t)b;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] *= dropout_scale(pixel, (uint32_t)(c + e), (uint32_t)a.Ci, s, a.rate,
                                    a.inv_keep);
          }
          if (!a.vec_a) {
            const int nv = a.Ci - c;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e >= nv) v[e] = 0.f;
          }
        }
      }
      *reinterpret_cast<uint4*>(As + buf * A_BYTES + g * PLANE + p * 16) = pack8(v);
    }
  };

  // the prologue: chunk 0's weights and its activated tile
  load_b(0, 0);
  cp_async_commit();
  load_coef(0);
#pragma unroll
  for (int part = 0; part < PARTS; ++part) {
    Raw r;
    load_part(0, part, r);
    store_part(0, 0, part, r);
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float acc[2][64];  // [unit: tile rows 0-7 / 8-15][fragment of 64 rows x 128 channels]
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[u][i] = 0.f;

  // chunk j: its products, with chunk j + 1's weights loading and its tile
  // being activated meanwhile; SKIP (KIND 3 only): a chunk of the projection
  auto chunk = [&](int j, auto skip_tag) {
    constexpr bool SKIP = decltype(skip_tag)::value;
    const int buf = j & 1;
    const bool more = j + 1 < NCH;
    if (more) load_b(j + 1, buf ^ 1);
    cp_async_commit();
    if (more) load_coef(j + 1);
    // descriptors of the chunk's tiles; a tap's, a slice's and a unit's are
    // these plus a constant start offset (in 16-byte units, the low bits)
    const uint64_t da0 = make_desc_plain(smem_u32(As + buf * A_BYTES), PLANE, HWD * 16);
    const uint64_t db0 = make_desc_mn(smem_u32(Bs + buf * B_BYTES), B_SUB);
    // taps [t0, t1): for each k16 slice (two channel groups) and each 8x8 unit
    // of this warpgroup, the tap's window of the haloed tile is the A operand:
    // core matrices are 8 pixels of a halo row (16 bytes each, 128 contiguous
    // bytes), 8-row groups one halo row apart (SBO), channel groups one plane
    // apart (LBO); the window starts dy * HWD + dx pixels in.  B: the tap's two
    // 64-wide sub-tiles, B_SUB apart (LBO)
    auto issue = [&](int t0, int t1) {
      wgmma_fence();
#pragma unroll
      for (int tap = t0; tap < t1; ++tap) {
        const int dy = SKIP ? 1 : tap / 3, dx = SKIP ? 1 : tap % 3;
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk) {
          const uint64_t db = db0 + ((tap * 2 * B_SUB + kk * 2048) >> 4);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            wgmma_ss128_tb(acc[u], da0 + ((2 * kk * PLANE + ((8 * u + dy) * HWD + dx) * 16) >> 4) +
                                       wg * 8, db, 1);
        }
      }
      wgmma_commit();
    };
    // the taps in PARTS groups (a skip chunk's one tap with the first), each
    // part of the next chunk's activation between them: its loads are issued
    // before the group, so they fly while the tensor cores work
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      Raw r;
      if (more) load_part(j + 1, part, r);
      if (SKIP) {
        if (part == 0) issue(0, 1);
      } else {
        issue(9 * part / PARTS, 9 * (part + 1) / PARTS);
      }
      if (more) store_part(j + 1, buf ^ 1, part, r);
    }
    wgmma_wait0();
#pragma unroll
    for (int u = 0; u < 2; ++u) fence_regs(acc[u]);
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  };
  for (int j = 0; j < KC; ++j) chunk(j, std::false_type{});
  if constexpr (KIND == 3 || KIND == 0)
    for (int j = KC; j < NCH; ++j) chunk(j, std::true_type{});

  // ---- epilogue, from the registers: bias (+ skip), stores of channel pairs.
  // acc[u][4j + 2h + e]: pixel row 2 warp + h, column lane / 4 of unit u
  // (tile rows 8u.., columns 8 wg..); channel 8 j + 2 (lane % 4) + e
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + 8 * u + 2 * warp + h, x = x0 + 8 * wg + (lane >> 2);
      if (y >= a.H || x >= a.W) continue;
      const size_t pix = ((size_t)b * a.H + y) * a.W + x;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int co = n0 + 8 * jj + 2 * (lane & 3);
        if (co >= a.Co) continue;
        const bool pair = co + 1 < a.Co;
        float v0 = acc[u][4 * jj + 2 * h] + (KIND == 0 ? 0.f : a.bias[co]);
        float v1 = pair ? acc[u][4 * jj + 2 * h + 1] + (KIND == 0 ? 0.f : a.bias[co + 1]) : 0.f;
        if (KIND <= 1) {
          float* o = static_cast<float*>(a.out) + pix * a.Co + co;
          if (a.vec_b) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (pair) o[1] = v1;
          }
          continue;
        }
        if (KIND == 2) {
          float s0 = 0.f, s1 = 0.f;
          if (RS == 2) {
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dx = 0; dx < 2; ++dx) {
                const bf16* q = a.x + (((size_t)b * a.Hs + 2 * y + dy) * a.Ws + 2 * x + dx) * a.Co + co;
                s0 += __bfloat162float(q[0]);
                if (pair) s1 += __bfloat162float(q[1]);
              }
            s0 *= 0.25f, s1 *= 0.25f;
          } else {
            const int yy = RS == 1 ? y >> 1 : y, xx = RS == 1 ? x >> 1 : x;
            const bf16* q = a.x + (((size_t)b * a.Hs + yy) * a.Ws + xx) * a.Co + co;
            s0 = __bfloat162float(q[0]);
            if (pair) s1 = __bfloat162float(q[1]);
          }
          v0 += s0, v1 += s1;
        }
        bf16* o = static_cast<bf16*>(a.out) + pix * a.Co + co;
        if (a.vec_b) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (pair) o[1] = __float2bfloat16_rn(v1);
        }
        }
    }
}

template <int KIND, int RS, bool DROP>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  // set on every launch: the attribute is per device, and a process may use several
  cudaError_t e = cudaFuncSetAttribute(conv_kernel<KIND, RS, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_CONV);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW) *
                           ((a.Co + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_kernel<KIND, RS, DROP><<<(unsigned)blocks, NT, SMEM_CONV, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace conv
