// Fused ResBlock backward for Hopper (sm_90a): K5, the port of the Pallas
// TPU kernel sgdm_tpu/ops/pallas/resblock.py _bwd_kernel (the custom VJP of
// fused_resblock, reached from f_bwd / bwd_impl).  Given the residuals of
// the training forward K4 (resblock.cu: x, h2 in f32, the per-channel GN
// mean and rstd of x and h2) and the output cotangent g, it returns dx,
// dW1, dc1, dgamma1, dbeta1, dW2, dc2, dgamma2, dbeta2, the per-sample
// dFiLM (dfs, dfsh) and, for a projection skip, dW_skip (dskb = dc2).
//
// The TPU kernel walks the batch on a sequential grid and carries every
// weight gradient in VMEM across it.  Blocks here run in parallel in no
// order, so nothing carries over: every cross-sample sum is written as
// per-block partials and summed by a second pass in a fixed order
// (deterministic, no float atomics).  One call is these launches:
//   1. dgrad conv2                dh3d = conv3x3(g, W2 flipped)      f32
//   2. gn_bwd<reduce>, GN2        per (sample, channel): S1 = Σ dpre3,
//                                 S2 = Σ dpre3·xhat2, Σ g; from them dfs,
//                                 dfsh, the dgamma2/dbeta2/dc2 partials and
//                                 the coefficients of dh2 = k1·dpre3 + k0 +
//                                 kx·xhat2 (the GN backward's group means);
//                                 and h3d = bf16(silu(GN2+FiLM) · mask)
//   3. gn_bwd<apply>, GN2         dh2 -> bf16, and the dc1 partials
//   4. dgrad conv1                dh1 = conv3x3(dh2, W1 flipped)     f32
//   5. dgrad 1x1 (proj skip)      g @ W_skipᵀ                        f32
//   6. gn_bwd<reduce>, GN1        dgamma1/dbeta1 partials, coefficients of
//                                 dx; and h1 = bf16(silu(GN1(x)))
//   7. gn_bwd<apply>, GN1         dx = GN1ᵀ(dh1) + skip'(g)          bf16
//   8. wgrad(h3d, g)              dW2 partials
//   9. wgrad(h1, dh2)             dW1 partials
//  10. wgrad(x, g), one tap       dW_skip partials (proj skip)
//  11-13. colsum over each weight gradient's partials, 14. over the
//  per-sample ones.
// dropout: dpre3 takes dh3d * mask with the mask regenerated from the same
// counter hash as the forward (common.cuh dropout_scale).
//
// Rounding points are _bwd_kernel's: g enters the dgrad and wgrad products
// as bf16 (it is the bf16 cotangent), dh2 is rounded to bf16 before the
// conv1 dgrad (resblock.py:323), h1 and h3d enter the weight gradients as
// bf16 (the TPU kernel saves them in the model dtype).  One difference: the
// conv1 weight gradient also takes the bf16 dh2 (the TPU kernel takes it in
// f32), so all gradient convolutions run on bf16 tensor cores.
//
// What bounds it on an H100: the gradient convolutions are twice the
// forward's tensor-core operations (2·2·9·HW·Cin·Cout·B per conv pair), well
// above the bf16 ridge point, so the call is bound by operations.
//
// h1 and h3d.  K4 keeps x, h2 and the GN statistics, not h1 and h3d, as the
// TPU kernel does.  The GN-backward reduce passes (2, 6), which read x and
// h2 element by element anyway, write them as bf16 side outputs with the
// forward's folded coefficients and its SiLU (common.cuh silu_fast): each
// element is activated once a call, and the weight gradients read the very
// values the forward's convolutions took, instead of recomputing them in
// the weight-gradient GEMMs' prologue for every tap and every 128 output
// channels (36 times an element at 16x16x512).
//
// Data gradients (1, 4, 5): conv_core.cuh's convolution, KIND 0 (the
// forward's design: a haloed 16x16 tile of g or dh2, zero-padded in g
// space, nine no-swizzle tap windows into it, the flipped weights as
// 128-byte-swizzled MN-major tiles by cp.async under the products, f32
// accumulators stored from the registers); the 1x1 skip is its one-tap
// chunks.
//
// Weight gradients (wgrad_kernel, 8-10): dW[tap][ci][co] = Σ_pixels
// act[p + tap - (1,1)][ci] · g[p][co].  A block owns 64 input x 64 output
// channels and all nine taps, and walks a contiguous run of 16x16 spatial
// tiles (the reduction), kept deterministic by writing its sums as one
// partial per run.  Per tile, by cp.async into a ring of three stages:
//   * A: the activation over the haloed 18x18 tile, [8-channel group][halo
//     pixel][8 channels] without swizzle (41 KB), zero outside the image (the
//     padding is in activation space).  Read as an MN-major A (channels on
//     M): a k16 step is 16 pixels of one window row; the descriptor of tap
//     (dy, dx) at tile row py starts ((py + dy)*18 + dx) pixels in, its K
//     halves 128 bytes apart (LBO), its channel groups a plane apart (SBO);
//   * B: g (or dh2) over the tile's own 256 pixels, [pixel][64 channels]
//     rows, 128-byte swizzled, MN-major (32 KB): a k16 step is one tile row.
// Three warpgroups, one per tap row dy: each runs m64n64k16 chains for its
// three taps dx over the 16 rows, 48 products a tile, with 3 x 32 f32
// accumulators in registers for the whole run, stored from the registers at
// the end (no shared-memory epilogue).  The 1x1 skip (TAPS 1): the three
// warpgroups take every third tile row of the centre tap, each writing its
// own partial.  Budget: 384 threads a block, at most 168 registers a thread
// (launch bounds), 219 KB of shared memory, one block an SM; chip_smoke's
// resblock_bwd ptxas row has the compiled figures.  No 64-bit division or
// modulo in any loop: the tile cursor is advanced by counting.
//
// C interface (ctypes): every function returns cudaGetLastError() after
// its launch, and launches on the stream it is given.

#include "conv_core.cuh"

namespace {

using sgdm::dropout_scale;
using sgdm::dsilu;
using sgdm::load8;
using sgdm::pack8;
using sgdm::silu_fast;

template <int V>
__device__ __forceinline__ void loadv(const float* p, float out[V]) {
  if (V == 8) load8(p, 8, true, out); else out[0] = *p;
}
template <int V>
__device__ __forceinline__ void loadv(const bf16* p, float out[V]) {
  if (V == 8) load8(p, 8, true, out); else out[0] = __bfloat162float(*p);
}

// ---------------------------------------------------- GroupNorm backward rows
// One block of 512 threads per sample, laid out as gn_coef in resblock.cu:
// thread t owns channels [j*V, j*V+V), j = t % (C/V), and pixels r, r+R, ...
// Per element: xhat = (s - mean)*rstd and the pre-activation z = s*sc + sh
// with the forward's folded coefficients (gn_coef, then conv_core.cuh's
// prologue: sc = rstd*gamma(*(1+fs)), sh = beta(*(1+fs) + fsh) - mean*sc);
// dpre = u * mask * silu'(z).  The reduce pass also writes the activation
// the forward's conv took, h = bf16(silu_fast(z) * mask) (h3d for GN2, h1
// for GN1), for the weight gradients: activated once per element per call.
struct RowArgs {
  const float* u;       // [B,HW,C] cotangent of the block activation (dh3d or dh1)
  const void* src;      // [B,HW,C] the GroupNorm input: h2 f32 (FILM) or x bf16
  const float* mean;    // [B,C]
  const float* rstd;    // [B,C]
  const float* gamma;   // [C]
  const float* beta;    // [C]
  const float* fs;      // FILM: [B,C]
  const float* fsh;     // FILM: [B,C]
  const bf16* g;        // reduce: [B,HW,C] whose per-channel sum is wanted, or null;
                        // apply: identity-skip addend, or null
  const float* add;     // apply: f32 addend [B,HW,C] (projection skip), or null
  float* coef;          // [B,3,C] (k1, k0, kx): written by reduce, read by apply
  float* dfs;           // reduce, FILM: [B,C]
  float* dfsh;          // reduce, FILM: [B,C]
  float* part;          // [B, part_ld] per-sample partial sums
  bf16* h;              // reduce: [B,HW,C] the activation (h3d or h1), or null
  int part_ld, off_g, off_b, off_c;  // column offsets (off_c < 0: none)
  bf16* out;            // apply: [B,HW,C]
  int HW, C, G;
  float rate, inv_keep;
  uint32_t seed;
};

constexpr int ROW_THREADS = 512;

// MODE 0 (reduce): S1 = Σ_p dpre, S2 = Σ_p dpre·xhat (and S3 = Σ_p g); writes h;
//   coef = (rstd·f·gamma, -rstd·mean_grp(f·gamma·S1)/n, -rstd·mean_grp(f·gamma·S2)/n),
//   part[off_g] = f·S2 (dgamma), part[off_b] = f·S1 (dbeta), part[off_c] = S3,
//   FILM: dfs = gamma·S2 + beta·S1, dfsh = S1.
// MODE 1 (apply): out = bf16(k1·dpre + k0 + kx·xhat + addend); part[off_c] = Σ_p of it.
template <typename T, int V, bool FILM, int MODE>
__global__ void __launch_bounds__(ROW_THREADS) gn_bwd_kernel(RowArgs a) {
  constexpr int NS = MODE == 0 ? 3 : 1;
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int C = a.C, HW = a.HW;
  const int CV = C / V;
  const int R = ROW_THREADS / CV;
  const int t = threadIdx.x;
  const int j = t % CV, r = t / CV;
  const int c0 = j * V;
  const T* src = static_cast<const T*>(a.src);
  const size_t bc = (size_t)b * C + c0;

  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;

  if (r < R) {
    float mean[V], rstd[V], sc[V], sh[V], k1[V], k0[V], kx[V];
    loadv<V>(a.mean + bc, mean);
    loadv<V>(a.rstd + bc, rstd);
    loadv<V>(a.gamma + c0, sc);
    loadv<V>(a.beta + c0, sh);
    if (FILM) {
      float f[V], fsh[V];
      loadv<V>(a.fs + bc, f);
      loadv<V>(a.fsh + bc, fsh);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        f[v] = 1.0f + f[v];
        sc[v] = rstd[v] * sc[v];
        sc[v] *= f[v];
        sh[v] = sh[v] * f[v] + fsh[v];
        sh[v] = fmaf(-mean[v], sc[v], sh[v]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sc[v] = rstd[v] * sc[v];
        sh[v] = fmaf(-mean[v], sc[v], sh[v]);
      }
    }
    if (MODE == 1) {
      const float* cf = a.coef + (size_t)b * 3 * C + c0;
      loadv<V>(cf, k1);
      loadv<V>(cf + C, k0);
      loadv<V>(cf + 2 * C, kx);
    }
    const uint32_t s = a.seed + (uint32_t)b;
    for (int p = r; p < HW; p += R) {
      const size_t off = ((size_t)b * HW + p) * C + c0;
      float u[V], sv[V], gv[V], dv[V], hv[V];
      loadv<V>(a.u + off, u);
      loadv<V>(src + off, sv);
      if (a.g != nullptr) loadv<V>(a.g + off, gv);
      if (MODE == 1 && a.add != nullptr) loadv<V>(a.add + off, dv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xhat = (sv[v] - mean[v]) * rstd[v];
        const float z = fmaf(sv[v], sc[v], sh[v]);
        const float m = a.rate > 0.f ? dropout_scale((uint32_t)p, (uint32_t)(c0 + v), (uint32_t)C,
                                                     s, a.rate, a.inv_keep)
                                     : 1.0f;
        const float dpre = u[v] * m * dsilu(z);
        if (MODE == 0) {
          hv[v] = silu_fast(z) * m;
          acc[0][v] += dpre;
          acc[1][v] += dpre * xhat;
          if (a.g != nullptr) acc[2][v] += gv[v];
        } else {
          float o = k1[v] * dpre + k0[v] + kx[v] * xhat;
          if (a.g != nullptr) o += gv[v];
          if (a.add != nullptr) o += dv[v];
          a.out[off + v] = __float2bfloat16_rn(o);
          acc[0][v] += o;
        }
      }
      if (MODE == 0 && a.h != nullptr) {
        if constexpr (V == 8) {
          *reinterpret_cast<uint4*>(a.h + off) = pack8(hv);
        } else {
          a.h[off] = __float2bfloat16_rn(hv[0]);
        }
      }
    }
  }

  // fixed-order reduction over the R pixel rows, then per channel
  float* ps = sm;                      // [NS][R*C]
  float* cs = sm + NS * R * C;         // [NS][C]
  float* wa = cs + NS * C;             // [2][C]: f·gamma·S1, f·gamma·S2
  if (r < R) {
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) ps[(k * R + r) * C + c0 + v] = acc[k][v];
  }
  __syncthreads();
  for (int c = t; c < C; c += ROW_THREADS) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      float z = 0.f;
      for (int rr = 0; rr < R; ++rr) z += ps[(k * R + rr) * C + c];
      cs[k * C + c] = z;
    }
  }
  __syncthreads();
  float* prow = a.part + (size_t)b * a.part_ld;
  if (MODE == 1) {
    if (a.off_c >= 0)
      for (int c = t; c < C; c += ROW_THREADS) prow[a.off_c + c] = cs[c];
    return;
  }
  for (int c = t; c < C; c += ROW_THREADS) {
    const float f = FILM ? 1.0f + a.fs[(size_t)b * C + c] : 1.0f;
    const float fg = f * a.gamma[c];
    wa[c] = fg * cs[c];
    wa[C + c] = fg * cs[C + c];
  }
  __syncthreads();
  const int gs = C / a.G;
  const float n = (float)HW * (float)gs;
  for (int c = t; c < C; c += ROW_THREADS) {
    const int g0 = (c / gs) * gs;
    float s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < gs; ++i) { s1 += wa[g0 + i]; s2 += wa[C + g0 + i]; }
    const float rs = a.rstd[(size_t)b * C + c];
    const float f = FILM ? 1.0f + a.fs[(size_t)b * C + c] : 1.0f;
    const float S1 = cs[c], S2 = cs[C + c];
    float* cf = a.coef + (size_t)b * 3 * C;
    cf[c] = rs * f * a.gamma[c];
    cf[C + c] = -rs * (s1 / n);
    cf[2 * C + c] = -rs * (s2 / n);
    prow[a.off_g + c] = f * S2;
    prow[a.off_b + c] = f * S1;
    if (a.g != nullptr && a.off_c >= 0) prow[a.off_c + c] = cs[2 * C + c];
    if (FILM) {
      a.dfs[(size_t)b * C + c] = a.gamma[c] * S2 + a.beta[c] * S1;
      a.dfsh[(size_t)b * C + c] = S1;
    }
  }
}

template <typename T, bool FILM, int MODE>
cudaError_t launch_row(const RowArgs& a, int B, cudaStream_t s) {
  const bool vec = a.C % 8 == 0;
  const int CV = vec ? a.C / 8 : a.C;
  if (CV > ROW_THREADS || a.C % a.G != 0) return cudaErrorInvalidValue;
  const int R = ROW_THREADS / CV;
  constexpr int NS = MODE == 0 ? 3 : 1;
  const size_t smem = (size_t)(NS * R * a.C + NS * a.C + 2 * a.C) * sizeof(float);
  cudaError_t e;
  if (vec) {
    e = cudaFuncSetAttribute(gn_bwd_kernel<T, 8, FILM, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    gn_bwd_kernel<T, 8, FILM, MODE><<<B, ROW_THREADS, smem, s>>>(a);
  } else {
    e = cudaFuncSetAttribute(gn_bwd_kernel<T, 1, FILM, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    gn_bwd_kernel<T, 1, FILM, MODE><<<B, ROW_THREADS, smem, s>>>(a);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------- the weight gradients
constexpr int WT = 16;                        // spatial tile: 16 x 16 pixels a step
constexpr int WHW = WT + 2;                   // side of the haloed tile
constexpr int WHPX = WHW * WHW;               // 324 halo pixels
constexpr int WM = 64, WN = 64;               // input (M) and output (N) channels a block
constexpr int WNT = 384;                      // three warpgroups: tap rows dy = 0, 1, 2
constexpr int WPLANE = WHPX * 16;             // bytes of one 8-channel group of the halo tile
constexpr int WA_BYTES = (WM / 8) * WPLANE;   // one activation tile (41,472 bytes)
constexpr int WG_BYTES = WT * WT * 128;       // one g tile: 256 rows of 64 channels (32 KB)
constexpr int WSTAGES = 3;
// 1 KB of alignment for the swizzled g tiles, then the ring of stages
constexpr size_t SMEM_WGRAD = 1024 + (size_t)WSTAGES * (WG_BYTES + WA_BYTES);

struct WgradArgs {
  const bf16* act;  // [B,H,W,lda] the conv's input: h3d, h1 or x (channels K.. zero)
  const bf16* g;    // [B,H,W,ldg] its output's cotangent: g or dh2
  float* part;      // [rows][TAPS][K][N]: rows = splits (TAPS 9) or 3 * splits (TAPS 1)
  int B, H, W, K, N, lda, ldg, splits;
};

// block -> (output tile nt fastest, input tile mt, split); split s sums the
// spatial tiles [s*T/splits, (s+1)*T/splits) of the T = B*ceil(H/16)*ceil(W/16)
// in order (b, tile row, tile column)
template <int TAPS>
__global__ void __launch_bounds__(WNT, 1) wgrad_kernel(const WgradArgs a) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* Gs = smem;                       // [stage][256 rows, 128-byte swizzled]
  unsigned char* As = smem + WSTAGES * WG_BYTES;  // [stage][group][halo pixel][8 channels]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int nnt = (a.N + WN - 1) / WN, nmt = (a.K + WM - 1) / WM;
  const int nt = blockIdx.x % nnt, rest = blockIdx.x / nnt;
  const int mt = rest % nmt, split = rest / nmt;
  const int m0 = mt * WM, n0 = nt * WN;
  const int ntx = (a.W + WT - 1) / WT, nty = (a.H + WT - 1) / WT, per_b = ntx * nty;
  const int tiles = a.B * per_b;
  const int t0 = (int)((long long)split * tiles / a.splits);
  const int nrun = (int)((long long)(split + 1) * tiles / a.splits) - t0;
  // the next tile to load, (cb, cty, ctx), advanced by counting
  int cb = t0 / per_b, cty = (t0 - cb * per_b) / ntx, ctx = t0 - cb * per_b - cty * ntx;

  auto load = [&](int stage) {
    const int y0 = cty * WT, x0 = ctx * WT;
    unsigned char* gd = Gs + stage * WG_BYTES;
    for (int i = tid; i < WT * WT * 8; i += WNT) {  // row r = pixel (r / 16, r % 16), chunk ch
      const int r = i >> 3, ch = i & 7;
      const int y = y0 + (r >> 4), x = x0 + (r & 15), co = n0 + 8 * ch;
      const bool in = y < a.H && x < a.W && co < a.ldg;
      const bf16* p = in ? a.g + (((size_t)cb * a.H + y) * a.W + x) * a.ldg + co : a.g;
      cp_async16(smem_u32(gd + swz(r, ch)), p, in);
    }
    unsigned char* ad = As + stage * WA_BYTES;
    for (int i = tid; i < WHPX * 8; i += WNT) {  // halo pixel i / 8, channel group i % 8
      const int grp = i & 7, pix = i >> 3;
      const int hy = pix / WHW, hx = pix - hy * WHW;
      const int y = y0 - 1 + hy, x = x0 - 1 + hx, c = m0 + 8 * grp;
      const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W && c < a.lda;
      const bf16* p = in ? a.act + (((size_t)cb * a.H + y) * a.W + x) * a.lda + c : a.act;
      cp_async16(smem_u32(ad + grp * WPLANE + pix * 16), p, in);
    }
    if (++ctx == ntx) {
      ctx = 0;
      if (++cty == nty) cty = 0, ++cb;
    }
  };

  float acc[3][32];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.f;

  // the ring: tile i's group is the i-th committed; one group a step, empty or not
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < nrun) load(s);
    cp_async_commit();
  }
  const int dy = wg;
  int stage = 0;
  for (int i = 0; i < nrun; ++i) {
    cp_async_wait<WSTAGES - 2>();  // tile i has landed (this thread's part of it)
    fence_proxy_async();
    __syncthreads();               // all of it, and every warpgroup is done with tile i - 1
    if (i + WSTAGES - 1 < nrun) load(stage == 0 ? WSTAGES - 1 : stage - 1);
    cp_async_commit();
    const uint64_t da0 = make_desc_plain(smem_u32(As + stage * WA_BYTES), 128, WPLANE);
    const uint64_t db0 = make_desc_mn(smem_u32(Gs + stage * WG_BYTES), 0);
    wgmma_fence();
#pragma unroll
    for (int py = 0; py < WT; ++py) {
      const uint64_t db = db0 + ((py * 2048) >> 4);
      if (TAPS == 9) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          wgmma_ss64_tt(acc[dx], da0 + ((((py + dy) * WHW + dx) * 16) >> 4), db, 1);
      } else if (py % 3 == wg) {
        wgmma_ss64_tt(acc[0], da0 + ((((py + 1) * WHW + 1) * 16) >> 4), db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int d = 0; d < 3; ++d) fence_regs(acc[d]);
    stage = stage + 1 == WSTAGES ? 0 : stage + 1;
  }

  // the run's sums, from the registers: acc[dx][4j + 2h + e] is input channel
  // m0 + 16 warp + lane / 4 + 8 h, output channel n0 + 8 j + 2 (lane % 4) + e
  const long long kn = (long long)a.K * a.N;
  float* base = a.part + (TAPS == 9 ? (long long)split * 9 * kn : (long long)(3 * split + wg) * kn);
  const bool pairs = (a.N & 1) == 0;
#pragma unroll
  for (int d = 0; d < (TAPS == 9 ? 3 : 1); ++d) {
    float* dst = base + (TAPS == 9 ? (long long)(3 * dy + d) * kn : 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = m0 + 16 * warp + (lane >> 2) + 8 * h;
      if (k >= a.K) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = n0 + 8 * j + 2 * (lane & 3);
        if (co >= a.N) continue;
        float* o = dst + (long long)k * a.N + co;
        const float v0 = acc[d][4 * j + 2 * h], v1 = acc[d][4 * j + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (co + 1 < a.N) o[1] = v1;
        }
      }
    }
  }
}

template <int TAPS>
cudaError_t launch_wgrad(const WgradArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(wgrad_kernel<TAPS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_WGRAD);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((a.K + WM - 1) / WM) * ((a.N + WN - 1) / WN) * a.splits;
  if (blocks > 0x7fffffffLL || blocks < 1) return cudaErrorInvalidValue;
  wgrad_kernel<TAPS><<<(unsigned)blocks, WNT, SMEM_WGRAD, s>>>(a);
  return cudaGetLastError();
}

// out[n] = Σ_{p < P} part[p*ld + n], summed in order p = 0, 1, ...
__global__ void colsum_kernel(const float* __restrict__ part, int P, long long N, long long ld,
                              float* __restrict__ out) {
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += (long long)gridDim.x * blockDim.x) {
    float z = 0.f;
    for (int p = 0; p < P; ++p) z += part[(long long)p * ld + n];
    out[n] = z;
  }
}

}  // namespace

extern "C" {

// GroupNorm(+FiLM)+SiLU(+dropout) backward over one sample per block.
// mode 0 reduce (h: the activation, bf16 [B,HW,C], or null), 1 apply;
// stage 2: src = h2 f32 with FiLM (fs, fsh) and dropout (rate > 0);
// stage 1: src = x bf16, no FiLM, no dropout.
int sgdm_gn_bwd(int mode, int stage, const float* u, const void* src, const float* mean,
                const float* rstd, const float* gamma, const float* beta, const float* fs,
                const float* fsh, const void* g, const float* add, float* coef, float* dfs,
                float* dfsh, float* part, int part_ld, int off_g, int off_b, int off_c,
                void* out, void* h, int B, int HW, int C, int G, float rate, int seed,
                void* stream) {
  RowArgs a;
  a.u = u; a.src = src; a.mean = mean; a.rstd = rstd; a.gamma = gamma; a.beta = beta;
  a.fs = fs; a.fsh = fsh; a.g = static_cast<const bf16*>(g); a.add = add; a.coef = coef;
  a.dfs = dfs; a.dfsh = dfsh; a.part = part; a.part_ld = part_ld; a.off_g = off_g;
  a.off_b = off_b; a.off_c = off_c; a.out = static_cast<bf16*>(out);
  a.h = static_cast<bf16*>(h);
  a.HW = HW; a.C = C; a.G = G; a.rate = rate;
  a.inv_keep = (float)(1.0 / (1.0 - (double)rate));
  a.seed = (uint32_t)seed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage == 2 && mode == 0) return (int)launch_row<float, true, 0>(a, B, s);
  if (stage == 2 && mode == 1) return (int)launch_row<float, true, 1>(a, B, s);
  if (stage == 1 && mode == 0 && rate == 0.f) return (int)launch_row<bf16, false, 0>(a, B, s);
  if (stage == 1 && mode == 1 && rate == 0.f) return (int)launch_row<bf16, false, 1>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// out f32 [B,H,W,Co] = conv3x3(src bf16 [B,H,W,Ci], w bf16 [9,Ci,Co8]) +
// x bf16 [B,H,W,Cx] @ wskip bf16 [Cx,Co8] (conv_core.cuh KIND 0; Ci = 0 or
// Cx = 0 leaves that product out).  Co8: Co rounded up to a multiple of 8,
// the columns beyond Co zero.
int sgdm_dgrad(const void* src, const void* w, int ci, const void* x, const void* wskip, int cx,
               float* out, int B, int H, int W, int Co, void* stream) {
  conv::ConvArgs a = {};
  a.src = src;
  a.w = static_cast<const bf16*>(w);
  a.x = static_cast<const bf16*>(x);
  a.wskip = static_cast<const bf16*>(wskip);
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.Ci = ci; a.Co = Co; a.Hs = H; a.Ws = W; a.Cx = cx;
  a.vec_a = ci % 8 == 0 && cx % 8 == 0;
  a.vec_b = Co % 8 == 0;
  if (ci + cx <= 0) return (int)cudaErrorInvalidValue;
  return (int)conv::launch_conv<0, 0, false>(a, static_cast<cudaStream_t>(stream));
}

// Weight-gradient partials (wgrad_kernel): taps 9 (3x3, part [splits][9][K][N])
// or 1 (1x1, part [3 * splits][K][N]).  act [B,H,W,lda], g [B,H,W,ldg] bf16,
// lda and ldg multiples of 8 (16-byte rows for cp.async), K <= lda, N <= ldg.
int sgdm_wgrad(int taps, const void* act, const void* g, float* part, int B, int H, int W,
               int K, int N, int lda, int ldg, int splits, void* stream) {
  WgradArgs a;
  a.act = static_cast<const bf16*>(act);
  a.g = static_cast<const bf16*>(g);
  a.part = part;
  a.B = B; a.H = H; a.W = W; a.K = K; a.N = N; a.lda = lda; a.ldg = ldg; a.splits = splits;
  if (lda % 8 != 0 || ldg % 8 != 0 || K > lda || N > ldg || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps == 9) return (int)launch_wgrad<9>(a, s);
  if (taps == 1) return (int)launch_wgrad<1>(a, s);
  return (int)cudaErrorInvalidValue;
}

// out f32 [N] = Σ_p part[p*ld + n] for p < P.
int sgdm_colsum(const float* part, int P, long long N, long long ld, float* out, void* stream) {
  const int threads = 256;
  long long blocks = (N + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  colsum_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      part, P, N, ld, out);
  return (int)cudaGetLastError();
}

// Blocks an SM holds of the weight-gradient kernel (taps 9) and of the
// data-gradient convolution, as the CUDA runtime's occupancy calculator
// counts them; -1 if it cannot say.
int sgdm_wgrad_occupancy() {
  int n = 0;
  if (cudaFuncSetAttribute(wgrad_kernel<9>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_WGRAD) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wgrad_kernel<9>, WNT, SMEM_WGRAD) !=
          cudaSuccess)
    return -1;
  return n;
}
// Dynamic shared memory a block of each takes, bytes.
int sgdm_wgrad_smem() { return (int)SMEM_WGRAD; }
int sgdm_dgrad_smem() { return (int)conv::SMEM_CONV; }
int sgdm_dgrad_occupancy() {
  int n = 0;
  if (cudaFuncSetAttribute(conv::conv_kernel<0, 0, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)conv::SMEM_CONV) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv::conv_kernel<0, 0, false>, conv::NT,
                                                    conv::SMEM_CONV) != cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
