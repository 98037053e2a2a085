// Fused ResBlock forward for Hopper (sm_90a): the port of the Pallas TPU
// kernels in sgdm_tpu/ops/pallas/resblock.py:
//   K1  _fwd_kernel, save_res=False  (identity skip or 1x1 projection skip)
//   K2  _fwd_resample_kernel         (resblock_updown: 'up' / 'down', identity skip)
//   K4  _fwd_kernel, save_res=True   (training: K1 plus dropout, keeping the
//                                     residuals the backward needs)
//
//   h1  = silu(GN1(x)*g1 + b1)                 [resampled for K2, f32 pool]
//   h2  = conv3x3(bf16(h1), W1) + c1            (f32, never rounded)
//   h3  = silu((GN2(h2)*g2 + b2)*(1+fs) + fsh) [* dropout mask, K4]
//   out = bf16(conv3x3(bf16(h3), W2) + c2 + skip(x))
//
// K4 keeps h2 (f32) and the per-channel GN mean and rstd of x and h2; it
// writes neither h1 nor h3d as the TPU kernel does, because the backward
// (resblock_bwd.cu) recomputes both pointwise: h1 from x and the GN1
// statistics, h3d from h2, the GN2 statistics, FiLM and the dropout hash.
// The TPU kernel stores h2 in the model dtype (bf16); here it stays f32, so
// the backward's GN2 recompute sees the values the forward normalised.
//
// The TPU kernel keeps one whole sample in VMEM.  One 64x64x128 bf16
// activation is 1 MiB against 227 KB of shared memory per block, so here
// the block is four launches:
//   1. gn_coef(x)    per-(sample, group) statistics of x -> per-channel
//                    (mean, scale, shift) with gamma/beta folded in;
//   2. conv (KIND 1) implicit GEMM whose A-tile prologue applies GN1+SiLU
//                    (and the nearest-up index map or the 2x2 average pool
//                    of the activated pixels); epilogue adds c1, writes h2 f32;
//   3. gn_coef(h2)   the same for GN2, with FiLM folded into scale/shift;
//   4. conv (KIND 2/3) prologue applies GN2+FiLM+SiLU; epilogue adds c2 and
//                    the skip (identity: x in f32, resampled for K2; proj:
//                    a tenth K-segment bf16(x) @ W_skip of the same GEMM).
//
// What bounds it on an H100: a convolution is 2*9*H*W*Ci*Co operations per
// sample against reading its input and writing its output once.  At the
// IN64 shapes (model batch 128) that is 158 GFLOP (0.16 ms at the bf16 peak)
// against 0.12 ms of bytes at 64x64x128 (h2 in f32), and 309 GFLOP (0.31 ms)
// against 0.02 ms at 16x16x1024->512: operations bound it.  What held the
// first version (WMMA, PR 1-4) at 25x its bound was the prologue: GN+SiLU
// (+pool, +dropout) ran on the CUDA cores for every tap and every 128-channel
// output tile, 9 x Co/128 times per input element, while the tensor cores
// waited.
//
// The convolution (conv_kernel).  A block of two warpgroups owns one
// sample's 16 x 16 output tile and 128 output channels (grid: samples x
// tiles x channel tiles, the channel tile fastest, so the blocks that share
// an input tile run together).  For each chunk of 32 input channels:
//   * the haloed 18 x 18 input tile (output-resolution coordinates) is
//     activated ONCE: GN(+FiLM)+SiLU in f32, through the nearest-up index map
//     or the 2x2 pool of the activated pixels, times the dropout mask, zero
//     outside the image, rounded to bf16 and stored as [8-channel
//     group][halo pixel][8 channels] without swizzle;
//   * the nine taps are nine windows of that one tile: the A descriptor of
//     tap (dy, dx) starts dy*18 + dx pixels in; its core matrices are 8
//     pixels of a halo row (128 contiguous bytes), its 8-row groups one halo
//     row apart (SBO) and its channel groups a plane apart (LBO).  Each
//     warpgroup's two 8 x 8 pixel units are m64n128k16 wgmma chains with f32
//     accumulators in registers (128 a thread);
//   * the chunk's weights, [tap][Ci][Co8] rows for nine taps (72 KB), come by
//     cp.async into 128-byte-swizzled MN-major tiles (two 64-channel blocks,
//     LBO apart), double-buffered: the next chunk's load runs under this
//     chunk's products; every layer's weights stay in the 50 MB L2;
//   * the next chunk's activation runs between three (six) groups of this
//     chunk's taps, its loads issued before each group and all of a group's
//     loads before its arithmetic, so the CUDA cores and the tensor cores
//     work at the same time.
// The projection skip (KIND 3) is more chunks of the same GEMM on x itself,
// one tap (the window at the tile's own pixels).  Bias, the identity skip
// (resampled for K2) and the stores of channel pairs come from the
// registers.  Budget (nvcc -Xptxas -v, chip_smoke's conv_kernel row):
// 234-255 registers a thread (up to 112 bytes of spill in the KIND 3 and
// 2x2-pool instances), 186 KB of shared memory, one block an SM.
//
// Traps kept from the TPU kernel:
//   * Zero padding is in h1 space, not x space: an out-of-image tap loads
//     0, not silu(GN(0)).  The same for h3 before conv2, and for K2 after
//     the resample (the halo is in output-resolution coordinates).
//   * Tap order: w[tap = dy*3 + dx][Cin][Cout] with dy on H is flax HWIO
//     cross-correlation.
//   * Rounding points: FiLM and SiLU in f32, bf16 only at the conv inputs
//     and at the output; h2 stays f32 so GN2 sees unrounded values; K2
//     pools the activated h1 in f32 and rounds after.  The SiLU here is
//     silu_fast (__expf, __fdividef: a few f32 ulps from the IEEE one),
//     while K5 (resblock_bwd.cu) recomputes h1 and h3d with the IEEE SiLU
//     of common.cuh: the two differ far below the bf16 rounding of h1 and
//     h3 that follows (2^-9), flipping at most a last bf16 bit of a conv
//     input, which chip_smoke's K4 and K5 rows (K5 on K4's residuals) hold
//     within RESBLOCK_TOL and K5_TOL.
//
// C interface (ctypes): every function returns cudaGetLastError() after
// its launch, and launches on the stream it is given.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using sgdm::dropout_scale;
using sgdm::load8;
using sgdm::pack8;

// ------------------------------------------------------------ GN statistics
// One block per sample.  Thread t owns channel chunk j = t % CV (V channels)
// and pixel rows r, r+R, ...; partial sums go to shared memory and are
// reduced in a fixed order (deterministic, no atomics).
// coef[b][0][c] = mean of c's group, coef[b][1][c] = scale, coef[b][2][c] =
// shift, so that GN(v)*g+b (then FiLM) = (v - mean)*scale + shift.  With
// rstd_out non-null, rstd_out[b][c] = 1/sqrt(var + eps) of c's group (K4).
template <typename T, int V>
__global__ void gn_coef_kernel(const T* __restrict__ x, int HW, int C, int G, float eps,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               const float* __restrict__ fs, const float* __restrict__ fsh,
                               float* __restrict__ coef, float* __restrict__ rstd_out) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int CV = C / V;
  const int R = blockDim.x / CV;
  const int t = threadIdx.x;
  const int j = t % CV, r = t / CV;
  float s[V], q[V];
#pragma unroll
  for (int v = 0; v < V; ++v) { s[v] = 0.f; q[v] = 0.f; }
  if (r < R) {
    const T* xb = x + (size_t)b * HW * C + j * V;
    for (int p = r; p < HW; p += R) {
      float vals[8];
      if (V == 8) {
        load8(xb + (size_t)p * C, 8, true, vals);
      } else {
        vals[0] = static_cast<float>(xb[(size_t)p * C]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) { s[v] += vals[v]; q[v] += vals[v] * vals[v]; }
    }
  }
  float* ps = sm;
  float* pq = sm + R * C;
  float* cs = sm + 2 * R * C;
  float* cq = cs + C;
  if (r < R) {
#pragma unroll
    for (int v = 0; v < V; ++v) { ps[r * C + j * V + v] = s[v]; pq[r * C + j * V + v] = q[v]; }
  }
  __syncthreads();
  for (int c = t; c < C; c += blockDim.x) {
    float a = 0.f, aq = 0.f;
    for (int rr = 0; rr < R; ++rr) { a += ps[rr * C + c]; aq += pq[rr * C + c]; }
    cs[c] = a;
    cq[c] = aq;
  }
  __syncthreads();
  const int gs = C / G;
  const float n = (float)HW * (float)gs;
  for (int c = t; c < C; c += blockDim.x) {
    const int g0 = (c / gs) * gs;
    float a = 0.f, aq = 0.f;
    for (int i = 0; i < gs; ++i) { a += cs[g0 + i]; aq += cq[g0 + i]; }
    const float mean = a / n;
    const float var = aq / n - mean * mean;
    const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
    float sc = rstd * gamma[c];
    float sh = beta[c];
    if (fs != nullptr) {
      const float f = 1.0f + fs[(size_t)b * C + c];
      sc *= f;
      sh = sh * f + fsh[(size_t)b * C + c];
    }
    coef[((size_t)b * 3 + 0) * C + c] = mean;
    coef[((size_t)b * 3 + 1) * C + c] = sc;
    coef[((size_t)b * 3 + 2) * C + c] = sh;
    if (rstd_out != nullptr) rstd_out[(size_t)b * C + c] = rstd;
  }
}

// ----------------------------------------------------------- the convolution
// Implicit GEMM on wgmma, one block per (sample, 16x16 output tile, 128
// output channels); see the file's header for the design and its reasons.
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

__device__ __forceinline__ float silu_fast(float z) { return __fdividef(z, 1.0f + __expf(-z)); }

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
  const void* src;     // KIND 1: x bf16 [B,Hs,Ws,Ci]; KIND 2/3: h2 f32 [B,H,W,Ci]
  const float* coef;   // [B,3,Ci]: mean, scale, shift
  const bf16* w;       // [9,Ci,Co8]: taps dy*3+dx, output channels padded to Co8 with zeros
  const float* bias;   // [Co]
  const bf16* x;       // KIND 2: [B,Hs,Ws,Co]; KIND 3: [B,H,W,Cx]
  const bf16* wskip;   // KIND 3: [Cx,Co8]
  void* out;           // KIND 1: f32 [B,H,W,Co]; KIND 2/3: bf16 [B,H,W,Co]
  int B, H, W, Ci, Co, Hs, Ws, Cx;
  int vec_a, vec_b;    // Ci (and Cx) % 8 == 0; Co % 8 == 0
  float rate, inv_keep;  // DROP: dropout rate and 1/(1-rate)
  uint32_t seed;         // DROP: the block's dropout seed (sample b hashes seed + b)
};

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
  const int NCH = KC + (KIND == 3 ? (a.Cx + CK - 1) / CK : 0);
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
  if constexpr (KIND == 3)
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
        float v0 = acc[u][4 * jj + 2 * h] + a.bias[co];
        float v1 = pair ? acc[u][4 * jj + 2 * h + 1] + a.bias[co + 1] : 0.f;
        if (KIND == 1) {
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

}  // namespace

extern "C" {

// Per-channel (mean, scale, shift) of GroupNorm over x [B, HW, C] (bf16 when
// x_is_f32 == 0, else f32), groups G, with gamma/beta and optional FiLM
// (fs, fsh f32 [B, C]; null for none) folded in.  coef: f32 [B, 3, C];
// rstd: f32 [B, C] per-channel 1/sqrt(var + eps), or null.
int sgdm_gn_coef(const void* x, int x_is_f32, int B, int HW, int C, int G, float eps,
                 const float* gamma, const float* beta, const float* fs, const float* fsh,
                 float* coef, float* rstd, void* stream) {
  const int threads = 512;
  const bool vec = C % 8 == 0;
  const int CV = vec ? C / 8 : C;
  if (CV > threads || C % G != 0) return (int)cudaErrorInvalidValue;
  const int R = threads / CV;
  const size_t smem = (size_t)(2 * R * C + 2 * C) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32) {
    if (vec) gn_coef_kernel<float, 8><<<B, threads, smem, s>>>(static_cast<const float*>(x), HW, C, G, eps, gamma, beta, fs, fsh, coef, rstd);
    else gn_coef_kernel<float, 1><<<B, threads, smem, s>>>(static_cast<const float*>(x), HW, C, G, eps, gamma, beta, fs, fsh, coef, rstd);
  } else {
    if (vec) gn_coef_kernel<bf16, 8><<<B, threads, smem, s>>>(static_cast<const bf16*>(x), HW, C, G, eps, gamma, beta, fs, fsh, coef, rstd);
    else gn_coef_kernel<bf16, 1><<<B, threads, smem, s>>>(static_cast<const bf16*>(x), HW, C, G, eps, gamma, beta, fs, fsh, coef, rstd);
  }
  return (int)cudaGetLastError();
}

// kind 1: conv1 (src = x bf16 at Hs x Ws, resample rs: 0 none, 1 up, 2 down;
//         out = h2 f32 at H x W).
// kind 2: conv2 + identity skip (src = h2 f32, x bf16 at Hs x Ws resampled
//         by rs; out bf16).
// kind 3: conv2 + projection skip (x bf16 [B,H,W,Cx], wskip [Cx,Co8]; rs 0).
// w: bf16 [9,Ci,Co8], Co8 = Co rounded up to a multiple of 8, the columns
// beyond Co zero.  rate > 0 (kind 2/3, rs 0): dropout on h3 with the block
// seed `seed`.
int sgdm_resblock_conv(int kind, int rs, const void* src, const float* coef, const void* w,
                       const float* bias, const void* x, const void* wskip, void* out,
                       int B, int H, int W, int Ci, int Co, int Hs, int Ws, int Cx,
                       float rate, int seed, void* stream) {
  ConvArgs a;
  a.src = src;
  a.coef = coef;
  a.w = static_cast<const bf16*>(w);
  a.bias = bias;
  a.x = static_cast<const bf16*>(x);
  a.wskip = static_cast<const bf16*>(wskip);
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.Ci = Ci; a.Co = Co; a.Hs = Hs; a.Ws = Ws; a.Cx = Cx;
  a.vec_a = (Ci % 8 == 0) && (kind != 3 || Cx % 8 == 0);
  a.vec_b = Co % 8 == 0;
  a.rate = rate;
  a.inv_keep = (float)(1.0 / (1.0 - (double)rate));
  a.seed = (uint32_t)seed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rate > 0.0f) {
    if (rs != 0 || kind == 1) return (int)cudaErrorInvalidValue;
    if (kind == 2) return (int)launch_conv<2, 0, true>(a, s);
    if (kind == 3) return (int)launch_conv<3, 0, true>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  if (kind == 1 && rs == 0) return (int)launch_conv<1, 0, false>(a, s);
  if (kind == 1 && rs == 1) return (int)launch_conv<1, 1, false>(a, s);
  if (kind == 1 && rs == 2) return (int)launch_conv<1, 2, false>(a, s);
  if (kind == 2 && rs == 0) return (int)launch_conv<2, 0, false>(a, s);
  if (kind == 2 && rs == 1) return (int)launch_conv<2, 1, false>(a, s);
  if (kind == 2 && rs == 2) return (int)launch_conv<2, 2, false>(a, s);
  if (kind == 3 && rs == 0) return (int)launch_conv<3, 0, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the convolution kernel an SM holds (every KIND, RS and DROP
// instance has the same shared memory and launch bounds; KIND 2's is asked).
int sgdm_resblock_conv_occupancy() {
  int n = 0;
  if (cudaFuncSetAttribute(conv_kernel<2, 0, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_CONV) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_kernel<2, 0, false>, NT,
                                                    SMEM_CONV) != cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
