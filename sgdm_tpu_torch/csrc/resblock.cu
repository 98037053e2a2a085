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
// What bounds it on an H100: the two convolutions are ~2*9*HW*Cin*Cout
// FLOP each per sample, well above the bf16 ridge point, so the block is
// bound by tensor-core operations.  This first version runs the GEMMs on
// WMMA bf16 16x16x16 tiles (mma.sync) with a register-staged double buffer
// in shared memory; the GN/SiLU prologue runs on the CUDA cores inside the
// tile load, so h1 and h3 never go to device memory.  wgmma/TMA pipelines
// are later work.
//
// Traps kept from the TPU kernel:
//   * Zero padding is in h1 space, not x space: an out-of-image tap loads
//     0, not silu(GN(0)).  The same for h3 before conv2, and for K2 after
//     the resample (the halo is in output-resolution coordinates).
//   * Tap order: w[tap = dy*3 + dx][Cin][Cout] with dy on H is flax HWIO
//     cross-correlation.
//   * Rounding points: FiLM and SiLU in f32, bf16 only at the conv inputs
//     and at the output; h2 stays f32 so GN2 sees unrounded values; K2
//     pools the activated h1 in f32 and rounds after.
//
// C interface (ctypes): every function returns cudaGetLastError() after
// its launch, and launches on the stream it is given.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

using sgdm::dropout_scale;
using sgdm::load8;
using sgdm::pack8;
using sgdm::silu;

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

// ----------------------------------------------------------- the conv GEMM
constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int LDA = BK + 8;  // bf16 elements; +8 staggers banks
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 epilogue staging
constexpr int SMEM_PIPE = (2 * BM * LDA + 2 * BK * LDB) * 2;
constexpr int SMEM_EPI = BM * LDC * 4;
constexpr int SMEM_CONV = SMEM_PIPE > SMEM_EPI ? SMEM_PIPE : SMEM_EPI;

struct ConvArgs {
  const void* src;     // KIND 1: x bf16 [B,Hs,Ws,Ci]; KIND 2/3: h2 f32 [B,H,W,Ci]
  const float* coef;   // [B,3,Ci]
  const bf16* w;       // [9,Ci,Co]
  const float* bias;   // [Co]
  const bf16* x;       // KIND 2: [B,Hs,Ws,Co]; KIND 3: [B,H,W,Cx]
  const bf16* wskip;   // KIND 3: [Cx,Co]
  void* out;           // KIND 1: f32 [B,H,W,Co]; KIND 2/3: bf16 [B,H,W,Co]
  int B, H, W, Ci, Co, Hs, Ws, Cx;
  int vec_a, vec_b;    // Ci (and Cx) % 8 == 0; Co % 8 == 0
  float rate, inv_keep;  // DROP: dropout rate and 1/(1-rate)
  uint32_t seed;         // DROP: the block's dropout seed (sample b hashes seed + b)
};

// KIND 1: conv1, A = act(x) resampled by RS (0 none, 1 up, 2 down).
// KIND 2: conv2 with identity skip, x resampled by RS.
// KIND 3: conv2 with the 1x1 projection skip (RS = 0).
// DROP (KIND 2/3): the conv2 prologue multiplies h3 by the dropout mask (K4).
template <int KIND, int RS, bool DROP>
__global__ void __launch_bounds__(NT) conv_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int HWo = a.H * a.W;
  const int M = a.B * HWo;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the two A chunks (8 channels each) this thread loads at every k-step
  int pb[2], py[2], px[2];
  bool pv[2];
  const int kq = (tid & 3) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + (tid >> 2) + i * 64;
    pv[i] = gm < M;
    const int g = pv[i] ? gm : 0;
    pb[i] = g / HWo;
    const int rem = g - pb[i] * HWo;
    py[i] = rem / a.W;
    px[i] = rem - py[i] * a.W;
  }

  const int KC = (a.Ci + BK - 1) / BK;
  const int KS = KIND == 3 ? (a.Cx + BK - 1) / BK : 0;
  const int S = 9 * KC + KS;

  uint4 ra[2], rb[2];

  auto fetch = [&](int s) {
    int tap, c0;
    if (s < 9 * KC) { tap = s / KC; c0 = (s - tap * KC) * BK; }
    else { tap = 9; c0 = (s - 9 * KC) * BK; }
    // ---- A: activated (and resampled) conv input, zero outside the image
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      const int c = c0 + kq;
      if (tap == 9) {
        const int nv = a.Cx - c;
        if (pv[i] && nv > 0) {
          const bf16* p = a.x + (((size_t)pb[i] * a.H + py[i]) * a.W + px[i]) * a.Cx + c;
          load8(p, nv, a.vec_a, v);
        }
      } else {
        const int sy = py[i] + tap / 3 - 1, sx = px[i] + tap % 3 - 1;
        const int nv = a.Ci - c;
        if (pv[i] && nv > 0 && sy >= 0 && sy < a.H && sx >= 0 && sx < a.W) {
          float mean[8], sc[8], sh[8];
          const float* cf = a.coef + (size_t)pb[i] * 3 * a.Ci + c;
          load8(cf, nv, a.vec_a, mean);
          load8(cf + a.Ci, nv, a.vec_a, sc);
          load8(cf + 2 * a.Ci, nv, a.vec_a, sh);
          if (KIND == 1) {
            const bf16* xs = static_cast<const bf16*>(a.src);
            if (RS == 2) {
#pragma unroll
              for (int dy = 0; dy < 2; ++dy)
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                  float t[8];
                  const bf16* p = xs + (((size_t)pb[i] * a.Hs + 2 * sy + dy) * a.Ws + 2 * sx + dx) * a.Ci + c;
                  load8(p, nv, a.vec_a, t);
#pragma unroll
                  for (int e = 0; e < 8; ++e) v[e] += silu((t[e] - mean[e]) * sc[e] + sh[e]);
                }
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] *= 0.25f;
            } else {
              const int yy = RS == 1 ? sy >> 1 : sy, xx = RS == 1 ? sx >> 1 : sx;
              const bf16* p = xs + (((size_t)pb[i] * a.Hs + yy) * a.Ws + xx) * a.Ci + c;
              load8(p, nv, a.vec_a, v);
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = silu((v[e] - mean[e]) * sc[e] + sh[e]);
            }
          } else {
            const float* hs = static_cast<const float*>(a.src);
            const float* p = hs + (((size_t)pb[i] * a.H + sy) * a.W + sx) * a.Ci + c;
            load8(p, nv, a.vec_a, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = silu((v[e] - mean[e]) * sc[e] + sh[e]);
            if (DROP) {
              const uint32_t pix = (uint32_t)(sy * a.W + sx), s = a.seed + (uint32_t)pb[i];
#pragma unroll
              for (int e = 0; e < 8; ++e)
                v[e] *= dropout_scale(pix, (uint32_t)(c + e), (uint32_t)a.Ci, s, a.rate,
                                      a.inv_keep);
            }
          }
          if (!a.vec_a) {
#pragma unroll
            for (int e = 0; e < 8; ++e) if (e >= nv) v[e] = 0.f;
          }
        }
      }
      ra[i] = pack8(v);
    }
    // ---- B: weights [tap][ci][co]
    const int krows = tap == 9 ? a.Cx : a.Ci;
    const bf16* wb = tap == 9 ? a.wskip : a.w + (size_t)tap * a.Ci * a.Co;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * NT;
      const int kr = q >> 4, n8 = (q & 15) * 8;
      const int ci = c0 + kr, co = n0 + n8;
      float v[8];
      const int nv = a.Co - co;
      if (ci < krows && nv > 0) {
        load8(wb + (size_t)ci * a.Co + co, nv, a.vec_b, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      rb[i] = pack8(v);
    }
  };

  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = (tid >> 2) + i * 64;
      *reinterpret_cast<uint4*>(As + (size_t)buf * BM * LDA + m * LDA + kq) = ra[i];
      const int q = tid + i * NT;
      *reinterpret_cast<uint4*>(Bs + (size_t)buf * BK * LDB + (q >> 4) * LDB + (q & 15) * 8) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const int buf = s & 1;
    if (s + 1 < S) fetch(s + 1);
    const bf16* Ab = As + (size_t)buf * BM * LDA;
    const bf16* Bb = Bs + (size_t)buf * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], Ab + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], Bb + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (s + 1 < S) stash(buf ^ 1);
    __syncthreads();
  }

  // ---- epilogue: stage the f32 tile, then bias (+ skip) and a coalesced store
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int m = idx / BN, n = idx - m * BN;
    const int gm = m0 + m, co = n0 + n;
    if (gm >= M || co >= a.Co) continue;
    float val = Cs[m * LDC + n] + a.bias[co];
    if (KIND == 1) {
      static_cast<float*>(a.out)[(size_t)gm * a.Co + co] = val;
    } else {
      if (KIND == 2) {
        const int b = gm / HWo, rem = gm - b * HWo;
        const int y = rem / a.W, xq = rem - y * a.W;
        if (RS == 2) {
          float sk = 0.f;
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              sk += __bfloat162float(a.x[(((size_t)b * a.Hs + 2 * y + dy) * a.Ws + 2 * xq + dx) * a.Co + co]);
          val += sk * 0.25f;
        } else {
          const int yy = RS == 1 ? y >> 1 : y, xx = RS == 1 ? xq >> 1 : xq;
          val += __bfloat162float(a.x[(((size_t)b * a.Hs + yy) * a.Ws + xx) * a.Co + co]);
        }
      }
      static_cast<bf16*>(a.out)[(size_t)gm * a.Co + co] = __float2bfloat16_rn(val);
    }
  }
}

template <int KIND, int RS, bool DROP>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  // set on every launch: the attribute is per device, and a process may use several
  cudaError_t e = cudaFuncSetAttribute(conv_kernel<KIND, RS, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CONV);
  if (e != cudaSuccess) return e;
  const long long M = (long long)a.B * a.H * a.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.Co + BN - 1) / BN));
  conv_kernel<KIND, RS, DROP><<<grid, NT, SMEM_CONV, stream>>>(a);
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
// kind 3: conv2 + projection skip (x bf16 [B,H,W,Cx], wskip [Cx,Co]; rs 0).
// rate > 0 (kind 2/3, rs 0): dropout on h3 with the block seed `seed`.
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

}  // extern "C"
