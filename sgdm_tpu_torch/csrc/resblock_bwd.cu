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
// (deterministic; a kernels-on vs kernels-off comparison is stable).
// One call is these launches:
//   1. dgrad(g, W2 flipped)      dh3d = conv3x3ᵀ(g)                f32
//   2. gn_bwd<reduce>, GN2       per (sample, channel): S1 = Σ dpre3,
//                                S2 = Σ dpre3·xhat2, Σ g; from them dfs,
//                                dfsh, the dgamma2/dbeta2/dc2 partials and
//                                the coefficients of dh2 = k1·dpre3 + k0 +
//                                kx·xhat2 (the GN backward's group means)
//   3. gn_bwd<apply>, GN2        dh2 -> bf16, and the dc1 partials
//   4. dgrad(dh2, W1 flipped)    dh1                               f32
//   5. dgrad 1x1 (proj skip)     g @ W_skipᵀ                       f32
//   6. gn_bwd<reduce>, GN1       dgamma1/dbeta1 partials, coefficients of dx
//   7. gn_bwd<apply>, GN1        dx = GN1ᵀ(dh1) + skip'(g)          bf16
//   8. wgrad(h3d, g)             dW2 partials  (h3d recomputed: GN2 + FiLM
//                                + SiLU + the dropout hash on h2, bf16)
//   9. wgrad(h1, dh2)            dW1 partials  (h1 recomputed: GN1 + SiLU on x)
//  10. wgrad(x, g) 1x1           dW_skip partials (proj skip)
//  11. colsum over the weight partials, 12. colsum over the per-sample ones.
// dropout: dpre3 takes dh3d * mask with the mask regenerated from the same
// counter hash as the forward (common.cuh dropout_scale).
//
// Rounding points are _bwd_kernel's: g enters the dgrad and wgrad products
// as bf16 (it is the bf16 cotangent), dh2 is rounded to bf16 before the
// conv1 dgrad (resblock.py:323).  One difference: the conv1 weight
// gradient also takes the bf16 dh2 (the TPU kernel takes it in f32), so
// all four gradient convolutions run on bf16 tensor cores.
//
// What bounds it on an H100: the four gradient convolutions are twice the
// forward's tensor-core operations (2·2·9·HW·Cin·Cout·B per conv pair),
// well above the bf16 ridge point, so the call is bound by operations.  The
// GEMMs here are the forward's WMMA design (128x128x32 tiles, register-
// staged double buffer); the weight-gradient GEMMs reduce over B·H·W pixels
// and split that reduction over blockIdx.z to fill the card.  The GN/SiLU/
// FiLM/dropout recompute of h1 and h3d runs in the A-tile prologue, so
// neither reaches device memory.
//
// C interface (ctypes): every function returns cudaGetLastError() after
// its launch, and launches on the stream it is given.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

using sgdm::dropout_scale;
using sgdm::dsilu;
using sgdm::load8;
using sgdm::pack8;
using sgdm::silu;

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
// Per element: xhat = (s - mean)*rstd, pre = xhat*gamma + beta (FILM: then
// pre*(1+fs) + fsh), dpre = u * mask * silu'(pre).
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
  int part_ld, off_g, off_b, off_c;  // column offsets (off_c < 0: none)
  bf16* out;            // apply: [B,HW,C]
  int HW, C, G;
  float rate, inv_keep;
  uint32_t seed;
};

constexpr int ROW_THREADS = 512;

// MODE 0 (reduce): S1 = Σ_p dpre, S2 = Σ_p dpre·xhat (and S3 = Σ_p g); writes
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
    float mean[V], rstd[V], gam[V], bet[V], f[V], fsh[V], k1[V], k0[V], kx[V];
    loadv<V>(a.mean + bc, mean);
    loadv<V>(a.rstd + bc, rstd);
    loadv<V>(a.gamma + c0, gam);
    loadv<V>(a.beta + c0, bet);
    if (FILM) {
      loadv<V>(a.fs + bc, f);
      loadv<V>(a.fsh + bc, fsh);
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] += 1.0f;
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
      float u[V], sv[V], gv[V], dv[V];
      loadv<V>(a.u + off, u);
      loadv<V>(src + off, sv);
      if (a.g != nullptr) loadv<V>(a.g + off, gv);
      if (MODE == 1 && a.add != nullptr) loadv<V>(a.add + off, dv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xhat = (sv[v] - mean[v]) * rstd[v];
        float pre = xhat * gam[v] + bet[v];
        if (FILM) pre = pre * f[v] + fsh[v];
        float du = u[v];
        if (a.rate > 0.f)
          du *= dropout_scale((uint32_t)p, (uint32_t)(c0 + v), (uint32_t)C, s, a.rate, a.inv_keep);
        const float dpre = du * dsilu(pre);
        if (MODE == 0) {
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

// ------------------------------------------------------------- the GEMMs
constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int LDB = BN + 8;   // bf16 [k][n] tiles
constexpr int LDC = BN + 4;   // f32 epilogue staging
constexpr int SMEM_EPI = BM * LDC * 4;

// dgrad: out[m][n] = Σ_tap Σ_k A[shift_tap(m)][k] · Wt[tap][k][n], A bf16
// [B,H,W,K] zero outside the image, Wt bf16 [TAPS][K][N], out f32 [B*H*W, N].
// TAPS 9 is a 3x3 conv (Wt = the flipped taps), TAPS 1 a 1x1 product.
constexpr int LDA = BK + 8;   // bf16 [m][k] tiles
constexpr int SMEM_DG_PIPE = (2 * BM * LDA + 2 * BK * LDB) * 2;
constexpr int SMEM_DG = SMEM_DG_PIPE > SMEM_EPI ? SMEM_DG_PIPE : SMEM_EPI;

struct DgradArgs {
  const bf16* a;
  const bf16* w;
  float* out;
  int B, H, W, K, N;
  int vec_a, vec_b;
};

template <int TAPS>
__global__ void __launch_bounds__(NT) dgrad_kernel(DgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int HW = a.H * a.W;
  const long long M = (long long)a.B * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int pb[2], py[2], px[2];
  bool pv[2];
  const int kq = (tid & 3) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long gm = m0 + (tid >> 2) + i * 64;
    pv[i] = gm < M;
    const long long g = pv[i] ? gm : 0;
    pb[i] = (int)(g / HW);
    const int rem = (int)(g - (long long)pb[i] * HW);
    py[i] = rem / a.W;
    px[i] = rem - py[i] * a.W;
  }
  const int KC = (a.K + BK - 1) / BK;
  const int S = TAPS * KC;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 ra[2], rb[2];

  auto fetch = [&](int s) {
    const int tap = s / KC, c0 = (s - tap * KC) * BK;
    const int dy = TAPS == 9 ? tap / 3 - 1 : 0, dx = TAPS == 9 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i] = zero;
      const int c = c0 + kq, sy = py[i] + dy, sx = px[i] + dx;
      const int nv = a.K - c;
      if (pv[i] && nv > 0 && sy >= 0 && sy < a.H && sx >= 0 && sx < a.W) {
        const bf16* p = a.a + (((size_t)pb[i] * a.H + sy) * a.W + sx) * a.K + c;
        if (a.vec_a && nv >= 8) {
          ra[i] = *reinterpret_cast<const uint4*>(p);
        } else {
          float v[8];
          load8(p, nv, false, v);
          ra[i] = pack8(v);
        }
      }
    }
    const bf16* wb = a.w + (size_t)tap * a.K * a.N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * NT;
      const int ci = c0 + (q >> 4), co = n0 + (q & 15) * 8;
      const int nv = a.N - co;
      rb[i] = zero;
      if (ci < a.K && nv > 0) {
        const bf16* p = wb + (size_t)ci * a.N + co;
        if (a.vec_b && nv >= 8) {
          rb[i] = *reinterpret_cast<const uint4*>(p);
        } else {
          float v[8];
          load8(p, nv, false, v);
          rb[i] = pack8(v);
        }
      }
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
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int m = idx / BN, n = idx - m * BN;
    const long long gm = m0 + m;
    const int co = n0 + n;
    if (gm < M && co < a.N) a.out[gm * a.N + co] = Cs[m * LDC + n];
  }
}

// wgrad: part[split][off + tap*K*N + k*N + n] = Σ_{m in split} act(A)[shift_tap(m)][k] · G[m][n]
// over the pixels m = (b, y, x) of the split, A zero outside the image.
//   AKIND 0: A = x bf16 as it is (1x1 projection skip);
//   AKIND 1: A = bf16(silu(GN1(x)·g1 + b1)) = h1, from x bf16;
//   AKIND 2: A = bf16(silu((GN2(h2)·g2 + b2)(1+fs) + fsh) · mask) = h3d, from h2 f32.
// The A tile is stored [m][k] and read as a column-major (k x m) operand.
constexpr int LDAW = BM + 8;  // bf16 [m][k] tiles of the wgrad A operand
constexpr int SMEM_WG_PIPE = (2 * BK * LDAW + 2 * BK * LDB) * 2;
constexpr int SMEM_WG = SMEM_WG_PIPE > SMEM_EPI ? SMEM_WG_PIPE : SMEM_EPI;

struct WgradArgs {
  const void* src;
  const bf16* g;                  // [B*H*W, N]
  const float *mean, *rstd;       // [B,K]
  const float *gamma, *beta;      // [K]
  const float *fs, *fsh;          // [B,K] (AKIND 2)
  float* part;
  long long part_ld, off;
  int B, H, W, K, N, mchunk;
  int vec_a, vec_b;
  float rate, inv_keep;
  uint32_t seed;
};

template <int AKIND, int TAPS>
__global__ void __launch_bounds__(NT) wgrad_kernel(WgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * BK * LDAW;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int HW = a.H * a.W;
  const long long M = (long long)a.B * HW;
  const int i0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tap = blockIdx.z % TAPS, split = blockIdx.z / TAPS;
  const int dy = TAPS == 9 ? tap / 3 - 1 : 0, dx = TAPS == 9 ? tap % 3 - 1 : 0;
  const long long mb = (long long)split * a.mchunk;
  const long long me = mb + a.mchunk < M ? mb + a.mchunk : M;
  const int S = me > mb ? (int)((me - mb + BK - 1) / BK) : 0;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 ra[2], rb[2];

  auto fetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * NT;
      const int mm = q >> 4, ch = (q & 15) * 8;
      const long long m = mb + (long long)s * BK + mm;
      ra[i] = zero;
      rb[i] = zero;
      if (m >= me) continue;
      const int b = (int)(m / HW);
      const int rem = (int)(m - (long long)b * HW);
      const int y = rem / a.W, x = rem - (rem / a.W) * a.W;
      // B: G at the unshifted pixel
      const int n = n0 + ch, nvn = a.N - n;
      if (nvn > 0) {
        const bf16* p = a.g + m * a.N + n;
        if (a.vec_b && nvn >= 8) {
          rb[i] = *reinterpret_cast<const uint4*>(p);
        } else {
          float v[8];
          load8(p, nvn, false, v);
          rb[i] = pack8(v);
        }
      }
      // A: the activated conv input at the shifted pixel
      const int sy = y + dy, sx = x + dx, c = i0 + ch, nv = a.K - c;
      if (nv <= 0 || sy < 0 || sy >= a.H || sx < 0 || sx >= a.W) continue;
      const size_t off = (((size_t)b * a.H + sy) * a.W + sx) * a.K + c;
      if (AKIND == 0) {
        const bf16* p = static_cast<const bf16*>(a.src) + off;
        if (a.vec_a && nv >= 8) {
          ra[i] = *reinterpret_cast<const uint4*>(p);
        } else {
          float v[8];
          load8(p, nv, false, v);
          ra[i] = pack8(v);
        }
        continue;
      }
      float v[8], mean[8], rstd[8], gam[8], bet[8];
      const size_t bk = (size_t)b * a.K + c;
      load8(a.mean + bk, nv, a.vec_a, mean);
      load8(a.rstd + bk, nv, a.vec_a, rstd);
      load8(a.gamma + c, nv, a.vec_a, gam);
      load8(a.beta + c, nv, a.vec_a, bet);
      if (AKIND == 1) {
        load8(static_cast<const bf16*>(a.src) + off, nv, a.vec_a, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = silu((v[e] - mean[e]) * (rstd[e] * gam[e]) + bet[e]);
      } else {
        float fs[8], fsh[8];
        load8(a.fs + bk, nv, a.vec_a, fs);
        load8(a.fsh + bk, nv, a.vec_a, fsh);
        load8(static_cast<const float*>(a.src) + off, nv, a.vec_a, v);
        const uint32_t pix = (uint32_t)(sy * a.W + sx), sd = a.seed + (uint32_t)b;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          // the forward's folded coefficients (gn_coef in resblock.cu)
          const float f = 1.0f + fs[e];
          const float sc = rstd[e] * gam[e] * f;
          const float sh = bet[e] * f + fsh[e];
          v[e] = silu((v[e] - mean[e]) * sc + sh);
          if (a.rate > 0.f)
            v[e] *= dropout_scale(pix, (uint32_t)(c + e), (uint32_t)a.K, sd, a.rate, a.inv_keep);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) if (e >= nv) v[e] = 0.f;
      ra[i] = pack8(v);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * NT;
      const int mm = q >> 4, ch = (q & 15) * 8;
      *reinterpret_cast<uint4*>(As + (size_t)buf * BK * LDAW + mm * LDAW + ch) = ra[i];
      *reinterpret_cast<uint4*>(Bs + (size_t)buf * BK * LDB + mm * LDB + ch) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (S > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const int buf = s & 1;
    if (s + 1 < S) fetch(s + 1);
    const bf16* Ab = As + (size_t)buf * BK * LDAW;
    const bf16* Bb = Bs + (size_t)buf * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], Ab + kk * LDAW + wm * 32 + i * 16, LDAW);
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
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  float* dst = a.part + (long long)split * a.part_ld + a.off + (long long)tap * a.K * a.N;
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int m = idx / BN, n = idx - m * BN;
    const int k = i0 + m, co = n0 + n;
    if (k < a.K && co < a.N) dst[(size_t)k * a.N + co] = Cs[m * LDC + n];
  }
}

template <typename F>
cudaError_t launch_gemm(F kernel, dim3 grid, int smem, const void* args, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  void* params[] = {const_cast<void*>(args)};
  return cudaLaunchKernel((const void*)kernel, grid, dim3(NT), params, smem, s);
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
// mode 0 reduce, 1 apply; stage 2: src = h2 f32 with FiLM (fs, fsh) and
// dropout (rate > 0); stage 1: src = x bf16, no FiLM, no dropout.
int sgdm_gn_bwd(int mode, int stage, const float* u, const void* src, const float* mean,
                const float* rstd, const float* gamma, const float* beta, const float* fs,
                const float* fsh, const void* g, const float* add, float* coef, float* dfs,
                float* dfsh, float* part, int part_ld, int off_g, int off_b, int off_c,
                void* out, int B, int HW, int C, int G, float rate, int seed, void* stream) {
  RowArgs a;
  a.u = u; a.src = src; a.mean = mean; a.rstd = rstd; a.gamma = gamma; a.beta = beta;
  a.fs = fs; a.fsh = fsh; a.g = static_cast<const bf16*>(g); a.add = add; a.coef = coef;
  a.dfs = dfs; a.dfsh = dfsh; a.part = part; a.part_ld = part_ld; a.off_g = off_g;
  a.off_b = off_b; a.off_c = off_c; a.out = static_cast<bf16*>(out);
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

// out f32 [B*H*W, N] = conv of a bf16 [B,H,W,K] with w bf16 [taps][K][N] (taps 9 or 1).
int sgdm_dgrad(int taps, const void* a, const void* w, float* out, int B, int H, int W, int K,
               int N, void* stream) {
  DgradArgs d;
  d.a = static_cast<const bf16*>(a);
  d.w = static_cast<const bf16*>(w);
  d.out = out;
  d.B = B; d.H = H; d.W = W; d.K = K; d.N = N;
  d.vec_a = K % 8 == 0;
  d.vec_b = N % 8 == 0;
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps == 9) return (int)launch_gemm(dgrad_kernel<9>, grid, SMEM_DG, &d, s);
  if (taps == 1) return (int)launch_gemm(dgrad_kernel<1>, grid, SMEM_DG, &d, s);
  return (int)cudaErrorInvalidValue;
}

// Weight-gradient partials of one conv (see wgrad_kernel): the pixels are cut
// into ceil(B*H*W / mchunk) splits; split z writes part[z*part_ld + off ...].
int sgdm_wgrad(int akind, int taps, const void* src, const void* g, const float* mean,
               const float* rstd, const float* gamma, const float* beta, const float* fs,
               const float* fsh, float* part, long long part_ld, long long off, int B, int H,
               int W, int K, int N, int mchunk, float rate, int seed, void* stream) {
  WgradArgs w;
  w.src = src; w.g = static_cast<const bf16*>(g); w.mean = mean; w.rstd = rstd;
  w.gamma = gamma; w.beta = beta; w.fs = fs; w.fsh = fsh; w.part = part;
  w.part_ld = part_ld; w.off = off;
  w.B = B; w.H = H; w.W = W; w.K = K; w.N = N; w.mchunk = mchunk;
  w.vec_a = K % 8 == 0;
  w.vec_b = N % 8 == 0;
  w.rate = rate;
  w.inv_keep = (float)(1.0 / (1.0 - (double)rate));
  w.seed = (uint32_t)seed;
  if (mchunk <= 0 || mchunk % BK != 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  const long long nsplit = (M + mchunk - 1) / mchunk;
  dim3 grid((unsigned)((K + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
            (unsigned)(taps * nsplit));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (akind == 0 && taps == 1) return (int)launch_gemm(wgrad_kernel<0, 1>, grid, SMEM_WG, &w, s);
  if (akind == 1 && taps == 9) return (int)launch_gemm(wgrad_kernel<1, 9>, grid, SMEM_WG, &w, s);
  if (akind == 2 && taps == 9) return (int)launch_gemm(wgrad_kernel<2, 9>, grid, SMEM_WG, &w, s);
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

}  // extern "C"
