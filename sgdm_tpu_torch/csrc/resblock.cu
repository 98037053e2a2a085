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
// (resblock_bwd.cu) rebuilds both once, in passes that read x and h2 anyway:
// h1 from x and the GN1 statistics, h3d from h2, the GN2 statistics, FiLM
// and the dropout hash.
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
//     pools the activated h1 in f32 and rounds after.  The SiLU is
//     common.cuh silu_fast (__expf, __fdividef: a few f32 ulps from the IEEE
//     one), the one K5 (resblock_bwd.cu) writes h1 and h3d with, from the
//     same folded coefficients, so the backward's weight gradients take the
//     very values these convolutions took.
//
// C interface (ctypes): every function returns cudaGetLastError() after
// its launch, and launches on the stream it is given.

#include "conv_core.cuh"

namespace {

using conv::ConvArgs;
using conv::NT;
using conv::SMEM_CONV;
using conv::conv_kernel;
using conv::launch_conv;
using sgdm::load8;

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
