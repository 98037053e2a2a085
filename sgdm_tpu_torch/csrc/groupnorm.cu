// GroupNorm(+FiLM)+SiLU apply pass for Hopper (sm_90a):
//   K6  the port of the Pallas TPU kernel sgdm_tpu/ops/pallas/groupnorm.py
//       fused_groupnorm_silu (_apply_kernel), which the ResBlock's unfused
//       composition calls in sampling mode.
//
//   h   = (x - mean[b, c]) * rstd[b, c]
//   h   = h * gamma[c] + beta[c]
//   h   = h * (1 + fs[b, c]) + fsh[b, c]          (FiLM, optional)
//   out = bf16(h * sigmoid(h))
//
// all in f32 in this order, rounded once at the end, as the TPU kernel does.
// The group statistics are computed outside this kernel, as in the JAX
// package (its _group_stats), and arrive broadcast to channels as the TPU
// kernel takes them: the wrapper runs the GN-statistics kernel of
// resblock.cu (gn_coef_kernel: E[x^2] - mean^2, clamped at 0) and hands over
// its coef [B, 3, C] (row 0: mean) and rstd [B, C].
//
// x and out are NHWC bf16 [B, HW, C], any H, W, C.  When C is a multiple of 8
// a thread handles 8 neighbouring channels of one pixel with 16-byte loads
// and stores; otherwise one element per thread.  A grid-stride loop covers
// the tensor.
//
// What bounds it on an H100: bytes only.  It reads x once and writes out
// once (2 * B*HW*C * 2 bytes; the per-channel vectors stay in cache) for
// about 10 operations per element.

#include "common.cuh"

namespace {

using sgdm::load8;
using sgdm::pack8;
using sgdm::silu;

struct GnArgs {
  const bf16* x;
  const float* coef;   // [B, 3, C]; coef[b][0][c] = mean of c's group
  const float* rstd;   // [B, C]
  const float* gamma;  // [C]
  const float* beta;   // [C]
  const float* fs;     // [B, C] or null
  const float* fsh;    // [B, C] or null
  bf16* out;
  int HW, C;
  size_t total;        // B * HW * C
};

__device__ __forceinline__ float apply_one(const GnArgs& a, float x, size_t b, int c) {
  float h = (x - a.coef[b * 3 * a.C + c]) * a.rstd[b * a.C + c];
  h = h * a.gamma[c] + a.beta[c];
  if (a.fs != nullptr) h = h * (1.0f + a.fs[b * a.C + c]) + a.fsh[b * a.C + c];
  return silu(h);
}

template <bool VEC>
__global__ void __launch_bounds__(256) gn_silu_kernel(GnArgs a) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t per_sample = (size_t)a.HW * a.C;
  if (VEC) {
    const size_t nvec = a.total / 8;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
      const size_t e = i * 8;
      const size_t b = e / per_sample;
      const int c0 = (int)(e % a.C);
      float vals[8];
      load8(a.x + e, 8, true, vals);
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = apply_one(a, vals[j], b, c0 + j);
      *reinterpret_cast<uint4*>(a.out + e) = pack8(vals);
    }
  } else {
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < a.total; e += stride) {
      const size_t b = e / per_sample;
      const int c = (int)(e % a.C);
      a.out[e] = __float2bfloat16_rn(apply_one(a, __bfloat162float(a.x[e]), b, c));
    }
  }
}

}  // namespace

extern "C" {

// x, out: bf16 [B, HW, C] contiguous (16-byte aligned when C % 8 == 0);
// coef: f32 [B, 3, C] with the per-channel group mean in row 0; rstd: f32
// [B, C]; gamma, beta: f32 [C]; fs, fsh: f32 [B, C] or both null.
int sgdm_groupnorm_silu(const void* x, const float* coef, const float* rstd, const float* gamma,
                        const float* beta, const float* fs, const float* fsh, void* out, int B,
                        int HW, int C, int sm_count, void* stream) {
  if (B < 1 || HW < 1 || C < 1 || (fs == nullptr) != (fsh == nullptr))
    return (int)cudaErrorInvalidValue;
  GnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.coef = coef;
  a.rstd = rstd;
  a.gamma = gamma;
  a.beta = beta;
  a.fs = fs;
  a.fsh = fsh;
  a.out = static_cast<bf16*>(out);
  a.HW = HW;
  a.C = C;
  a.total = (size_t)B * HW * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (C % 8) == 0;
  const size_t work = vec ? a.total / 8 : a.total;
  size_t blocks = (work + 255) / 256;
  const size_t cap = (size_t)(sm_count > 0 ? sm_count : 132) * 16;
  if (blocks > cap) blocks = cap;
  if (vec)
    gn_silu_kernel<true><<<(unsigned)blocks, 256, 0, s>>>(a);
  else
    gn_silu_kernel<false><<<(unsigned)blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
