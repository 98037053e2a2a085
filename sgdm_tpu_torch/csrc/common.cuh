// Device helpers shared by the ResBlock kernels (resblock.cu, resblock_bwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace sgdm {

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// The SiLU of the ResBlock kernels: K4's conv prologue applies it, and K5
// recomputes h1 and h3d with the same one (and the same folded GN
// coefficients), so the backward's weight-gradient inputs are the forward's
// conv inputs.  __expf and __fdividef: a few f32 ulps from z / (1 + e^-z).
__device__ __forceinline__ float silu_fast(float z) { return __fdividef(z, 1.0f + __expf(-z)); }

// d silu(z) / dz = s (1 + z (1 - s)), s = sigmoid(z)
__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

__device__ __forceinline__ void load8(const bf16* p, int nvalid, bool vec, float out[8]) {
  if (vec && nvalid >= 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < nvalid ? __bfloat162float(p[i]) : 0.0f;
  }
}

__device__ __forceinline__ void load8(const float* p, int nvalid, bool vec, float out[8]) {
  if (vec && nvalid >= 8) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < nvalid ? p[i] : 0.0f;
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r;
}

// Dropout keep-mask of sgdm_tpu/ops/pallas/resblock.py _dropout_mask, bit for
// bit: element (pixel i, channel j) of sample b, for a block of C channels,
// keeps when the top 24 bits of a murmur3-style finalizer of
// z = (i*C + j) + (seed + b) * 2654435761 (uint32 wrap-around), read as a
// fraction of 2^24, are >= rate.  Returns the mask value: 1/(1-rate) or 0.
__device__ __forceinline__ float dropout_scale(uint32_t i, uint32_t j, uint32_t C, uint32_t s,
                                               float rate, float inv_keep) {
  uint32_t z = (i * C + j) + s * 2654435761u;
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  const float u = (float)(int)(z >> 8) * (1.0f / 16777216.0f);
  return u >= rate ? inv_keep : 0.0f;
}

}  // namespace sgdm
