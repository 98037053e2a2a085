// Fused AdamW + EMA update for Hopper (sm_90a): K8, the port of the Pallas
// TPU kernel sgdm_tpu/ops/pallas/fused_optim.py make_fused_adamw_ema
// (_leaf_pallas -> _kernel).  One pass over f32 parameters, in place:
//
//   mu  = mu*b1 + g*(1-b1)
//   nu  = nu*b2 + g*g*(1-b2)
//   p'  = p - lr * ((mu*inv_bc1) / (sqrt(nu*inv_bc2) + eps) + wd*p)
//   e'  = e - (1-d) * (e - p')
//
// with lr = lr(count), inv_bc = 1/(1 - b^(count+1)) and the LitEma decay d
// computed on the host (optax order: the schedule reads the count before
// its increment, the bias correction the count after it).
//
// The port keeps the parameters, mu, nu and the EMA as flat f32 buffers
// (every leaf a view), so one launch covers the whole tree, the small
// leaves too.  Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; IEEE division and square root), so the result is the plain
// PyTorch version's bit for bit.
//
// What bounds it on an H100: 9 f32 streams (read p, g, mu, nu, e; write p,
// mu, nu, e), 36 bytes per parameter for about 15 operations: bound by
// device memory.  The design reads and writes each element once, 16 bytes
// per thread per stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float lr, inv_bc1, inv_bc2, one_minus, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void step(float& p, float g, float& mu, float& nu, float& e,
                                     const Hyper& h) {
  mu = __fadd_rn(__fmul_rn(mu, h.b1), __fmul_rn(g, h.omb1));
  nu = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.inv_bc2)), h.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fmul_rn(mu, h.inv_bc1), den), __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, upd));
  e = __fsub_rn(e, __fmul_rn(h.one_minus, __fsub_rn(e, p)));
}

__global__ void adamw_ema_kernel(float* __restrict__ p, const float* __restrict__ g,
                                 float* __restrict__ mu, float* __restrict__ nu,
                                 float* __restrict__ e, long long n, Hyper h) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 pv = reinterpret_cast<float4*>(p)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    float4 mv = reinterpret_cast<float4*>(mu)[i];
    float4 nv = reinterpret_cast<float4*>(nu)[i];
    float4 ev = reinterpret_cast<float4*>(e)[i];
    step(pv.x, gv.x, mv.x, nv.x, ev.x, h);
    step(pv.y, gv.y, mv.y, nv.y, ev.y, h);
    step(pv.z, gv.z, mv.z, nv.z, ev.z, h);
    step(pv.w, gv.w, mv.w, nv.w, ev.w, h);
    reinterpret_cast<float4*>(p)[i] = pv;
    reinterpret_cast<float4*>(mu)[i] = mv;
    reinterpret_cast<float4*>(nu)[i] = nv;
    reinterpret_cast<float4*>(e)[i] = ev;
  }
  for (long long i = n4 * 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    step(p[i], g[i], mu[i], nu[i], e[i], h);
}

}  // namespace

extern "C" {

// In place over n f32 elements; every pointer 16-byte aligned.
int sgdm_adamw_ema(float* p, const float* g, float* mu, float* nu, float* e, long long n,
                   float lr, float inv_bc1, float inv_bc2, float one_minus, float b1, float omb1,
                   float b2, float omb2, float eps, float wd, void* stream) {
  for (const void* q : {(const void*)p, (const void*)g, (const void*)mu, (const void*)nu,
                        (const void*)e})
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Hyper h{lr, inv_bc1, inv_bc2, one_minus, b1, omb1, b2, omb2, eps, wd};
  const int threads = 256;
  long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  adamw_ema_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, g, mu, nu, e, n, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
