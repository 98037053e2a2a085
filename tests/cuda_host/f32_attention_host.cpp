// csrc/attention_f32.cuh's kernels on the host (cuda_host.h), with the
// parameters sgdm_self_attention_f32 and sgdm_attention_bwd_f32 build, for
// tests/test_torch_attention_f32_host.py.  Built with g++ -std=c++20 from a
// directory that holds a copy of the header beside this directory's
// hopper.cuh.  The entry points return 0, 2 for a block too large, 3 for a
// deadlock.
#include "cuda_host.h"
#include "attention_f32.cuh"

namespace f32k {
alignas(16) float4 f32k_smem[HOST_SMEM_BYTES / 16];
}

using namespace f32k;

template <class Kernel, class P>
static int run(Kernel kernel, const P& p, long long blocks, size_t smem) {
  if (smem > HOST_SMEM_BYTES || NT != HOST_THREADS) return 2;
  gridDim.x = (unsigned)blocks;
  for (long long bi = 0; bi < blocks; ++bi) {
    float* f = reinterpret_cast<float*>(f32k_smem);
    for (size_t u = 0; u < HOST_SMEM_BYTES / 4; ++u) f[u] = NAN;
    blockIdx.x = (unsigned)bi;
    hopper::host_reset();
    if (!host_run_block([&] { kernel(p); })) return 3;
  }
  return 0;
}

extern "C" int host_attention_f32(const float* q, const float* k, const float* v, float* o,
                                  int B, int H, int N, int D, const long long* strides,
                                  float scale2, float* lse) {
  Fwd p = {};
  p.q = q, p.k = k, p.v = v, p.o = o, p.lse = lse;
  for (int i = 0; i < 4; ++i)
    p.sb[i] = strides[3 * i], p.sh[i] = strides[3 * i + 1], p.sr[i] = strides[3 * i + 2];
  p.H = H, p.heads = B * H, p.n = N, p.scale = scale2;
  if (D == 64) return run(f32_fwd_kernel, p, (long long)p.heads * ((N + FROWS - 1) / FROWS),
                          fwd_smem());
  if (D == 128) return run(f32_fwd_tile_kernel<128>, p, (long long)p.heads * ((N + T - 1) / T),
                           fwd_tile_smem<128>());
  return 1;
}

extern "C" int host_attention_bwd_f32(const float* q, const float* k, const float* v,
                                      const float* o, const float* dout, const float* lse,
                                      float* dr, float* dq, float* dk, float* dv, int B, int H,
                                      int N, int D, const long long* strides, float scale) {
  Bwd p = {};
  const float* in[5] = {q, k, v, o, dout};
  float* out[3] = {dq, dk, dv};
  for (int i = 0; i < 5; ++i) p.in[i] = in[i];
  for (int i = 0; i < 3; ++i) p.out[i] = out[i];
  for (int i = 0; i < 8; ++i)
    p.sb[i] = strides[3 * i], p.sh[i] = strides[3 * i + 1], p.sr[i] = strides[3 * i + 2];
  p.lse = lse, p.dr = dr;
  p.H = H, p.heads = B * H, p.n = N, p.scale = scale;
  if (D == 64) return run(f32_bwd_kernel, p, p.heads, bwd_smem());
  if (D != 128) return 1;
  const long long blocks = (long long)p.heads * ((N + T - 1) / T);
  const int e = run(f32_bwd_tile_kernel<128, false>, p, blocks, bwd_tile_smem<128>());
  return e ? e : run(f32_bwd_tile_kernel<128, true>, p, blocks, bwd_tile_smem<128>());
}
