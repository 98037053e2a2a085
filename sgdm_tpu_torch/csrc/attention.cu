// Sampling self-attention for Hopper (sm_90a): the port of the Pallas TPU
// kernel sgdm_tpu/ops/pallas/attention.py fused_self_attention
// (_self_attn_kernel):
//
//   out = softmax((q*s)(k*s)^T) v,  s = d^-1/4,  f32 logits and softmax,
//         weights cast to v's dtype (bf16) before the PV product.
//
// Layout [BH, N, D] bf16, contiguous.  One block per (b*h, tile of BQ query
// rows); each warp owns 16 query rows.  K and then V stream through shared
// memory in chunks of 64 keys.  The full logits row (BQ x N f32) stays in
// shared memory, so the softmax is a plain full-row softmax with no online
// rescaling (the Pallas kernel's rounding: normalise in f32, cast the
// weights to bf16, accumulate PV in f32).  The bf16 weights are written in
// place over the f32 logits they came from.
//
// (q*s)·(k*s) is computed as s^2 * (q·k): bf16 products are exact in the
// f32 accumulator, so this is the f32 reference up to summation order,
// without rounding q*s and k*s to bf16 for the tensor cores.
//
// What bounds it on an H100: at the IN64 shape [2B*8, 256, 64] it reads
// q, k, v and writes o once (8*N*D bytes per head) for 4*N*N*D FLOP, about
// 64 FLOP per byte, under the bf16 ridge point: it is bound by device
// memory.  The design reads each input once per query tile (K/V once per
// BQ rows, L2-resident across the N/BQ tiles of one head) and never writes
// the logits to device memory.  The QK^T and PV products run on WMMA bf16
// tiles.
//
// Shared memory: (BQ + 64) * (D + 8) * 2 + BQ * (max(ceil64(N), D) + 4) * 4 bytes.
// BQ is 64 while that fits, else 32; N = 1024 at D = 64 takes 145 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int SMEM_MAX = 232448;  // 227 KB opt-in per block on sm_90

__host__ __device__ constexpr int padded_n(int n) { return (n + 63) / 64 * 64; }

// f32 row stride of the logits buffer; a row also stages D outputs at the end
__host__ __device__ constexpr int logits_ld(int n, int d) {
  return (padded_n(n) > d ? padded_n(n) : d) + 4;
}

size_t attn_smem(int bq, int n, int d) {
  return (size_t)(bq + 64) * (d + 8) * 2 + (size_t)bq * logits_ld(n, d) * 4;
}

template <int BQ, int D>
__global__ void __launch_bounds__(BQ * 2) attn_kernel(const bf16* __restrict__ q,
                                                      const bf16* __restrict__ k,
                                                      const bf16* __restrict__ v,
                                                      bf16* __restrict__ o, int N, float scale2) {
  constexpr int NW = BQ / 16;
  constexpr int NTH = NW * 32;
  constexpr int LDQ = D + 8;
  constexpr int D8 = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int NP = padded_n(N);
  const int LDS = logits_ld(N, D);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + BQ * LDQ;
  float* S = reinterpret_cast<float*>(KV + 64 * LDQ);

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * BQ;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < BQ * D8; i += NTH) {
    const int r = i / D8, c = (i - r * D8) * 8;
    uint4 val = zero;
    if (q0 + r < N) val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) = val;
  }

  auto load_chunk = [&](const bf16* src, int kc) {
    for (int i = tid; i < 64 * D8; i += NTH) {
      const int r = i / D8, c = (i - r * D8) * 8;
      uint4 val = zero;
      if (kc + r < N) val = *reinterpret_cast<const uint4*>(src + base + (size_t)(kc + r) * D + c);
      *reinterpret_cast<uint4*>(KV + r * LDQ + c) = val;
    }
  };

  // ---- S = Q K^T (unscaled), one 16 x 64 strip per warp and chunk
  for (int kc = 0; kc < NP; kc += 64) {
    __syncthreads();
    load_chunk(k, kc);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + (w * 16) * LDQ + kk, LDQ);
        wmma::load_matrix_sync(fb, KV + (j * 16) * LDQ + kk, LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + (w * 16) * LDS + kc + j * 16, acc, LDS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // ---- full-row f32 softmax of this warp's 16 rows; bf16 weights in place
  for (int rr = 0; rr < 16; ++rr) {
    float* row = S + (w * 16 + rr) * LDS;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, row[c] * scale2);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) sum += expf(row[c] * scale2 - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    bf16* prow = reinterpret_cast<bf16*>(row);
    // bf16 element c overlays f32 element c/2: writing chunk [c0, c0+64)
    // touches only f32 elements below c0/2 + 32, all read already
    for (int c0 = 0; c0 < NP; c0 += 64) {
      const int ca = c0 + lane, cb = c0 + 32 + lane;
      const float ea = ca < N ? expf(row[ca] * scale2 - m) / sum : 0.f;
      const float eb = cb < N ? expf(row[cb] * scale2 - m) / sum : 0.f;
      __syncwarp();
      prow[ca] = __float2bfloat16_rn(ea);
      prow[cb] = __float2bfloat16_rn(eb);
      __syncwarp();
    }
  }

  // ---- O = P V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc_o[j], 0.0f);
  const bf16* P = reinterpret_cast<const bf16*>(S + (w * 16) * LDS);
  for (int kc = 0; kc < NP; kc += 64) {
    __syncthreads();
    load_chunk(v, kc);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, P + kc + kk, 2 * LDS);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, KV + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc_o[j], fa, fb, acc_o[j]);
      }
    }
  }
  __syncwarp();
  float* Ow = S + (w * 16) * LDS;  // this warp's rows, free once P is consumed
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(Ow + j * 16, acc_o[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i - r * D;
    const int qr = q0 + w * 16 + r;
    if (qr < N) o[base + (size_t)qr * D + c] = __float2bfloat16_rn(Ow[r * LDS + c]);
  }
}

template <int BQ, int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int N,
                   float scale2, cudaStream_t stream) {
  const size_t smem = attn_smem(BQ, N, D);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel<BQ, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((N + BQ - 1) / BQ), (unsigned)BH);
  attn_kernel<BQ, D><<<grid, BQ * 2, smem, stream>>>(q, k, v, o, N, scale2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int N,
                     float scale2, cudaStream_t stream) {
  if (attn_smem(64, N, D) <= SMEM_MAX) return launch<64, D>(q, k, v, o, BH, N, scale2, stream);
  if (attn_smem(32, N, D) <= SMEM_MAX) return launch<32, D>(q, k, v, o, BH, N, scale2, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest N the kernel takes at head dim d (0 if d is not 32, 64 or 128).
int sgdm_attention_max_n(int d) {
  if (d != 32 && d != 64 && d != 128) return 0;
  int n = 64;
  while (attn_smem(32, n + 64, d) <= SMEM_MAX) n += 64;
  return n;
}

// q, k, v, o: bf16 [BH, N, D] contiguous; scale2 = (D^-1/4)^2.
int sgdm_self_attention(const void* q, const void* k, const void* v, void* o, int BH, int N,
                        int D, float scale2, void* stream) {
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_d<32>(qq, kk, vv, oo, BH, N, scale2, s);
    case 64: return (int)launch_d<64>(qq, kk, vv, oo, BH, N, scale2, s);
    case 128: return (int)launch_d<128>(qq, kk, vv, oo, BH, N, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
