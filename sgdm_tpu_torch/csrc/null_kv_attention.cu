// Null-KV multi-query attention for Hopper (sm_90a):
//   K7  the port of the Pallas TPU kernel sgdm_tpu/ops/pallas/attention.py
//       fused_null_kv_attention (_null_kv_kernel), the sampling forward of
//       models/attention_lr.py AttentionLR.
//
//   out[b, r, :] = softmax(q[b, r, :] . k[b]^T) v[b]
//
// q arrives pre-scaled; no scale is applied here.  Every query row r = (pixel
// n, head h) of item b attends to the ONE single-head K/V [M, D] of that item
// (M = context + null + self keys).  Rounding points of the TPU kernel: f32
// logits from the bf16 q and k, f32 softmax, the weights cast to v's dtype
// (bf16), f32 accumulation of P V, one cast of the output.
//
// The TPU kernel transposes q to [B, H*N, D] because its block is one batch
// item.  Rows are independent and share the item's K/V, so this kernel reads
// q as [B, R = N*H, D] in place and writes the output the same way: no
// transpose on either side.
//
// One block per (tile of BQ query rows, item b); each warp owns 16 rows.  K
// and then V of the item stream through shared memory in chunks of 64 keys
// (both are a few tens of KB and stay in L2 across the item's row tiles).
// The full logits row (BQ x M f32) stays in shared memory, so the softmax is
// a plain full-row softmax; the bf16 weights overwrite the f32 logits they
// came from.  Keys beyond M in the last chunk are zero rows: the row maximum
// and the sum run over the M real keys only, and the weights of the tail are
// written as exact zeros.
//
// Any head dim D <= 128: tiles are padded to DP = 32, 64 or 128 columns of
// zeros, which add nothing to q.k and whose output columns are not stored.
// When D is not a multiple of 8 the rows of q, k, v are not 16-byte aligned
// and are loaded element by element.
//
// What bounds it on an H100: at the VOC64 shape (q [128, 256*8, 64], M = 273)
// it reads q and writes out once (2 x 33.6 MB) plus K/V (9 MB) for
// 4*B*R*M*D = 18.3 GFLOP: about 240 FLOP per byte, just under the bf16 ridge
// point, so bytes bound it (23 us against 19 us of tensor-core time).  The
// QK^T and PV products run on WMMA bf16 tiles; nothing of size R x M reaches
// device memory.
//
// Shared memory: (BQ + 64) * (DP + 8) * 2 + BQ * (max(ceil64(M), DP) + 4) * 4
// bytes.  BQ is 64 while that fits in 227 KB, else 32; beyond that the
// launch is refused (the wrapper raises).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int SMEM_MAX = 232448;  // 227 KB opt-in per block on sm_90
constexpr int KC = 64;            // keys per chunk

__host__ __device__ constexpr int padded_m(int m) { return (m + KC - 1) / KC * KC; }

// f32 row stride of the logits buffer; a row also stages DP outputs at the end
__host__ __device__ constexpr int logits_ld(int m, int dp) {
  return (padded_m(m) > dp ? padded_m(m) : dp) + 4;
}

size_t nkv_smem(int bq, int m, int dp) {
  return (size_t)(bq + KC) * (dp + 8) * 2 + (size_t)bq * logits_ld(m, dp) * 4;
}

// dst[rows][DP + 8] = src rows [row0, row0 + rows) of a [total, D] matrix,
// zero beyond `total` and beyond column D.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int total, int D, int rows, bool vec, int tid,
                                          int nth) {
  constexpr int LDQ = DP + 8, D8 = DP / 8;
  for (int i = tid; i < rows * D8; i += nth) {
    const int r = i / D8, c = (i - r * D8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < total && c < D) {
      const bf16* p = src + (size_t)(row0 + r) * D + c;
      if (vec && c + 8 <= D) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        bf16* e = reinterpret_cast<bf16*>(&val);
        for (int j = 0; j < 8 && c + j < D; ++j) e[j] = p[j];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

template <int BQ, int DP>
__global__ void __launch_bounds__(BQ * 2) null_kv_kernel(const bf16* __restrict__ q,
                                                         const bf16* __restrict__ k,
                                                         const bf16* __restrict__ v,
                                                         bf16* __restrict__ o, int R, int M,
                                                         int D) {
  constexpr int NW = BQ / 16;
  constexpr int NTH = NW * 32;
  constexpr int LDQ = DP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int MP = padded_m(M);
  const int LDS = logits_ld(M, DP);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + BQ * LDQ;
  float* S = reinterpret_cast<float*>(KV + KC * LDQ);

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const bf16* qb = q + (size_t)b * R * D;
  const bf16* kb = k + (size_t)b * M * D;
  const bf16* vb = v + (size_t)b * M * D;
  const int q0 = blockIdx.x * BQ;
  const bool vec = (D % 8) == 0;

  load_rows<DP>(Qs, qb, q0, R, D, BQ, vec, tid, NTH);

  // ---- S = Q K^T, one 16 x 64 strip per warp and chunk
  for (int kc = 0; kc < MP; kc += KC) {
    __syncthreads();
    load_rows<DP>(KV, kb, kc, M, D, KC, vec, tid, NTH);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
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

  // ---- full-row f32 softmax over the M real keys of this warp's 16 rows;
  //      bf16 weights in place, exact zeros for the tail keys [M, MP)
  for (int rr = 0; rr < 16; ++rr) {
    float* row = S + (w * 16 + rr) * LDS;
    float m = -INFINITY;
    for (int c = lane; c < M; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int c = lane; c < M; c += 32) sum += expf(row[c] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    bf16* prow = reinterpret_cast<bf16*>(row);
    // bf16 element c overlays f32 element c/2: writing chunk [c0, c0+64)
    // touches only f32 elements below c0/2 + 32, all read already
    for (int c0 = 0; c0 < MP; c0 += KC) {
      const int ca = c0 + lane, cb = c0 + 32 + lane;
      const float ea = ca < M ? expf(row[ca] - m) / sum : 0.f;
      const float eb = cb < M ? expf(row[cb] - m) / sum : 0.f;
      __syncwarp();
      prow[ca] = __float2bfloat16_rn(ea);
      prow[cb] = __float2bfloat16_rn(eb);
      __syncwarp();
    }
  }

  // ---- O = P V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(acc_o[j], 0.0f);
  const bf16* P = reinterpret_cast<const bf16*>(S + (w * 16) * LDS);
  for (int kc = 0; kc < MP; kc += KC) {
    __syncthreads();
    load_rows<DP>(KV, vb, kc, M, D, KC, vec, tid, NTH);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, P + kc + kk, 2 * LDS);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, KV + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc_o[j], fa, fb, acc_o[j]);
      }
    }
  }
  __syncwarp();
  float* Ow = S + (w * 16) * LDS;  // this warp's rows, free once P is consumed
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(Ow + j * 16, acc_o[j], LDS, wmma::mem_row_major);
  __syncwarp();
  bf16* ob = o + (size_t)b * R * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i - r * D;
    const int qr = q0 + w * 16 + r;
    if (qr < R) ob[(size_t)qr * D + c] = __float2bfloat16_rn(Ow[r * LDS + c]);
  }
}

template <int BQ, int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int R, int M,
                   int D, cudaStream_t stream) {
  const size_t smem = nkv_smem(BQ, M, DP);
  cudaError_t e = cudaFuncSetAttribute(null_kv_kernel<BQ, DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((R + BQ - 1) / BQ), (unsigned)B);
  null_kv_kernel<BQ, DP><<<grid, BQ * 2, smem, stream>>>(q, k, v, o, R, M, D);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int R, int M,
                     int D, cudaStream_t stream) {
  if (nkv_smem(64, M, DP) <= SMEM_MAX) return launch<64, DP>(q, k, v, o, B, R, M, D, stream);
  if (nkv_smem(32, M, DP) <= SMEM_MAX) return launch<32, DP>(q, k, v, o, B, R, M, D, stream);
  return cudaErrorInvalidValue;
}

int padded_d(int d) { return d <= 32 ? 32 : (d <= 64 ? 64 : 128); }

}  // namespace

extern "C" {

// Largest M (keys per item) the kernel takes at head dim d (0 if d is not in [1, 128]).
int sgdm_null_kv_max_m(int d) {
  if (d < 1 || d > 128) return 0;
  int m = KC;
  while (nkv_smem(32, m + KC, padded_d(d)) <= SMEM_MAX) m += KC;
  return m;
}

// q, o: bf16 [B, R, D] contiguous (R = pixels * heads); k, v: bf16 [B, M, D]
// contiguous.  B <= 65535, 1 <= D <= 128, M <= sgdm_null_kv_max_m(D).
int sgdm_null_kv_attention(const void* q, const void* k, const void* v, void* o, int B, int R,
                           int M, int D, void* stream) {
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || B < 1 || B > 65535 || M < 1 || R < 1) return (int)cudaErrorInvalidValue;
  switch (padded_d(D)) {
    case 32: return (int)launch_d<32>(qq, kk, vv, oo, B, R, M, D, s);
    case 64: return (int)launch_d<64>(qq, kk, vv, oo, B, R, M, D, s);
    default: return (int)launch_d<128>(qq, kk, vv, oo, B, R, M, D, s);
  }
}

}  // extern "C"
