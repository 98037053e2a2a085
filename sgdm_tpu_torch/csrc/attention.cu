// Self-attention for Hopper (sm_90a):
//   K3  the port of the Pallas TPU kernel sgdm_tpu/ops/pallas/attention.py
//       fused_self_attention (_self_attn_kernel), sampling forward;
//   K9  the port of the library TPU flash attention the training step calls
//       (sgdm_tpu/models/layers.py:400-432, jax.experimental.pallas.ops.tpu.
//       flash_attention), forward and backward.
//
//   out = softmax((q*s)(k*s)^T) v,  s = d^-1/4 (K9: sm_scale 1/sqrt(d) on
//         q k^T, the same number),  f32 logits and softmax, weights cast to
//         v's dtype (bf16) before the PV product.
//
// K9's forward is K3's kernel with one more output, the f32 row
// log-sum-exp lse = max + log(sum); its backward is two kernels below
// (attn_bwd_dq_kernel, then attn_bwd_dkdv_kernel) that rebuild the weights
// from lse, P = exp(s*q.k - lse), and never write an N x N matrix.
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
                                                      bf16* __restrict__ o, int N, float scale2,
                                                      float* __restrict__ lse) {
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
    if (lse != nullptr && lane == 0 && q0 + w * 16 + rr < N)
      lse[(size_t)blockIdx.y * N + q0 + w * 16 + rr] = m + logf(sum);
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
                   float scale2, float* lse, cudaStream_t stream) {
  const size_t smem = attn_smem(BQ, N, D);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel<BQ, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((N + BQ - 1) / BQ), (unsigned)BH);
  attn_kernel<BQ, D><<<grid, BQ * 2, smem, stream>>>(q, k, v, o, N, scale2, lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int N,
                     float scale2, float* lse, cudaStream_t stream) {
  if (attn_smem(64, N, D) <= SMEM_MAX) return launch<64, D>(q, k, v, o, BH, N, scale2, lse, stream);
  if (attn_smem(32, N, D) <= SMEM_MAX) return launch<32, D>(q, k, v, o, BH, N, scale2, lse, stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ K9 backward
// With P = exp(scale * q.k - lse) rebuilt from the forward's row
// log-sum-exp and Dr = rowsum(dO * o):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Dr),  dQ = scale dS K,
//   dK = scale dS^T Q.
// P and dS are cast to bf16 for the tensor-core products, accumulated in
// f32.  Two kernels, each 4 warps over a tile of 64 rows, 16 rows a warp:
//   attn_bwd_dq_kernel   one block per (query tile, b*h); K/V stream in
//                        chunks of 64 keys; also writes Dr;
//   attn_bwd_dkdv_kernel one block per (key tile, b*h); Q/dO/lse/Dr stream
//                        in chunks of 64 queries.
// What bounds it on an H100: at [B*H, 256, 64] each kernel reads its
// operands once per tile and K/V (Q/dO) once per tile of the other side
// (L2-resident across the 4 tiles of a head), for 10*N*N*D FLOP per head
// against about 16*N*D bytes: under the bf16 ridge point, bound by device
// memory.  Nothing of size N x N reaches device memory.
constexpr int BT = 64;  // rows per tile and per chunk
__host__ __device__ constexpr int strip_ld(int d) { return (d > BT ? d : BT) + 4; }

template <int D>
__host__ __device__ constexpr size_t bwd_smem() {
  return (size_t)4 * BT * (D + 8) * 2        // two row tiles and two chunk tiles, bf16
         + (size_t)2 * BT * strip_ld(D) * 4  // two f32 strips (S and dP), 16 rows a warp
         + (size_t)2 * BT * (BT + 8) * 2     // two bf16 strips (P and dS)
         + (size_t)2 * BT * 4;               // lse and Dr of 64 rows
}

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int N, int tid) {
  constexpr int LDQ = D + 8, D8 = D / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < BT * D8; i += 128) {
    const int r = i / D8, c = (i - r * D8) * 8;
    uint4 val = zero;
    if (row0 + r < N) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

// C[16 x 64] (f32, ld LDS) = A[16 rows of a tile] . B[64 rows of a tile]^T (both [row][D])
template <int D>
__device__ __forceinline__ void strip_abt(float* C, const bf16* A, const bf16* B) {
  constexpr int LDQ = D + 8, LDS = strip_ld(D);
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + kk, LDQ);
      wmma::load_matrix_sync(fb, B + (j * 16) * LDQ + kk, LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[16 x D] += P[16 x 64] (bf16, ld BT+8) . B[64 x D] (bf16 [row][D])
template <int D>
__device__ __forceinline__ void strip_accum(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], const bf16* P,
    const bf16* B) {
  constexpr int LDQ = D + 8, LDP = BT + 8;
#pragma unroll
  for (int kk = 0; kk < BT; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, P + kk, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, B + kk * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// rows [16*w, 16*w+16) of out (bf16 [N][D]) = scale * acc, via the f32 strip
template <int D>
__device__ __forceinline__ void store_rows(
    bf16* out, wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], float* strip,
    int row0, int N, float scale, int lane) {
  constexpr int LDS = strip_ld(D);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(strip + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i - r * D;
    if (row0 + r < N)
      out[(size_t)(row0 + r) * D + c] = __float2bfloat16_rn(strip[r * LDS + c] * scale);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dr, bf16* __restrict__ dq, int N, float scale) {
  constexpr int LDQ = D + 8, LDS = strip_ld(D), LDP = BT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BT * LDQ;
  bf16* Ks = dOs + BT * LDQ;
  bf16* Vs = Ks + BT * LDQ;
  float* Sw = reinterpret_cast<float*>(Vs + BT * LDQ);
  float* dPw = Sw + BT * LDS;
  bf16* dSw = reinterpret_cast<bf16*>(dPw + BT * LDS);
  float* Ls = reinterpret_cast<float*>(dSw + BT * LDP);
  float* Ds = Ls + BT;

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * BT;
  load_tile<D>(Qs, q + base, q0, N, tid);
  load_tile<D>(dOs, dout + base, q0, N, tid);
  __syncthreads();
  // Dr and lse of this warp's 16 rows
  for (int rr = 0; rr < 16; ++rr) {
    const int row = w * 16 + rr, qr = q0 + row;
    float z = 0.f;
    if (qr < N)
      for (int c = lane; c < D; c += 32)
        z += __bfloat162float(dOs[row * LDQ + c]) * __bfloat162float(o[base + (size_t)qr * D + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
    if (lane == 0) {
      Ds[row] = z;
      Ls[row] = qr < N ? lse[(size_t)blockIdx.y * N + qr] : 0.f;
      if (qr < N) dr[(size_t)blockIdx.y * N + qr] = z;
    }
  }
  __syncwarp();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  float* S = Sw + (w * 16) * LDS;
  float* dP = dPw + (w * 16) * LDS;
  bf16* dS = dSw + (w * 16) * LDP;
  for (int kc = 0; kc < N; kc += BT) {
    __syncthreads();
    load_tile<D>(Ks, k + base, kc, N, tid);
    load_tile<D>(Vs, v + base, kc, N, tid);
    __syncthreads();
    strip_abt<D>(S, Qs + (w * 16) * LDQ, Ks);
    strip_abt<D>(dP, dOs + (w * 16) * LDQ, Vs);
    __syncwarp();
    for (int i = lane; i < 16 * BT; i += 32) {
      const int r = i / BT, c = i - r * BT;
      const float p = kc + c < N ? expf(S[r * LDS + c] * scale - Ls[w * 16 + r]) : 0.f;
      dS[r * LDP + c] = __float2bfloat16_rn(p * (dP[r * LDS + c] - Ds[w * 16 + r]));
    }
    __syncwarp();
    strip_accum<D>(acc, dS, Ks);
  }
  __syncwarp();
  store_rows<D>(dq + base, acc, S, q0 + w * 16, N, scale, lane);
}

template <int D>
__global__ void __launch_bounds__(128) attn_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dr,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int N, float scale) {
  constexpr int LDQ = D + 8, LDS = strip_ld(D), LDP = BT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BT * LDQ;
  bf16* Qs = Vs + BT * LDQ;
  bf16* dOs = Qs + BT * LDQ;
  float* Sw = reinterpret_cast<float*>(dOs + BT * LDQ);
  float* dPw = Sw + BT * LDS;
  bf16* PdS = reinterpret_cast<bf16*>(dPw + BT * LDS);  // P^T, then dS^T
  float* Ls = reinterpret_cast<float*>(PdS + BT * LDP);
  float* Ds = Ls + BT;

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int k0 = blockIdx.x * BT;
  load_tile<D>(Ks, k + base, k0, N, tid);
  load_tile<D>(Vs, v + base, k0, N, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[D / 16], acc_v[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_k[j], 0.0f);
    wmma::fill_fragment(acc_v[j], 0.0f);
  }
  float* S = Sw + (w * 16) * LDS;    // S^T: this warp's 16 keys x 64 queries
  float* dP = dPw + (w * 16) * LDS;  // dP^T
  bf16* P = PdS + (w * 16) * LDP;
  for (int qc = 0; qc < N; qc += BT) {
    __syncthreads();
    load_tile<D>(Qs, q + base, qc, N, tid);
    load_tile<D>(dOs, dout + base, qc, N, tid);
    for (int i = tid; i < BT; i += 128) {
      const bool in = qc + i < N;
      Ls[i] = in ? lse[(size_t)blockIdx.y * N + qc + i] : 0.f;
      Ds[i] = in ? dr[(size_t)blockIdx.y * N + qc + i] : 0.f;
    }
    __syncthreads();
    strip_abt<D>(S, Ks + (w * 16) * LDQ, Qs);
    strip_abt<D>(dP, Vs + (w * 16) * LDQ, dOs);
    __syncwarp();
    for (int i = lane; i < 16 * BT; i += 32) {
      const int r = i / BT, c = i - r * BT;
      const float p = qc + c < N ? expf(S[r * LDS + c] * scale - Ls[c]) : 0.f;
      S[r * LDS + c] = p;
      P[r * LDP + c] = __float2bfloat16_rn(p);
    }
    __syncwarp();
    strip_accum<D>(acc_v, P, dOs);
    __syncwarp();
    for (int i = lane; i < 16 * BT; i += 32) {
      const int r = i / BT, c = i - r * BT;
      P[r * LDP + c] = __float2bfloat16_rn(S[r * LDS + c] * (dP[r * LDS + c] - Ds[c]));
    }
    __syncwarp();
    strip_accum<D>(acc_k, P, Qs);
  }
  __syncwarp();
  store_rows<D>(dk + base, acc_k, S, k0 + w * 16, N, scale, lane);
  store_rows<D>(dv + base, acc_v, S, k0 + w * 16, N, 1.0f, lane);
}

template <int D>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                       const bf16* dout, const float* lse, float* dr, bf16* dq, bf16* dk,
                       bf16* dv, int BH, int N, float scale, cudaStream_t s) {
  const int smem = (int)bwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((N + BT - 1) / BT), (unsigned)BH);
  attn_bwd_dq_kernel<D><<<grid, 128, smem, s>>>(q, k, v, o, dout, lse, dr, dq, N, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<D><<<grid, 128, smem, s>>>(q, k, v, dout, lse, dr, dk, dv, N, scale);
  return cudaGetLastError();
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

// q, k, v, o: bf16 [BH, N, D] contiguous; scale2 = (D^-1/4)^2.  lse: f32
// [BH, N] row log-sum-exp of the scaled logits (K9), or null (K3).
int sgdm_self_attention(const void* q, const void* k, const void* v, void* o, int BH, int N,
                        int D, float scale2, float* lse, void* stream) {
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_d<32>(qq, kk, vv, oo, BH, N, scale2, lse, s);
    case 64: return (int)launch_d<64>(qq, kk, vv, oo, BH, N, scale2, lse, s);
    case 128: return (int)launch_d<128>(qq, kk, vv, oo, BH, N, scale2, lse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K9 backward.  q, k, v, o, dout, dq, dk, dv: bf16 [BH, N, D] contiguous;
// lse: f32 [BH, N] from sgdm_self_attention; dr: f32 [BH, N] scratch
// (rowsum(dout * o)); scale: the forward's scale2.  D is 64 or 128.
int sgdm_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* dr, void* dq, void* dk,
                       void* dv, int BH, int N, int D, float scale, void* stream) {
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bwd<64>(c(q), c(k), c(v), c(o), c(dout), lse, dr, m(dq), m(dk),
                                        m(dv), BH, N, scale, s);
    case 128: return (int)launch_bwd<128>(c(q), c(k), c(v), c(o), c(dout), lse, dr, m(dq), m(dk),
                                          m(dv), BH, N, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
