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
// (q*s)·(k*s) is computed as s^2 * (q·k): bf16 products are exact in the
// f32 accumulator, so this is the f32 reference up to summation order,
// without rounding q*s and k*s to bf16 for the tensor cores.
//
// Forward (attn_kernel; K9's forward is K3's kernel with one more output, the
// f32 row log-sum-exp lse = max + log(sum) in natural log of the SCALED
// logits, converted from the kernel's base-2 bookkeeping before the store).
// What bounds it on an H100: at the IN64 shape [2B*8, 256, 64] it reads q, k,
// v and writes o once (8*N*D bytes per head, 134 MB: 40 us at 3.35 TB/s) for
// 4*N*N*D FLOP per head (17.2 GFLOP: 17 us at the bf16 tensor-core peak):
// bytes bound it.  Under that bound the tensor cores (2 x 4 m64n256k16 per
// tile) and the one ex2 per logit (16 a clock and SM) each take about as long
// as the bytes, so they have to overlap.  The design, in attention_core.cuh:
// one-warpgroup blocks, two an SM, each walking over a contiguous run of
// 64-row tiles, so a head's K and V (32 KB each) are read from device memory
// once (twice where a run starts inside a head), by cp.async into
// 128-byte-swizzled tiles, the next head's K and V loading under this head's
// last softmax, P V and stores; both products are wgmma with f32 accumulators
// in registers (S: one m64n256k16 chain, 128 registers a thread; P goes from
// the accumulator fragment straight to the A operand of P V); softmax in
// registers with the TPU kernel's rounding at N <= 256 (normalise in f32,
// cast, then P V) and a carried maximum and sum beyond (unnormalised weights
// rounded to bf16: a few bf16 ulps of the weights, inside the tolerance).
// q, k, v and o carry element strides for batch, head and row, so the
// [B, N, 3, H, D] projection is read and a [B, N, H, D] output written in
// place, without copies.
//
// What holds it in practice (measured, PERF.md): not the bytes but the chain
// inside a warpgroup, S, then the softmax (its 128 ex2 a thread alone are
// 1024 cycles of the SM's special-function units), then P V; two blocks an SM
// hide only part of it.
//
// Budget at N = 256, D = 64: 203 registers a thread, 81 KB of shared memory
// (2 Q buffers 16 KB, K and V 32 KB each, 1 KB alignment), two blocks an SM.
// Any N >= 1 (keys beyond N are zero rows masked to -inf before the row
// maximum; rows beyond N are zero-filled and not stored; N > 512, or N > 256
// at head dim 128, streams K/V chunk by chunk through one K and one V
// buffer); head dim 32, 64 or 128.
//
// Backward (K9 only): two WMMA kernels below (attn_bwd_dq_kernel, then
// attn_bwd_dkdv_kernel) that rebuild the weights from lse,
// P = exp(s*q.k - lse), and never write an N x N matrix; contiguous
// [BH, N, D] operands.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

template <int D>
__global__ void __launch_bounds__(attn_core::THREADS, 2) attn_kernel(const attn_core::Params p) {
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  attn_core::attention_block<D, true>(p, fwd_smem);
}

template <int D>
cudaError_t launch_fwd(attn_core::Params& p, cudaStream_t stream) {
  unsigned grid = 0;
  const size_t smem = attn_core::plan(p, D, attn_core::sm_count(), &grid);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attn_kernel<D><<<grid, attn_core::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// blocks of attn_kernel<D> an SM holds at N keys (registers and shared memory)
template <int D>
int occupancy(int N) {
  attn_core::Params p = {};
  p.nq = p.nk = N, p.heads = 1;
  unsigned grid = 0;
  const size_t smem = attn_core::plan(p, D, attn_core::sm_count(), &grid);
  int n = 0;
  if (cudaFuncSetAttribute(attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_kernel<D>, attn_core::THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
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

// q, k, v, o: bf16 [B, H, N, D] by element strides (batch, head, row; unit
// stride along D, every row 16-byte aligned): `strides` holds the twelve of
// q, k, v, o in that order.  scale2 = (D^-1/4)^2.  lse: f32 [B, H, N]
// contiguous, the row log-sum-exp of the scaled logits (K9), or null (K3).
// D is 32, 64 or 128.
int sgdm_self_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                        int D, const long long* strides, float scale2, float* lse,
                        void* stream) {
  if (B < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  attn_core::Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_sr = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_sr = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_sr = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_sr = strides[11];
  if ((long long)B * H * ((N + 63) / 64) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.H = H, p.heads = B * H, p.nq = N, p.nk = N, p.d = D;
  p.scale_log2 = scale2 * attn_core::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_fwd<32>(p, s);
    case 64: return (int)launch_fwd<64>(p, s);
    case 128: return (int)launch_fwd<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the forward kernel an SM holds at sequence length N (-1: D not taken).
int sgdm_self_attention_occupancy(int N, int D) {
  switch (D) {
    case 32: return occupancy<32>(N);
    case 64: return occupancy<64>(N);
    case 128: return occupancy<128>(N);
    default: return -1;
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
