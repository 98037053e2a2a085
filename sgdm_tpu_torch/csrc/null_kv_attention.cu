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
// What bounds it on an H100: at the VOC64 shape (q [128, 256*8, 64], M = 273)
// it reads q and writes out once (2 x 33.6 MB) plus K/V (9 MB) for
// 4*B*R*M*D = 18.3 GFLOP: about 240 FLOP per byte, just under the bf16 ridge
// point, so bytes bound it (23 us against 19 us of tensor-core time), and
// the one ex2 per logit (16 a clock and SM) takes about as long again: the
// three have to overlap.  The design is the block of attention_core.cuh with
// an item as the "head" (H = 1, nq = R, nk = M, scale 1):
//   * K and V of the item stay in shared memory while the block walks over
//     the item's row tiles: M = 273 is one chunk of 256 keys and one of 17
//     padded to the wgmma width 32 (288 rows, 36 KB each), loaded by cp.async,
//     V in flight while the first S and softmax run.  The grid is two blocks
//     an SM (264 on an H100), each walking over one contiguous run of the
//     launch's 64-row tiles: at B = 128 that is 15 or 16 of an item's 32
//     tiles, so an item's K/V are loaded two or three times in all, the next
//     item's under the last tile of this one.  The next q tile (8 KB,
//     contiguous rows) loads while the present one is computed, the output
//     tile is staged in the freed q buffer and stored 16 bytes a thread.
//   * Both products are wgmma; the logits of a tile are an m64n256k16 and an
//     m64n32k16 chain, P goes from registers into P V.  The two chunks are
//     joined by the online rescale: the weights are rounded to bf16
//     unnormalised and the sum divided out at the end, which differs from the
//     plain version by bf16 ulps of the weights, inside the 2^-6 tolerance.
//     M <= 256 is one chunk and keeps the TPU kernel's order (normalise, then
//     round).  Pad keys are zero rows masked to -inf before the row maximum
//     and exact zeros in P.
//   * M <= 512 (256 at D > 64) stays resident; beyond that K/V stream chunk
//     by chunk (256 keys, 128 at D > 64) through one K and one V buffer.
//
// Any head dim D <= 128: tiles are padded to 32, 64 or 128 columns of zeros,
// which add nothing to q.k and whose output columns are not stored.  When D
// is not a multiple of 8 the rows of q, k, v are not 16-byte aligned and are
// loaded and stored element by element (null_kv_kernel<DP, false>): the same
// block, chosen by shape at the launch.
//
// Budget at the VOC64 shape: 203 registers a thread, 89 KB of shared memory
// (2 q buffers 16 KB, K and V 36 KB each, 1 KB alignment), two blocks an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_core.cuh"

typedef __nv_bfloat16 bf16;

namespace {

template <int DP, bool VEC>
__global__ void __launch_bounds__(attn_core::THREADS, 2)
    null_kv_kernel(const attn_core::Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_core::attention_block<DP, VEC>(p, smem);
}

template <int DP, bool VEC>
cudaError_t launch(attn_core::Params& p, cudaStream_t stream) {
  unsigned grid = 0;
  const size_t smem = attn_core::plan(p, DP, attn_core::sm_count(), &grid);
  cudaError_t e = cudaFuncSetAttribute(null_kv_kernel<DP, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  null_kv_kernel<DP, VEC><<<grid, attn_core::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// blocks of null_kv_kernel<DP, true> an SM holds at M keys (registers and shared memory)
template <int DP>
int occupancy(int M) {
  attn_core::Params p = {};
  p.nq = attn_core::BM, p.nk = M, p.heads = 1;
  unsigned grid = 0;
  const size_t smem = attn_core::plan(p, DP, attn_core::sm_count(), &grid);
  int n = 0;
  if (cudaFuncSetAttribute(null_kv_kernel<DP, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, null_kv_kernel<DP, true>,
                                                    attn_core::THREADS, smem) != cudaSuccess)
    return -1;
  return n;
}

template <int DP>
cudaError_t launch_d(attn_core::Params& p, cudaStream_t stream) {
  return p.d % 8 == 0 ? launch<DP, true>(p, stream) : launch<DP, false>(p, stream);
}

}  // namespace

extern "C" {

// q, o: bf16 [B, R, D] contiguous (R = pixels * heads); k, v: bf16 [B, M, D]
// contiguous; 16-byte aligned when D % 8 == 0.  1 <= D <= 128, any M >= 1.
int sgdm_null_kv_attention(const void* q, const void* k, const void* v, void* o, int B, int R,
                           int M, int D, void* stream) {
  if (D < 1 || D > 128 || B < 1 || M < 1 || R < 1) return (int)cudaErrorInvalidValue;
  attn_core::Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = nullptr;
  p.q_sb = p.o_sb = (long long)R * D;
  p.k_sb = p.v_sb = (long long)M * D;
  p.q_sr = p.k_sr = p.v_sr = p.o_sr = D;
  if ((long long)B * ((R + 63) / 64) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.H = 1, p.heads = B, p.nq = R, p.nk = M, p.d = D;
  p.scale_log2 = attn_core::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_d<32>(p, s);
  if (D <= 64) return (int)launch_d<64>(p, s);
  return (int)launch_d<128>(p, s);
}

// Blocks of the kernel an SM holds at M keys and head dim D (-1: D not taken).
int sgdm_null_kv_occupancy(int M, int D) {
  if (D < 1 || D > 128 || M < 1) return -1;
  return D <= 32 ? occupancy<32>(M) : (D <= 64 ? occupancy<64>(M) : occupancy<128>(M));
}

}  // extern "C"
