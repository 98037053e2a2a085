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
// What held that design at 1.26-1.33x SDPA's device time (PERF.md):
// the chain inside one warpgroup, S, then the softmax (its 128 ex2 a thread
// alone are 1024 cycles of the SM's special-function units), then P V, and
// loads issued by the same threads that compute.  So the main shape (head
// dim 64, at most 256 keys, operands TMA can address) now runs on a
// warp-specialised block instead (attn_pp_kernel, attention_core.cuh
// pingpong_block): two producer threads issuing every load by TMA into
// mbarrier rings (K and V a head ahead, Q three units ahead), two consumer
// warpgroups whose products alternate on the tensor cores so one's softmax
// runs under the other's wgmma, setmaxnreg moving registers from the
// producer warpgroup (40) to the consumers (232), the output stored by TMA.
// The rest (head dims 32 and 128, longer rows, stride-0 views) keeps
// attention_block.
//
// Backward (K9 only): two launches of one wgmma block design on the same
// core (attn_bwd_kernel<D, false>: dq and Dr, then <D, true>: dk and dv),
// which rebuild the weights from lse, P = exp(s*q.k - lse), never write an
// N x N matrix, and take every operand by element strides; see below.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_core.cuh"
#include "attention_f32.cuh"

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

// ------------------------------------------------ the warp-specialised forward
// attn_core::pingpong_block: head dim 64, at most 256 keys (the IN64 shape and
// every shape of that class); the rest go to attn_kernel.
template <int NW>
__global__ void __launch_bounds__(attn_core::PP_THREADS, 1)
    attn_pp_kernel(const __grid_constant__ attn_core::PPParams p) {
  extern __shared__ __align__(128) unsigned char pp_smem[];
  attn_core::pingpong_block<NW>(p, pp_smem);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 4-d map of a bf16 [B, H, rows, 64] tensor by element strides (batch,
// head, row), dims innermost first (d, row, head, batch), boxes of `box_rows`
// rows of one head, 128-byte swizzle, rows outside the tensor zero
bool make_map(CUtensorMap* map, const void* base, int B, int H, int rows, long long sb,
              long long sh, long long sr, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sr * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// does the warp-specialised kernel take this call?  head dim 64, at most 256
// keys, TMA's alignment: 16-byte base addresses and strides
bool pp_takes(const attn_core::Params& p) {
  if (p.d != 64 || p.nk > 256 || p.nq != p.nk) return false;
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  const long long st[12] = {p.q_sb, p.q_sh, p.q_sr, p.k_sb, p.k_sh, p.k_sr,
                            p.v_sb, p.v_sh, p.v_sr, p.o_sb, p.o_sh, p.o_sr};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  for (long long s : st)
    if (s % 8 != 0 || s <= 0) return false;
  return true;
}

// The producer gives back (168 - 40) x 128 registers and the two consumers take
// (232 - 168) x 256: the same number only if the kernel was compiled to 168 a
// thread (65,536 / 384 rounded down to 8), which launch bounds and setmaxnreg
// make ptxas choose; anything else would leave a consumer waiting for
// registers for ever, so it is refused.
constexpr int PP_REGS = 168;
static_assert((PP_REGS - 40) * 128 == (232 - PP_REGS) * 256, "the register moves balance");

template <int NW>
cudaError_t launch_pp_nw(const attn_core::PPParams& pp, int grid, cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, attn_pp_kernel<NW>);
  if (e != cudaSuccess) return e;
  if (attr.numRegs != PP_REGS) return cudaErrorInvalidDeviceFunction;
  e = cudaFuncSetAttribute(attn_pp_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)attn_core::PP_SMEM);
  if (e != cudaSuccess) return e;
  attn_pp_kernel<NW><<<grid, attn_core::PP_THREADS, attn_core::PP_SMEM, stream>>>(pp);
  return cudaGetLastError();
}

cudaError_t launch_pp(const attn_core::Params& p, int B, cudaStream_t stream) {
  attn_core::PPParams pp;
  memset(&pp, 0, sizeof(pp));
  const int nw = attn_core::width_class(p.nk);
  if (!make_map(&pp.tq, p.q, B, p.H, p.nq, p.q_sb, p.q_sh, p.q_sr, attn_core::BM) ||
      !make_map(&pp.tk, p.k, B, p.H, p.nk, p.k_sb, p.k_sh, p.k_sr, nw) ||
      !make_map(&pp.tv, p.v, B, p.H, p.nk, p.v_sb, p.v_sh, p.v_sr, nw) ||
      !make_map(&pp.to, p.o, B, p.H, p.nq, p.o_sb, p.o_sh, p.o_sr, attn_core::BM))
    return cudaErrorInvalidValue;
  pp.lse = p.lse;
  pp.H = p.H, pp.heads = p.heads, pp.nq = p.nq, pp.nk = p.nk, pp.kv_rows = nw;
  pp.scale_log2 = p.scale_log2;
  const int sms = attn_core::sm_count();
  const int grid = p.heads < sms ? p.heads : sms;  // whole heads a block
  switch (nw) {
    case 32: return launch_pp_nw<32>(pp, grid, stream);
    case 64: return launch_pp_nw<64>(pp, grid, stream);
    case 128: return launch_pp_nw<128>(pp, grid, stream);
    default: return launch_pp_nw<256>(pp, grid, stream);
  }
}

int pp_occupancy() {
  int n = 0;
  if (cudaFuncSetAttribute(attn_pp_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)attn_core::PP_SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_pp_kernel<256>,
                                                    attn_core::PP_THREADS,
                                                    attn_core::PP_SMEM) != cudaSuccess)
    return -1;
  return n;
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
// P and dS are rounded to bf16 for the tensor-core products (as
// flash_attention_bwd_plain rounds them), accumulated in f32, scaled and
// rounded once at the store.  Two launches of one block design, bwd_block:
//   dq    (DKDV = false) rows are 64 queries: Q and dO are the row operands,
//         K and V the column operands in chunks of 64 keys; it also writes Dr;
//   dk/dv (DKDV = true)  rows are 64 keys: K and V the row operands, Q and dO
//         (with the lse and Dr of each query) the column operands.
// A step is one (row tile, column chunk) pair and runs the same four parts in
// both: S = R1 C1^T and dP = R2 C2^T as wgmma_ss (both operands K-major from
// 128-byte-swizzled shared memory, the forward's S), P = ex2(S*scale*log2e -
// lse*log2e) and dS in registers, then the accumulating products with the
// bf16-packed P or dS accumulator fragment as the A registers and a column
// operand as the MN-major B (the forward's P.V): dQ += dS K;  dV += P^T dO,
// dK += dS^T Q.  Deterministic: every output row is written by one block,
// once, and nothing is summed across blocks.
// Grid and loads follow the forward: two one-warpgroup blocks an SM (one at
// head dim 128), each walking over a contiguous run of (head, 64-row tile)
// pairs.  The column buffer holds four 64-row chunks of both column operands
// (two at head dim 128): when a head's columns fit (N <= 256; 128 at head dim
// 128) they are loaded once per head and stay while the block walks over the
// head's tiles, else they stream through the same slots as a ring.  Either
// way the step that next uses a slot is `period` steps later (a head's chunk
// count, or the ring's length), and its load is issued as soon as this step is
// done with the slot, so it has that many steps to land; the next tile's row
// operands load one tile ahead.  Every step end and every tile start commits
// one cp.async group (possibly empty), so what a step waits for is a count
// known from its position alone.
// What bounds it on an H100: at [128*8 heads, 256, 64] both kernels together
// do 14*N*N*D operations per head (S and dP are computed in both: 60 GFLOP,
// 61 us at the bf16 peak) against the 80 us the bytes take if every operand
// were read once (q, k, v, o, dO, lse in; dq, dk, dv out: 270 MB): bytes.
// With the split, q, k, v and dO are read by both kernels (about 400 MB,
// 120 us); what the design does about the rest is the forward's: wgmma with
// the elementwise work in registers, a head's columns loaded once per run of
// its tiles, loads issued as early as their slot is free.  The old WMMA
// kernels (f32 strips of S and dP in shared memory, one block per tile that
// streamed its head's columns again) took 1.30 ms a call.
// Budget (nvcc -Xptxas -v, chip_smoke's flash_attention_bwd row): 163 (dq)
// and 178 (dk/dv) registers a thread at head dim 64, no spill, 99 KB of
// shared memory, two blocks an SM; 225 and 247 registers, 130 KB, one block
// at head dim 128.
constexpr int BC = 64;  // columns per step: keys (dq) or queries (dk/dv); one wgmma N
enum Operand { OP_Q, OP_K, OP_V, OP_O, OP_DO, OP_DQ, OP_DK, OP_DV };

// 64-row chunks a column buffer holds: 256 rows at head dim 64, 128 at head dim 128
__host__ __device__ constexpr int bwd_slots(int dp) { return dp > 64 ? 2 : 4; }
// blocks an SM: registers allow two; shared memory allows one at head dim 128
__host__ __device__ constexpr int bwd_blocks(int dp) { return dp > 64 ? 1 : 2; }

template <int DP, bool DKDV>
__host__ __device__ constexpr size_t bwd_smem() {
  // 1 KB of alignment; two buffers of the two row operands; the column slots
  // of the two column operands; dk/dv: the lse and Dr of each slot's queries
  return 1024 + (size_t)(DP / 64) * attn_core::SUB * (4 + 2 * bwd_slots(DP)) +
         (DKDV ? (size_t)2 * bwd_slots(DP) * BC * sizeof(float) : 0);
}

struct BwdParams {
  const bf16* in[5];   // q, k, v, o, dout
  bf16* out[3];        // dq, dk, dv
  const float* lse;    // [heads, n] from the forward
  float* dr;           // [heads, n]: written by the dq launch, read by the dk/dv launch
  long long sb[8], sh[8], sr[8];  // element strides (batch, head, row) by Operand
  int H, heads, n;
  float scale, scale_log2;
};

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    z = fmaf(fx.x, fy.x, z);
    z = fmaf(fx.y, fy.y, z);
  }
  return z;
}

template <int DP, bool DKDV>
__device__ __forceinline__ void bwd_block(const BwdParams& p, unsigned char* smem_raw) {
  using namespace attn_core;
  constexpr int KT = DP / 64, KS = DP / 16, NS = bwd_slots(DP), TILE = KT * SUB;
  constexpr int R1 = DKDV ? OP_K : OP_Q, R2 = DKDV ? OP_V : OP_DO;   // A of S and of dP
  constexpr int C1 = DKDV ? OP_Q : OP_K, C2 = DKDV ? OP_DO : OP_V;  // B of S and of dP
  constexpr int CPR = DP / 32;  // 16-byte chunks of a row a thread reads for Dr
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* rows = smem;             // [2 buffers][R1, R2], 64 rows each
  unsigned char* cols = rows + 4 * TILE;  // [NS slots][C1, C2], 64 rows each
  float* lse_s = reinterpret_cast<float*>(cols + 2 * NS * TILE);  // dk/dv: [NS][BC]
  float* dr_s = lse_s + NS * BC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (p.n + BM - 1) / BM;  // per head
  const int total = p.heads * tiles;
  const int g0 = (int)((long long)total * blockIdx.x / gridDim.x);
  const int g1 = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  const int nc = (p.n + BC - 1) / BC;
  const bool resident = nc <= NS;
  const int period = resident ? nc : NS;
  const int steps = (g1 - g0) * nc;

  // where a tile is: batch item, head in it, tile in the head; counted up, never divided
  struct Pos {
    int b, h, t;
  };
  auto next = [&](Pos a) {
    if (++a.t == tiles) {
      a.t = 0;
      if (++a.h == p.H) a.h = 0, ++a.b;
    }
    return a;
  };
  auto in_ptr = [&](int op, Pos a) { return p.in[op] + a.b * p.sb[op] + a.h * p.sh[op]; };
  auto vec_row = [&](Pos a) { return ((long long)a.b * p.H + a.h) * p.n; };  // lse, dr
  // each warp loads (and later stages and stores) its own 16 rows of a row buffer
  auto load_row_ops = [&](Pos a, int buf) {
    unsigned char* dst = rows + buf * 2 * TILE + warp * 16 * 128;
    const int row0 = a.t * BM + warp * 16;
    load_rows<DP, true>(dst, SUB, in_ptr(R1, a), p.sr[R1], row0, 16, p.n, DP, lane, 32);
    load_rows<DP, true>(dst + TILE, SUB, in_ptr(R2, a), p.sr[R2], row0, 16, p.n, DP, lane, 32);
  };
  auto load_chunk = [&](Pos a, int c, int slot) {
    unsigned char* dst = cols + slot * 2 * TILE;
    const int row0 = c * BC;
    load_rows<DP, true>(dst, SUB, in_ptr(C1, a), p.sr[C1], row0, BC, p.n, DP, tid, THREADS);
    load_rows<DP, true>(dst + TILE, SUB, in_ptr(C2, a), p.sr[C2], row0, BC, p.n, DP, tid,
                        THREADS);
    if (DKDV) {  // threads 0..63: the chunk's lse; 64..127: its Dr (zero beyond n)
      const int i = tid & (BC - 1), row = row0 + i;
      const long long off = vec_row(a) + (row < p.n ? row : 0);
      cp_async4(smem_u32((tid < BC ? lse_s : dr_s) + slot * BC + i),
                (tid < BC ? p.lse : p.dr) + off, row < p.n);
    }
  };

  Pos cur = {g0 / tiles / p.H, g0 / tiles % p.H, g0 % tiles};
  Pos ahead = cur;  // the step `period` steps after the present one, and its chunk
  int ac = 0;
  load_row_ops(cur, 0);
  cp_async_commit();
  for (int i = 0; i < period; ++i) {
    if (i < steps) load_chunk(ahead, ac, resident ? ac : i);
    cp_async_commit();
    if (++ac == nc) ac = 0, ahead = next(ahead);
  }

  float acc1[KT][32];               // dQ, or dK
  float acc2[KT][32];               // dV (dk/dv only)
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};  // dq: lse*log2(e) and Dr of the thread's rows
  const int c0 = 2 * (lane & 3);
  bool fresh = true;  // this tile's columns were loaded for it, not kept from the tile before
  for (int s = 0, c = 0, slot = 0, ti = 0; s < steps; ++s) {
    const bool first = c == 0, last = c == nc - 1;
    unsigned char* rb = rows + (ti & 1) * 2 * TILE;
    // dq: the o and dO rows of Dr and the lse of the thread's two rows, issued
    // before the wait so that they are in flight while it lasts
    uint4 ov[2][CPR], dov[2][CPR];
    float lraw[2];
    if (!DKDV && first) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = cur.t * BM + warp * 16 + (lane >> 2) + 8 * r;
        const bool in = row < p.n;
        const bf16* po = in_ptr(OP_O, cur) + (long long)(in ? row : 0) * p.sr[OP_O];
        const bf16* pd = in_ptr(OP_DO, cur) + (long long)(in ? row : 0) * p.sr[OP_DO];
#pragma unroll
        for (int j = 0; j < CPR; ++j) {
          const int ch = (lane & 3) + 4 * j;
          ov[r][j] = in ? *reinterpret_cast<const uint4*>(po + ch * 8) : make_uint4(0, 0, 0, 0);
          dov[r][j] = in ? *reinterpret_cast<const uint4*>(pd + ch * 8) : make_uint4(0, 0, 0, 0);
        }
        lraw[r] = in ? p.lse[vec_row(cur) + row] : 0.f;
      }
    }
    if (first || fresh || !resident) {
      // groups committed after this step's slot load: the loads of the next
      // period - 1 steps, and the next tile's row operands when this tile
      // started within the last period - 1 steps
      cp_async_wait_upto(period - 1 + (resident ? c > 0 : (c >= 1 && c < NS)));
      fence_proxy_async();
      __syncthreads();
    }
    if (first) {
      if (g0 + ti + 1 < g1) load_row_ops(next(cur), (ti + 1) & 1);
      cp_async_commit();
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc1[kt][i] = 0.f;
      if constexpr (DKDV) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc2[kt][i] = 0.f;
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float z = 0.f;
#pragma unroll
          for (int j = 0; j < CPR; ++j) z += dot8(ov[r][j], dov[r][j]);
          z = quad_sum(z);
          rd[r] = z;
          rl[r] = lraw[r] * LOG2E;
          const int row = cur.t * BM + warp * 16 + (lane >> 2) + 8 * r;
          if ((lane & 3) == 0 && row < p.n) p.dr[vec_row(cur) + row] = z;
        }
      }
    }

    // S = R1 C1^T and dP = R2 C2^T, one group
    const uint32_t ra = smem_u32(rb), ca = smem_u32(cols + slot * 2 * TILE);
    float sc[32], dp[32];  // written whole by the first wgmma of each (scale-d 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss<64>(sc, make_desc(ra + (kk >> 2) * SUB + (kk & 3) * 32),
                   make_desc(ca + (kk >> 2) * SUB + (kk & 3) * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss<64>(dp, make_desc(ra + TILE + (kk >> 2) * SUB + (kk & 3) * 32),
                   make_desc(ca + TILE + (kk >> 2) * SUB + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    // dk/dv: lse*log2(e) and Dr of the thread's 16 columns (queries) 8j + c0 + {0, 1}
    float cl[DKDV ? 16 : 1], cd[DKDV ? 16 : 1];
    if (DKDV) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + slot * BC + 8 * j + c0);
        const float2 d = *reinterpret_cast<const float2*>(dr_s + slot * BC + 8 * j + c0);
        cl[2 * j] = l.x * LOG2E, cl[2 * j + 1] = l.y * LOG2E;
        cd[2 * j] = d.x, cd[2 * j + 1] = d.y;
      }
    }
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    // sc[4j], sc[4j+1]: row lane/4, columns 8j + c0 + {0, 1}; sc[4j+2], sc[4j+3]: row + 8
    const int nvalid = min(BC, p.n - c * BC);
    uint32_t pp[16], ps[16];  // P and dS, bf16 pairs: the A fragments of the next products
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float pv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * j + e, ci = 2 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
        float pr = ex2(fmaf(sc[i], p.scale_log2, DKDV ? -cl[DKDV ? ci : 0] : -rl[r]));
        if (nvalid < BC && 8 * (i >> 2) + c0 + (i & 1) >= nvalid) pr = 0.f;
        pv[e] = pr;
        dv[e] = pr * (dp[i] - (DKDV ? cd[DKDV ? ci : 0] : rd[r]));
      }
      pp[j] = pack_bf16(pv[0], pv[1]);
      ps[j] = pack_bf16(dv[0], dv[1]);
    }
    wgmma_fence();
    if constexpr (DKDV) {
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)  // dV += P^T dO
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          wgmma_rs64(acc2[kt], pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                     pp[4 * kk + 3], make_desc(ca + TILE + kt * SUB + kk * 2048), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)  // dQ += dS K, or dK += dS^T Q
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        wgmma_rs64(acc1[kt], ps[4 * kk], ps[4 * kk + 1], ps[4 * kk + 2], ps[4 * kk + 3],
                   make_desc(ca + kt * SUB + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait0();
    keep_regs(pp);
    keep_regs(ps);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) fence_regs(acc1[kt]);
    if constexpr (DKDV) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) fence_regs(acc2[kt]);
    }

    if (last) {  // scale, then stage each output in its own row operand's tile and store
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc1[kt][i] *= p.scale;
      __syncthreads();  // every warp's products are done with the row tiles
      const int o1 = DKDV ? OP_DK : OP_DQ;
      store_tile<DP, true>(acc1, rb, p.out[o1 - OP_DQ] + cur.b * p.sb[o1] + cur.h * p.sh[o1],
                           p.sr[o1], cur.t * BM, p.n, DP, warp, lane);
      if constexpr (DKDV)
        store_tile<DP, true>(acc2, rb + TILE,
                             p.out[OP_DV - OP_DQ] + cur.b * p.sb[OP_DV] + cur.h * p.sh[OP_DV],
                             p.sr[OP_DV], cur.t * BM, p.n, DP, warp, lane);
    }

    // the step `period` steps on uses this slot: load it now if it needs other columns
    if (s + period < steps && (!resident || ahead.b != cur.b || ahead.h != cur.h)) {
      __syncthreads();
      load_chunk(ahead, ac, slot);
    }
    cp_async_commit();
    if (++ac == nc) ac = 0, ahead = next(ahead);
    if (last) {
      const Pos nx = next(cur);
      fresh = !resident || nx.b != cur.b || nx.h != cur.h;
      cur = nx, ++ti, c = 0;
    } else {
      ++c;
    }
    slot = resident ? c : (slot + 1 == NS ? 0 : slot + 1);
  }
  cp_async_wait<0>();
}

template <int DP, bool DKDV>
__global__ void __launch_bounds__(attn_core::THREADS, 2) attn_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char bwd_smem_buf[];
  bwd_block<DP, DKDV>(p, bwd_smem_buf);
}

template <int DP, bool DKDV>
cudaError_t launch_bwd_one(const BwdParams& p, unsigned grid, cudaStream_t s) {
  const int smem = (int)bwd_smem<DP, DKDV>();
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_kernel<DP, DKDV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attn_bwd_kernel<DP, DKDV><<<grid, attn_core::THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t s) {
  const long long tiles = (long long)p.heads * ((p.n + attn_core::BM - 1) / attn_core::BM);
  const long long most = (long long)bwd_blocks(DP) * attn_core::sm_count();
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  cudaError_t e = launch_bwd_one<DP, false>(p, grid, s);  // dq and Dr
  if (e != cudaSuccess) return e;
  return launch_bwd_one<DP, true>(p, grid, s);  // dk, dv
}

// blocks of the dq (dkdv = 0) or dk/dv (dkdv = 1) kernel an SM holds
template <int DP>
int bwd_occupancy(int dkdv) {
  int n = 0;
  cudaError_t e;
  if (dkdv) {
    e = cudaFuncSetAttribute(attn_bwd_kernel<DP, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bwd_smem<DP, true>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_bwd_kernel<DP, true>,
                                                        attn_core::THREADS, bwd_smem<DP, true>());
  } else {
    e = cudaFuncSetAttribute(attn_bwd_kernel<DP, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bwd_smem<DP, false>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_bwd_kernel<DP, false>,
                                                        attn_core::THREADS, bwd_smem<DP, false>());
  }
  return e == cudaSuccess ? n : -1;
}

}  // namespace

// ------------------------------------------------------------ K9 on f32 operands
// The kernels and their design note are in attention_f32.cuh: at head dim 64
// f32_fwd_kernel and the one-launch f32_bwd_kernel, at 128 the simple blocks
// (f32_fwd_tile_kernel; f32_bwd_tile_kernel, two launches).
namespace f32k {
namespace {

template <class Kernel>
cudaError_t launch(Kernel kernel, const void* params, long long blocks, size_t smem,
                   cudaStream_t s) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<void*>(params)};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3((unsigned)blocks), dim3(NT),
                       args, smem, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <class Kernel>
int occupancy(Kernel kernel, size_t smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem);
  return e == cudaSuccess ? n : -1;
}

cudaError_t launch_fwd(const Fwd& p, int D, cudaStream_t s) {
  if (D == 64)
    return launch(f32_fwd_kernel, &p, (long long)p.heads * ((p.n + FROWS - 1) / FROWS),
                  fwd_smem(), s);
  if (D == 128)
    return launch(f32_fwd_tile_kernel<128>, &p, (long long)p.heads * ((p.n + T - 1) / T),
                  fwd_tile_smem<128>(), s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_bwd(const Bwd& p, int D, cudaStream_t s) {
  if (D == 64) return launch(f32_bwd_kernel, &p, p.heads, bwd_smem(), s);
  if (D != 128) return cudaErrorInvalidValue;
  const long long blocks = (long long)p.heads * ((p.n + T - 1) / T);
  cudaError_t e = launch(f32_bwd_tile_kernel<128, false>, &p, blocks,  // dq and Dr
                         bwd_tile_smem<128>(), s);
  if (e != cudaSuccess) return e;
  return launch(f32_bwd_tile_kernel<128, true>, &p, blocks, bwd_tile_smem<128>(), s);
}

}  // namespace
}  // namespace f32k

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
  if (pp_takes(p)) return (int)launch_pp(p, B, s);
  switch (D) {
    case 32: return (int)launch_fwd<32>(p, s);
    case 64: return (int)launch_fwd<64>(p, s);
    case 128: return (int)launch_fwd<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the forward kernel an SM holds at sequence length N (-1: D not taken):
// the warp-specialised one where it takes (D, N) with aligned operands.
int sgdm_self_attention_occupancy(int N, int D) {
  if (D == 64 && N <= 256) return pp_occupancy();
  switch (D) {
    case 32: return occupancy<32>(N);
    case 64: return occupancy<64>(N);
    case 128: return occupancy<128>(N);
    default: return -1;
  }
}

// K9 backward.  q, k, v, o, dout, dq, dk, dv: bf16 [B, H, N, D] by element
// strides (batch, head, row; unit stride along D, every row 16-byte aligned):
// `strides` holds the 24 of them in that order.  lse: f32 [B, H, N]
// contiguous, from sgdm_self_attention; dr: f32 [B, H, N] scratch
// (rowsum(dout * o)); scale: the forward's scale2.  D is 64 or 128.
int sgdm_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* dr, void* dq, void* dk,
                       void* dv, int B, int H, int N, int D, const long long* strides, float scale,
                       void* stream) {
  if (B < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * ((N + 63) / 64) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  const void* in[5] = {q, k, v, o, dout};
  void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 5; ++i) p.in[i] = static_cast<const bf16*>(in[i]);
  for (int i = 0; i < 3; ++i) p.out[i] = static_cast<bf16*>(out[i]);
  for (int i = 0; i < 8; ++i)
    p.sb[i] = strides[3 * i], p.sh[i] = strides[3 * i + 1], p.sr[i] = strides[3 * i + 2];
  p.lse = lse, p.dr = dr;
  p.H = H, p.heads = B * H, p.n = N;
  p.scale = scale, p.scale_log2 = scale * attn_core::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bwd<64>(p, s);
    case 128: return (int)launch_bwd<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of a backward kernel (dkdv 0: dq, 1: dk/dv) an SM holds at head dim D.
int sgdm_attention_bwd_occupancy(int D, int dkdv) {
  switch (D) {
    case 64: return bwd_occupancy<64>(dkdv);
    case 128: return bwd_occupancy<128>(dkdv);
    default: return -1;
  }
}

// K3 / K9 forward on f32 operands: as sgdm_self_attention, every tensor f32
// (o as well), any strides with unit stride along D; D is 64 or 128.
int sgdm_self_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int N, int D, const long long* strides, float scale2, float* lse,
                            void* stream) {
  if (B < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * ((N + 63) / 64) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f32k::Fwd p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = lse;
  for (int i = 0; i < 4; ++i)
    p.sb[i] = strides[3 * i], p.sh[i] = strides[3 * i + 1], p.sr[i] = strides[3 * i + 2];
  p.H = H, p.heads = B * H, p.n = N, p.scale = scale2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)f32k::launch_fwd(p, D, s);
}

// K9 backward on f32 operands: as sgdm_attention_bwd, every tensor f32.
int sgdm_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* dr, void* dq, void* dk,
                           void* dv, int B, int H, int N, int D, const long long* strides,
                           float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * ((N + 63) / 64) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f32k::Bwd p = {};
  const void* in[5] = {q, k, v, o, dout};
  void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 5; ++i) p.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < 3; ++i) p.out[i] = static_cast<float*>(out[i]);
  for (int i = 0; i < 8; ++i)
    p.sb[i] = strides[3 * i], p.sh[i] = strides[3 * i + 1], p.sr[i] = strides[3 * i + 2];
  p.lse = lse, p.dr = dr;
  p.H = H, p.heads = B * H, p.n = N, p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)f32k::launch_bwd(p, D, s);
}

// Blocks an SM holds of the f32 kernels of head dim D (bwd 0: the forward;
// 1: the backward, the fewer of its two kernels at D = 128); -1: D not taken.
int sgdm_attention_f32_occupancy(int D, int bwd) {
  if (D == 64) return bwd ? f32k::occupancy(f32k::f32_bwd_kernel, f32k::bwd_smem())
                          : f32k::occupancy(f32k::f32_fwd_kernel, f32k::fwd_smem());
  if (D != 128) return -1;
  if (!bwd) return f32k::occupancy(f32k::f32_fwd_tile_kernel<128>, f32k::fwd_tile_smem<128>());
  const int a = f32k::occupancy(f32k::f32_bwd_tile_kernel<128, false>,
                                f32k::bwd_tile_smem<128>());
  const int b = f32k::occupancy(f32k::f32_bwd_tile_kernel<128, true>,
                                f32k::bwd_tile_smem<128>());
  return a < b ? a : b;
}

}  // extern "C"
