// Shared core of the two attention forward kernels for Hopper (sm_90a):
// csrc/attention.cu (attn_kernel: K3 and the forward of K9) and
// csrc/null_kv_attention.cu (null_kv_kernel: K7).  Both compute, for one
// "head" (a (batch, head) pair of self-attention; a batch item of the
// multi-query attention, whose rows are its pixels x heads),
//
//   out[r, :] = softmax(scale * q[r, :] . k^T) v          r < nq, nk keys,
//
// with f32 logits and softmax, the weights rounded to bf16 for the second
// product, f32 accumulation and one cast of the output.  K9's backward
// (csrc/attention.cu bwd_block) builds on the same tiles, loads and stores
// (load_rows, store_tile) and on the PTX wrappers of csrc/hopper.cuh.
//
// Design.  A block is ONE warpgroup (128 threads); the grid is two blocks for
// every SM (registers: 2 x 128 threads x 203; shared memory: see plan), so
// one block's loads and softmax overlap the other's tensor-core work.  Each
// block walks over one contiguous run of the launch's (head, 64-row query
// tile) pairs, so a head's K and V are loaded by as few blocks as possible.
//   * Both products are wgmma.  S = Q K^T reads Q and K as K-major tiles
//     from shared memory (rows of 64 bf16 = 128 bytes, 128-byte swizzle,
//     8-row groups 1024 bytes apart; head dim 128 is two such sub-tiles, head
//     dim 32 uses the first two k16 slices of a 64-wide tile whose other
//     columns are zero).  O = P V takes P from registers: the f32 accumulator
//     fragment of S, packed to bf16 pairs, IS the A fragment of the next
//     wgmma (rows lane/4 and lane/4+8 of the warp's 16, column pairs
//     8j + 2(lane%4)); V [keys, 64] is the MN-major B operand (trans-b) of an
//     m64n64k16 per 64-column sub-tile, so no leading-dimension offset is
//     relied on.  Nothing of S or P ever touches shared memory.
//   * Keys come in chunks of BN = 256 (128 at head dim 128: the accumulators
//     of S and O must fit 255 registers).  The chunk's wgmma is as wide as
//     its real keys need: N = 32, 64, 128 or 256 (width_class), so M = 273
//     costs 256 + 32 key columns, not 320.  Tail keys are zero rows, masked to
//     -inf before the row maximum, and exact zeros in P.
//   * Softmax in registers: row max and sum by two quad shuffles (four
//     partial maxima and sums a row keep the dependency chains short), ONE
//     ex2 per element with scale*log2(e) folded into an fma, one reciprocal
//     per row.  With one chunk (nk <= BN: the main self-attention shape) the
//     weights are normalised in f32 and then rounded to bf16, the TPU
//     kernel's rounding.  With more chunks the running maximum and sum are
//     carried (online softmax): the UNNORMALISED weights exp2(s - m_run) are
//     rounded to bf16, O is rescaled when the maximum moves and divided by
//     the sum at the end.  That differs from the plain version by bf16 ulps
//     of the weights (2^-9 relative each, averaged over the row) and stays
//     well inside the 2^-6 tolerance the kernels are held to.
//   * Loads are cp.async, 16 bytes a thread, written straight to the
//     swizzled address (src-size 0 zero-fills rows beyond the end).  When a
//     head's keys fit the buffers (nk <= 2 BN) K and V are loaded once per
//     head and stay while the block walks over its tiles; the next head's K
//     is loaded as soon as the last S of this head is done and its V as soon
//     as the last P V is, so both arrive under the softmax, the stores and the
//     next S.  Longer rows stream: each chunk's K and V load over the last
//     one's in the same way.  The next tile's Q always loads during the
//     present tile, and V of the first step is still in flight while S and
//     the softmax run.  The block barriers that guard a buffer are taken only
//     in the steps that load into it: one barrier a tile in the steady state.
//   * The time a warp would wait for the first S product of a tile is used:
//     the tile before it is stored then (its O stays in registers until
//     there), and the next tile's Q loads are issued.  The output tile is
//     staged in its own (now free) Q buffer and stored with 16-byte coalesced
//     writes.  Each warp loads, stages and stores its own 16 rows of a Q
//     buffer, so reusing the buffer needs only the order inside the warp.
//     Every operand has element strides for batch, head and row, so permuted
//     views are read and written in place.
//   * Head dims that are not multiples of 8 (rows not 16-byte aligned) load
//     and store element by element through the same tiles (VEC = false).
//   * The bookkeeping of where a tile is (batch item, head, tile) counts up
//     and never divides: a 64-bit division costs about a thousand cycles of
//     a warp's dependent instructions, as much as a tile's two products.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn_core {

using namespace hopper;  // the PTX wrappers

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;            // query rows per tile: one wgmma M
constexpr int THREADS = 128;      // one warpgroup
constexpr int SUB = BM * 128;     // bytes of a 64-row x 64-column bf16 sub-tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// keys per chunk, and columns of a shared-memory tile, at padded head dim dp
__host__ __device__ constexpr int chunk_keys(int dp) { return dp > 64 ? 128 : 256; }
__host__ __device__ constexpr int tile_width(int dp) { return dp < 64 ? 64 : dp; }
// the wgmma N (and the rows loaded) for a chunk with n real keys
__host__ __device__ constexpr int width_class(int n) {
  return n <= 32 ? 32 : (n <= 64 ? 64 : (n <= 128 ? 128 : 256));
}

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // f32 [heads, nq] natural-log row log-sum-exp of the scaled logits, or null
  long long q_sb, q_sh, q_sr;  // element strides: batch, head, row (unit stride along d)
  long long k_sb, k_sh, k_sr;
  long long v_sb, v_sh, v_sr;
  long long o_sb, o_sh, o_sr;
  int H;                // heads per batch item: head index = b * H + h
  int heads;            // batch items times H; heads times tiles fits an int
  int nq, nk, d;        // query rows and keys per head, real head dim
  int kv_rows;          // rows of the K (and of the V) buffer in shared memory
  int resident;         // all keys of a head fit the buffer: loaded once per head
  float scale_log2;     // logit scale times log2(e)
};

// What a block keeps in shared memory, the bytes that takes, and the grid:
// two blocks for every SM (fewer when there are fewer tiles), each walking over
// one contiguous run of the launch's (head, 64-row tile) pairs, so that a
// head's K and V are loaded by as few blocks as possible.
inline size_t plan(Params& p, int dp, int sm_count, unsigned* grid) {
  const int bn = chunk_keys(dp), kt = tile_width(dp) / 64;
  const int nc = (p.nk + bn - 1) / bn;
  p.resident = nc <= 2;
  p.kv_rows = p.resident ? (nc - 1) * bn + width_class(p.nk - (nc - 1) * bn) : bn;
  const long long tiles = (long long)p.heads * ((p.nq + BM - 1) / BM);
  *grid = (unsigned)(tiles < 2LL * sm_count ? tiles : 2LL * sm_count);
  // 1 KB to align the tiles to the swizzle atom; two Q buffers; K and V
  return 1024 + (size_t)kt * 128 * (2 * BM + 2 * p.kv_rows);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// ------------------------------------------------------------ the block

// rows [row0, row0 + nrows) of a [total, d] matrix (row stride `sr`) into the
// swizzled tile at `tile` (sub-tiles `sub_bytes` apart; `tile` at a multiple of 8
// rows), by thread t of nt; zero beyond `total` and beyond column d
template <int DP, bool VEC>
__device__ __forceinline__ void load_rows(unsigned char* tile, int sub_bytes,
                                          const bf16* __restrict__ src, long long sr, int row0,
                                          int nrows, int total, int d, int t, int nt) {
  constexpr int CH = tile_width(DP) / 8;  // 16-byte chunks per row
  for (int i = t; i < nrows * CH; i += nt) {
    const int r = i / CH, c = i - r * CH;
    unsigned char* dst = tile + (c >> 3) * sub_bytes + swz(r, c & 7);
    const bool in = row0 + r < total && c * 8 < d;
    if (VEC) {
      cp_async16(smem_u32(dst), in ? src + (long long)(row0 + r) * sr + c * 8 : src, in);
    } else {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (in) {
        const bf16* p = src + (long long)(row0 + r) * sr + c * 8;
        bf16* e = reinterpret_cast<bf16*>(&val);
        for (int j = 0; j < 8 && c * 8 + j < d; ++j) e[j] = p[j];
      }
      *reinterpret_cast<uint4*>(dst) = val;
    }
  }
}

// The softmax of one chunk of NW key columns (nvalid real) in the S
// accumulators s: masks the tail keys, carries the row maximum m and sum l
// (alpha: the factor an O accumulated over earlier chunks is rescaled by),
// exponentiates in place and, with one chunk (single), normalises in f32.
template <int NW>
__device__ __forceinline__ void softmax_chunk(float (&s)[NW / 2], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], int nvalid, float sl2,
                                              bool single, int lane) {
  // s[4j], s[4j+1]: row lane/4, columns 8j + 2(lane%4) + {0, 1}; s[4j+2], s[4j+3]: row + 8
  if (nvalid < NW) {
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i)
      if (8 * (i >> 2) + c0 + (i & 1) >= nvalid) s[i] = -INFINITY;
  }
  // four partial maxima and sums a row (columns 8j + .. by j % 4): short dependency chains
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[r][j] = -INFINITY, sum[r][j] = 0.f;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn =
        fmaxf(m[r], quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]))));
    alpha[r] = ex2((m[r] - mn) * sl2);  // 0 at the first chunk (m = -inf)
    m[r] = mn;
    ms[r] = mn * sl2;
  }
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    s[i] = ex2(fmaf(s[i], sl2, -ms[(i >> 1) & 1]));
    sum[(i >> 1) & 1][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  if (single) {  // one chunk: normalise in f32, then round (the TPU kernel's order)
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) s[i] *= inv[(i >> 1) & 1];
  }
}

// One chunk of NW key columns (nvalid real) against the 64-row Q tile: S,
// softmax (carried m, l when there are more chunks), O += P V.
template <int DP, int NW, class DuringS, class AfterS, class AfterPV>
__device__ __forceinline__ void chunk_step(float (&o)[tile_width(DP) / 64][32], float (&m)[2],
                                           float (&l)[2], uint32_t q_addr, uint32_t k_addr,
                                           uint32_t v_addr, uint32_t sub_kv, int nvalid,
                                           float sl2, bool first, bool single, int v_behind,
                                           int lane, DuringS during_s, AfterS after_s,
                                           AfterPV after_pv) {
  constexpr int KT = tile_width(DP) / 64, KS = DP / 16;
  float s[NW / 2];  // written whole by the first wgmma (scale-d 0)
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<NW>(s, make_desc(q_addr + (kk >> 2) * SUB + (kk & 3) * 32),
                 make_desc(k_addr + (kk >> 2) * sub_kv + (kk & 3) * 32), kk > 0);
  wgmma_commit();
  during_s();  // the warps would only wait: issue the next tile's Q loads meanwhile
  wgmma_wait0();
  fence_regs(s);
  after_s();  // loads the next K once every warp is done with this one

  float alpha[2];
  softmax_chunk<NW>(s, m, l, alpha, nvalid, sl2, single, lane);
  if (!single && !first) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[kt][i] *= alpha[(i >> 1) & 1];
  }
  uint32_t pa[NW / 4];
#pragma unroll
  for (int j = 0; j < NW / 4; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);

  if (v_behind >= 0) {  // V was loaded for this step; v_behind groups were committed after it
    if (v_behind == 0) cp_async_wait<0>();
    else if (v_behind == 1) cp_async_wait<1>();
    else cp_async_wait<2>();
    fence_proxy_async();
    __syncthreads();
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk)
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      wgmma_rs64(o[kt], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                 make_desc(v_addr + kt * sub_kv + kk * 2048), 1);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) fence_regs(o[kt]);
  after_pv();  // loads the next V once every warp is done with this one
}

// the warp's 16 rows of the output tile: registers -> `stage` (swizzled, this
// warp's rows only) -> device memory, 16 bytes a thread
template <int DP, bool VEC>
__device__ __forceinline__ void store_tile(float (&o)[tile_width(DP) / 64][32],
                                           unsigned char* stage, bf16* __restrict__ out,
                                           long long sr, int row0, int total, int d, int warp,
                                           int lane) {
  constexpr int KT = tile_width(DP) / 64;
  const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned char* base = stage + kt * SUB + (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(base + swz(r0, j)) = pack_bf16(o[kt][4 * j], o[kt][4 * j + 1]);
      *reinterpret_cast<uint32_t*>(base + swz(r0 + 8, j)) =
          pack_bf16(o[kt][4 * j + 2], o[kt][4 * j + 3]);
    }
  __syncwarp();
  if (VEC) {
    constexpr int CH = DP / 8;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = warp * 16 + i / CH, c = i % CH;
      if (row0 + r < total && c * 8 < d)
        *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * sr + c * 8) =
            *reinterpret_cast<const uint4*>(stage + (c >> 3) * SUB + swz(r, c & 7));
    }
  } else {
    for (int i = lane; i < 16 * d; i += 32) {
      const int r = warp * 16 + i / d, c = i % d;
      if (row0 + r < total)
        out[(long long)(row0 + r) * sr + c] = *reinterpret_cast<const bf16*>(
            stage + (c >> 6) * SUB + swz(r, (c & 63) >> 3) + (c & 7) * 2);
    }
  }
}

// The whole block.  It walks over the (head, tile) pairs [g0, g1) of the launch,
// a step being one (tile, key chunk) pair.  Three kinds of load are in flight
// around a step s, each committed as its own cp.async group, in this order:
//   Q of the next tile      issued under the S product of the tile's first step;
//   K of step s + 1         issued once every warp has finished S of step s;
//   V of step s + 1         issued once every warp has finished P V of step s;
// K and V only when step s + 1 needs other keys than step s (another head,
// or, when a head's keys do not fit the buffer, another chunk), and the block
// barriers that guard them only then; no empty group is committed.  A tile's
// output is stored under the first S product of the next tile.  So at
// the top of a step everything must have landed but the step's own V, when
// one was loaded (the newest group then), and before P V all but the groups
// committed after that V (the next Q, the next K: none, one or two).
template <int DP, bool VEC>
__device__ __forceinline__ void attention_block(const Params& p, unsigned char* smem_raw) {
  constexpr int BN = chunk_keys(DP), KT = tile_width(DP) / 64;
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* Qs = smem;  // two buffers of KT sub-tiles
  unsigned char* Ks = Qs + 2 * KT * SUB;
  const int sub_kv = p.kv_rows * 128;
  unsigned char* Vs = Ks + KT * sub_kv;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (p.nq + BM - 1) / BM;  // per head
  const int total = p.heads * tiles;
  const int g0 = (int)((long long)total * blockIdx.x / gridDim.x);
  const int g1 = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  const int nc = (p.nk + BN - 1) / BN;
  const int steps = (g1 - g0) * nc;
  const bool single = nc == 1;

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
  // each warp loads (and later stages and stores) its own 16 rows of a Q tile, so
  // reusing a Q buffer needs no block barrier: the order inside the warp is enough
  auto load_q = [&](Pos a, int buf) {
    load_rows<DP, VEC>(Qs + buf * KT * SUB + warp * 16 * 128, SUB,
                       p.q + a.b * p.q_sb + a.h * p.q_sh, p.q_sr, a.t * BM + warp * 16, 16, p.nq,
                       p.d, lane, 32);
  };
  // the keys a step needs: all of its head's when they fit, else its chunk c
  auto load_kv = [&](unsigned char* dst, const bf16* ptr, long long sr, int c) {
    const int row0 = p.resident ? 0 : c * BN;
    const int rows = p.resident ? p.kv_rows : width_class(min(BN, p.nk - row0));
    load_rows<DP, VEC>(dst, sub_kv, ptr, sr, row0, rows, p.nk, p.d, tid, THREADS);
  };

  Pos cur = {g0 / tiles / p.H, g0 / tiles % p.H, g0 % tiles}, prev = cur;
  float o[KT][32], m[2], l[2];
  // the tile at `a`, whose O, m and l are in registers: the division (more chunks
  // than one), the log-sum-exp, and the store through the tile's own Q buffer
  auto finish_tile = [&](Pos a, int buf) {
    if (!single) {
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[kt][i] *= inv[(i >> 1) & 1];
    }
    const int row0 = a.t * BM;
    if (p.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + warp * 16 + (lane >> 2) + 8 * r;
        if (row < p.nq)
          p.lse[((long long)a.b * p.H + a.h) * p.nq + row] =
              m[r] * p.scale_log2 * LN2 + logf(l[r]);
      }
    }
    store_tile<DP, VEC>(o, Qs + buf * KT * SUB, p.o + a.b * p.o_sb + a.h * p.o_sh, p.o_sr, row0,
                        p.nq, p.d, warp, lane);
  };
  load_q(cur, 0);
  load_kv(Ks, p.k + cur.b * p.k_sb + cur.h * p.k_sh, p.k_sr, 0);
  cp_async_commit();
  load_kv(Vs, p.v + cur.b * p.v_sb + cur.h * p.v_sh, p.v_sr, 0);
  cp_async_commit();
  bool v_fresh = true;  // were K and V loaded for this step (not kept from the last)?
  for (int s = 0, ti = 0, c = 0; s < steps; ++s) {
    const Pos nxt = next(cur);  // the tile after this one
    const bool last = c == nc - 1, more = s + 1 < steps;
    // does step s + 1 need other keys than step s, and whose?
    const bool other_keys = more && (!p.resident || (last && (nxt.h != cur.h || nxt.b != cur.b)));
    const Pos kvp = last ? nxt : cur;
    const int kvc = last ? 0 : c + 1;
    if (c == 0 || v_fresh) {  // a new Q tile, or new keys
      if (v_fresh) cp_async_wait<1>();  // Q and K of this step; its V may still be in flight
      else cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    const bool next_q = c == 0 && g0 + ti + 1 < g1;
    // groups committed after this step's V by the time P V waits for it
    const int v_behind = v_fresh ? (int)next_q + (int)other_keys : -1;
    // While the first S product of a tile runs the warps would only wait: they
    // store the tile before (its O, maximum and sum are still in registers; it is
    // staged in its own Q buffer), then load the next tile's Q over that buffer.
    auto during_s = [&]() {
      if (c == 0) {
        if (ti > 0) finish_tile(prev, (ti - 1) & 1);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[kt][i] = 0.f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
      }
      if (next_q) {
        __syncwarp();
        load_q(nxt, (ti + 1) & 1);
        cp_async_commit();
      }
    };
    const int nvalid = min(BN, p.nk - c * BN);
    const int slot = p.resident ? c * BN * 128 : 0;
    unsigned char* Qt = Qs + (ti & 1) * KT * SUB;
    const uint32_t qa = smem_u32(Qt), ka = smem_u32(Ks + slot), va = smem_u32(Vs + slot);
    auto after_s = [&]() {
      if (other_keys) {
        __syncthreads();
        load_kv(Ks, p.k + kvp.b * p.k_sb + kvp.h * p.k_sh, p.k_sr, kvc);
        cp_async_commit();
      }
    };
    auto after_pv = [&]() {
      if (other_keys) {
        __syncthreads();
        load_kv(Vs, p.v + kvp.b * p.v_sb + kvp.h * p.v_sh, p.v_sr, kvc);
        cp_async_commit();
      }
    };
    switch (width_class(nvalid)) {
      case 32:
        chunk_step<DP, 32>(o, m, l, qa, ka, va, sub_kv, nvalid, p.scale_log2, c == 0, single,
                           v_behind, lane, during_s, after_s, after_pv);
        break;
      case 64:
        chunk_step<DP, 64>(o, m, l, qa, ka, va, sub_kv, nvalid, p.scale_log2, c == 0, single,
                           v_behind, lane, during_s, after_s, after_pv);
        break;
      case 128:
        chunk_step<DP, 128>(o, m, l, qa, ka, va, sub_kv, nvalid, p.scale_log2, c == 0, single,
                            v_behind, lane, during_s, after_s, after_pv);
        break;
      default:
        if constexpr (BN == 256)
          chunk_step<DP, 256>(o, m, l, qa, ka, va, sub_kv, nvalid, p.scale_log2, c == 0, single,
                              v_behind, lane, during_s, after_s, after_pv);
        break;
    }
    if (last) {
      prev = cur, cur = nxt, ++ti, c = 0;
    } else {
      ++c;
    }
    v_fresh = other_keys;
  }
  finish_tile(prev, (g1 - g0 - 1) & 1);
  cp_async_wait<0>();
}

// ------------------------------------------------- the warp-specialised block
// attn_kernel's design for the main shape (head dim 64, one chunk of at most
// 256 keys, every operand a TMA tensor map): a block of three warpgroups, one
// an SM, persistent over a contiguous run of whole heads (so each head's K and
// V are read from device memory once), a head being ceil(N / 128) units, a
// unit a pair of 64-row query tiles (tile 2u to the first consumer, 2u + 1 to
// the second).
//   * Warpgroup 0 is the producer: it gives up registers (setmaxnreg 40), and
//     one thread of its first warp issues the Q loads and one of its second
//     the K and V loads, each on its own, as TMA (cp.async.bulk.tensor,
//     128-byte swizzle, rows beyond N zero-filled by the hardware): the
//     heads' K and V into a ring of two stages (a head ahead), each
//     consumer's Q tiles into a ring of four (three units ahead), every
//     stage behind an mbarrier pair (full: its bytes have landed; empty: the
//     consumers are done with it).  Two threads, so that neither kind of
//     load waits behind the other's ring.
//   * Warpgroups 1 and 2 are the consumers (setmaxnreg 232).  Their products
//     alternate on the tensor cores in ping-pong: a consumer issues S = Q K^T
//     (or O = P V) only after the other has issued its own, through two named
//     barriers, so one's softmax and epilogue run under the other's products.
//   * The epilogue writes O in bf16 over the tile's own Q (read by then) in the
//     swizzled layout, and one thread stores it by TMA (rows beyond N are
//     clipped); the stage goes back to the producer one unit later, once that
//     store has surely read it.  K9's lse goes out from the registers.
constexpr int PP_THREADS = 384;
constexpr int PP_KV_STAGES = 2, PP_Q_STAGES = 4;
constexpr int PP_KV_SLOT = 256 * 128;   // one stage of K (or V): up to 256 keys x 64 dims
constexpr int PP_Q_SLOT = BM * 128;     // a Q tile (and its O): 64 rows x 64 dims
constexpr int PP_OFF_V = PP_KV_STAGES * PP_KV_SLOT;
constexpr int PP_OFF_Q = 2 * PP_KV_STAGES * PP_KV_SLOT;  // [stage][consumer]
constexpr int PP_OFF_BAR = PP_OFF_Q + 2 * PP_Q_STAGES * PP_Q_SLOT;
// barriers (8 bytes each): kv_full[KV], kv_empty[KV], q_full[Q][2], q_empty[Q][2]
constexpr int PP_BAR_KV_EMPTY = 8 * PP_KV_STAGES, PP_BAR_Q_FULL = 16 * PP_KV_STAGES,
              PP_BAR_Q_EMPTY = PP_BAR_Q_FULL + 16 * PP_Q_STAGES;
constexpr size_t PP_SMEM = 1024 + PP_OFF_BAR + PP_BAR_Q_EMPTY + 16 * PP_Q_STAGES;

struct PPParams {
  CUtensorMap tq, tk, tv, to;  // 4-d maps (dims d, row, head, batch) of q, k, v, o
  float* lse;                  // f32 [heads, nq] (K9) or null
  int H, heads, nq, nk;        // heads per batch item, heads in all, query rows, keys
  int kv_rows;                 // rows of a K / V box: width_class(nk)
  float scale_log2;
};

// a ring's position: its stage and the parity of that stage's present use
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

template <int NW>
__device__ __forceinline__ void pp_consumer(const PPParams& p, unsigned char* smem, uint32_t bars,
                                            int c, int head, int n, int pairs) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int mine = 1 + c, other = 2 - c;  // named barriers 1, 2: whose turn on the tensor cores
  int pair = 0, last_q = -1;
  Ring kv, q;
  if (c == 1) named_arrive(1, 256);  // the first consumer goes first
  for (int i = 0; i < n; ++i) {
    const bool last_of_head = pair == pairs - 1;
    const int slot = 2 * q.stage + c;
    unsigned char* qt = smem + PP_OFF_Q + slot * PP_Q_SLOT;
    const uint32_t qa = smem_u32(qt), ka = smem_u32(smem + kv.stage * PP_KV_SLOT);
    const uint32_t va = smem_u32(smem + PP_OFF_V + kv.stage * PP_KV_SLOT);

    // S = Q K^T, in this consumer's turn
    float s[NW / 2];
    named_sync(mine, 256);
    if (pair == 0) mbar_wait(bars + 8 * kv.stage, kv.phase);
    mbar_wait(bars + PP_BAR_Q_FULL + 8 * slot, q.phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<NW>(s, make_desc(qa + kk * 32), make_desc(ka + kk * 32), kk > 0);
    wgmma_commit();
    named_arrive(other, 256);
    wgmma_wait0();
    fence_regs(s);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    softmax_chunk<NW>(s, m, l, alpha, p.nk, p.scale_log2, true, lane);
    uint32_t pa[NW / 4];
#pragma unroll
    for (int j = 0; j < NW / 4; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);

    // O = P V, in this consumer's turn
    float o[32];  // written whole by the first wgmma (scale-d 0)
    named_sync(mine, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk)
      wgmma_rs64(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                 make_desc(va + kk * 2048), kk > 0);
    wgmma_commit();
    if (!(c == 1 && i == n - 1)) named_arrive(other, 256);  // (the last turn is not handed on)
    wgmma_wait0();
    fence_regs(o);
    if (last_of_head) {  // both consumers' last P V of the head: K and V are free
      mbar_arrive(bars + PP_BAR_KV_EMPTY + 8 * kv.stage);
      kv.advance(PP_KV_STAGES);
    }

    // epilogue: O over the tile's Q, out by TMA; then lse from the registers
    const int b = head / p.H, h = head - b * p.H;
    const int row0 = (2 * pair + c) * BM;
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned char* base = qt + (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(base + swz(r0, j)) = pack_bf16(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(base + swz(r0 + 8, j)) = pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
    fence_proxy_async();  // the generic writes, before TMA reads them
    named_sync(3 + c, 128);
    if (tid == 0) {
      tma_store_4d(&p.to, qa, 0, row0, h, b);
      bulk_commit();
      if (last_q >= 0) {  // the last unit's store has read its stage: hand it back
        bulk_wait_read<1>();
        mbar_arrive(bars + PP_BAR_Q_EMPTY + 8 * last_q);
      }
    }
    if (p.lse != nullptr && (lane & 3) == 0) {  // __logf: ~1e-6 absolute, lse ~ 1-10
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r0 + 8 * r;
        if (row < p.nq)
          p.lse[(long long)head * p.nq + row] = m[r] * p.scale_log2 * LN2 + __logf(l[r]);
      }
    }
    last_q = slot;
    q.advance(PP_Q_STAGES);
    if (++pair == pairs) pair = 0, ++head;
  }
  if (tid == 0) bulk_wait0();
}

template <int NW>
__device__ __forceinline__ void pingpong_block(const PPParams& p, unsigned char* smem_raw) {
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t bars = smem_u32(smem + PP_OFF_BAR);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int pairs = ((p.nq + BM - 1) / BM + 1) / 2;
  // this block's heads: [h0, h0 + nh)
  const int h0 = (int)((long long)p.heads * blockIdx.x / gridDim.x);
  const int nh = (int)((long long)p.heads * (blockIdx.x + 1) / gridDim.x) - h0;
  if (tid == 0) {
    for (int s = 0; s < PP_KV_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                      // kv_full: the producer's expect_tx
      mbar_init(bars + PP_BAR_KV_EMPTY + 8 * s, 256);  // kv_empty: every consumer thread
    }
    for (int i = 0; i < 2 * PP_Q_STAGES; ++i) {
      mbar_init(bars + PP_BAR_Q_FULL + 8 * i, 1);   // q_full: the producer's expect_tx
      mbar_init(bars + PP_BAR_Q_EMPTY + 8 * i, 1);  // q_empty: the consumer's storing thread
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (wg == 0) {
    setmaxnreg_dec<40>();
    // waits on an empty barrier take the parity before the use's: a fresh
    // barrier passes at once
    if (tid == 0) {  // the Q tiles, unit by unit
      Ring q;
      for (int head = h0; head < h0 + nh; ++head) {
        const int b = head / p.H, h = head - b * p.H;
        for (int pair = 0; pair < pairs; ++pair) {
          for (int c = 0; c < 2; ++c) {
            const int slot = 2 * q.stage + c;
            const uint32_t full = bars + PP_BAR_Q_FULL + 8 * slot;
            mbar_wait(bars + PP_BAR_Q_EMPTY + 8 * slot, q.phase ^ 1);
            mbar_expect_tx(full, PP_Q_SLOT);
            tma_load_4d(smem_u32(smem + PP_OFF_Q + slot * PP_Q_SLOT), &p.tq, full, 0,
                        (2 * pair + c) * BM, h, b);
          }
          q.advance(PP_Q_STAGES);
        }
      }
    } else if (tid == 32) {  // K and V, head by head
      Ring kv;
      const uint32_t kv_bytes = 2u * p.kv_rows * 128;
      for (int head = h0; head < h0 + nh; ++head) {
        const int b = head / p.H, h = head - b * p.H;
        const uint32_t full = bars + 8 * kv.stage;
        mbar_wait(bars + PP_BAR_KV_EMPTY + 8 * kv.stage, kv.phase ^ 1);
        mbar_expect_tx(full, kv_bytes);
        tma_load_4d(smem_u32(smem + kv.stage * PP_KV_SLOT), &p.tk, full, 0, 0, h, b);
        tma_load_4d(smem_u32(smem + PP_OFF_V + kv.stage * PP_KV_SLOT), &p.tv, full, 0, 0, h, b);
        kv.advance(PP_KV_STAGES);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  pp_consumer<NW>(p, smem, bars, wg - 1, h0, nh * pairs, pairs);
}

}  // namespace attn_core
