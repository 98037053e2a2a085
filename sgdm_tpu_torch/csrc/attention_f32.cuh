// K9 on f32 operands: the kernels of csrc/attention.cu's f32 entry points
// (sgdm_self_attention_f32: K9's forward and K3's on f32; sgdm_attention_bwd_f32).
//
// They replace, on f32 q, k, v, the library TPU flash attention the training
// step calls (sgdm_tpu/models/layers.py:428, pallas.ops.tpu.flash_attention):
// the noisy-image classifier (models/encoder_unet.py) trains and evaluates in
// f32, its three attention blocks at [B, 8, 256, 64].  Every product is an f32
// FFMA on the CUDA cores and no operand, weight or gradient is rounded, so the
// result is the exact-f32 reference (flash_attention_plain and
// flash_attention_bwd_plain on f32 tensors) up to the order of the sums.
//
// What bounds them on an H100: operations at the f32 peak (67 TFLOP/s, 128
// FFMA a clock and SM).  The forward does 4 N^2 D FLOP a head, the backward
// 10 N^2 D (five N x N x D products: S, dP, dV, dK, dQ); at the classifier's
// shape 0.256 and 0.641 ms, against 0.011 and 0.018 ms of bytes.  Under that
// bound sits a second one: an SM's shared memory delivers 32 floats a clock to
// the lanes of a warp, broadcast or not (a 16-byte load costs 4 clocks
// however few addresses it has), against 128 FFMA.  A product whose operands
// come from shared memory must load at most 0.25 floats an FFMA, and at 0.25
// the two pipes are even; that ratio, not the FFMA count, sets these kernels'
// pace (tools/f32_attention_probe.py measures both ceilings and every part).
//
// Design (head dim 64; 256 threads, 8 warps, one block an SM):
// - Register blocking.  Every product but one is an 8 x 8 micro-tile a thread
//   over a warp tile of 32 rows, lanes (i, j) = (lane / 8, lane % 8) owning
//   rows i + 4r and columns j + 8c.  Operands come from shared memory as
//   16-byte vectors: per four steps of the 64-long reduction a thread loads 16
//   float4 for 256 FFMA, 0.25 floats an FFMA.  The backward's dQ (16 outputs
//   a thread in a 64 x 64 chunk) splits its 128 keys four ways instead, an
//   8 x 8 tile a lane quarter, the quarters summed by two xor shuffles.
// - Layouts.  Tiles read along D (q, k, v, dO, o; the forward's P by rows) are
//   row-major with rows padded to 68 floats, so the 4 (8) neighbouring rows a
//   load touches sit in distinct banks; the forward's V is read along D by
//   columns and kept unpadded.  P, and in the backward P^T and dS^T, go from
//   the micro-tile to shared memory with their columns permuted (column j + 8c
//   to position 8j + c) so each thread writes and the next product reads
//   16-byte vectors; the product that reads them maps positions back to rows
//   of its other operand.  Every access takes the fewest wavefronts its bytes
//   need (tests/test_torch_attention_f32_tiling.py).
// - Asynchronous copies.  Every tile comes by 16-byte cp.async straight from
//   the strided rows (the [B, N, 3, H, D] projection read in place; rows
//   beyond N zero-filled) into a two-stage ring: the next chunk lands while
//   this one is multiplied.  The 227 KB of shared memory hold a block's 256
//   query rows (forward) or 128 key rows (backward), two stages of chunks and
//   the exchange buffers (202 KB, 220 KB): no room for a third stage.
// - Forward (f32_fwd_kernel): a block takes 256 query rows of a head and
//   walks the keys in chunks of 64, so K and V are read once a head at
//   N <= 256 (once per 256 query rows beyond).  Online softmax in natural
//   exponent: running maximum by three xor shuffles, each thread's partial
//   row sum rescaled with it and summed across the row's 8 lanes at the end,
//   O / l and lse = m + log(l) (written for K9 only).  P goes to the warp's
//   own rows of shared memory: __syncwarp, no block barrier; one
//   __syncthreads a chunk.
// - Backward (f32_bwd_kernel): one launch, one block a head, the five
//   products.  The keys go in tiles of 128 (K and V read once) and, for each,
//   the queries in chunks of 64 (q, dO read once a key tile; o and Dr =
//   rowsum(dO o) at the first tile, Dr kept in the dr scratch for the rest).
//   Warps pair up, one of each role on each SM sub-partition: role 0 takes
//   S^T = K Q^T and P^T = exp(scale S^T - lse), then dV += P^T dO; role 1
//   takes dP^T = V dO^T and dS^T = P^T (dP^T - Dr), then dK += dS^T Q.  The
//   pair splits the exponentials and hands P^T over by named barriers; dV and
//   dK stay in registers over the key tile's chunks.  dQ's share of the key
//   tile is added to the tiles' before it in dq itself, in tile order, by the
//   lane that owns those elements (read back, added, stored; scaled at the
//   last tile): no atomics and no scratch, so two runs give the same bits.
//   Role 1 takes dQ before dK and role 0 after dV, so each sub-partition mixes
//   the two.  The two-launch alternative recomputes S and dP, 7 products.
// - Not TF32 and not 3xTF32 on the tensor cores: TF32 rounds q, k, v to a
//   10-bit mantissa (errors near 1e-3 against the 1e-4 the f32 kernels are
//   held to and the exact-f32 plain version), and the split-operand 3xTF32
//   changes the error contract, is measured against another peak, and needs
//   K-major (transposed) copies of V, Q, K and dO for wgmma.  A later option.
//
// Head dim 128 keeps the simple blocks of the first f32 port (the D = 128
// route: f32_fwd_tile_kernel, f32_bwd_tile_kernel): its 8 x 8 micro-tiles of O
// and of dK, dV would not fit the registers.  One (head, 64-row tile) a
// block, 16 x 16 threads, operands padded to D + 1 floats in shared memory;
// the backward in two launches (dq and Dr, then dk and dv).
//
// The kernels and their device code only; the launches are in attention.cu.

#pragma once

#include "hopper.cuh"

namespace f32k {

enum Op { F_Q, F_K, F_V, F_O, F_DO, F_DQ, F_DK, F_DV };

struct Fwd {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // null for K3
  long long sb[4], sh[4], sr[4];  // q, k, v, o
  int H, heads, n;
  float scale;
};

struct Bwd {
  const float* in[5];  // q, k, v, o, dout
  float* out[3];       // dq, dk, dv
  const float* lse;
  float* dr;
  long long sb[8], sh[8], sr[8];  // by Op
  int H, heads, n;
  float scale;
};

// ------------------------------------------------------------ head dim 64

constexpr int NT = 256;       // threads a block
constexpr int LD = 68;        // padded row of a tile read along D (floats)
constexpr int CH = 64;        // keys (forward) or queries (backward) a chunk
constexpr int FROWS = 256;    // forward: query rows a block, 32 a warp
constexpr int KT = 128;       // backward: keys a tile

constexpr size_t fwd_smem() {  // Q, two stages of K and of V, P of each warp
  return (size_t)(FROWS * LD + 2 * CH * (LD + 64) + FROWS * LD) * sizeof(float);
}
constexpr size_t bwd_smem() {  // K, V, two stages of Q and of dO, P^T, dS^T, o of a chunk
  return (size_t)(2 * KT * LD + 4 * CH * LD + 2 * KT * LD + CH * 64) * sizeof(float);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
// reductions over the 8 lanes of a row (lane % 8)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + rows) of a [N, 64] operand with row stride sr into a
// tile with row stride ld, by 16-byte cp.async; rows at or beyond n zero-filled
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          long long sr, int row0, int rows, int n) {
  for (int u = threadIdx.x; u < rows * 16; u += NT) {
    const int r = u >> 4, c = (u & 15) * 4;
    const bool in = row0 + r < n;
    hopper::cp_async16(hopper::smem_u32(dst + r * ld + c),
                       in ? src + (long long)(row0 + r) * sr + c : src, in);
  }
}

// acc[r][c] += A[r * astep + d] . B[c * bstep + d] over d < 64: rows of A and
// B read as float4 along d
template <int R, int C>
__device__ __forceinline__ void dot_rows(float (&acc)[R][C], const float* A, int astep,
                                         const float* B, int bstep) {
#pragma unroll 2
  for (int d = 0; d < 64; d += 4) {
    float4 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = ld4(A + r * astep + d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 b = ld4(B + c * bstep + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][c] = fmaf(a[r].x, b.x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b.y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b.z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b.w, acc[r][c]);
      }
    }
  }
}

// acc[r][4 m + e] += sum over positions u < 64 of A[r * astep + u] *
// B[row_of(u) * bld + 32 m + e]: A read as float4 along u, B as float4 along
// its columns (M blocks of 4, 32 apart)
template <int R, int M, class RowOf>
__device__ __forceinline__ void acc_rows(float (&acc)[R][4 * M], const float* A, int astep,
                                         const float* B, int bld, RowOf row_of) {
#pragma unroll 2
  for (int u = 0; u < 64; u += 4) {
    float4 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = ld4(A + r * astep + u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* brow = B + row_of(u + e) * bld;
      float4 b[M];
#pragma unroll
      for (int m = 0; m < M; ++m) b[m] = ld4(brow + 32 * m);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = lane_of(a[r], e);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc[r][4 * m] = fmaf(x, b[m].x, acc[r][4 * m]);
          acc[r][4 * m + 1] = fmaf(x, b[m].y, acc[r][4 * m + 1]);
          acc[r][4 * m + 2] = fmaf(x, b[m].z, acc[r][4 * m + 2]);
          acc[r][4 * m + 3] = fmaf(x, b[m].w, acc[r][4 * m + 3]);
        }
      }
    }
  }
}

// One block: 256 query rows of one head; warp w rows 32 w.., thread (i, j)
// rows i + 4 r of the warp's, keys j + 8 c of each chunk, O columns 4 j.. and
// 32 + 4 j.. .  Grid: heads x ceil(N / 256).
__global__ void __launch_bounds__(NT, 1) f32_fwd_kernel(const Fwd p) {
  extern __shared__ float4 f32k_smem[];
  float* Qs = reinterpret_cast<float*>(f32k_smem);
  float* Ks = Qs + FROWS * LD;      // two stages of [64][LD]
  float* Vs = Ks + 2 * CH * LD;     // two stages of [64][64]
  float* Ps = Vs + 2 * CH * 64;     // [256][LD]: P of each warp's rows, keys permuted
  const int tiles = (p.n + FROWS - 1) / FROWS;
  const int head = blockIdx.x / tiles, row0 = (blockIdx.x % tiles) * FROWS;
  const int b = head / p.H, h = head % p.H;
  const int warp = threadIdx.x >> 5, i = (threadIdx.x >> 3) & 3, j = threadIdx.x & 7;
  const float* q = p.q + b * p.sb[0] + h * p.sh[0];
  const float* k = p.k + b * p.sb[1] + h * p.sh[1];
  const float* v = p.v + b * p.sb[2] + h * p.sh[2];
  const int nc = (p.n + CH - 1) / CH;
  load_rows(Qs, LD, q, p.sr[0], row0, FROWS, p.n);
  load_rows(Ks, LD, k, p.sr[1], 0, CH, p.n);
  load_rows(Vs, 64, v, p.sr[2], 0, CH, p.n);
  hopper::cp_async_commit();

  const float* Qw = Qs + (warp * 32 + i) * LD;  // row r of the thread at Qw + 4 r LD
  float* Pw = Ps + (warp * 32 + i) * LD;
  float m[8], l[8], acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY, l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    if (c + 1 < nc) {
      load_rows(Ks + ((c + 1) & 1) * CH * LD, LD, k, p.sr[1], (c + 1) * CH, CH, p.n);
      load_rows(Vs + ((c + 1) & 1) * CH * 64, 64, v, p.sr[2], (c + 1) * CH, CH, p.n);
    }
    hopper::cp_async_commit();
    const float* Kc = Ks + (c & 1) * CH * LD;
    const float* Vc = Vs + (c & 1) * CH * 64;
    float s[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[r][e] = 0.f;
    dot_rows<8, 8>(s, Qw, 4 * LD, Kc + j * LD, 8 * LD);
    const int c0 = c * CH;
    const bool ragged = c0 + CH > p.n;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[r][e] = ragged && c0 + j + 8 * e >= p.n ? -INFINITY : s[r][e] * p.scale;
        mx = fmaxf(mx, s[r][e]);
      }
      const float mn = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - mn);  // 0 at the first chunk
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[r][e] = expf(s[r][e] - mn);
        sum += s[r][e];
      }
      l[r] = l[r] * alpha + sum;  // this thread's 8 keys; the row's 8 lanes summed at the end
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
      st4(Pw + 4 * r * LD + 8 * j, s[r][0], s[r][1], s[r][2], s[r][3]);
      st4(Pw + 4 * r * LD + 8 * j + 4, s[r][4], s[r][5], s[r][6], s[r][7]);
    }
    __syncwarp();
    // O += P V: position u holds key (u / 8) + 8 (u % 8)
    acc_rows<8, 2>(acc, Pw, 4 * LD, Vc + 4 * j, 64,
                   [](int u) { return (u >> 3) + 8 * (u & 7); });
  }
  float* o = p.o + b * p.sb[3] + h * p.sh[3];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float lr = row_sum(l[r]);
    const int row = row0 + warp * 32 + i + 4 * r;
    if (row < p.n) {
      float* dst = o + (long long)row * p.sr[3] + 4 * j;
      st4(dst, acc[r][0] / lr, acc[r][1] / lr, acc[r][2] / lr, acc[r][3] / lr);
      st4(dst + 32, acc[r][4] / lr, acc[r][5] / lr, acc[r][6] / lr, acc[r][7] / lr);
      if (p.lse != nullptr && j == 0) p.lse[(long long)head * p.n + row] = m[r] + logf(lr);
    }
  }
}

// One block a head.  Warp w = (g, role) = (w % 4, w / 4), thread (i, j): keys
// 32 g + i + 4 r of the key tile (r < 8) and queries j + 8 c of the chunk
// (c < 8).  Role 0 computes S^T and P^T, then dV (columns 4 j.. and
// 32 + 4 j..); role 1 dP^T and, from its partner's P^T, dS^T, then dK.  P^T
// and dS^T are [key][position], query j + 8 c at 8 j + c.
__global__ void __launch_bounds__(NT, 1) f32_bwd_kernel(const Bwd p) {
  extern __shared__ float4 f32k_smem[];
  float* Ks = reinterpret_cast<float*>(f32k_smem);
  float* Vs = Ks + KT * LD;
  float* Qs = Vs + KT * LD;     // two stages of [64][LD]
  float* DOs = Qs + 2 * CH * LD;
  float* Pt = DOs + 2 * CH * LD;  // [128][LD]
  float* dSt = Pt + KT * LD;
  float* Os = dSt + KT * LD;      // [64][64]: o of the chunk, for Dr (first key tile)
  const int head = blockIdx.x, b = head / p.H, h = head % p.H, n = p.n;
  const int warp = threadIdx.x >> 5, i = (threadIdx.x >> 3) & 3, j = threadIdx.x & 7;
  const int g = warp & 3, role = warp >> 2;  // one warp of each role an SM sub-partition
  // dQ: warp w the chunk's queries w + 8 e (positions 8 w + e), lane quarter
  // k4 = lane / 8 the tile's keys k4, k4 + 4, ..., columns 4 j.. and 32 + 4 j..;
  // the quarters' sums meet by two xor shuffles, each lane keeping 2 queries
  const int k4 = (threadIdx.x >> 3) & 3;
  const int qd = warp + 8 * (4 * (k4 & 1) + 2 * (k4 >> 1));  // its rows qd and qd + 8
  auto ptr = [&](int op) { return p.in[op] + b * p.sb[op] + h * p.sh[op]; };
  const float *q = ptr(F_Q), *k = ptr(F_K), *v = ptr(F_V), *dout = ptr(F_DO);
  float* dq = p.out[0] + b * p.sb[F_DQ] + h * p.sh[F_DQ];
  float* dkv = role ? p.out[1] + b * p.sb[F_DK] + h * p.sh[F_DK]
                    : p.out[2] + b * p.sb[F_DV] + h * p.sh[F_DV];
  const long long sr_kv = role ? p.sr[F_DK] : p.sr[F_DV];
  const float* lv_src = role ? p.dr : p.lse;  // role 0: lse; role 1: Dr
  const long long vec = (long long)head * n;
  const int nq = (n + CH - 1) / CH, steps = (n + KT - 1) / KT * nq;
  const float* o = ptr(F_O);
  load_rows(Ks, LD, k, p.sr[F_K], 0, KT, n);
  load_rows(Vs, LD, v, p.sr[F_V], 0, KT, n);
  load_rows(Qs, LD, q, p.sr[F_Q], 0, CH, n);
  load_rows(DOs, LD, dout, p.sr[F_DO], 0, CH, n);
  load_rows(Os, 64, o, p.sr[F_O], 0, CH, n);
  hopper::cp_async_commit();
  const int kr = 32 * g + i;  // the thread's first key in the tile
  float acc[8][8];            // dV (role 0) or dK (role 1) of the thread's keys
  for (int s = 0; s < steps; ++s) {
    const int kt = s / nq, c = s % nq, k0 = kt * KT, q0 = c * CH;
    if (c == 0 && kt > 0) {
      __syncthreads();  // every warp is done with key tile kt - 1
      load_rows(Ks, LD, k, p.sr[F_K], k0, KT, n);
      load_rows(Vs, LD, v, p.sr[F_V], k0, KT, n);
      hopper::cp_async_commit();
    }
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // chunk s (and key tile kt) is in; step s - 1 is done with its stage, Pt, dSt
    const float* Qc = Qs + (s & 1) * CH * LD;
    const float* DOc = DOs + (s & 1) * CH * LD;
    if (kt == 0) {  // Dr = rowsum(dO o) of the chunk's rows, 16 threads a row
      const int c4 = (threadIdx.x & 15) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 16 * u + (threadIdx.x >> 4);
        const float4 x = ld4(DOc + r * LD + c4), y = ld4(Os + r * 64 + c4);
        float z = fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
#pragma unroll
        for (int sh = 1; sh < 16; sh <<= 1) z += __shfl_xor_sync(0xffffffffu, z, sh);
        if ((threadIdx.x & 15) == 0 && q0 + r < n) p.dr[vec + q0 + r] = z;
      }
      __syncthreads();  // the chunk's Dr is written; o's tile is free
    }
    if (s + 1 < steps) {
      const int c1 = (s + 1) % nq;
      load_rows(Qs + ((s + 1) & 1) * CH * LD, LD, q, p.sr[F_Q], c1 * CH, CH, n);
      load_rows(DOs + ((s + 1) & 1) * CH * LD, LD, dout, p.sr[F_DO], c1 * CH, CH, n);
      if (s + 1 < nq) load_rows(Os, 64, o, p.sr[F_O], c1 * CH, CH, n);
    }
    hopper::cp_async_commit();
    float4 prev[4];  // dQ summed over the key tiles before this one: rows qd, qd + 8
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + qd + 8 * (e >> 1);
      prev[e] = kt > 0 && row < n
                    ? ld4(dq + (long long)row * p.sr[F_DQ] + 32 * (e & 1) + 4 * j)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float lv[8];  // lse (role 0) or Dr (role 1) of the thread's queries
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int row = q0 + j + 8 * e;
      lv[e] = row < n ? lv_src[vec + row] : 0.f;
    }
    float t[8][8];  // role 0: S^T, then P^T; role 1: dP^T, then dS^T
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) t[r][e] = 0.f;
    float* Tt = role ? dSt : Pt;
    auto tile_row = [&](float* T, int r) { return T + (kr + 4 * r) * LD + 8 * j; };
    // The exponentials are split between the pair: role 0 takes rows 0-3 of
    // P^T and hands the exponents of rows 4-7 to role 1 (named barrier 1 + g);
    // role 1 then reads P^T rows 0-3 (named barrier 5 + g)
    if (role == 0) {
      dot_rows<8, 8>(t, Ks + kr * LD, 4 * LD, Qc + j * LD, 8 * LD);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const bool key_in = k0 + kr + 4 * r < n;
#pragma unroll
        for (int e = 0; e < 8; ++e)  // exp(-inf) = 0 beyond N
          t[r][e] = key_in && q0 + j + 8 * e < n ? t[r][e] * p.scale - lv[e] : -INFINITY;
      }
#pragma unroll
      for (int r = 4; r < 8; ++r) {
        st4(tile_row(Pt, r), t[r][0], t[r][1], t[r][2], t[r][3]);
        st4(tile_row(Pt, r) + 4, t[r][4], t[r][5], t[r][6], t[r][7]);
      }
      hopper::named_arrive(1 + g, 64);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) t[r][e] = expf(t[r][e]);
        st4(tile_row(Pt, r), t[r][0], t[r][1], t[r][2], t[r][3]);
        st4(tile_row(Pt, r) + 4, t[r][4], t[r][5], t[r][6], t[r][7]);
      }
      hopper::named_arrive(5 + g, 64);
    } else {
      dot_rows<8, 8>(t, Vs + kr * LD, 4 * LD, DOc + j * LD, 8 * LD);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) t[r][e] -= lv[e];  // dP^T - Dr
      hopper::named_sync(1 + g, 64);  // the exponents of P^T rows 4-7 are in
#pragma unroll
      for (int r = 4; r < 8; ++r) {
        const float4 x0 = ld4(tile_row(Pt, r)), x1 = ld4(tile_row(Pt, r) + 4);
        const float pr[8] = {expf(x0.x), expf(x0.y), expf(x0.z), expf(x0.w),
                             expf(x1.x), expf(x1.y), expf(x1.z), expf(x1.w)};
        st4(tile_row(Pt, r), pr[0], pr[1], pr[2], pr[3]);
        st4(tile_row(Pt, r) + 4, pr[4], pr[5], pr[6], pr[7]);
#pragma unroll
        for (int e = 0; e < 8; ++e) t[r][e] *= pr[e];
      }
      hopper::named_sync(5 + g, 64);  // P^T rows 0-3 are in
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 p0 = ld4(tile_row(Pt, r)), p1 = ld4(tile_row(Pt, r) + 4);
        const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) t[r][e] *= pr[e];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        st4(tile_row(dSt, r), t[r][0], t[r][1], t[r][2], t[r][3]);
        st4(tile_row(dSt, r) + 4, t[r][4], t[r][5], t[r][6], t[r][7]);
      }
    }
    __syncthreads();  // the chunk's P^T and dS^T are in
    // dV += P^T dO (role 0) or dK += dS^T Q (role 1); position u holds query
    // (u / 8) + 8 (u % 8)
    auto kv_product = [&]() {
      acc_rows<8, 2>(acc, Tt + kr * LD, 4 * LD, (role ? Qc : DOc) + 4 * j, LD,
                     [](int u) { return (u >> 3) + 8 * (u & 7); });
    };
    // this key tile's share of dQ, added to the tiles' before it
    auto dq_share = [&]() {
      float dqa[8][8];  // queries warp + 8 e, columns 4 j + f and 32 + 4 j + f (4 + f)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int f = 0; f < 8; ++f) dqa[e][f] = 0.f;
#pragma unroll 2
      for (int key = k4; key < KT; key += 4) {
        const float4 d0 = ld4(dSt + key * LD + 8 * warp);
        const float4 d1 = ld4(dSt + key * LD + 8 * warp + 4);
        const float4 b0 = ld4(Ks + key * LD + 4 * j);
        const float4 b1 = ld4(Ks + key * LD + 32 + 4 * j);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = lane_of(e < 4 ? d0 : d1, e & 3);
          dqa[e][0] = fmaf(x, b0.x, dqa[e][0]);
          dqa[e][1] = fmaf(x, b0.y, dqa[e][1]);
          dqa[e][2] = fmaf(x, b0.z, dqa[e][2]);
          dqa[e][3] = fmaf(x, b0.w, dqa[e][3]);
          dqa[e][4] = fmaf(x, b1.x, dqa[e][4]);
          dqa[e][5] = fmaf(x, b1.y, dqa[e][5]);
          dqa[e][6] = fmaf(x, b1.z, dqa[e][6]);
          dqa[e][7] = fmaf(x, b1.w, dqa[e][7]);
        }
      }
      // quarter k4 keeps rows 4 (k4 % 2) + 2 (k4 / 2) + {0, 1}: it hands the
      // other half of its rows to lane ^ 8, then half of the rest to lane ^ 16
      const int h1 = 4 * (k4 & 1), h2 = 2 * (k4 >> 1);
      float r1[4][8];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float mine = h1 ? dqa[4 + e][f] : dqa[e][f];
          const float give = h1 ? dqa[e][f] : dqa[4 + e][f];
          r1[e][f] = mine + __shfl_xor_sync(0xffffffffu, give, 8);
        }
      const float mul = k0 + KT >= n ? p.scale : 1.f;  // the last key tile scales the sum
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float r2[8];
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float mine = h2 ? r1[2 + e][f] : r1[e][f];
          const float give = h2 ? r1[e][f] : r1[2 + e][f];
          r2[f] = mine + __shfl_xor_sync(0xffffffffu, give, 16);
        }
        const int row = q0 + qd + 8 * e;
        if (row < n) {
          float* dst = dq + (long long)row * p.sr[F_DQ] + 4 * j;
          const float4 a0 = prev[2 * e], a1 = prev[2 * e + 1];
          st4(dst, (a0.x + r2[0]) * mul, (a0.y + r2[1]) * mul, (a0.z + r2[2]) * mul,
              (a0.w + r2[3]) * mul);
          st4(dst + 32, (a1.x + r2[4]) * mul, (a1.y + r2[5]) * mul, (a1.z + r2[6]) * mul,
              (a1.w + r2[7]) * mul);
        }
      }
    };
    // one warp of each role an SM sub-partition: dQ beside the other's product
    if (role) {
      dq_share();
      kv_product();
    } else {
      kv_product();
      dq_share();
    }
    if (c == nq - 1) {  // the key tile's dV (role 0) or dK (role 1)
      const float mk = role ? p.scale : 1.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = k0 + kr + 4 * r;
        if (row < n) {
          float* dst = dkv + (long long)row * sr_kv + 4 * j;
          st4(dst, acc[r][0] * mk, acc[r][1] * mk, acc[r][2] * mk, acc[r][3] * mk);
          st4(dst + 32, acc[r][4] * mk, acc[r][5] * mk, acc[r][6] * mk, acc[r][7] * mk);
        }
      }
    }
  }
}

// ----------------------------------------------- head dim 128 (the D = 128 route)
// One (head, 64-row tile) a block: 256 threads, thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4) of each 64 x 64 product tile, so a
// row's 16 threads are one half-warp and its maximum and sum are four xor
// shuffles.  Operands staged in shared memory, rows padded to D + 1 floats.

constexpr int T = 64;

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, long long sr,
                                          int row0, int n) {
  for (int idx = threadIdx.x; idx < T * D; idx += NT) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    dst[r * (D + 1) + c] = row < n ? src[(long long)row * sr + c] : 0.f;
  }
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D, A and B padded tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* B, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][c] += sum_r P[ty + 16 i][r] * B[r][tx + 16 c] over the tile's 64 r;
// P is [64][T + 1], B a padded tile
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* P, const float* B,
                                         int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < T; ++r) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(ty + 16 * i) * (T + 1) + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float bv = B[r * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], bv, acc[i][c]);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float (&acc)[4][D / 16], float mul, float* out,
                                           long long sr, int row0, int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < n)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) out[(long long)row * sr + tx + 16 * c] = acc[i][c] * mul;
  }
}

template <int D>
constexpr size_t fwd_tile_smem() {
  return (size_t)(3 * T * (D + 1) + T * (T + 1)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT) f32_fwd_tile_kernel(const Fwd p) {
  extern __shared__ float4 f32k_smem[];
  float* Qs = reinterpret_cast<float*>(f32k_smem);
  float* Ks = Qs + T * (D + 1);
  float* Vs = Ks + T * (D + 1);
  float* Ps = Vs + T * (D + 1);
  const int tiles = (p.n + T - 1) / T;
  const int head = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int b = head / p.H, h = head % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = p.q + b * p.sb[0] + h * p.sh[0];
  const float* k = p.k + b * p.sb[1] + h * p.sh[1];
  const float* v = p.v + b * p.sb[2] + h * p.sh[2];
  load_tile<D>(Qs, q, p.sr[0], t * T, p.n);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY, l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  for (int c0 = 0; c0 < p.n; c0 += T) {
    __syncthreads();  // the last chunk's Ks, Vs and Ps are read
    load_tile<D>(Ks, k, p.sr[1], c0, p.n);
    load_tile<D>(Vs, v, p.sr[2], c0, p.n);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = c0 + tx + 16 * j < p.n ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - mn);  // 0 at the first chunk
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * (T + 1) + tx + 16 * j] = e;
        sum += e;
      }
      l[i] = l[i] * alpha + half_sum(sum);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_acc<D>(acc, Ps, Vs, ty, tx);
  }
  float* o = p.o + b * p.sb[3] + h * p.sh[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t * T + ty + 16 * i;
    if (row < p.n) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c) o[(long long)row * p.sr[3] + tx + 16 * c] = acc[i][c] / l[i];
      if (p.lse != nullptr && tx == 0) p.lse[(long long)head * p.n + row] = m[i] + logf(l[i]);
    }
  }
}

template <int D>
constexpr size_t bwd_tile_smem() {
  return (size_t)(4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T) * sizeof(float);
}

// dq (DKDV false): rows are a tile of queries, columns chunks of keys;
// dk/dv (DKDV true): rows are a tile of keys, columns chunks of queries.
// Either way S holds logits [query][key]: in the dk/dv kernel the thread's
// s[i][j] is (key ty + 16 i, query tx + 16 j).
template <int D, bool DKDV>
__global__ void __launch_bounds__(NT) f32_bwd_tile_kernel(const Bwd p) {
  extern __shared__ float4 f32k_smem[];
  constexpr int R1 = DKDV ? F_K : F_Q, R2 = DKDV ? F_V : F_DO;
  constexpr int C1 = DKDV ? F_Q : F_K, C2 = DKDV ? F_DO : F_V;
  float* R1s = reinterpret_cast<float*>(f32k_smem);
  float* R2s = R1s + T * (D + 1);
  float* C1s = R2s + T * (D + 1);
  float* C2s = C1s + T * (D + 1);
  float* Ps = C2s + T * (D + 1);   // P (dk/dv: P^T by rows of keys)
  float* Ss = Ps + T * (T + 1);    // dS likewise
  float* lse_s = Ss + T * (T + 1);  // dk/dv: the chunk's lse and Dr
  float* dr_s = lse_s + T;
  const int tiles = (p.n + T - 1) / T;
  const int head = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int b = head / p.H, h = head % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  auto ptr = [&](int op) { return p.in[op] + b * p.sb[op] + h * p.sh[op]; };
  const long long vec = (long long)head * p.n;
  load_tile<D>(R1s, ptr(R1), p.sr[R1], t * T, p.n);
  load_tile<D>(R2s, ptr(R2), p.sr[R2], t * T, p.n);
  float rl[4], rd[4];  // dq: lse and Dr of the thread's rows
  if (!DKDV) {
    __syncthreads();
    const float* o = ptr(F_O);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = t * T + r;
      float z = 0.f;
      if (row < p.n)
#pragma unroll
        for (int c = 0; c < D / 16; ++c)
          z = fmaf(R2s[r * (D + 1) + tx + 16 * c], o[(long long)row * p.sr[F_O] + tx + 16 * c], z);
      rd[i] = half_sum(z);
      rl[i] = row < p.n ? p.lse[vec + row] : 0.f;
      if (tx == 0 && row < p.n) p.dr[vec + row] = rd[i];
    }
  }
  float acc1[4][D / 16], acc2[4][D / 16];  // dQ or dK; dV
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc1[i][c] = acc2[i][c] = 0.f;
  for (int c0 = 0; c0 < p.n; c0 += T) {
    __syncthreads();
    load_tile<D>(C1s, ptr(C1), p.sr[C1], c0, p.n);
    load_tile<D>(C2s, ptr(C2), p.sr[C2], c0, p.n);
    if (DKDV && threadIdx.x < 2 * T) {
      const int i = threadIdx.x & (T - 1), row = c0 + i;
      const float* src = threadIdx.x < T ? p.lse : p.dr;
      (threadIdx.x < T ? lse_s : dr_s)[i] = row < p.n ? src[vec + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, R1s, C1s, ty, tx);   // dq: q.k; dk/dv: k.q
    tile_dot<D>(dp, R2s, C2s, ty, tx);  // dq: dO.v; dk/dv: v.dO
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float lse = DKDV ? lse_s[col] : rl[i], dr = DKDV ? dr_s[col] : rd[i];
        const float pr = c0 + col < p.n ? expf(s[i][j] * p.scale - lse) : 0.f;
        if (DKDV) Ps[(ty + 16 * i) * (T + 1) + col] = pr;
        Ss[(ty + 16 * i) * (T + 1) + col] = pr * (dp[i][j] - dr);
      }
    __syncthreads();
    if (DKDV) tile_acc<D>(acc2, Ps, C2s, ty, tx);  // dV += P^T dO
    tile_acc<D>(acc1, Ss, C1s, ty, tx);            // dQ += dS K, or dK += dS^T Q
  }
  const int o1 = DKDV ? F_DK : F_DQ;
  store_rows<D>(acc1, p.scale, p.out[o1 - F_DQ] + b * p.sb[o1] + h * p.sh[o1], p.sr[o1], t * T,
                p.n, ty, tx);
  if (DKDV)
    store_rows<D>(acc2, 1.f, p.out[F_DV - F_DQ] + b * p.sb[F_DV] + h * p.sh[F_DV], p.sr[F_DV],
                  t * T, p.n, ty, tx);
}

}  // namespace f32k
