// GroupNorm(+FiLM)+SiLU for Hopper (sm_90a):
//   K6  the port of the Pallas TPU kernel sgdm_tpu/ops/pallas/groupnorm.py
//       fused_groupnorm_silu (_apply_kernel, with the statistics that the
//       TPU left to XLA in _group_stats), which the ResBlock's unfused
//       composition calls in sampling mode.
//
//   mean, var = E[x], E[x^2] - mean^2 over (pixels, channels of the group),
//               per sample, var clamped at 0;  rstd = 1 / sqrt(var + eps)
//   A[c]  = rstd * gamma[c] * (1 + fs[b, c])
//   Bc[c] = (beta[c] - mean * rstd * gamma[c]) * (1 + fs[b, c]) + fsh[b, c]
//   out   = bf16(silu(x * A + Bc))                  (FiLM optional)
//
// in f32, rounded once at the end.  x and out are NHWC bf16 [B, HW, C].
//
// What bounds it on an H100: bytes.  The function reads x once and writes out
// once (2 * B*HW*C * 2 bytes) for about 10 operations an element.  The TPU
// kernel left the statistics outside because one sample did not fit VMEM, so
// x was read twice; here a sample fits the shared memory of a thread-block
// cluster (up to 16 blocks of up to 227 KB), and the cluster route reads x
// once:
//
// Cluster route (gn_cluster_kernel, one launch): a cluster of n blocks owns
// one sample at a time, rank r the contiguous pixel run [r*per, min(HW,
// (r+1)*per)), which is contiguous bytes in NHWC; the grid holds as many
// clusters as the card keeps resident, and each walks the samples b = its
// cluster id, + the cluster count, ...  A block is T consumer threads and a
// producer warp.  The producer brings the run into shared memory with 1-D
// TMA (cp.async.bulk) in `stages` pieces, each on its own mbarrier.  The
// consumers sum per-channel f32 (sum x, sum x^2) as each piece lands, every
// thread over its own pixels in increasing order, and fold those to
// per-group partials; one consumer a rank then arrives on that rank's
// exchange mbarrier (a remote arrive, release at cluster scope), every block
// waits on its own, gathers the n ranks' partials over DSMEM and adds them
// in rank order, so every block derives bit-identical statistics whatever
// the timing.  Each consumer folds gamma, beta and FiLM into its channels'
// (A, Bc) and applies them piece by piece from the resident run, 16-byte
// stores to out; once every consumer has read a piece, the producer loads
// the same piece of the cluster's next sample into its place, so the next
// sample lands while this one is applied.  Partials and exchange barriers
// are double-buffered by sample parity: a block rewrites a buffer two
// samples later, after every peer has arrived for the sample between, which
// it does only after its reads; a cluster barrier before exit keeps each
// block's partials alive until its peers' last reads.  Where C % 8 != 0 or
// x is not 16-byte aligned, the consumers copy the run with ordinary loads
// into the same layout.
//
// Split route (gn_split_stats_kernel + gn_split_apply_kernel, for samples
// too large for a cluster): the statistics kernel on a grid of (S slices,
// B) writes per-slice per-channel (sum x, sum x^2) to a scratch tensor; the
// apply kernel on a grid of (chunks, B) reduces its sample's S partials in
// slice order in its prologue (the same sums in every block), then applies
// its pixel chunk.
//
// Thread layout of every pass: with V channels a thread (8, or 1 when
// C % 8 != 0), CV = C / V threads cover one pixel's channels and R =
// blockDim / CV rows of them cover R pixels; thread (j = t % CV, r = t / CV)
// owns channels [j*V, j*V + V) of pixels r, r + R, ...  So its (A, Bc) stay
// in registers, no index is divided per element, and the active threads of
// a step touch R*C contiguous elements.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using sgdm::load8;
using sgdm::pack8;
using sgdm::silu_fast;

constexpr int MAX_STAGES = 4;

struct GnArgs {
  const bf16* x;
  const float* gamma;  // [C]
  const float* beta;   // [C]
  const void* fs;      // FiLM [B, C] (rows film_stride apart, f32 or bf16) or null
  const void* fsh;
  int film_stride, film_bf16;
  bf16* out;
  float* part;         // split route: [B, S, 2, C]
  int HW, C, G;
  float eps;
  int per;             // cluster: pixels a rank; split: pixels a slice
  int stages;          // cluster: TMA pieces of a run
  int tma;             // cluster: 1 when the run is loaded by cp.async.bulk
  int per_chunk;       // split: pixels an apply block
  int slices;          // split: S
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// a float of block `rank`'s shared memory, at the offset of `local` in ours
__device__ __forceinline__ float ld_dsmem(const float* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hopper::smem_u32(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}
// 1-D TMA: `bytes` (a multiple of 16) from global into this block's shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int V>
__device__ __forceinline__ void load_v(const bf16* p, float v[V]) {
  if constexpr (V == 8) {
    load8(p, 8, true, v);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(bf16* p, const float v[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = pack8(v);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Per-channel sums of the rows of T threads: every active thread's s[V]
// (then q[V]) through `red` [R][C], summed over r in order into cs (cq);
// `sync` is the barrier of the T threads.
template <int V, typename Sync>
__device__ __forceinline__ void rows_to_channels(const float s[V], const float q[V], float* red,
                                                 float* cs, float* cq, int C, int R, int j, int r,
                                                 bool active, int T, Sync sync) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const float* v = pass == 0 ? s : q;
    float* dst = pass == 0 ? cs : cq;
    if (active) {
#pragma unroll
      for (int k = 0; k < V; ++k) red[r * C + j * V + k] = v[k];
    }
    sync();
    for (int c = threadIdx.x; c < C; c += T) {
      float a = 0.f;
      for (int rr = 0; rr < R; ++rr) a += red[rr * C + c];
      dst[c] = a;
    }
    sync();
  }
}

__device__ __forceinline__ float film_at(const GnArgs& a, const void* p, int b, int c) {
  const size_t i = (size_t)b * a.film_stride + c;
  return a.film_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

// (mean, rstd) of group g from its (sum x, sum x^2) over n elements
__device__ __forceinline__ float2 group_moments(float s, float q, float n, float eps) {
  const float mean = s / n;
  const float var = q / n - mean * mean;
  return make_float2(mean, rsqrtf(fmaxf(var, 0.f) + eps));
}

// (A, Bc) of channels [j*V, j*V + V) of sample b from gstat (mean [G], rstd
// [G]) and those channels' gamma and beta
template <int V>
__device__ __forceinline__ void thread_coefs(const GnArgs& a, int b, int j, const float* gstat,
                                             const float gam[V], const float bet[V], float A[V],
                                             float Bc[V]) {
  const int gs = a.C / a.G;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = j * V + k, g = c / gs;
    const float sc = gstat[a.G + g] * gam[k];
    A[k] = sc;
    Bc[k] = bet[k] - gstat[g] * sc;
    if (a.fs != nullptr) {
      const float f = 1.0f + film_at(a, a.fs, b, c);
      A[k] = sc * f;
      Bc[k] = Bc[k] * f + film_at(a, a.fsh, b, c);
    }
  }
}

template <int V>
__device__ __forceinline__ void load_gamma_beta(const GnArgs& a, int j, float gam[V],
                                                float bet[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    gam[k] = a.gamma[j * V + k];
    bet[k] = a.beta[j * V + k];
  }
}

template <int V>
__device__ __forceinline__ void apply_v(float v[V], const float A[V], const float Bc[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = silu_fast(fmaf(v[k], A[k], Bc[k]));
}

// ------------------------------------------------------------ cluster route
// Shared memory, in this order: the run [per, C] bf16 (16-byte rounded);
// mbarriers: full [MAX_STAGES] (a piece landed), freed [MAX_STAGES] (a piece
// read for the last time), ready [2] (every rank's partials of an even / odd
// sample written); red [max(R*C, 32G)] f32 (row partials, then the ranks'
// group partials), cs [C], cq [C], gpart [2][2G] (read by the peers), gstat
// [2G].
__host__ __device__ inline size_t cluster_smem(int per, int C, int G, int R) {
  const size_t tile = ((size_t)per * C * 2 + 15) / 16 * 16;
  const size_t red = (size_t)R * C > 32 * (size_t)G ? (size_t)R * C : 32 * (size_t)G;
  return tile + 8 * (2 * MAX_STAGES + 2) + (red + 2 * (size_t)C + 6 * (size_t)G) * 4;
}

constexpr int CONSUMER_BAR = 1;  // named barrier of the consumer threads

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// an arrival on the mbarrier at `local`'s offset in block `rank`, releasing
// this thread's (and, after a barrier, its block's) writes at cluster scope
__device__ __forceinline__ void remote_arrive(uint64_t* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hopper::smem_u32(local)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
// mbar_wait with acquire at cluster scope: the peers' writes before their
// arrivals are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAITC;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// T consumer threads (256, or 512) and the producer warp.  At 256 the
// registers are capped so that three blocks fit an SM; 512 is for plans of
// one block an SM.
template <int V, int T>
__global__ void __launch_bounds__(T + 32, T == 256 ? 3 : 1) gn_cluster_kernel(GnArgs a, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, G = a.G;
  const int CV = C / V;
  const int R = T / CV;
  const int t = threadIdx.x;
  const int j = t % CV, r = t / CV;
  const bool active = r < R;
  const uint32_t rank = cluster_rank(), n = cluster_size();
  const int P = (int)cluster_count(), cid = (int)cluster_id();
  const int p0 = (int)rank * a.per;
  const int np = min(a.per, a.HW - p0);
  const int stages = a.tma ? a.stages : 1;

  bf16* tile = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ((size_t)a.per * C * 2 + 15) / 16 * 16);
  uint64_t* freed = full + MAX_STAGES;
  uint64_t* ready = freed + MAX_STAGES;
  float* red = reinterpret_cast<float*>(ready + 2);
  float* cs = red + (R * C > 32 * G ? R * C : 32 * G);
  float* cq = cs + C;
  float* gpart = cq + C;
  float* gstat = gpart + 4 * G;

  if (t == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      hopper::mbar_init(hopper::smem_u32(&full[s]), 1);
      hopper::mbar_init(hopper::smem_u32(&freed[s]), T);
    }
    hopper::mbar_init(hopper::smem_u32(&ready[0]), n);
    hopper::mbar_init(hopper::smem_u32(&ready[1]), n);
    hopper::fence_mbar_init();
  }
  cluster_arrive();  // every block's barriers exist before any remote arrival
  cluster_wait();

  if (t >= T) {  // ---- producer warp: a piece is refilled once its last reader is done
    if (t == T && a.tma) {
      const size_t run = (size_t)p0 * C;
      int it = 0;
      for (int b = cid; b < B; b += P, ++it) {
        for (int st = 0; st < stages; ++st) {
          const int q0 = np * st / stages, q1 = np * (st + 1) / stages;
          const uint32_t bytes = (uint32_t)(q1 - q0) * C * 2;
          const uint32_t bar = hopper::smem_u32(&full[st]);
          if (it > 0) hopper::mbar_wait(hopper::smem_u32(&freed[st]), (it - 1) & 1);
          hopper::mbar_expect_tx(bar, bytes);
          if (bytes > 0)
            bulk_load(hopper::smem_u32(tile + (size_t)q0 * C),
                      a.x + (size_t)b * a.HW * C + run + (size_t)q0 * C, bytes, bar);
        }
      }
    }
    __syncwarp();
  } else {  // ---- consumers
    const auto sync = [] { hopper::named_sync(CONSUMER_BAR, T); };
    const int gs = C / G;
    const float cnt = (float)a.HW * (float)gs;
    float gam[V], bet[V];  // this thread's channels of gamma and beta, for every sample
    load_gamma_beta<V>(a, j, gam, bet);
    int it = 0;
    for (int b = cid; b < B; b += P, ++it) {
      const uint32_t par = it & 1;
      if (!a.tma) {  // ordinary loads into the run's layout
        sync();      // the previous sample's apply has read the tile
        const bf16* xs = a.x + ((size_t)b * a.HW + p0) * C;
        for (int e = t; e < np * C; e += T) tile[e] = xs[e];
        sync();
      }
      float s[V], q[V];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
      int p = r;
      for (int st = 0; st < stages; ++st) {
        const int q1 = a.tma ? np * (st + 1) / stages : np;
        if (a.tma) hopper::mbar_wait(hopper::smem_u32(&full[st]), par);
        if (!active) continue;
        for (; p < q1; p += R) {
          float v[V];
          load_v<V>(tile + (size_t)p * C + j * V, v);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            s[k] += v[k];
            q[k] = fmaf(v[k], v[k], q[k]);
          }
        }
      }
      rows_to_channels<V>(s, q, red, cs, cq, C, R, j, r, active, T, sync);
      float* gp = gpart + par * 2 * G;
      for (int g = t; g < G; g += T) {
        float ss = 0.f, qq = 0.f;
        for (int i = 0; i < gs; ++i) {
          ss += cs[g * gs + i];
          qq += cq[g * gs + i];
        }
        gp[g] = ss;
        gp[G + g] = qq;
      }
      sync();
      if (t < (int)n) remote_arrive(&ready[par], t);  // one thread a rank, in parallel
      mbar_wait_cluster(hopper::smem_u32(&ready[par]), (it >> 1) & 1);
      // every rank's partials, gathered by as many threads at once, then added
      // in rank order: the same sums in every block
      for (int e = t; e < 2 * G * (int)n; e += T) red[e] = ld_dsmem(&gp[e % (2 * G)], e / (2 * G));
      sync();
      for (int g = t; g < G; g += T) {
        float ss = 0.f, qq = 0.f;
        for (uint32_t k = 0; k < n; ++k) {
          ss += red[k * 2 * G + g];
          qq += red[k * 2 * G + G + g];
        }
        const float2 m = group_moments(ss, qq, cnt, a.eps);
        gstat[g] = m.x;
        gstat[G + g] = m.y;
      }
      sync();
      float A[V], Bc[V];
      thread_coefs<V>(a, b, j, gstat, gam, bet, A, Bc);
      bf16* os = a.out + ((size_t)b * a.HW + p0) * C + j * V;
      p = r;
      for (int st = 0; st < stages; ++st) {
        const int q1 = a.tma ? np * (st + 1) / stages : np;
        if (active) {
#pragma unroll 4
          for (; p < q1; p += R) {
            float v[V];
            load_v<V>(tile + (size_t)p * C + j * V, v);
            apply_v<V>(v, A, Bc);
            store_v<V>(os + (size_t)p * C, v);
          }
        }
        if (a.tma) hopper::mbar_arrive(hopper::smem_u32(&freed[st]));  // refill it
      }
    }
  }
  cluster_arrive();  // the peers have read our partials for the last time
  cluster_wait();
}

// ------------------------------------------------------------ split route
// grid (S, B): slice s of sample b covers pixels [s*per, min(HW, (s+1)*per))
template <int V>
__global__ void __launch_bounds__(512) gn_split_stats_kernel(GnArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, CV = C / V, R = blockDim.x / CV;
  const int t = threadIdx.x, j = t % CV, r = t / CV;
  const bool active = r < R;
  const int b = blockIdx.y, sl = blockIdx.x;
  const int p0 = sl * a.per, np = min(a.per, a.HW - p0);
  float* red = sm;
  float* cs = red + R * C;
  float* cq = cs + C;
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (active) {
    const bf16* xs = a.x + ((size_t)b * a.HW + p0) * C + j * V;
#pragma unroll 4
    for (int p = r; p < np; p += R) {
      float v[V];
      load_v<V>(xs + (size_t)p * C, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] += v[k];
        q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }
  rows_to_channels<V>(s, q, red, cs, cq, C, R, j, r, active, (int)blockDim.x,
                      [] { __syncthreads(); });
  float* dst = a.part + ((size_t)b * a.slices + sl) * 2 * C;
  for (int c = t; c < C; c += blockDim.x) {
    dst[c] = cs[c];
    dst[C + c] = cq[c];
  }
}

// grid (chunks, B): chunk k of sample b covers pixels [k*per_chunk, ...)
template <int V>
__global__ void __launch_bounds__(512) gn_split_apply_kernel(GnArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, G = a.G, CV = C / V, R = blockDim.x / CV;
  const int t = threadIdx.x, j = t % CV, r = t / CV;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * a.per_chunk, np = min(a.per_chunk, a.HW - p0);
  float* cs = sm;
  float* cq = cs + C;
  float* gstat = cq + C;
  const float* part = a.part + (size_t)b * a.slices * 2 * C;
  for (int c = t; c < C; c += blockDim.x) {
    float ss = 0.f, qq = 0.f;
    for (int sl = 0; sl < a.slices; ++sl) {  // slice order: the same sums in every block
      ss += part[(size_t)sl * 2 * C + c];
      qq += part[(size_t)sl * 2 * C + C + c];
    }
    cs[c] = ss;
    cq[c] = qq;
  }
  __syncthreads();
  const int gs = C / G;
  const float cnt = (float)a.HW * (float)gs;
  for (int g = t; g < G; g += blockDim.x) {
    float ss = 0.f, qq = 0.f;
    for (int i = 0; i < gs; ++i) {
      ss += cs[g * gs + i];
      qq += cq[g * gs + i];
    }
    const float2 m = group_moments(ss, qq, cnt, a.eps);
    gstat[g] = m.x;
    gstat[G + g] = m.y;
  }
  __syncthreads();
  if (r >= R) return;
  float gam[V], bet[V], A[V], Bc[V];
  load_gamma_beta<V>(a, j, gam, bet);
  thread_coefs<V>(a, b, j, gstat, gam, bet, A, Bc);
  const size_t base = ((size_t)b * a.HW + p0) * C + j * V;
  const bf16* xs = a.x + base;
  bf16* os = a.out + base;
#pragma unroll 4
  for (int p = r; p < np; p += R) {
    float v[V];
    load_v<V>(xs + (size_t)p * C, v);
    apply_v<V>(v, A, Bc);
    store_v<V>(os + (size_t)p * C, v);
  }
}

GnArgs make_args(const void* x, const float* gamma, const float* beta, const void* fs,
                 const void* fsh, void* out, int HW, int C, int G, float eps, int film_stride,
                 int film_bf16) {
  GnArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.gamma = gamma;
  a.beta = beta;
  a.fs = fs;
  a.fsh = fsh;
  a.film_stride = film_stride;
  a.film_bf16 = film_bf16;
  a.out = static_cast<bf16*>(out);
  a.HW = HW;
  a.C = C;
  a.G = G;
  a.eps = eps;
  return a;
}

// the thread layout's checks: V channels a thread, R >= 1 rows of CV
bool layout_ok(int C, int G, int threads, bool vec) {
  const int CV = vec ? C / 8 : C;
  return C > 0 && G > 0 && C % G == 0 && threads > 0 && threads <= 512 && threads % 32 == 0 &&
         CV <= threads;
}

// Kernel attributes are per device; each is set once a device (the shared
// memory to the largest size asked so far), so a launch costs no extra call.
constexpr int MAX_DEVICES = 64;

template <auto* KERNEL>
cudaError_t raise_smem(int smem) {
  static int done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) done[dev] = smem;
  return e;
}

template <auto* KERNEL>
cudaError_t cluster_config(int n, int smem) {
  static int non_portable[MAX_DEVICES];
  cudaError_t e = raise_smem<KERNEL>(smem);
  if (e != cudaSuccess || n <= 8) return e;
  int dev = 0;
  cudaGetDevice(&dev);
  if (non_portable[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) non_portable[dev] = 1;
  return e;
}

cudaLaunchConfig_t cluster_launch(int clusters, int n, int threads, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * n), 1, 1);
  cfg.blockDim = dim3((unsigned)(threads + 32), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <auto* KERNEL>
cudaError_t launch_cluster(const GnArgs& a, int B, int clusters, int n, int threads, int smem,
                           cudaStream_t s) {
  cudaError_t e = cluster_config<KERNEL>(n, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(clusters, n, threads, smem, s, &attr);
  return cudaLaunchKernelEx(&cfg, KERNEL, a, B);
}

template <auto* KERNEL>
int max_clusters(int n, int threads, int smem) {
  if (cluster_config<KERNEL>(n, smem) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(1, n, threads, smem, nullptr, &attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, (void*)KERNEL, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

template <auto* KERNEL>
int blocks_per_sm(int threads, int smem) {
  if (raise_smem<KERNEL>(smem) != cudaSuccess) return -1;
  int count = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, KERNEL, threads + 32, (size_t)smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

// the cluster kernel for V channels a thread and `threads` consumers
template <int V>
int blocks_per_sm_of(int threads, int smem) {
  return threads == 256 ? blocks_per_sm<gn_cluster_kernel<V, 256>>(threads, smem)
                        : blocks_per_sm<gn_cluster_kernel<V, 512>>(threads, smem);
}
template <int V>
int max_clusters_of(int threads, int n, int smem) {
  return threads == 256 ? max_clusters<gn_cluster_kernel<V, 256>>(n, threads, smem)
                        : max_clusters<gn_cluster_kernel<V, 512>>(n, threads, smem);
}
template <int V>
cudaError_t launch_cluster_of(const GnArgs& a, int B, int clusters, int n, int threads, int smem,
                              cudaStream_t s) {
  return threads == 256
             ? launch_cluster<gn_cluster_kernel<V, 256>>(a, B, clusters, n, threads, smem, s)
             : launch_cluster<gn_cluster_kernel<V, 512>>(a, B, clusters, n, threads, smem, s);
}

// shared-memory bytes of one cluster-route block (the planner in
// ops/groupnorm.py computes the same)
int cluster_block_smem(int per, int C, int G, int threads) {
  const int CV = C % 8 == 0 ? C / 8 : C;
  if (CV < 1 || CV > threads) return -1;
  return (int)cluster_smem(per, C, G, threads / CV);
}

}  // namespace

extern "C" {

// Shared-memory bytes a block of the current card may opt in to.
int sgdm_groupnorm_max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return v;
}

// Clusters of n blocks (threads, smem bytes each) that the card holds at
// once, by cudaOccupancyMaxActiveClusters; 0 when none schedules.
int sgdm_groupnorm_max_clusters(int vec, int n, int threads, int smem) {
  if (threads != 256 && threads != 512) return -1;
  return vec ? max_clusters_of<8>(threads, n, smem) : max_clusters_of<1>(threads, n, smem);
}

// Blocks of the cluster kernel (threads consumers and the producer warp,
// smem bytes each) that one SM holds, by registers and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); 0 when none fits.
int sgdm_groupnorm_blocks_per_sm(int vec, int threads, int smem) {
  if (threads != 256 && threads != 512) return -1;
  return vec ? blocks_per_sm_of<8>(threads, smem) : blocks_per_sm_of<1>(threads, smem);
}

// Cluster route.  x, out: bf16 [B, HW, C] contiguous; gamma, beta: f32 [C];
// fs, fsh: FiLM [B, C] (f32, or bf16 with film_bf16; rows film_stride
// apart) or both null.  `clusters` clusters (at most B) of n blocks of
// `threads` consumers and a producer warp, `per` pixels a rank (the last may
// have fewer; none empty), `stages` TMA pieces, `smem` bytes a block.
int sgdm_groupnorm_cluster(const void* x, const float* gamma, const float* beta, const void* fs,
                           const void* fsh, void* out, int B, int HW, int C, int G,
                           float eps, int film_stride, int film_bf16, int clusters, int n, int per,
                           int stages, int threads, int smem, void* stream) {
  const bool vec = C % 8 == 0;
  if (B < 1 || HW < 1 || (fs == nullptr) != (fsh == nullptr) || !layout_ok(C, G, threads, vec) ||
      (threads != 256 && threads != 512) || clusters < 1 || clusters > B || n < 1 || n > 16 ||
      per < 1 || (long long)(n - 1) * per >= HW || (long long)n * per < HW || stages < 1 ||
      stages > MAX_STAGES || smem != cluster_block_smem(per, C, G, threads) ||
      (vec && reinterpret_cast<uintptr_t>(out) % 16))
    return (int)cudaErrorInvalidValue;
  GnArgs a = make_args(x, gamma, beta, fs, fsh, out, HW, C, G, eps, film_stride, film_bf16);
  a.per = per;
  a.stages = stages;
  a.tma = vec && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec ? launch_cluster_of<8>(a, B, clusters, n, threads, smem, s)
                            : launch_cluster_of<1>(a, B, clusters, n, threads, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Split route.  part: f32 scratch [B, slices, 2, C]; slice k covers pixels
// [k*per_slice, ...), apply block k [k*per_chunk, ...), none empty.  x and
// out 16-byte aligned when C % 8 == 0.
int sgdm_groupnorm_split(const void* x, const float* gamma, const float* beta, const void* fs,
                         const void* fsh, void* out, float* part, int B, int HW, int C, int G,
                         float eps, int film_stride, int film_bf16, int slices, int per_slice,
                         int chunks, int per_chunk, int threads, void* stream) {
  const bool vec = C % 8 == 0;
  if (B < 1 || HW < 1 || (fs == nullptr) != (fsh == nullptr) || !layout_ok(C, G, threads, vec) ||
      slices < 1 || per_slice < 1 || (long long)(slices - 1) * per_slice >= HW ||
      (long long)slices * per_slice < HW || chunks < 1 || per_chunk < 1 ||
      (long long)(chunks - 1) * per_chunk >= HW || (long long)chunks * per_chunk < HW ||
      B > 65535 ||
      (vec && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)))
    return (int)cudaErrorInvalidValue;
  GnArgs a = make_args(x, gamma, beta, fs, fsh, out, HW, C, G, eps, film_stride, film_bf16);
  a.part = part;
  a.per = per_slice;
  a.slices = slices;
  a.per_chunk = per_chunk;
  const int CV = vec ? C / 8 : C;
  const size_t stats_smem = ((size_t)(threads / CV) * C + 2 * (size_t)C) * 4;
  const size_t apply_smem = (2 * (size_t)C + 2 * (size_t)G) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (vec) {
    if ((e = raise_smem<gn_split_stats_kernel<8>>((int)stats_smem)) != cudaSuccess ||
        (e = raise_smem<gn_split_apply_kernel<8>>((int)apply_smem)) != cudaSuccess)
      return (int)e;
    gn_split_stats_kernel<8><<<dim3(slices, B), threads, stats_smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    gn_split_apply_kernel<8><<<dim3(chunks, B), threads, apply_smem, s>>>(a);
  } else {
    if ((e = raise_smem<gn_split_stats_kernel<1>>((int)stats_smem)) != cudaSuccess ||
        (e = raise_smem<gn_split_apply_kernel<1>>((int)apply_smem)) != cudaSuccess)
      return (int)e;
    gn_split_stats_kernel<1><<<dim3(slices, B), threads, stats_smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    gn_split_apply_kernel<1><<<dim3(chunks, B), threads, apply_smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
