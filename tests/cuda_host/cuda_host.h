// The CUDA constructs csrc/attention_f32.cuh uses, on the host, so that
// tests/test_torch_attention_f32_host.py can run the kernels' own code on the
// CPU.  A block's 256 threads are fibers (ucontext) on one OS thread, run in
// turn, each until it waits at a barrier: __syncthreads, __syncwarp, the
// named barriers and the two warp barriers around a shuffle's exchange
// through an array.  No thread runs past a barrier before every participant
// has reached it, and a pass in which no waiting thread can go on is a
// deadlock, reported instead of hanging.  Dynamic shared memory is one array,
// filled with NaN before each block; blocks run one after another.
#pragma once

#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

struct HostDim3 {
  unsigned x = 0;
};
inline HostDim3 threadIdx, blockIdx, gridDim;  // threadIdx: the running fiber's

constexpr size_t HOST_SMEM_BYTES = 232448;  // a block's shared memory on the H100
constexpr int HOST_THREADS = 256, HOST_WARPS = HOST_THREADS / 32;

// A barrier of `count` threads: arrivals in this phase and the phase number.
struct HostBarrier {
  int count = 0, arrived = 0, phase = 0;
  // arrive; true when this arrival completes the phase
  bool arrive(int n) {
    count = n;
    if (++arrived < count) return false;
    arrived = 0;
    ++phase;
    return true;
  }
};

struct HostFiber {
  ucontext_t ctx;
  std::vector<char> stack;
  const int* wait_phase = nullptr;  // waiting until *wait_phase != wait_value
  int wait_value = 0;
  bool done = false;
};

inline ucontext_t host_scheduler;
inline std::vector<HostFiber> host_fibers(HOST_THREADS);
inline std::function<void()> host_body;
inline HostBarrier host_block_barrier, host_warp_barrier[HOST_WARPS], host_named_barrier[16];
inline float host_shuffle[HOST_WARPS][32];

inline void host_wait(HostBarrier& b, int n) {
  const int phase = b.phase;
  if (b.arrive(n)) return;
  HostFiber& f = host_fibers[threadIdx.x];
  f.wait_phase = &b.phase, f.wait_value = phase;
  swapcontext(&f.ctx, &host_scheduler);
}

inline void __syncthreads() { host_wait(host_block_barrier, HOST_THREADS); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_wait(host_warp_barrier[threadIdx.x / 32], 32);
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  host_shuffle[w][l] = v;
  __syncwarp();
  const float r = host_shuffle[w][l ^ o];
  __syncwarp();
  return r;
}

inline void host_fiber_entry() {
  host_body();
  host_fibers[threadIdx.x].done = true;
}

// Runs `body` as HOST_THREADS threads of one block; false on a deadlock.
inline bool host_run_block(std::function<void()> body) {
  host_body = std::move(body);
  host_block_barrier = HostBarrier();
  for (auto& b : host_warp_barrier) b = HostBarrier();
  for (auto& b : host_named_barrier) b = HostBarrier();
  for (int t = 0; t < HOST_THREADS; ++t) {
    HostFiber& f = host_fibers[t];
    f.stack.resize(1 << 16);
    f.wait_phase = nullptr, f.done = false;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.data();
    f.ctx.uc_stack.ss_size = f.stack.size();
    f.ctx.uc_link = &host_scheduler;
    makecontext(&f.ctx, host_fiber_entry, 0);
  }
  for (int left = HOST_THREADS; left > 0;) {
    bool moved = false;
    for (int t = 0; t < HOST_THREADS; ++t) {
      HostFiber& f = host_fibers[t];
      if (f.done || (f.wait_phase != nullptr && *f.wait_phase == f.wait_value)) continue;
      f.wait_phase = nullptr;
      threadIdx.x = t;
      swapcontext(&host_scheduler, &f.ctx);
      moved = true;
      left -= f.done;
    }
    if (!moved) return false;
  }
  return true;
}

namespace f32k {
extern float4 f32k_smem[];
}
