// Host stand-ins for what csrc/attention_f32.cuh takes from csrc/hopper.cuh,
// for cuda_host.h.  cp.async: a copy is queued in its thread's open group and
// lands only when a wait_group drains that group, so a read that the kernel
// did not wait for sees stale shared memory (NaN at first) instead of the
// data.  Named barriers: cuda_host.h's barriers by id (bar.arrive arrives
// without waiting).
#pragma once

#include <deque>
#include <vector>

#include "cuda_host.h"

namespace hopper {

struct HostCopy {
  uint32_t dst;
  const void* src;
  bool valid;
};
inline std::vector<HostCopy> host_open[HOST_THREADS];
inline std::deque<std::vector<HostCopy>> host_groups[HOST_THREADS];

[[noreturn]] inline void host_fail(const char* what) {
  fprintf(stderr, "cuda_host: %s (thread %u, block %u)\n", what, threadIdx.x, blockIdx.x);
  abort();
}

inline uint32_t smem_u32(const void* p) {
  const long off = (const char*)p - (const char*)f32k::f32k_smem;
  if (off < 0 || off + 16 > (long)HOST_SMEM_BYTES) host_fail("shared address out of range");
  return (uint32_t)off;
}
inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  if (dst % 16 || (uintptr_t)src % 16) host_fail("cp.async of 16 bytes not 16-byte aligned");
  host_open[threadIdx.x].push_back({dst, src, valid});
}
inline void cp_async_commit() {
  host_groups[threadIdx.x].push_back(std::move(host_open[threadIdx.x]));
  host_open[threadIdx.x].clear();
}
template <int N>
inline void cp_async_wait() {
  char* base = (char*)f32k::f32k_smem;
  auto& groups = host_groups[threadIdx.x];
  while ((int)groups.size() > N) {
    for (const HostCopy& c : groups.front()) {
      if (c.valid) memcpy(base + c.dst, c.src, 16);
      else memset(base + c.dst, 0, 16);
    }
    groups.pop_front();
  }
}
inline void host_reset() {
  for (auto& o : host_open) o.clear();
  for (auto& g : host_groups) g.clear();
}

inline void named_sync(int id, int threads) { host_wait(host_named_barrier[id], threads); }
inline void named_arrive(int id, int threads) { host_named_barrier[id].arrive(threads); }

}  // namespace hopper
