// latency_probe: the time of one dependent round trip to device memory.
//
// Replaces no TPU kernel.  It exists only to give mer_walk its bound: a
// walk's steps are a chain of dependent round trips (csrc/mer_walk.cu), so
// the least time of a walk is its longest walker's steps times one such
// round trip.  One thread follows a pointer cycle: next[p] is the index of
// the following node, the nodes are spread over a buffer as large as the
// walk's tables (far larger than the 50 MB L2) and visited in a random
// order, so every hop is a load that waits for the one before it and
// misses the caches.  The kernel times its own hops with %globaltimer
// (ns), so the launch is not counted.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void chase_kernel(const uint32_t* __restrict__ next,
                             uint32_t start, long long hops,
                             uint32_t* __restrict__ last,
                             unsigned long long* __restrict__ ns) {
  uint32_t p = start;
  const unsigned long long t0 = global_ns();
  for (long long h = 0; h < hops; ++h) p = __ldcg(next + p);
  const unsigned long long t1 = global_ns();
  *last = p;  // keeps the chain live
  *ns = t1 - t0;
}

}  // namespace

// One thread, `hops` hops from node `start` of the cycle `next` (uint32
// indices into itself).  last [1] uint32 receives the node reached, ns [1]
// uint64 the nanoseconds the hops took.
extern "C" int latency_probe_launch(const void* next, unsigned start,
                                    long long hops, void* last, void* ns,
                                    void* stream) {
  if (hops < 1) return (int)cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)next, start, hops, (uint32_t*)last,
      (unsigned long long*)ns);
  return (int)cudaGetLastError();
}
