// Barriers shared by the kernels that run as one co-resident grid of
// thread-block clusters (lu_panel.cuh and its LU kernels, chase.cuh and
// the two bulge chases): a release/acquire barrier over the whole grid
// on a counter in global memory, and the two halves of the cluster
// barrier.

#pragma once

#include <cuda_runtime.h>

namespace grid_sync {

// Wait until *ctr ≥ target (acquire loads), trapping after 2^36 clocks.
__device__ inline void wait_at_least(const unsigned* ctr, unsigned target) {
  const long long t0 = clock64();
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
    if (v < target && clock64() - t0 > (1ll << 36)) __trap();
  } while (v < target);
}

// A barrier over the whole grid on a counter of its own that only grows:
// the n-th sync() waits for it to reach n·G.  A release reduction and
// acquire loads (no sequentially consistent fence, which cooperative
// groups' grid.sync() issues): the writes of the block before it are
// visible to every block after it.  A wait past 2^36 clocks (half a
// minute) traps, so that a fault ends the launch with an error instead of
// holding the card.
struct ColumnBarrier {
  unsigned* ctr;
  unsigned G, target;
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      target += G;
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(ctr), "r"(1u) : "memory");
      wait_at_least(ctr, target);
    }
    __syncthreads();
  }
};

// barrier.cluster in two halves: the arrival (release: this thread's
// earlier accesses are ordered before every block of the cluster passes
// its wait) and the wait (acquire).  Every thread of every block of the
// cluster takes part.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// An arrival that publishes nothing (no fence: a release arrival costs a
// fence over the whole GPU): it only tells the cluster that this thread's
// earlier loads, whose values it has already used, are done.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

}  // namespace grid_sync
