// cp.async copies from device memory into shared memory (sm_80 and up),
// shared by B4's state loads (segment.cuh), B8 (chol_lanes.cu) and B10
// (chol_blk.cu).  A thread's copies are in flight until it waits for
// them; the block syncs before another thread reads what they wrote.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      static_cast<unsigned>(__cvta_generic_to_shared(s))), "l"(g));
}
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      static_cast<unsigned>(__cvta_generic_to_shared(s))), "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// waits for every copy of this thread, committed or not
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

}  // namespace
