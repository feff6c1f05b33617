// Shared by the probe kernels (csrc/probe_*.cu): the start of a dynamic
// slice as the probes' Pallas kernels take it, and floor division.
//
// Twin of meshflow_tpu_torch/probes/_slices.py `dyn_start`: a negative
// start is wrapped once by the axis length, then clamped into
// [0, dim - size].  `floor_div` is Python's `//` (towards -infinity);
// C++'s `/` truncates towards zero and differs for negative operands.
#pragma once

#include <cuda_runtime.h>

namespace probes {

__host__ __device__ __forceinline__ int dyn_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  const int hi = dim - size;
  return start < 0 ? 0 : (start > hi ? hi : start);
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// 16-byte copy from global to shared memory that bypasses L1 (cp.async.cg);
// both addresses must be 16-byte aligned.  Completed by cp_async_wait_all,
// or by cp_async_commit then cp_async_wait_group.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the group of this thread's cp.async copies issued since the last
// commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
// Other threads' copies become visible only after a barrier.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace probes
