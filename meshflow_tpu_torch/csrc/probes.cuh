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
// both addresses must be 16-byte aligned.  Completed by cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace probes
