// Probe G: how a per-feature scalar (a band base) is handed from a value
// computed in the kernel to an address.
//
// Replaces the Pallas kernel `kernel` of scripts/probe_scalar_from_vmem.py
// (:35).  The plain PyTorch version it is held against is
// `band_row_plain` in meshflow_tpu_torch/probes/scalar_from_vmem.py.  For
// each feature i:
//   v = 2 * corners[i, 0] + 1  (float32, multiply then add),
//   base = (floor(v) // 8) * 8,  out[i, 0, :] = plane[dyn_start(base, H, 16)].
// On the TPU the vector-to-scalar handoff went through a VMEM scratch; on
// Hopper it is a warp shuffle: lane 0 computes the base and
// __shfl_sync hands it to the warp, which then copies the row with 16-byte
// loads.
//
// What bounds it: launch latency (8 rows of 1 KB).  Design: one warp per
// feature, one block of B warps.

#include <cmath>
#include <cuda_runtime.h>

#include "probes.cuh"

namespace {

constexpr int ROWS = 16;
constexpr int MAX_B = 32;

__global__ void scalar_from_vmem_kernel(const float* __restrict__ plane,
                                        const float* __restrict__ corners, int H, int W,
                                        int ldc, float* __restrict__ out) {
  const int i = threadIdx.x / 32, lane = threadIdx.x % 32;
  int start = 0;
  if (lane == 0) {
    const float v = corners[static_cast<long long>(i) * ldc] * 2.0f + 1.0f;
    const int base = probes::floor_div(static_cast<int>(floorf(v)), 8) * 8;
    start = probes::dyn_start(base, H, ROWS);
  }
  start = __shfl_sync(0xffffffffu, start, 0);
  const float4* src = reinterpret_cast<const float4*>(plane + static_cast<long long>(start) * W);
  float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(i) * W);
  for (int q = lane; q < W / 4; q += 32) dst[q] = __ldg(src + q);
}

}  // namespace

extern "C" int meshflow_probe_scalar_from_vmem(const void* plane, const void* corners,
                                               void* out, int H, int W, int B, int ldc,
                                               void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (B > MAX_B) return static_cast<int>(cudaErrorInvalidValue);
  scalar_from_vmem_kernel<<<1, 32 * B, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), static_cast<const float*>(corners), H, W, ldc,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
