// Probe E: does an 8-row-aligned dynamic band load plus a small shift
// select the 16 rows at a dynamic row r0?
//
// Replaces the Pallas kernel `kernel` of scripts/probe_aligned_dynslice.py
// (:34).  The plain PyTorch version it is held against is
// `aligned_rows_plain` in meshflow_tpu_torch/probes/aligned_dynslice.py.
//   base = (r0 // 8) * 8,  s = dyn_start(base, H, 24),
//   out[p] = plane[s + (r0 - base) + p]  for p < 16.
// Near the bottom the band start is clamped while the shift r0 - base is
// not, as in the probe, so r0 > H - 24 selects rows above r0.
//
// What bounds it on the H100: latency.  It moves 16 rows in and 16 out
// (32 KB at W = 256), nanoseconds at the memory rate; what is left is the
// launch and a chain of two dependent loads (r0, then the rows it
// selects).  The band of the TPU kernel is only how a TPU reaches an
// unaligned row: here any row is one address away.  Design: a direct
// gather, no shared memory and no barrier.  Each thread moves one 16-byte
// float4 of the result: it reads r0 (one address, cached for the whole
// grid), computes its source row in closed form, loads and stores.  The
// grid covers 16 x W/4 float4s, so W is limited only by W % 4 == 0 (rows
// stay 16-byte aligned).

#include <cuda_runtime.h>

#include "probes.cuh"

namespace {

constexpr int ROWS = 16;
constexpr int BAND = ROWS + 8;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
aligned_dynslice_kernel(const int* __restrict__ r0_ptr, const float4* __restrict__ plane,
                        int H, int wq, float4* __restrict__ out) {
  const int q = blockIdx.x * THREADS + threadIdx.x;  // float4 of the result
  if (q >= ROWS * wq) return;
  const int r0 = __ldg(r0_ptr);
  const int base = probes::floor_div(r0, 8) * 8;
  const int row = probes::dyn_start(base, H, BAND) + (r0 - base) + q / wq;
  out[q] = __ldg(plane + static_cast<long long>(row) * wq + q % wq);
}

}  // namespace

extern "C" int meshflow_probe_aligned_dynslice(const void* r0, const void* plane, void* out,
                                               int H, int W, void* stream) {
  if (W < 4 || W % 4 != 0 || H < BAND) return static_cast<int>(cudaErrorInvalidValue);
  const int wq = W / 4;
  const int blocks = (ROWS * wq + THREADS - 1) / THREADS;
  aligned_dynslice_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(r0), static_cast<const float4*>(plane), H, wq,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
