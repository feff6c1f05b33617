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
// What bounds it: launch latency.  It moves 24 rows in and 16 out (40 KB
// at W = 256).  Design: one block; r0 is read on the card (it is a
// dynamic index), the 24-row band is staged in dynamic shared memory
// (24 x W floats, 24 KB at W = 256) with 16-byte cp.async copies (the band
// starts on a row and W % 4 == 0), then the 16 shifted rows are written
// with 16-byte stores.

#include <cuda_runtime.h>

#include "probes.cuh"

namespace {

constexpr int ROWS = 16;
constexpr int BAND = ROWS + 8;
constexpr int THREADS = 256;
constexpr int MAX_W = 512;  // 48 KB of band, the dynamic shared memory a block gets unasked

__global__ void __launch_bounds__(THREADS)
aligned_dynslice_kernel(const int* __restrict__ r0_ptr, const float* __restrict__ plane,
                        int H, int W, float* __restrict__ out) {
  extern __shared__ __align__(16) float band[];  // BAND x W
  const int r0 = r0_ptr[0];
  const int base = probes::floor_div(r0, 8) * 8;
  const int s = probes::dyn_start(base, H, BAND);
  const int wq = W / 4;
  for (int q = threadIdx.x; q < BAND * wq; q += THREADS)
    probes::cp_async16(band + (q / wq) * W + (q % wq) * 4,
                       plane + static_cast<long long>(s) * W + q * 4);
  probes::cp_async_wait_all();
  __syncthreads();
  const int off = r0 - base;  // 0..7
  for (int q = threadIdx.x; q < ROWS * wq; q += THREADS)
    reinterpret_cast<float4*>(out)[q] =
        reinterpret_cast<const float4*>(band + (off + q / wq) * W)[q % wq];
}

}  // namespace

extern "C" int meshflow_probe_aligned_dynslice(const void* r0, const void* plane, void* out,
                                               int H, int W, void* stream) {
  if (W > MAX_W || W % 4 != 0 || H < BAND) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = BAND * W * static_cast<int>(sizeof(float));
  aligned_dynslice_kernel<<<1, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(r0), static_cast<const float*>(plane), H, W,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
