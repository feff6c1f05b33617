// Probe G: how a per-feature scalar (a band base) is handed from a value
// computed in the kernel to an address.
//
// Replaces the Pallas kernel `kernel` of scripts/probe_scalar_from_vmem.py
// (:35).  The plain PyTorch version it is held against is
// `band_row_plain` in meshflow_tpu_torch/probes/scalar_from_vmem.py.  For
// each feature i:
//   v = 2 * corners[i, 0] + 1  (float32, multiply then add),
//   base = (floor(v) // 8) * 8,  out[i, 0, :] = plane[dyn_start(base, H, 16)].
// On the TPU the vector-to-scalar handoff went through a VMEM scratch.  On
// Hopper there is no handoff: every thread computes its feature's base
// itself.  The threads of a feature read the same corner address, which
// the memory system serves as one broadcast transaction.
//
// What bounds it: launch latency.  It copies 8 rows of 1 KB, so the bytes
// take nanoseconds and the launch and the block's set-up take the time.
// Design: one float4 of the output per thread (B x W/4 threads, 512 at
// B = 8), so each thread's chain is corner load -> base -> row load ->
// store, with no shuffle between them.  The launch may be programmatic
// (`pdl`): the kernel is launched with
// cudaLaunchAttributeProgrammaticStreamSerialization, so the card may
// launch it and set up its blocks while the kernel before it in the stream
// is still finishing.  That is safe because every global read and write of
// this kernel comes after `griddepcontrol.wait`, which returns only once
// the grid before it has completed and its writes are visible: only the
// launch and the block's set-up overlap the previous kernel.  Once a block
// has issued its loads it lets the next kernel launch
// (`griddepcontrol.launch_dependents`).  Without the attribute both
// instructions do nothing.

#include <cmath>
#include <cuda_runtime.h>

#include "probes.cuh"

namespace {

constexpr int ROWS = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS)
    scalar_from_vmem_kernel(const float* __restrict__ plane, const float* __restrict__ corners,
                            int H, int W4, int total, int ldc, float* __restrict__ out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  grid_dependency_wait();
  if (t < total) {
    const int i = t / W4, q = t - i * W4;
    const float v = corners[static_cast<long long>(i) * ldc] * 2.0f + 1.0f;
    const int base = probes::floor_div(static_cast<int>(floorf(v)), 8) * 8;
    const int start = probes::dyn_start(base, H, ROWS);
    const float4 row = __ldg(reinterpret_cast<const float4*>(plane) +
                             static_cast<long long>(start) * W4 + q);
    launch_dependents();
    reinterpret_cast<float4*>(out)[t] = row;
  } else {
    launch_dependents();
  }
}

__global__ void __launch_bounds__(THREADS) empty_kernel() {
  grid_dependency_wait();
  launch_dependents();
}

// Launch `kernel` on `blocks` x THREADS, programmatically when `pdl`.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int pdl, void* stream,
                   Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(THREADS);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

}  // namespace

extern "C" int meshflow_probe_scalar_from_vmem(const void* plane, const void* corners,
                                               void* out, int H, int W, int B, int ldc,
                                               int pdl, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int W4 = W / 4, total = B * W4;
  const cudaError_t err =
      launch(scalar_from_vmem_kernel, (total + THREADS - 1) / THREADS, pdl, stream,
             static_cast<const float*>(plane), static_cast<const float*>(corners), H, W4,
             total, ldc, static_cast<float*>(out));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch floor of G's grid: an empty kernel of `blocks` x THREADS,
// launched as G is.
extern "C" int meshflow_probe_launch_floor(int blocks, int pdl, void* stream) {
  const cudaError_t err = launch(empty_kernel, blocks, pdl, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
