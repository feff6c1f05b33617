// Probe F: the one-hot row select of the backward map's cell table, as a
// gather.
//
// Replaces the Pallas kernel `kern` in `run_case` of
// scripts/probe_select_rows.py (:39).  The plain PyTorch version it is
// held against is `select_rows_plain` in
// meshflow_tpu_torch/probes/select_rows.py.  It computes
//   out[r, j] = table[r, cells[j]]   (0 where cells[j] is outside [0, K))
// The TPU formed it as the product table @ onehot(cells) on its matrix
// unit; on this card the select needs no arithmetic: the kernel copies each
// selected value, so it is exact for every float32 bit pattern.
//
// What bounds it: bytes, the output above all (rows x N floats: 13.3 MB at
// 432 x 7680).  Design: a block of 128 threads covers a strip of 8 table
// rows and 512 output columns.  It stages the strip's rows in shared
// memory with 16-byte loads; each thread reads its 4 cells once (one
// 16-byte load) and then, row by row, writes its 4 outputs with one
// 16-byte store, so each warp stores 512 contiguous bytes a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4 * THREADS;  // output columns a block
constexpr int STRIP = 8;           // table rows a block

__device__ __forceinline__ float pick(const float* row, int c, int K) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(K) ? row[c] : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
select_rows_kernel(const float* __restrict__ table, const int* __restrict__ cells, int rows,
                   int K, int N, float* __restrict__ out) {
  extern __shared__ __align__(16) float strip[];  // STRIP x K
  const int r0 = blockIdx.y * STRIP;
  const int nr = min(STRIP, rows - r0);
  const float4* src = reinterpret_cast<const float4*>(table + static_cast<long long>(r0) * K);
  for (int q = threadIdx.x; q < nr * K / 4; q += THREADS)
    reinterpret_cast<float4*>(strip)[q] = __ldg(src + q);
  __syncthreads();

  const int j = blockIdx.x * COLS + threadIdx.x * 4;
  if (j >= N) return;  // N % 4 == 0: a thread's 4 columns are wholly in or out
  const int4 c = __ldg(reinterpret_cast<const int4*>(cells + j));
  float* dst = out + static_cast<long long>(r0) * N + j;
  for (int r = 0; r < nr; ++r, dst += N) {
    const float* row = strip + r * K;
    *reinterpret_cast<float4*>(dst) =
        make_float4(pick(row, c.x, K), pick(row, c.y, K), pick(row, c.z, K), pick(row, c.w, K));
  }
}

}  // namespace

extern "C" int meshflow_probe_select_rows(const void* table, const void* cells, void* out,
                                          int rows, int K, int N, void* stream) {
  if (rows == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const int bytes = STRIP * K * static_cast<int>(sizeof(float));
  const dim3 grid((N + COLS - 1) / COLS, (rows + STRIP - 1) / STRIP);
  select_rows_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(cells), rows, K, N,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
