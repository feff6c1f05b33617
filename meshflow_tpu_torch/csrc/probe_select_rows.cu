// Probe F: is a one-hot select on the matrix unit exact as the row count
// grows?
//
// Replaces the Pallas kernel `kern` in `run_case` of
// scripts/probe_select_rows.py (:39).  The plain PyTorch version it is
// held against is `select_rows_plain` in
// meshflow_tpu_torch/probes/select_rows.py.  It computes
//   out[r, j] = table[r, cells[j]]   (0 where cells[j] is outside [0, K))
// as the TPU did, as the product table @ onehot(cells), on the tensor
// cores: mma.sync m16n8k8 with TF32 operands and float32 sums.  The A
// fragments are tiles of the table, staged per 16-row strip in shared
// memory (rows padded by 4 floats, so the fragment reads hit 32 distinct
// banks); the B fragments are the one-hot, built in registers from the
// cells each thread holds.  Operands are rounded to TF32 (cvt.rna), so the
// select is exact for tables whose values have at most 11 significant
// bits: the probe's bf16-valued pieces (the backward map's Dekker split).
// A general float32 value comes back rounded to 11 bits.
//
// What bounds it: bytes at the probe's shapes (the output is rows x N
// floats: 13 MB at 432 x 7680); the product's 2*rows*K*N flops at the
// TF32 rate take about as long.  Design: a block of 4 warps covers 16
// rows and 256 columns; each warp 16 x 64 (8 n-tiles), walking K in steps
// of 8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int NT = 8;                 // n-tiles of 8 columns per warp
constexpr int WARP_N = 8 * NT;        // 64 columns per warp
constexpr int BLOCK_N = WARPS * WARP_N;
constexpr uint32_t TF32_ONE = 0x3f800000u;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__global__ void __launch_bounds__(WARPS * 32)
select_rows_kernel(const float* __restrict__ table, const int* __restrict__ cells, int K,
                   int N, float* __restrict__ out) {
  extern __shared__ __align__(16) float strip[];  // 16 x (K + 4)
  const int ld = K + 4;
  const int r0 = blockIdx.y * 16;
  const int kq = K / 4;
  for (int q = threadIdx.x; q < 16 * kq; q += WARPS * 32) {
    const int row = q / kq, col = (q % kq) * 4;
    *reinterpret_cast<float4*>(strip + row * ld + col) = __ldg(
        reinterpret_cast<const float4*>(table + static_cast<long long>(r0 + row) * K + col));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BLOCK_N + warp * WARP_N;
  int cell[NT];
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + g;
    cell[j] = n < N ? cells[n] : -1;
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += 8) {
    // A (16x8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
    const uint32_t a0 = to_tf32(strip[g * ld + k0 + t]);
    const uint32_t a1 = to_tf32(strip[(g + 8) * ld + k0 + t]);
    const uint32_t a2 = to_tf32(strip[g * ld + k0 + t + 4]);
    const uint32_t a3 = to_tf32(strip[(g + 8) * ld + k0 + t + 4]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // B (8x8, column-major): b0 (k = t, n = g), b1 (k = t+4, n = g)
      const uint32_t b0 = cell[j] == k0 + t ? TF32_ONE : 0u;
      const uint32_t b1 = cell[j] == k0 + t + 4 ? TF32_ONE : 0u;
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  // C (16x8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: a tile is wholly in or out
    float* top = out + static_cast<long long>(r0 + g) * N + n;
    float* bottom = top + 8LL * N;
    *reinterpret_cast<float2*>(top) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(bottom) = make_float2(acc[j][2], acc[j][3]);
  }
}

}  // namespace

extern "C" int meshflow_probe_select_rows(const void* table, const void* cells, void* out,
                                          int rows, int K, int N, void* stream) {
  if (rows == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const int bytes = 16 * (K + 4) * static_cast<int>(sizeof(float));
  const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, rows / 16);
  select_rows_kernel<<<grid, WARPS * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(cells), K, N,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
