// Probe D: what a per-feature band fetch costs against a full-plane
// one-hot row select, at 1080p level-0 tile geometry (plane 328x664 f32).
//
// Replaces the three Pallas kernels of scripts/probe_dynslice_fetch.py:
// `copy_kernel` (:40), `fine_kernel` (:57) and `onehot_kernel` (:81).
// The plain PyTorch versions they are held against are in
// meshflow_tpu_torch/probes/dynslice_fetch.py.  Each launch runs `reps`
// rounds (the probe's REPS = 50), so the time of one round is the launch
// time over reps.
//
// * dynslice_copy: per round r and feature i, the 48x256 band at the
//   8-aligned row and 128-aligned column of idx[2i], idx[2i+1] (shifted
//   by r, as the probe shifts it), clamped into the plane by dyn_start.
//   One block per feature stages its band in shared memory (48 KB) with
//   16-byte cp.async copies: the column start is a multiple of 4 floats
//   and a plane row of W % 4 == 0 floats keeps every row 16-byte aligned.
// * dynslice_fine: the copy, then rows[p][c] = sum_r rsel[p][r] band[r][c]
//   (40x48 by 48x256) from the staged band, the sum taken in r order with
//   separate multiply and add (--fmad=false), as the plain version takes
//   it.  rsel is an input: the probe's own kernel reads a scratch that
//   nothing writes.  Rows are stored every round with __stcg, an inline
//   asm store the compiler cannot drop, so no round's product is dead code
//   (the one-hot gather's rows likewise).
// * onehot_rowsel: per round, all B*40 rows of the band the one-hot select
//   forms, row k = plane[idx[0] + r % 4 + k % 40] or zero past the plane,
//   written to global memory; out sums rows 0..7, columns 0..127, over
//   rounds in round order.  One block per band row, 16-byte loads.
//
// What bounds them: bytes.  The copy moves 48 KB per feature per round
// and computes nothing; the fine select adds 2*40*48*256 flops per
// feature per round, far below the float32 rate; the one-hot form moves
// B*40 rows of 2.6 KB per round.  Each round re-reads what the last read,
// so L2 (50 MB) holds the plane and the rates are L2's, not HBM's.

#include <cstdint>
#include <cuda_runtime.h>

#include "probes.cuh"

namespace {

constexpr int PN = 40;
constexpr int BAND_R = PN + 8;
constexpr int BAND_C = 256;
constexpr int BAND_Q = BAND_C / 4;  // float4 per band row
constexpr int THREADS = 256;

// Stage feature i's band of round r into `band` (BAND_R x BAND_C floats).
__device__ __forceinline__ void stage_band(const int* __restrict__ idx,
                                           const float* __restrict__ plane, int H, int W,
                                           int i, int r, float* band) {
  const int rb = probes::floor_div(idx[2 * i] + 8 * (r % 4), 8) * 8;
  const int cb = probes::floor_div(idx[2 * i + 1] + 128 * (r % 2), 128) * 128;
  const int rs = probes::dyn_start(rb, H, BAND_R);
  const int cs = probes::dyn_start(cb, W, BAND_C);
  for (int q = threadIdx.x; q < BAND_R * BAND_Q; q += THREADS) {
    const int row = q / BAND_Q, col = (q % BAND_Q) * 4;
    probes::cp_async16(band + row * BAND_C + col,
                       plane + static_cast<long long>(rs + row) * W + cs + col);
  }
  probes::cp_async_wait_all();
  __syncthreads();
}

// bands[i] <- the staged band; out <- its top-left 8x128 corner (plus the
// probe's `r * 0.0`) when i is the last feature.
__device__ __forceinline__ void write_band(const float* band, float* __restrict__ bands,
                                           float* __restrict__ out, int i, int B, int r) {
  float* dst = bands + static_cast<long long>(i) * BAND_R * BAND_C;
  for (int q = threadIdx.x; q < BAND_R * BAND_Q; q += THREADS)
    reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(band)[q];
  if (i == B - 1) {
    const float zero = static_cast<float>(r) * 0.0f;
    for (int q = threadIdx.x; q < 8 * 128; q += THREADS)
      out[q] = band[(q / 128) * BAND_C + q % 128] + zero;
  }
}

__global__ void __launch_bounds__(THREADS)
dynslice_copy_kernel(const int* __restrict__ idx, const float* __restrict__ plane, int H,
                     int W, int B, int reps, float* __restrict__ out,
                     float* __restrict__ bands) {
  __shared__ __align__(16) float band[BAND_R * BAND_C];
  const int i = blockIdx.x;
  for (int r = 0; r < reps; ++r) stage_band(idx, plane, H, W, i, r, band);
  write_band(band, bands, out, i, B, reps - 1);
}

__global__ void __launch_bounds__(THREADS)
dynslice_fine_kernel(const int* __restrict__ idx, const float* __restrict__ plane,
                     const float* __restrict__ rsel, int H, int W, int B, int reps,
                     float* __restrict__ out, float* __restrict__ bands,
                     float* __restrict__ rows) {
  extern __shared__ __align__(16) float smem[];
  float* band = smem;                     // BAND_R x BAND_C
  float* sel = smem + BAND_R * BAND_C;    // PN x BAND_R
  const int i = blockIdx.x;
  for (int q = threadIdx.x; q < PN * BAND_R; q += THREADS)
    sel[q] = rsel[static_cast<long long>(i) * PN * BAND_R + q];
  float* dst = rows + static_cast<long long>(i) * PN * BAND_C;
  const int c = threadIdx.x;  // THREADS == BAND_C: one column per thread
  for (int r = 0; r < reps; ++r) {
    stage_band(idx, plane, H, W, i, r, band);
    for (int p = 0; p < PN; ++p) {
      float acc = 0.0f;
      for (int k = 0; k < BAND_R; ++k) acc = acc + sel[p * BAND_R + k] * band[k * BAND_C + c];
      __stcg(dst + p * BAND_C + c, acc);  // an asm store: no round's product is dead
      if (i == B - 1 && r == reps - 1 && p < 8 && c < 128)
        out[p * 128 + c] = acc + static_cast<float>(r) * 0.0f;
    }
    __syncthreads();  // the next round restages the band these sums read
  }
  for (int q = threadIdx.x; q < BAND_R * BAND_Q; q += THREADS)
    reinterpret_cast<float4*>(bands + static_cast<long long>(i) * BAND_R * BAND_C)[q] =
        reinterpret_cast<const float4*>(band)[q];
}

constexpr int ROW_THREADS = 128;

__global__ void __launch_bounds__(ROW_THREADS)
onehot_rowsel_kernel(const int* __restrict__ idx, const float* __restrict__ plane, int H,
                     int W, int reps, float* __restrict__ out, float* __restrict__ band) {
  const int k = blockIdx.x;  // band row
  const int wq = W / 4;
  const int base = idx[0] + k % PN;
  float4* dst = reinterpret_cast<float4*>(band + static_cast<long long>(k) * W);
  const bool corner = k < 8 && threadIdx.x < 32;  // columns 0..127 of rows 0..7
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < reps; ++r) {
    const int t = base + r % 4;
    const bool inside = t >= 0 && t < H;
    const float4* src = reinterpret_cast<const float4*>(plane + static_cast<long long>(t) * W);
    for (int q = threadIdx.x; q < wq; q += ROW_THREADS) {
      const float4 v = inside ? __ldg(src + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __stcg(dst + q, v);  // an asm store: no round's gather is dead
      if (corner && q == threadIdx.x) {
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
      }
    }
  }
  if (corner) reinterpret_cast<float4*>(out + k * 128)[threadIdx.x] = acc;
}

}  // namespace

extern "C" int meshflow_probe_dynslice_copy(const void* idx, const void* plane, void* out,
                                            void* bands, int H, int W, int B, int reps,
                                            void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  dynslice_copy_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(plane), H, W, B, reps,
      static_cast<float*>(out), static_cast<float*>(bands));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meshflow_probe_dynslice_fine(const void* idx, const void* plane,
                                            const void* rsel, void* out, void* bands,
                                            void* rows, int H, int W, int B, int reps,
                                            void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  constexpr int bytes = (BAND_R * BAND_C + PN * BAND_R) * static_cast<int>(sizeof(float));
  const cudaError_t attr = cudaFuncSetAttribute(
      dynslice_fine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dynslice_fine_kernel<<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(plane),
      static_cast<const float*>(rsel), H, W, B, reps, static_cast<float*>(out),
      static_cast<float*>(bands), static_cast<float*>(rows));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meshflow_probe_onehot_rowsel(const void* idx, const void* plane, void* out,
                                            void* band, int H, int W, int B, int reps,
                                            void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  onehot_rowsel_kernel<<<B * PN, ROW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(plane), H, W, reps,
      static_cast<float*>(out), static_cast<float*>(band));
  return static_cast<int>(cudaGetLastError());
}
