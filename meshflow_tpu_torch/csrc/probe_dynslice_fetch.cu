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
// * dynslice_fine: the copy, then rows[p][c] = sum_k rsel[p][k] band[k][c]
//   (40x48 by 48x256), the sum taken in k order from 0.0 with separate
//   multiply and add (--fmad=false), as the plain version takes it, so the
//   kernel is bit-equal to it for any rsel.  rsel is an input: the probe's
//   own kernel reads a scratch that nothing writes.  Every round's rows are
//   stored with __stcg, an inline asm store the compiler cannot drop, so
//   no round's product is dead code.
// * onehot_rowsel: per round, all B*40 rows of the band the one-hot select
//   forms, row k = plane[idx[0] + r % 4 + k % 40] or zero past the plane,
//   written to global memory; out sums rows 0..7, columns 0..127, over
//   rounds in round order.  One block per band row, 16-byte loads.
//
// What bounds the copy and the one-hot form: bytes.  The copy moves 48 KB
// per feature per round and computes nothing; the one-hot form moves B*40
// rows of 2.6 KB per round.  Each round re-reads what the last read, so
// L2 (50 MB) holds the plane and the rates are L2's, not HBM's.
//
// What bounds the fine select on the H100: instruction issue.  A round is
// 40*48*256 multiply-adds per feature, and --fmad=false (which keeps the
// bits) makes each a separate FMUL and FADD: two issue slots, the floor,
// at 128 float lanes per SM and clock about 7,400 cycles a round at
// B = 128 (about 4 us).  Shared memory delivers 32 floats per SM and
// clock, so each value a thread loads from it has to feed more than one
// multiply-add.  Its bytes (48 KB in, 40 KB out per feature) are far
// below either.  One block per feature ran 256 threads on 16 SMs at
// B = 16, loaded two shared values per multiply-add, and waited for each
// band before its product.  Design: a feature's outputs are split by
// column into 8 slices of 32 columns, one block each (128 blocks at
// B = 16), and a block stages only the 48 x 32 band columns its outputs
// read.  A thread owns two output rows and four columns: each k is an
// 8-byte load of its two rsel values (staged once, k-major) and a 16-byte
// load of four band values, then eight FMUL + FADD pairs (18 instructions
// for 16 of the floor, 0.75 shared floats a multiply-add).  Holding the
// two rsel rows in registers instead (96 of them, three blocks an SM) was
// measured slower at B = 16 and 64 and no faster at 128.  The band is
// double-buffered: round r + 1's slice is fetched with cp.async while
// round r's product runs, so one barrier a round remains, where a buffer
// is reused.

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

constexpr int FINE_COLS = 32;                      // band columns a fine block reads
constexpr int FINE_SLICES = BAND_C / FINE_COLS;    // fine blocks per feature
constexpr int FINE_Q = FINE_COLS / 4;              // float4 per slice row
constexpr int FINE_THREADS = (PN / 2) * (FINE_COLS / 4);  // 2 rows x 4 columns a thread
constexpr int FINE_SLICE = BAND_R * FINE_COLS;     // floats of one staged slice

// Start copying the 48 x 32 slice at column c0 of feature (ri, ci)'s band
// of round r into `dst`, as one cp.async group.
__device__ __forceinline__ void stage_slice(const float* __restrict__ plane, int H, int W,
                                            int ri, int ci, int r, int c0, float* dst) {
  const int rs = probes::dyn_start(probes::floor_div(ri + 8 * (r % 4), 8) * 8, H, BAND_R);
  const int cs =
      probes::dyn_start(probes::floor_div(ci + 128 * (r % 2), 128) * 128, W, BAND_C) + c0;
  for (int q = threadIdx.x; q < BAND_R * FINE_Q; q += FINE_THREADS)
    probes::cp_async16(dst + q * 4,
                       plane + static_cast<long long>(rs + q / FINE_Q) * W + cs + (q % FINE_Q) * 4);
  probes::cp_async_commit();
}

__global__ void __launch_bounds__(FINE_THREADS, 5)
dynslice_fine_kernel(const int* __restrict__ idx, const float* __restrict__ plane,
                     const float* __restrict__ rsel, int H, int W, int B, int reps,
                     float* __restrict__ out, float* __restrict__ bands,
                     float* __restrict__ rows) {
  __shared__ __align__(16) float buf[2][FINE_SLICE];
  __shared__ __align__(16) float2 ssel[BAND_R][PN / 2];  // rsel[i][p][k], rsel[i][p + 1][k]
  const int i = blockIdx.x / FINE_SLICES;
  const int c0 = (blockIdx.x % FINE_SLICES) * FINE_COLS;
  const int p = (threadIdx.x / (FINE_COLS / 4)) * 2;    // this thread's rows p, p + 1
  const int c = c0 + (threadIdx.x % (FINE_COLS / 4)) * 4;  // and columns c .. c + 3
  const int ri = __ldg(idx + 2 * i), ci = __ldg(idx + 2 * i + 1);
  stage_slice(plane, H, W, ri, ci, 0, c0, buf[0]);

  for (int q = threadIdx.x; q < PN * BAND_R; q += FINE_THREADS) {  // the same every round
    const int pr = q / BAND_R, k = q % BAND_R;
    reinterpret_cast<float*>(&ssel[k][pr / 2])[pr % 2] =
        __ldg(rsel + static_cast<long long>(i) * PN * BAND_R + q);
  }
  const float2* sel = &ssel[0][p / 2];
  float* dst = rows + (static_cast<long long>(i) * PN + p) * BAND_C + c;
  const bool corner = i == B - 1 && p < 8 && c < 128;  // out: rows 0..7, columns 0..127

  for (int r = 0; r < reps; ++r) {
    probes::cp_async_wait_group<0>();  // this thread's copies of round r
    __syncthreads();  // everyone's copies of round r landed; round r - 1's buffer is free
    if (r + 1 < reps) stage_slice(plane, H, W, ri, ci, r + 1, c0, buf[(r + 1) & 1]);
    const float* band = buf[r & 1] + (c - c0);
    float4 a0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), a1 = a0;
#pragma unroll
    for (int k = 0; k < BAND_R; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(band + k * FINE_COLS);
      const float2 sk = sel[k * (PN / 2)];
      a0.x = a0.x + sk.x * v.x;
      a0.y = a0.y + sk.x * v.y;
      a0.z = a0.z + sk.x * v.z;
      a0.w = a0.w + sk.x * v.w;
      a1.x = a1.x + sk.y * v.x;
      a1.y = a1.y + sk.y * v.y;
      a1.z = a1.z + sk.y * v.z;
      a1.w = a1.w + sk.y * v.w;
    }
    __stcg(reinterpret_cast<float4*>(dst), a0);  // asm stores: no round's product is dead
    __stcg(reinterpret_cast<float4*>(dst + BAND_C), a1);
    if (corner && r == reps - 1) {
      const float zero = static_cast<float>(r) * 0.0f;
      *reinterpret_cast<float4*>(out + p * 128 + c) =
          make_float4(a0.x + zero, a0.y + zero, a0.z + zero, a0.w + zero);
      *reinterpret_cast<float4*>(out + (p + 1) * 128 + c) =
          make_float4(a1.x + zero, a1.y + zero, a1.z + zero, a1.w + zero);
    }
  }
  // bands[i] <- this block's columns of the last round's band
  const float4* last = reinterpret_cast<const float4*>(buf[(reps - 1) & 1]);
  for (int q = threadIdx.x; q < BAND_R * FINE_Q; q += FINE_THREADS)
    reinterpret_cast<float4*>(bands + (static_cast<long long>(i) * BAND_R + q / FINE_Q) * BAND_C +
                              c0)[q % FINE_Q] = last[q];
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
  dynslice_fine_kernel<<<B * FINE_SLICES, FINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
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
