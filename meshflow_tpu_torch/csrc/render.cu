// The render's per-pixel sampling over a block of frames: the bilinear warp
// through kernel B's backward maps, and the crop-stretch back to full size.
//
// Replaces no TPU kernel: the JAX package renders with XLA-fused array code
// (meshflow_tpu/render/stabilize.py), so there is no Pallas counterpart.  The
// plain PyTorch versions it is held against, bit for bit, are
// `warp_frame_plain` and `crop_resize_frame_plain` in
// meshflow_tpu_torch/render/stabilize.py, which run ~90 and ~50 eager
// operators a frame.  Two entry points, one launch each over every frame of
// a block (grid.z):
//   1. warp_kernel: a pixel covered by its map samples the frame at (x, y):
//      x0 = floor(x), fx = x - x0 (y likewise); the taps (0,0), (0,1),
//      (1,0), (1,1) (dy, dx) in that order, each weighted
//      (1 - fx or fx) * (1 - fy or fy), a tap outside the image reading the
//      border colour, summed left to right from 0; an uncovered pixel takes
//      the border colour.  Then round half to even, clamp to 0..255, uint8.
//   2. crop_kernel: the crop [left, top, right, bottom] (read from device
//      memory, int32 or int64) stretched back to H x W with cv2.resize's
//      half-pixel sampling: s = (i + 0.5) * (crop_w / W) - 0.5 clamped to
//      [0, crop_w - 1], plus left; taps floor(s) and min(floor(s) + 1,
//      W - 1) (y likewise); the row lerp (1 - fy) a + fy b at both columns,
//      then the column lerp; round, clamp, uint8.
//
// What bounds it: bytes.  The warp reads 9 B of map (two floats and a
// bool) and C B of frame and writes C B a pixel; the crop reads and writes
// C B a pixel; each does a few float operations a byte.  In practice the
// instructions bound it, 4 C tap loads and about 25 more a byte: the bytes
// become floats and the sums bytes again by exact additions of 2^23
// (`u8_to_f32`, `to_u8`), since the conversion unit runs at a quarter of the
// float rate.  Design: the 32 lanes
// of a warp take 32 neighbouring pixels of one row, so every load and store
// instruction of a warp (maps, taps, the output's bytes) spans about 32
// neighbouring pixels, a few 128-byte lines; a thread takes RUN such
// pixels, BLOCK_X apart, sharing its row's set-up; the taps are read
// through the read-only path, where neighbouring lanes share them in L1; no
// shared memory.  Exactness: the build uses --fmad=false, and every
// product, sum and division below is an explicit round-to-nearest
// intrinsic in the plain version's order (tests/test_torch_render_exact.py
// emulates it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RUN = 4;  // pixels a thread, BLOCK_X apart along a row
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int THREADS = BLOCK_X * BLOCK_Y;

constexpr float TWO_23 = 8388608.0f;  // 2^23: from it up, floats are the integers

// float(b): the float whose bits are those of 2^23 with b in the low byte is
// 2^23 + b.
__device__ __forceinline__ float u8_to_f32(uint8_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), TWO_23);
}

// torch.clamp(torch.round(v), 0, 255).to(torch.uint8): clamping first gives
// the same byte, and 2^23 + v for v in [0, 255] rounds v to an integer, ties
// to even, in the low byte of its bits.
__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(__float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), TWO_23)));
}

// The thread's row y of frame blockIdx.z and its first pixel x0 (its k-th
// is x0 + k BLOCK_X); false when the row lies below the frame.
__device__ __forceinline__ bool row_of(int H, int* x0, int* y) {
  *x0 = blockIdx.x * BLOCK_X * RUN + threadIdx.x;
  *y = blockIdx.y * BLOCK_Y + threadIdx.y;
  return *y < H;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ map_x,
            const float* __restrict__ map_y, const uint8_t* __restrict__ covered,
            uint8_t* __restrict__ out, int H, int W, float b0, float b1, float b2) {
  int x0, y;
  if (!row_of(H, &x0, &y)) return;
  const long long plane = static_cast<long long>(H) * W;
  const long long row = blockIdx.z * plane + static_cast<long long>(y) * W;
  const uint8_t* img = frames + blockIdx.z * plane * C;
  const float border[3] = {b0, b1, b2};
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const int x = x0 + k * BLOCK_X;
    if (x >= W) return;
    const long long i = row + x;
    float acc[C];
    if (!__ldg(covered + i)) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = border[c];
    } else {
      const float mx = __ldg(map_x + i), my = __ldg(map_y + i);
      const float fx0 = floorf(mx), fy0 = floorf(my);
      const float fx = __fsub_rn(mx, fx0), fy = __fsub_rn(my, fy0);
      const int tx0 = static_cast<int>(fx0), ty0 = static_cast<int>(fy0);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int tx = tx0 + dx, ty = ty0 + dy;
          const float w = __fmul_rn(dx ? fx : __fsub_rn(1.0f, fx), dy ? fy : __fsub_rn(1.0f, fy));
          const bool inside = tx >= 0 && tx < W && ty >= 0 && ty < H;
          const uint8_t* tap = img + (static_cast<long long>(ty) * W + tx) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float s = inside ? u8_to_f32(__ldg(tap + c)) : border[c];
            acc[c] = __fadd_rn(acc[c], __fmul_rn(w, s));
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) out[i * C + c] = to_u8(acc[c]);
  }
}

// One axis of the crop-stretch at output index i: the taps i0, i1 and the
// weight f of i1, for a crop of `extent` pixels from `start` of an n-pixel
// axis (`scale` = extent / n).  The taps are clamped to the axis for memory
// safety only: crop edges inside the frame keep them there.
__device__ __forceinline__ void axis_taps(int i, float scale, float extent, float start, int n,
                                          int* i0, int* i1, float* f) {
  float s = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), scale), 0.5f);
  s = __fadd_rn(fminf(fmaxf(s, 0.0f), __fsub_rn(extent, 1.0f)), start);
  const float s0 = floorf(s);
  *f = __fsub_rn(s, s0);
  const int k = static_cast<int>(s0);
  *i0 = min(max(k, 0), n - 1);
  *i1 = min(max(min(k + 1, n - 1), 0), n - 1);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), a), __fmul_rn(f, b));
}

template <int C, typename Index>
__global__ void __launch_bounds__(THREADS)
crop_kernel(const uint8_t* __restrict__ frames, const Index* __restrict__ crop,
            uint8_t* __restrict__ out, int H, int W) {
  int x0, y;
  if (!row_of(H, &x0, &y)) return;
  const float left = static_cast<float>(__ldg(crop)), top = static_cast<float>(__ldg(crop + 1));
  const float crop_w = __fadd_rn(__fsub_rn(static_cast<float>(__ldg(crop + 2)), left), 1.0f);
  const float crop_h = __fadd_rn(__fsub_rn(static_cast<float>(__ldg(crop + 3)), top), 1.0f);
  const float sx = __fdiv_rn(crop_w, static_cast<float>(W));
  int r0, r1;
  float fy;
  axis_taps(y, __fdiv_rn(crop_h, static_cast<float>(H)), crop_h, top, H, &r0, &r1, &fy);
  const long long plane = static_cast<long long>(H) * W;
  const uint8_t* row0 = frames + (blockIdx.z * plane + static_cast<long long>(r0) * W) * C;
  const uint8_t* row1 = frames + (blockIdx.z * plane + static_cast<long long>(r1) * W) * C;
  uint8_t* dst = out + (blockIdx.z * plane + static_cast<long long>(y) * W) * C;
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const int x = x0 + k * BLOCK_X;
    if (x >= W) return;
    int c0, c1;
    float fx;
    axis_taps(x, sx, crop_w, left, W, &c0, &c1, &fx);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a = lerp(u8_to_f32(__ldg(row0 + c0 * C + c)),
                           u8_to_f32(__ldg(row1 + c0 * C + c)), fy);
      const float b = lerp(u8_to_f32(__ldg(row0 + c1 * C + c)),
                           u8_to_f32(__ldg(row1 + c1 * C + c)), fy);
      dst[x * C + c] = to_u8(lerp(a, b, fx));
    }
  }
}

dim3 grid_of(int F, int H, int W) {
  return dim3((W + BLOCK_X * RUN - 1) / (BLOCK_X * RUN), (H + BLOCK_Y - 1) / BLOCK_Y, F);
}

template <typename Kernel>
int occupancy(Kernel kernel, int* warps_per_sm, int* regs) {
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  *warps_per_sm = blocks * THREADS / 32;
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

}  // namespace

// Warp F frames (F, H, W, C) uint8, C = 1 or 3, through their maps (F, H, W)
// into out; b0..b2 the border colour (b0 alone for C = 1).
extern "C" int meshflow_render_warp(const void* frames, const void* map_x, const void* map_y,
                                    const void* covered, void* out, int F, int H, int W, int C,
                                    float b0, float b1, float b2, void* stream) {
  if (F == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid_of(F, H, W), dim3(BLOCK_X, BLOCK_Y), 0, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<const float*>(map_x),
        static_cast<const float*>(map_y), static_cast<const uint8_t*>(covered),
        static_cast<uint8_t*>(out), H, W, b0, b1, b2);
  };
  if (C == 1)
    launch(warp_kernel<1>);
  else if (C == 3)
    launch(warp_kernel<3>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Crop-stretch F frames (F, H, W, C) uint8 into out by the crop (4,) on the
// card, int64 when crop_is_64 else int32.
extern "C" int meshflow_render_crop(const void* frames, const void* crop, int crop_is_64,
                                    void* out, int F, int H, int W, int C, void* stream) {
  if (F == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, const auto* index) {
    kernel<<<grid_of(F, H, W), dim3(BLOCK_X, BLOCK_Y), 0, s>>>(
        static_cast<const uint8_t*>(frames), index, static_cast<uint8_t*>(out), H, W);
  };
  const long long* c64 = static_cast<const long long*>(crop);
  const int* c32 = static_cast<const int*>(crop);
  if (C == 1 && crop_is_64)
    launch(crop_kernel<1, long long>, c64);
  else if (C == 1)
    launch(crop_kernel<1, int>, c32);
  else if (C == 3 && crop_is_64)
    launch(crop_kernel<3, long long>, c64);
  else if (C == 3)
    launch(crop_kernel<3, int>, c32);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's launch shape at C planes (warp when `crop` is 0, else the
// crop-stretch with an int64 crop): resident warps per SM, registers a thread.
extern "C" int meshflow_render_occupancy(int crop, int C, int* warps_per_sm, int* regs) {
  if (C != 1 && C != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (crop)
    return C == 1 ? occupancy(crop_kernel<1, long long>, warps_per_sm, regs)
                  : occupancy(crop_kernel<3, long long>, warps_per_sm, regs);
  return C == 1 ? occupancy(warp_kernel<1>, warps_per_sm, regs)
                : occupancy(warp_kernel<3>, warps_per_sm, regs);
}
