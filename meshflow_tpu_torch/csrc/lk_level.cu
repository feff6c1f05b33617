// Kernel A: one pyramid level of sparse pyramidal Lucas-Kanade tracking
// (cv2.calcOpticalFlowPyrLK semantics) for every (pair, tile, feature) slot.
//
// Replaces the JAX package's Pallas kernel `_lk_level_kernel`
// (meshflow_tpu/kernels/_lk_pallas_onehot.py:73).  The plain PyTorch
// version it is held against is `lk_level_plain` in
// meshflow_tpu_torch/kernels/lk.py; the per-feature logic, shared with
// kernel C, is `lk::track_slot` in lk_common.cuh.
//
// What bounds it: latency.  Each valid feature runs a data-dependent loop
// of up to 30 iterations, each gathering 21x21xC bilinear windows (4 taps
// per texel) at an unaligned, moving position, then reducing two sums
// before the next step can start.  At 640x360 a level holds ~8k valid
// features per pair, so the work is many short dependent chains, not
// bandwidth or FLOPs.
//
// Design: one warp per feature slot, two warps per block.  The Pallas
// kernel's one-hot MXU selection, channel-minor layouts and patch
// re-fetch rounds existed only for the TPU's vector unit and fast-memory
// size; here:
//   * lanes stride over the window texels (x C channels), so every load
//     and FMA-free product of an iteration is spread over 32 lanes;
//   * the frozen prev window (image, gx, gy: 3 * 441 * C floats) is kept
//     in shared memory for the warp, computed once per level; Scharr is
//     computed from the uint8 prev plane over the 23x23 support;
//   * each iteration reads the next-image taps straight from the padded
//     uint8 plane in global memory through the read-only cache (__ldg):
//     the 22x22 footprint stays in L1 across iterations, and no patch or
//     re-fetch is needed because the whole padded plane is addressable;
//   * the 2x2 system and the b vector are reduced with xor shuffles, so
//     every lane holds the result and runs the (uniform) control flow;
//   * a slot that is not valid exits at once (writes its pass-through).

#include "lk_common.cuh"

namespace {

constexpr int WARPS = 2;

// Next-image taps read from global memory through the read-only cache.
struct GlobalTaps {
  const uint8_t* N;
  long long plane_size;
  int wpad;

  __device__ __forceinline__ void bind(const uint8_t* n, long long size) {
    N = n;
    plane_size = size;
  }
  __device__ __forceinline__ void cover(int, int) {}
  __device__ __forceinline__ float at(int c, int y, int x) const {
    return lk::tap(N + c * plane_size, wpad, y, x);
  }
};

__global__ void __launch_bounds__(32 * WARPS) lk_level_kernel(const lk::LevelArgs a) {
  __shared__ float win[WARPS][3][lk::MAXC * lk::AREA];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (slot >= a.nslots) return;
  GlobalTaps taps{nullptr, 0, a.wpad};
  lk::track_slot(a, slot, lane, win[warp][0], win[warp][1], win[warp][2], taps);
}

}  // namespace

extern "C" int meshflow_lk_level(const void* prev, const void* next, const void* pts,
                                 const void* guess, const void* valid,
                                 const void* status_in, void* corner_out,
                                 void* status_out, int T, int S, int K, int C, int hpad,
                                 int wpad, int rows, int cols, int shift, int max_iters,
                                 float eps2, float min_eig_thr, int is_level0,
                                 void* stream) {
  if (C < 1 || C > lk::MAXC) return static_cast<int>(cudaErrorInvalidValue);
  const long long nslots = static_cast<long long>(T) * S * K;
  if (nslots == 0) return static_cast<int>(cudaSuccess);
  const lk::LevelArgs a{
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next),
      static_cast<const float*>(pts), static_cast<const float*>(guess),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(status_in),
      static_cast<float*>(corner_out), static_cast<uint8_t*>(status_out),
      nslots, S, K, C, hpad, wpad, rows, cols, shift, max_iters,
      eps2, min_eig_thr, is_level0};
  const long long blocks = (nslots + WARPS - 1) / WARPS;
  lk_level_kernel<<<static_cast<unsigned int>(blocks), 32 * WARPS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM and shared bytes per block.
extern "C" int meshflow_lk_level_occupancy(int* warps_per_sm, int* smem_per_block) {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lk_level_kernel, 32 * WARPS, 0);
  *warps_per_sm = blocks * WARPS;
  *smem_per_block = static_cast<int>(sizeof(float)) * WARPS * 3 * lk::MAXC * lk::AREA;
  return static_cast<int>(err);
}
