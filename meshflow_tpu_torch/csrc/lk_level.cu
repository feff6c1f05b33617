// Kernel A: one pyramid level of sparse pyramidal Lucas-Kanade tracking
// (cv2.calcOpticalFlowPyrLK semantics) for every (pair, tile, feature) slot.
//
// Replaces the JAX package's Pallas kernel `_lk_level_kernel`
// (meshflow_tpu/kernels/_lk_pallas_onehot.py:73).  The plain PyTorch
// version it is held against is `lk_level_plain` in
// meshflow_tpu_torch/kernels/lk.py; the per-feature logic, shared with
// kernel C, is `lk::track_slot` in lk_common.cuh, whose header says how the
// set-up, the iterations and the launch are laid out for this card.
//
// What bounds it: latency.  Each valid feature runs a data-dependent loop
// of up to 30 iterations, each gathering a 21x21xC bilinear window at an
// unaligned, moving position, then reducing two sums before the next step
// can start.  A main-path launch holds 16 tiles x 512 slots per pair (63
// pairs in a motion block), ~90% of them valid, ~6 steps each on average:
// many short dependent chains, far from the card's float rate or bandwidth.
//
// Design: persistent warps, one slot at a time per warp, taken from a work
// counter; as many blocks as stay resident, each with the warps per block
// that keep the most warps on an SM (lk::LaunchCache).  The Pallas kernel's
// one-hot MXU selection, channel-minor layouts and patch re-fetch rounds
// existed only for the TPU's vector unit and fast-memory size; here:
//   * the frozen prev window (gx, gy, image: 3 * 441 * C floats) is kept in
//     the warp's shared memory, set up once per slot from a staged support
//     with one integer Scharr evaluation per support point;
//   * each iteration reads the next-image taps straight from the padded
//     uint8 plane in global memory through the read-only cache (__ldg), four
//     taps per texel at an int32 offset that each lane advances by adds;
//   * the 2x2 system and the b vector are reduced with xor shuffles, so
//     every lane holds the result and runs the (uniform) control flow;
//   * a slot that is not valid exits at once (writes its pass-through).
// Shared memory per warp: 15,888 B of window at C = 3 (5,296 at C = 1) plus
// the 576-byte support, so 14 warps per SM at C = 3.  What it reached and
// what holds it back now (PERF.md §6, H100 80GB HBM3 at 700 W): 2.1x the
// earlier one-slot-per-block kernel (four Scharr pairs per texel) at the
// main path's motion launch, with the set-up and the steps each about
// twice as fast; the set-up is still ~40% of a launch, and the time is
// latency at 14 warps per SM (fewer warps were slower in proportion, more
// do not fit the shared memory) over a step's 42 trips of dependent loads
// and sums per lane.

#include "lk_common.cuh"

namespace {

// Next-image taps read from global memory through the read-only cache.
struct GlobalTaps {
  const uint8_t* N;
  long long plane_size;
  int wpad;
  const uint8_t* origin;  // the window's top-left tap in channel 0

  __device__ __forceinline__ void bind(const uint8_t* n, long long size) {
    N = n;
    plane_size = size;
  }
  __device__ __forceinline__ void cover(int y, int x) {
    origin = N + static_cast<long long>(y) * wpad + x;
  }
  __device__ __forceinline__ float texel(int off, int, int, int, float fy, float fx) const {
    const uint8_t* p = origin + off;
    return lk::bilinear(lk::u8f(__ldg(p)), lk::u8f(__ldg(p + 1)), lk::u8f(__ldg(p + wpad)),
                        lk::u8f(__ldg(p + wpad + 1)), fy, fx);
  }
};

int per_warp_bytes(int C) { return lk::window_bytes(C) + lk::SUPPORT_BYTES; }

__global__ void __launch_bounds__(32 * lk::MAX_WARPS) lk_level_kernel(const lk::LevelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* mine = smem + warp * (lk::window_bytes(a.C) + lk::SUPPORT_BYTES);
  float* win = reinterpret_cast<float*>(mine);
  uint8_t* scratch = mine + lk::window_bytes(a.C);
  GlobalTaps taps{nullptr, 0, a.wpad, nullptr};
  for (long long slot = lk::next_slot(a.counter, lane); slot < a.nslots;
       slot = lk::next_slot(a.counter, lane))
    lk::track_slot(a, slot, lane, win, scratch, taps);
}

lk::LaunchCache launches;

}  // namespace

extern "C" int meshflow_lk_level(const void* prev, const void* next, const void* pts,
                                 const void* guess, const void* valid,
                                 const void* status_in, void* corner_out,
                                 void* status_out, void* counter, int T, int S, int K, int C,
                                 int hpad, int wpad, int rows, int cols, int shift,
                                 int max_iters, float eps2, float min_eig_thr, int is_level0,
                                 void* stream) {
  const long long nslots = static_cast<long long>(T) * S * K;
  if (lk::bad_planes(C, hpad, wpad) || nslots > lk::MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nslots == 0) return static_cast<int>(cudaSuccess);
  lk::Launch l;
  const cudaError_t err = launches.get(lk_level_kernel, per_warp_bytes(C), &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const lk::LevelArgs a{
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next),
      static_cast<const float*>(pts), static_cast<const float*>(guess),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(status_in),
      static_cast<float*>(corner_out), static_cast<uint8_t*>(status_out),
      static_cast<int*>(counter), nslots, S, K, C, hpad, wpad, rows, cols, shift,
      max_iters, eps2, min_eig_thr, is_level0};
  lk_level_kernel<<<lk::grid_for(l, nslots), 32 * l.warps_per_block, l.smem_per_block,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape at C channels: resident warps per SM, shared bytes per
// block, warps per block, registers per thread.
extern "C" int meshflow_lk_level_occupancy(int C, int* warps_per_sm, int* smem_per_block,
                                           int* warps_per_block, int* regs) {
  if (C < 1 || C > lk::MAXC) return static_cast<int>(cudaErrorInvalidValue);
  lk::Launch l;
  const cudaError_t err = launches.get(lk_level_kernel, per_warp_bytes(C), &l);
  *warps_per_sm = l.warps_per_sm();
  *smem_per_block = static_cast<int>(l.smem_per_block);
  *warps_per_block = l.warps_per_block;
  *regs = l.regs;
  return static_cast<int>(err);
}
