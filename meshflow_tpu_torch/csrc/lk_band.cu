// Kernel C: one pyramid level of sparse pyramidal Lucas-Kanade tracking
// with the next-image footprint staged in shared memory (the "band fetch"
// form of kernel A).
//
// Replaces the JAX package's Pallas kernel `_lk_level_kernel` with band
// fetch (meshflow_tpu/kernels/_lk_pallas_band.py:89).  It computes the
// same function as kernel A (lk_level.cu) and is held against the same
// plain PyTorch version, `lk_level_plain` (meshflow_tpu_torch/kernels/
// lk.py); the per-feature logic is `lk::track_slot` in lk_common.cuh, so
// the two kernels differ only in where an iteration's taps come from.
//
// What bounds it: latency, as kernel A.  Each valid feature runs a
// data-dependent loop of up to 30 iterations, each a bilinear 21x21xC
// gather at a moving, unaligned position followed by two warp reductions.
//
// What staging the footprint changes: the Pallas kernel copies a
// pn x pn next-image patch around the iterate into VMEM (pn = 72 at the
// top level, 40 below), from 8-row / 128-lane aligned bands, and selects
// each iteration's window from it.  Here the warp copies the pn x pn x C
// uint8 patch into its own shared memory with 16-byte vector loads from
// 16-byte aligned addresses (each patch row starts at its address rounded
// down to 16 bytes; the row's lead offset is kept beside it), and every
// iteration reads its four taps a texel (as kernel A does) from shared
// memory instead of L1/L2.  When the iterate's footprint would
// leave the patch, the warp re-stages the patch around it.  The Pallas
// kernel's cap of 4 fetch rounds was a VMEM artifact and is not carried
// over: kernel C re-stages as often as the one 30-iteration budget needs
// and computes exactly what kernel A computes.
//
// Design: kernel A's persistent launch and per-slot loop (lk_common.cuh:
// staged set-up, work counter).  The patch lives in
// the warp's scratch, which the set-up's 576-byte support uses before the
// first iteration stages a patch, so a warp holds the frozen window
// (15,888 B at C = 3) plus the patch (20.9 KB at pn = 72, 7.8 KB at
// pn = 40).  The cost is occupancy against kernel A's 16,464 B a warp;
// what it reached is in PERF.md (§6, kernel table).

#include "lk_common.cuh"

namespace {

// Shared-memory geometry of one warp for a launch.
struct BandGeom {
  int pnr, pnc;     // staged patch rows, columns (pn, clipped to the plane)
  int nch;          // 16-byte chunks a patch row can touch at any alignment
  int patch_bytes;  // C * pnr rows of 16 * nch bytes
  int per_warp;     // window + scratch (patch and row offsets, or the support)
};

BandGeom band_geom(int C, int pn, int hpad, int wpad) {
  BandGeom g;
  g.pnr = pn < hpad ? pn : hpad;
  g.pnc = pn < wpad ? pn : wpad;
  g.nch = (g.pnc + 30) / 16;
  g.patch_bytes = C * g.pnr * 16 * g.nch;
  const int patch = g.patch_bytes + lk::align16(C * g.pnr);
  g.per_warp = lk::window_bytes(C) + (patch > lk::SUPPORT_BYTES ? patch : lk::SUPPORT_BYTES);
  return g;
}

// Next-image taps read from a patch staged in the warp's shared memory.
struct StagedTaps {
  const uint8_t* N;
  long long plane_size;
  uint8_t* patch;  // [C][pnr][16 * nch]
  uint8_t* offs;   // [C][pnr] lead offset of each staged row
  int hpad, wpad, C, pnr, pnc, nch, lane;
  int y0, x0;  // padded origin of the staged patch, y0 < 0: none
  int wy0, wx0;  // the window's origin, relative to the patch's

  __device__ __forceinline__ void bind(const uint8_t* n, long long size) {
    N = n;
    plane_size = size;
    y0 = -1;  // the set-up reuses the patch's bytes
    x0 = -1;
  }

  __device__ __forceinline__ void cover(int y, int x) {
    if (!(y0 >= 0 && y >= y0 && y + lk::SUPPORT <= y0 + pnr && x >= x0 &&
          x + lk::SUPPORT <= x0 + pnc))
      stage(y, x);
    wy0 = y - y0;
    wx0 = x - x0;
  }

  // Stage the patch around the footprint at padded (y, x).
  __device__ __forceinline__ void stage(int y, int x) {
    // Centre the patch on the footprint, clipped to the plane: every
    // in-bounds footprint lies inside the plane, so it then fits.
    y0 = min(max(y - (pnr - lk::SUPPORT) / 2, 0), hpad - pnr);
    x0 = min(max(x - (pnc - lk::SUPPORT) / 2, 0), wpad - pnc);
    __syncwarp();  // every lane is done with the previous patch
    const int sw = 16 * nch;
    const int per_plane = pnr * nch;
    for (int i = lane; i < C * per_plane; i += 32) {
      const int c = i / per_plane, rem = i - c * per_plane;
      const int r = rem / nch, k = rem - r * nch;
      const uintptr_t addr = reinterpret_cast<uintptr_t>(
          N + c * plane_size + static_cast<long long>(y0 + r) * wpad + x0);
      const uintptr_t base = addr & ~static_cast<uintptr_t>(15);
      const int off = static_cast<int>(addr - base);
      if (k == 0) offs[c * pnr + r] = static_cast<uint8_t>(off);
      // Only chunks that hold a byte of the row: an aligned 16-byte chunk
      // around a byte of the tensor lies inside its allocation.
      if (16 * k < off + pnc) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(base) + k);
        *reinterpret_cast<uint4*>(patch + (c * pnr + r) * sw + 16 * k) = v;
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ float texel(int, int c, int r, int col, float fy, float fx) const {
    const int row = c * pnr + wy0 + r, sw = 16 * nch, x = wx0 + col;
    const uint8_t* p0 = patch + row * sw + offs[row] + x;
    const uint8_t* p1 = patch + (row + 1) * sw + offs[row + 1] + x;
    return lk::bilinear(lk::u8f(p0[0]), lk::u8f(p0[1]), lk::u8f(p1[0]), lk::u8f(p1[1]), fy, fx);
  }
};

__global__ void __launch_bounds__(32 * lk::MAX_WARPS)
lk_band_kernel(const lk::LevelArgs a, const BandGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* mine = smem + warp * g.per_warp;
  float* win = reinterpret_cast<float*>(mine);
  uint8_t* scratch = mine + lk::window_bytes(a.C);
  StagedTaps taps{nullptr, 0, scratch, scratch + g.patch_bytes,
                  a.hpad, a.wpad, a.C, g.pnr, g.pnc, g.nch, lane, -1, -1, 0, 0};
  for (long long slot = lk::next_slot(a.counter, lane); slot < a.nslots;
       slot = lk::next_slot(a.counter, lane))
    lk::track_slot(a, slot, lane, win, scratch, taps);
}

lk::LaunchCache launches;

bool bad_geometry(int C, int pn, int hpad, int wpad) {
  return lk::bad_planes(C, hpad, wpad) || pn < lk::SUPPORT || hpad < lk::SUPPORT ||
         wpad < lk::SUPPORT;
}

}  // namespace

extern "C" int meshflow_lk_band(const void* prev, const void* next, const void* pts,
                                const void* guess, const void* valid,
                                const void* status_in, void* corner_out,
                                void* status_out, void* counter, int T, int S, int K, int C,
                                int hpad, int wpad, int rows, int cols, int shift,
                                int max_iters, float eps2, float min_eig_thr, int is_level0,
                                int pn, void* stream) {
  const long long nslots = static_cast<long long>(T) * S * K;
  if (bad_geometry(C, pn, hpad, wpad) || nslots > lk::MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nslots == 0) return static_cast<int>(cudaSuccess);
  const BandGeom g = band_geom(C, pn, hpad, wpad);
  lk::Launch l;
  const cudaError_t err = launches.get(lk_band_kernel, g.per_warp, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const lk::LevelArgs a{
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next),
      static_cast<const float*>(pts), static_cast<const float*>(guess),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(status_in),
      static_cast<float*>(corner_out), static_cast<uint8_t*>(status_out),
      static_cast<int*>(counter), nslots, S, K, C, hpad, wpad, rows, cols, shift,
      max_iters, eps2, min_eig_thr, is_level0};
  lk_band_kernel<<<lk::grid_for(l, nslots), 32 * l.warps_per_block, l.smem_per_block,
                   static_cast<cudaStream_t>(stream)>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of a geometry: resident warps per SM, shared bytes per
// block, warps per block, registers per thread.
extern "C" int meshflow_lk_band_occupancy(int C, int pn, int hpad, int wpad,
                                          int* warps_per_sm, int* smem_per_block,
                                          int* warps_per_block, int* regs) {
  if (bad_geometry(C, pn, hpad, wpad)) return static_cast<int>(cudaErrorInvalidValue);
  lk::Launch l;
  const cudaError_t err =
      launches.get(lk_band_kernel, band_geom(C, pn, hpad, wpad).per_warp, &l);
  *warps_per_sm = l.warps_per_sm();
  *smem_per_block = static_cast<int>(l.smem_per_block);
  *warps_per_block = l.warps_per_block;
  *regs = l.regs;
  return static_cast<int>(err);
}
