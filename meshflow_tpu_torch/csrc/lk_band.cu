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
// iteration reads its 22x22xC taps from shared memory instead of L1/L2.
// When the iterate's footprint would leave the patch, the warp re-stages
// the patch around it.  The Pallas kernel's cap of 4 fetch rounds was a
// VMEM artifact and is not carried over: kernel C re-stages as often as
// the one 30-iteration budget needs and computes exactly what kernel A
// computes.  The cost is occupancy: a warp holds the frozen prev window
// (3 * 441 * C floats) plus the patch (20.7 KB at pn = 72, C = 3; 7.7 KB
// at pn = 40), about 36.8 KB against kernel A's 15.9 KB.
//
// Design: one warp per feature slot, two warps per block; dynamic shared
// memory sized per launch from pn and C (above 48 KB per block through
// cudaFuncSetAttribute).

#include "lk_common.cuh"

namespace {

constexpr int WARPS = 2;

// Shared-memory geometry of one warp for a launch.
struct BandGeom {
  int pnr, pnc;     // staged patch rows, columns (pn, clipped to the plane)
  int nch;          // 16-byte chunks a patch row can touch at any alignment
  int win_bytes;    // frozen prev window: 3 * C * AREA floats, 16-aligned
  int patch_bytes;  // C * pnr rows of 16 * nch bytes
  int per_warp;     // win + patch + row offsets, 16-aligned
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

BandGeom band_geom(int C, int pn, int hpad, int wpad) {
  BandGeom g;
  g.pnr = pn < hpad ? pn : hpad;
  g.pnc = pn < wpad ? pn : wpad;
  g.nch = (g.pnc + 30) / 16;
  g.win_bytes = align16(3 * C * lk::AREA * static_cast<int>(sizeof(float)));
  g.patch_bytes = C * g.pnr * 16 * g.nch;
  g.per_warp = g.win_bytes + g.patch_bytes + align16(C * g.pnr);
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

  __device__ __forceinline__ void bind(const uint8_t* n, long long size) {
    N = n;
    plane_size = size;
    y0 = -1;
    x0 = -1;
  }

  __device__ __forceinline__ void cover(int y, int x) {
    if (y0 >= 0 && y >= y0 && y + lk::SUPPORT <= y0 + pnr && x >= x0 &&
        x + lk::SUPPORT <= x0 + pnc)
      return;
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

  __device__ __forceinline__ float at(int c, int y, int x) const {
    const int row = c * pnr + (y - y0);
    return static_cast<float>(patch[row * (16 * nch) + offs[row] + (x - x0)]);
  }
};

__global__ void __launch_bounds__(32 * WARPS)
lk_band_kernel(const lk::LevelArgs a, const BandGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (slot >= a.nslots) return;
  unsigned char* mine = smem + warp * g.per_warp;
  float* iw = reinterpret_cast<float*>(mine);
  float* gxw = iw + a.C * lk::AREA;
  float* gyw = gxw + a.C * lk::AREA;
  StagedTaps taps{nullptr, 0, mine + g.win_bytes, mine + g.win_bytes + g.patch_bytes,
                  a.hpad, a.wpad, a.C, g.pnr, g.pnc, g.nch, lane, -1, -1};
  lk::track_slot(a, slot, lane, iw, gxw, gyw, taps);
}

// Shared bytes per block, raising the kernel's dynamic limit when needed.
cudaError_t prepare(const BandGeom& g, size_t* bytes) {
  *bytes = static_cast<size_t>(WARPS) * g.per_warp;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(lk_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

extern "C" int meshflow_lk_band(const void* prev, const void* next, const void* pts,
                                const void* guess, const void* valid,
                                const void* status_in, void* corner_out,
                                void* status_out, int T, int S, int K, int C, int hpad,
                                int wpad, int rows, int cols, int shift, int max_iters,
                                float eps2, float min_eig_thr, int is_level0, int pn,
                                void* stream) {
  if (C < 1 || C > lk::MAXC || pn < lk::SUPPORT || hpad < lk::SUPPORT ||
      wpad < lk::SUPPORT)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nslots = static_cast<long long>(T) * S * K;
  if (nslots == 0) return static_cast<int>(cudaSuccess);
  const BandGeom g = band_geom(C, pn, hpad, wpad);
  size_t bytes = 0;
  const cudaError_t err = prepare(g, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const lk::LevelArgs a{
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next),
      static_cast<const float*>(pts), static_cast<const float*>(guess),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(status_in),
      static_cast<float*>(corner_out), static_cast<uint8_t*>(status_out),
      nslots, S, K, C, hpad, wpad, rows, cols, shift, max_iters,
      eps2, min_eig_thr, is_level0};
  const long long blocks = (nslots + WARPS - 1) / WARPS;
  lk_band_kernel<<<static_cast<unsigned int>(blocks), 32 * WARPS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM and shared bytes per block of a launch geometry.
extern "C" int meshflow_lk_band_occupancy(int C, int pn, int hpad, int wpad,
                                          int* warps_per_sm, int* smem_per_block) {
  if (C < 1 || C > lk::MAXC || pn < lk::SUPPORT || hpad < lk::SUPPORT ||
      wpad < lk::SUPPORT)
    return static_cast<int>(cudaErrorInvalidValue);
  const BandGeom g = band_geom(C, pn, hpad, wpad);
  size_t bytes = 0;
  cudaError_t err = prepare(g, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lk_band_kernel, 32 * WARPS,
                                                      bytes);
  *warps_per_sm = blocks * WARPS;
  *smem_per_block = static_cast<int>(bytes);
  return static_cast<int>(err);
}
