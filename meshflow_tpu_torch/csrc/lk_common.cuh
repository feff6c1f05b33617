// Per-feature logic shared by the LK level kernels A (lk_level.cu) and C
// (lk_band.cu): one warp tracks one (pair, tile, feature) slot through one
// pyramid level with cv2.calcOpticalFlowPyrLK semantics.  The two kernels
// differ only in where an iteration's next-image taps come from, which is
// the `Taps` template parameter of `track_slot`:
//
//   struct Taps {
//     // N: the slot's next plane (channel 0), plane_size: bytes per channel
//     __device__ void bind(const uint8_t* N, long long plane_size);
//     // make the 22x22 tap footprint whose top-left padded texel is (y, x)
//     // readable, as the window's origin; called by all 32 lanes alike
//     __device__ void cover(int y, int x);
//     // `bilinear` of the four uint8 next-image taps of window texel
//     // (c, r, col) at (fy, fx); off = c * plane_size + r * wpad + col is
//     // that texel's offset from the origin in the padded planes
//     __device__ float texel(int off, int c, int r, int col, float fy, float fx) const;
//   };
//
// Everything else is computed here in one order of operations, the order of
// the plain version `lk_level_plain` (meshflow_tpu_torch/kernels/lk.py):
// bilinear rows before columns, (1-f)*lo + f*hi, Scharr as 3*d + 10*d + 3*d,
// the same update and stopping tests.  Only the window sums differ in order:
// lane l sums texels l, l+32, ... of the flattened (channel, row, column)
// window in that order, and a warp reduces the lanes by xor shuffles, which
// leave every lane with the same bits (each butterfly step adds the same two
// values in either order), so the control flow of the loop is warp-uniform.
// Compiled with --fmad=false so products and sums round like the plain
// version's separate ops.
//
// What bounds the loop, and what its design does about it (H100):
//   * Latency and issue: each warp runs dependent chains (tap loads, lerps,
//     two warp reductions per step) at 14 warps per SM, so every
//     instruction a texel needs shows in the time.  Set-up and iteration
//     therefore do each operation the function needs once, and little else:
//   * Set-up from a staged support.  The warp copies the 24x24 uint8 prev
//     support of one channel into shared memory (aligned 4-byte loads,
//     shifted into place; the next channel's are in flight meanwhile),
//     computes each of the 22x22 support points'
//     Scharr pair once, in integers (|3a+10b+3c| <= 4080, so the int16 it
//     is kept as, times 1/32, is exactly the float the plain version
//     computes), and bilinearly samples the frozen window (gx, gy, image)
//     from the staging.  The Scharr staging lives in the bytes of the
//     channel's own window (see `setup_channel`), so the set-up adds only
//     the 576-byte support to the warp's shared memory.
//   * Iterations: lane l keeps texels l, l+32, ...; its (channel, row,
//     column) and its int32 tap offset from the window's origin advance by
//     32 texels with adds (`advance`), no divisions and no 64-bit address
//     arithmetic per texel; four taps per texel.  Taking the "column x+1"
//     lerp from the next lane by a shuffle halves the taps but was measured
//     slower on the H100 (a shuffle chained to a load every trip; PERF.md
//     §6), so each texel reads its own four.  A uint8 or an int16 Scharr
//     sum becomes a float through its bit pattern (`u8f`, `unscale`), not
//     the quarter-rate I2F.
//   * Persistent warps: a launch holds as many blocks as stay resident, and
//     each warp takes its next slot from a work counter (`next_slot`), so
//     an invalid slot costs a few instructions and no warp waits on another.
//     A grid-stride order (warp w takes slots w, w + warps, ...; no
//     counter) was measured 1.18-1.31x slower at every LK case, kernel C
//     too, which it left at 81 registers and no spills (PERF.md §6).
//   * Shared memory per warp is sized from C (dynamic), not for 3 channels.

#pragma once

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace lk {

constexpr int WIN = 21;
constexpr int AREA = WIN * WIN;
constexpr int SUPPORT = WIN + 1;  // bilinear taps per axis of a window
constexpr int STAGE = WIN + 3;    // staged prev support per axis (Scharr's 3x3)
constexpr int PAD = 28;
constexpr int MAXC = 3;
constexpr int MAX_WARPS = 16;  // warps per block of a persistent launch
constexpr float CV_SCALE = 1.0f / 1024.0f;
constexpr float FLT_EPS = 1.19209290e-07f;

// One channel of a warp's frozen window: gx, gy, image, AREA floats each.
constexpr int CH_FLOATS = 3 * AREA;
// The set-up's int16 Scharr pairs (SUPPORT^2 short2) occupy the last bytes
// of the channel's window block while its gx and gy are sampled.
constexpr int SCHARR_OFFSET = CH_FLOATS * 4 - SUPPORT * SUPPORT * 4;
constexpr int SUPPORT_BYTES = STAGE * STAGE;

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Shared bytes of a warp's frozen window; its scratch (the staged support,
// and kernel C's patch) starts there.
__host__ __device__ constexpr int window_bytes(int C) { return align16(C * CH_FLOATS * 4); }

// The arguments of one level launch (the C entry points' parameters).
struct LevelArgs {
  const uint8_t* prev;
  const uint8_t* next;
  const float* pts;
  const float* guess;
  const uint8_t* valid;
  const uint8_t* status_in;
  float* corner_out;
  uint8_t* status_out;
  int* counter;  // work counter: slots handed out so far (0 at launch)
  long long nslots;
  int S, K, C, hpad, wpad, rows, cols, shift, max_iters;
  float eps2, min_eig_thr;
  int is_level0;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The warp's next slot from the work counter (the same on every lane).
__device__ __forceinline__ long long next_slot(int* counter, int lane) {
  int s = 0;
  if (lane == 0) s = atomicAdd(counter, 1);
  return __shfl_sync(0xffffffffu, s, 0);
}

__device__ __forceinline__ float bilinear(float v00, float v01, float v10, float v11,
                                          float fy, float fx) {
  const float lo = (1.0f - fy) * v00 + fy * v10;  // column x
  const float hi = (1.0f - fy) * v01 + fy * v11;  // column x + 1
  return (1.0f - fx) * lo + fx * hi;
}

__device__ __forceinline__ bool in_bounds(int ix, int iy, int rows, int cols) {
  return ix >= -WIN && ix < cols && iy >= -WIN && iy < rows;
}

__device__ __forceinline__ void write_slot(const LevelArgs& a, long long slot, int lane,
                                           float cx, float cy, bool st) {
  if (lane == 0) {
    a.corner_out[2 * slot] = cx;
    a.corner_out[2 * slot + 1] = cy;
    a.status_out[slot] = st;
  }
}

// The STAGE x STAGE uint8 block of `plane` whose top-left padded texel is
// (y, x), row-major (STAGE bytes a row), as SUPPORT_WORDS words: lane l
// holds words l, l + 32, ..., each read as the two aligned words around it
// and shifted into place.  Every word read lies inside the block's rows
// (x >= 6, x + 27 < wpad).
constexpr int SUPPORT_WORDS = STAGE * STAGE / 4;
constexpr int LANE_WORDS = (SUPPORT_WORDS + 31) / 32;

__device__ __forceinline__ void load_support(const uint8_t* plane, int wpad, int y, int x,
                                             int lane, unsigned (&words)[LANE_WORDS]) {
  constexpr int ROW_WORDS = STAGE / 4;
#pragma unroll
  for (int k = 0; k < LANE_WORDS; ++k) {
    const int w = lane + 32 * k;
    if (w < SUPPORT_WORDS) {
      const int row = w / ROW_WORDS, q = w - row * ROW_WORDS;
      const uintptr_t addr =
          reinterpret_cast<uintptr_t>(plane + static_cast<long long>(y + row) * wpad + x) +
          4 * q;
      const unsigned* base =
          reinterpret_cast<const unsigned*>(addr & ~static_cast<uintptr_t>(3));
      const unsigned shift = 8u * static_cast<unsigned>(addr & 3);
      const unsigned lo = __ldg(base);
      const unsigned hi = shift ? __ldg(base + 1) : 0u;
      words[k] = __funnelshift_r(lo, hi, shift);
    }
  }
}

__device__ __forceinline__ void store_support(uint8_t* s, int lane,
                                              const unsigned (&words)[LANE_WORDS]) {
#pragma unroll
  for (int k = 0; k < LANE_WORDS; ++k)
    if (lane + 32 * k < SUPPORT_WORDS) reinterpret_cast<unsigned*>(s)[lane + 32 * k] = words[k];
}

// 32x the Scharr x/y derivative at support point (sy, sx) of the staged
// support `s`, zero outside the level ((ly, lx): the point's level texel).
// Exact: uint8 taps, integer weights.
__device__ __forceinline__ short2 scharr_point(const uint8_t* s, int sy, int sx, int ly,
                                               int lx, int rows, int cols) {
  if (ly < 0 || ly >= rows || lx < 0 || lx >= cols) return make_short2(0, 0);
  const uint8_t* p = s + sy * STAGE + sx;  // top-left of the 3x3
  const int a00 = p[0], a01 = p[1], a02 = p[2];
  const int a10 = p[STAGE], a12 = p[STAGE + 2];
  const int a20 = p[2 * STAGE], a21 = p[2 * STAGE + 1], a22 = p[2 * STAGE + 2];
  return make_short2(static_cast<short>(3 * (a02 - a00) + 10 * (a12 - a10) + 3 * (a22 - a20)),
                     static_cast<short>(3 * (a20 - a00) + 10 * (a21 - a01) + 3 * (a22 - a02)));
}

// Exact conversions without the quarter-rate I2F: an integer added to the
// bit pattern of 2^23 (a uint8) or of 1.5 * 2^18 (|v| < 2^21, in steps of
// 1/32) is a float whose value is the base plus the integer (times 1/32),
// and subtracting the base is exact.
__device__ __forceinline__ float u8f(unsigned v) {
  return __int_as_float(0x4B000000u | v) - 8388608.0f;
}

// The float the plain version computes for a Scharr sum: sum * (1/32).
__device__ __forceinline__ float unscale(short v) {
  return __int_as_float(0x48C00000 + v) - 393216.0f;
}

// Frozen window of channel c (`ch`: gx, gy, image) from the support of that
// channel staged in `sup` (the warp's SUPPORT_BYTES of scratch); adds its
// texels' gradient products to the lane's sums in the lane's texel order.
//
// The Scharr pairs are staged at SCHARR_OFFSET of `ch`, i.e. over gy's last
// 43 texels and the image window.  gy's texels 398..440 overwrite Scharr
// points 0..42 (support rows 0 and 1), which only texels 0..41 read; one
// __syncwarp before the first trip that starts past texel 41 orders those
// reads before those writes.  The image window is written after the last
// Scharr read.
__device__ __forceinline__ void setup_channel(int ipy, int ipx, int rows, int cols, float fb0,
                                              float fa0, int c, float* ch, const uint8_t* sup,
                                              int lane, float& s11, float& s12, float& s22) {
  short2* sch = reinterpret_cast<short2*>(reinterpret_cast<unsigned char*>(ch) + SCHARR_OFFSET);
  for (int q = lane; q < SUPPORT * SUPPORT; q += 32) {
    const int sy = q / SUPPORT, sx = q - sy * SUPPORT;
    sch[q] = scharr_point(sup, sy, sx, ipy + sy, ipx + sx, rows, cols);
  }
  __syncwarp();
  // gx, gy: trips aligned with the iterations' (texel i on lane i % 32)
  const int first = c * AREA;
  for (int base = first & ~31; base < first + AREA; base += 32) {
    if (base - first >= 2 * WIN && base - first < 2 * WIN + 32) __syncwarp();
    const int j = base + lane - first;
    if (j >= 0 && j < AREA) {
      const int r = j / WIN, col = j - r * WIN;
      const short2 g00 = sch[r * SUPPORT + col], g01 = sch[r * SUPPORT + col + 1];
      const short2 g10 = sch[(r + 1) * SUPPORT + col], g11 = sch[(r + 1) * SUPPORT + col + 1];
      const float gx = bilinear(unscale(g00.x), unscale(g01.x), unscale(g10.x),
                                unscale(g11.x), fb0, fa0);
      const float gy = bilinear(unscale(g00.y), unscale(g01.y), unscale(g10.y),
                                unscale(g11.y), fb0, fa0);
      ch[j] = gx;
      ch[AREA + j] = gy;
      s11 += gx * gx;
      s12 += gx * gy;
      s22 += gy * gy;
    }
  }
  __syncwarp();
  for (int j = lane; j < AREA; j += 32) {
    const int r = j / WIN, col = j - r * WIN;
    const uint8_t* t = sup + (r + 1) * STAGE + col + 1;
    ch[2 * AREA + j] = bilinear(u8f(t[0]), u8f(t[1]), u8f(t[STAGE]), u8f(t[STAGE + 1]), fb0, fa0);
  }
}

// Texel i + 32 of texel i = (c, r, col) (32 = WIN + 11), and its tap
// offset off = c * plane + r * wpad + col from the window's origin.
__device__ __forceinline__ void advance(int& c, int& r, int& col, int& off, int wpad,
                                        int plane) {
  col += 32 - WIN;
  r += 1;
  off += wpad + 32 - WIN;
  if (col >= WIN) {
    col -= WIN;
    r += 1;
    off += wpad - WIN;
  }
  if (r >= WIN) {
    r -= WIN;
    c += 1;
    off += plane - WIN * wpad;
  }
}

// Track one slot through the level.  win: the warp's C * CH_FLOATS floats
// of shared memory for the frozen window; scratch: its SUPPORT_BYTES (or
// more) of set-up staging, which the Taps may reuse during the iterations.
template <class Taps>
__device__ __forceinline__ void track_slot(const LevelArgs& a, long long slot, int lane,
                                           float* win, uint8_t* scratch, Taps& taps) {
  float cx = a.guess[2 * slot], cy = a.guess[2 * slot + 1];
  bool st = a.status_in[slot] != 0;
  if (!a.valid[slot]) {
    write_slot(a, slot, lane, cx, cy, st);
    return;
  }

  const int C = a.C, wpad = a.wpad, rows = a.rows, cols = a.cols;
  const long long pair = slot / (static_cast<long long>(a.S) * a.K);
  const long long tile = (slot / a.K) % a.S;
  const long long plane_size = static_cast<long long>(a.hpad) * wpad;
  const uint8_t* P = a.prev + (pair * a.S + tile) * C * plane_size;
  taps.bind(a.next + ((pair + a.shift) * a.S + tile) * C * plane_size, plane_size);

  const float px = a.pts[2 * slot], py = a.pts[2 * slot + 1];
  const float ipx_f = floorf(px), ipy_f = floorf(py);
  const float fa0 = px - ipx_f, fb0 = py - ipy_f;
  const int ipx = static_cast<int>(ipx_f), ipy = static_cast<int>(ipy_f);

  if (!in_bounds(ipx, ipy, rows, cols)) {
    write_slot(a, slot, lane, cx, cy, a.is_level0 ? false : st);
    return;
  }

  // Frozen prev window and its gradient matrix.
  __syncwarp();  // every lane is done with the warp's previous slot
  float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
  // The next channel's support is loaded while this one's is used.
  unsigned words[LANE_WORDS];
  load_support(P, wpad, ipy + PAD - 1, ipx + PAD - 1, lane, words);
  for (int c = 0; c < C; ++c) {
    store_support(scratch, lane, words);
    __syncwarp();
    if (c + 1 < C)
      load_support(P + (c + 1) * plane_size, wpad, ipy + PAD - 1, ipx + PAD - 1, lane, words);
    setup_channel(ipy, ipx, rows, cols, fb0, fa0, c, win + c * CH_FLOATS, scratch, lane,
                  s11, s12, s22);
    __syncwarp();  // the next channel re-stages the support
  }
  const float a11 = warp_sum(s11) * CV_SCALE;
  const float a12 = warp_sum(s12) * CV_SCALE;
  const float a22 = warp_sum(s22) * CV_SCALE;
  const float det = a11 * a22 - a12 * a12;
  const float dd = a11 - a22;
  const float min_eig =
      (a22 + a11 - sqrtf(dd * dd + 4.0f * a12 * a12)) / (2.0f * WIN * WIN);
  const bool well_posed = (min_eig >= a.min_eig_thr) && (det >= FLT_EPS);
  const float inv_det = det == 0.0f ? 0.0f : 1.0f / det;
  if (a.is_level0) st = st && well_posed;

  const int texels = C * AREA;
  const int plane = static_cast<int>(plane_size);  // C * plane < 2^31 (entry points)
  const int r0 = lane / WIN, col0 = lane - r0 * WIN;  // the lane's first texel
  bool active = well_posed;
  float pdx = 0.0f, pdy = 0.0f;
  for (int j = 0; j < a.max_iters && active; ++j) {
    const float icx_f = floorf(cx), icy_f = floorf(cy);
    const float fa = cx - icx_f, fb = cy - icy_f;
    const int icx = static_cast<int>(icx_f), icy = static_cast<int>(icy_f);
    if (!in_bounds(icx, icy, rows, cols)) {
      if (a.is_level0) st = false;
      break;
    }
    taps.cover(icy + PAD, icx + PAD);
    float sb1 = 0.0f, sb2 = 0.0f;
    int c = 0, r = r0, col = col0, off = r0 * wpad + col0;
#pragma unroll 8  // against 4 on the H100: PERF.md §6
    for (int i = lane; i < texels; i += 32) {
      const float jw = taps.texel(off, c, r, col, fb, fa);
      const float* w = win + i + 2 * AREA * c;  // channel c's block: gx, gy, image
      const float diff = jw - w[2 * AREA];
      sb1 += diff * w[0];
      sb2 += diff * w[AREA];
      advance(c, r, col, off, wpad, plane);
    }
    const float b1 = warp_sum(sb1) * CV_SCALE;
    const float b2 = warp_sum(sb2) * CV_SCALE;
    const float dx = (a12 * b2 - a22 * b1) * inv_det;
    const float dy = (a12 * b1 - a11 * b2) * inv_det;
    float ncx = cx + dx, ncy = cy + dy;
    const bool converged = (dx * dx + dy * dy) <= a.eps2;
    const bool oscillating =
        j > 0 && fabsf(dx + pdx) < 0.01f && fabsf(dy + pdy) < 0.01f;
    if (oscillating) {
      ncx = ncx - dx * 0.5f;
      ncy = ncy - dy * 0.5f;
    }
    cx = ncx;
    cy = ncy;
    active = !converged && !oscillating;
    pdx = dx;
    pdy = dy;
  }
  write_slot(a, slot, lane, cx, cy, st);
}

// ---- host side: the persistent launch shape -------------------------------

// A persistent launch: warps per block, blocks per SM, grid, registers.
struct Launch {
  int warps_per_block = 0, blocks_per_sm = 0, grid = 0, regs = 0;
  size_t smem_per_block = 0;
  int warps_per_sm() const { return warps_per_block * blocks_per_sm; }
};

// The launch shape that keeps the most warps resident for `per_warp` shared
// bytes a warp, found once per (device, per_warp) with the occupancy API and
// cached: every launch of a kernel on a device then costs no query.
class LaunchCache {
 public:
  template <class Kernel>
  cudaError_t get(Kernel kernel, int per_warp, Launch* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mutex_);
    for (int i = 0; i < n_; ++i)
      if (keys_[i][0] == dev && keys_[i][1] == per_warp) {
        *out = shapes_[i];
        return cudaSuccess;
      }
    int sms = 0, max_smem = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    max_smem)) ||
        (err = cudaFuncGetAttributes(&attr, kernel)))
      return err;
    Launch best;
    for (int w = 1; w <= MAX_WARPS && w * per_warp <= max_smem; ++w) {
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * w,
                                                          static_cast<size_t>(w) * per_warp);
      if (err != cudaSuccess) return err;
      if (blocks * w > best.warps_per_sm()) {
        best.warps_per_block = w;
        best.blocks_per_sm = blocks;
      }
    }
    if (best.blocks_per_sm == 0) return cudaErrorInvalidConfiguration;
    best.grid = best.blocks_per_sm * sms;
    best.regs = attr.numRegs;
    best.smem_per_block = static_cast<size_t>(best.warps_per_block) * per_warp;
    if (n_ < kSize) {
      keys_[n_][0] = dev;
      keys_[n_][1] = per_warp;
      shapes_[n_++] = best;
    }
    *out = best;
    return cudaSuccess;
  }

 private:
  static constexpr int kSize = 32;
  std::mutex mutex_;
  int keys_[kSize][2] = {};
  Launch shapes_[kSize];
  int n_ = 0;
};

// Blocks to launch for `nslots` slots: no more than the slots can use.
inline unsigned int grid_for(const Launch& l, long long nslots) {
  const long long need = (nslots + l.warps_per_block - 1) / l.warps_per_block;
  return static_cast<unsigned int>(need < l.grid ? need : l.grid);
}

// The work counter is an int32; it ends at most one slot a warp past nslots.
constexpr long long MAX_SLOTS = (1LL << 31) - (1LL << 24);

// The C entry points' limits: channels, and the int32 tap offsets.
inline bool bad_planes(int C, int hpad, int wpad) {
  return C < 1 || C > MAXC || static_cast<long long>(C) * hpad * wpad >= (1LL << 31);
}

}  // namespace lk
