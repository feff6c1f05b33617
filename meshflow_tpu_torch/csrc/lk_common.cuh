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
//     // readable; called by all 32 lanes with the same arguments
//     __device__ void cover(int y, int x);
//     // the uint8 next-image texel at padded (y, x) of channel c, as float
//     __device__ float at(int c, int y, int x) const;
//   };
//
// Everything else is computed here in one order of operations, the order of
// the plain version `lk_level_plain` (meshflow_tpu_torch/kernels/lk.py):
// bilinear rows before columns, (1-f)*lo + f*hi, Scharr as 3*d + 10*d + 3*d,
// the same update and stopping tests.  Only the window sums differ in order:
// a warp reduces them by xor shuffles, which leave every lane with the same
// bits (each butterfly step adds the same two values in either order), so
// the control flow of the loop is warp-uniform.  Compiled with --fmad=false
// so products and sums round like the plain version's separate ops.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lk {

constexpr int WIN = 21;
constexpr int AREA = WIN * WIN;
constexpr int SUPPORT = WIN + 1;  // bilinear taps per axis of a window
constexpr int PAD = 28;
constexpr int MAXC = 3;
constexpr float CV_SCALE = 1.0f / 1024.0f;
constexpr float FLT_EPS = 1.19209290e-07f;

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
  long long nslots;
  int S, K, C, hpad, wpad, rows, cols, shift, max_iters;
  float eps2, min_eig_thr;
  int is_level0;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float tap(const uint8_t* plane, int wpad, int y, int x) {
  return static_cast<float>(__ldg(plane + static_cast<long long>(y) * wpad + x));
}

// Scharr x/y derivative / 32 at padded (y, x), zero outside the level.
__device__ __forceinline__ void scharr(const uint8_t* p, int wpad, int y, int x,
                                       int rows, int cols, float* gx, float* gy) {
  const int ly = y - PAD, lx = x - PAD;
  if (ly < 0 || ly >= rows || lx < 0 || lx >= cols) {
    *gx = 0.0f;
    *gy = 0.0f;
    return;
  }
  const float a00 = tap(p, wpad, y - 1, x - 1), a01 = tap(p, wpad, y - 1, x),
              a02 = tap(p, wpad, y - 1, x + 1);
  const float a10 = tap(p, wpad, y, x - 1), a12 = tap(p, wpad, y, x + 1);
  const float a20 = tap(p, wpad, y + 1, x - 1), a21 = tap(p, wpad, y + 1, x),
              a22 = tap(p, wpad, y + 1, x + 1);
  *gx = (3.0f * (a02 - a00) + 10.0f * (a12 - a10) + 3.0f * (a22 - a20)) * (1.0f / 32.0f);
  *gy = (3.0f * (a20 - a00) + 10.0f * (a21 - a01) + 3.0f * (a22 - a02)) * (1.0f / 32.0f);
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

// Track one slot through the level.  iw, gxw, gyw: the warp's C*AREA floats
// each of shared memory for the frozen prev window and its gradients.
template <class Taps>
__device__ __forceinline__ void track_slot(const LevelArgs& a, long long slot, int lane,
                                           float* iw, float* gxw, float* gyw, Taps& taps) {
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
  float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
  const int texels = C * AREA;
  for (int i = lane; i < texels; i += 32) {
    const int c = i / AREA, rem = i - c * AREA;
    const int r = rem / WIN, cc = rem - r * WIN;
    const uint8_t* p = P + c * plane_size;
    const int y = ipy + PAD + r, x = ipx + PAD + cc;
    iw[i] = bilinear(tap(p, wpad, y, x), tap(p, wpad, y, x + 1), tap(p, wpad, y + 1, x),
                     tap(p, wpad, y + 1, x + 1), fb0, fa0);
    float g00x, g00y, g01x, g01y, g10x, g10y, g11x, g11y;
    scharr(p, wpad, y, x, rows, cols, &g00x, &g00y);
    scharr(p, wpad, y, x + 1, rows, cols, &g01x, &g01y);
    scharr(p, wpad, y + 1, x, rows, cols, &g10x, &g10y);
    scharr(p, wpad, y + 1, x + 1, rows, cols, &g11x, &g11y);
    const float gx = bilinear(g00x, g01x, g10x, g11x, fb0, fa0);
    const float gy = bilinear(g00y, g01y, g10y, g11y, fb0, fa0);
    gxw[i] = gx;
    gyw[i] = gy;
    s11 += gx * gx;
    s12 += gx * gy;
    s22 += gy * gy;
  }
  __syncwarp();
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
    for (int i = lane; i < texels; i += 32) {
      const int c = i / AREA, rem = i - c * AREA;
      const int r = rem / WIN, cc = rem - r * WIN;
      const int y = icy + PAD + r, x = icx + PAD + cc;
      const float jw = bilinear(taps.at(c, y, x), taps.at(c, y, x + 1),
                                taps.at(c, y + 1, x), taps.at(c, y + 1, x + 1), fb, fa);
      const float diff = jw - iw[i];
      sb1 += diff * gxw[i];
      sb2 += diff * gyw[i];
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

}  // namespace lk
