// Kernel A: one pyramid level of sparse pyramidal Lucas-Kanade tracking
// (cv2.calcOpticalFlowPyrLK semantics) for every (pair, tile, feature) slot.
//
// Replaces the JAX package's Pallas kernel `_lk_level_kernel`
// (meshflow_tpu/kernels/_lk_pallas_onehot.py:73).  The plain PyTorch
// version it is held against is `lk_level_plain` in
// meshflow_tpu_torch/kernels/lk.py; this file computes the same thing in
// the same order of operations wherever it can (bilinear rows before
// columns, (1-f)*lo + f*hi, Scharr as 3*d + 10*d + 3*d, the same update and
// stopping tests).  Only the window sums differ in order: a warp reduces
// them by shuffles.
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
// Compiled with --fmad=false so products and sums round like the plain
// version's separate PyTorch ops.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 21;
constexpr int AREA = WIN * WIN;
constexpr int PAD = 28;
constexpr int MAXC = 3;
constexpr int WARPS = 2;
constexpr float CV_SCALE = 1.0f / 1024.0f;
constexpr float FLT_EPS = 1.19209290e-07f;

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

__global__ void __launch_bounds__(32 * WARPS)
lk_level_kernel(const uint8_t* __restrict__ prev, const uint8_t* __restrict__ next,
                const float* __restrict__ pts, const float* __restrict__ guess,
                const uint8_t* __restrict__ valid, const uint8_t* __restrict__ status_in,
                float* __restrict__ corner_out, uint8_t* __restrict__ status_out,
                long long nslots, int S, int K, int C, int hpad, int wpad, int rows,
                int cols, int shift, int max_iters, float eps2, float min_eig_thr,
                int is_level0) {
  __shared__ float win[WARPS][3][MAXC * AREA];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (slot >= nslots) return;

  float cx = guess[2 * slot], cy = guess[2 * slot + 1];
  bool st = status_in[slot] != 0;
  if (!valid[slot]) {
    if (lane == 0) {
      corner_out[2 * slot] = cx;
      corner_out[2 * slot + 1] = cy;
      status_out[slot] = st;
    }
    return;
  }

  const long long pair = slot / (static_cast<long long>(S) * K);
  const long long tile = (slot / K) % S;
  const long long plane_size = static_cast<long long>(hpad) * wpad;
  const uint8_t* P = prev + (pair * S + tile) * C * plane_size;
  const uint8_t* N = next + ((pair + shift) * S + tile) * C * plane_size;

  const float px = pts[2 * slot], py = pts[2 * slot + 1];
  const float ipx_f = floorf(px), ipy_f = floorf(py);
  const float a = px - ipx_f, b = py - ipy_f;
  const int ipx = static_cast<int>(ipx_f), ipy = static_cast<int>(ipy_f);

  if (!in_bounds(ipx, ipy, rows, cols)) {
    if (lane == 0) {
      corner_out[2 * slot] = cx;
      corner_out[2 * slot + 1] = cy;
      status_out[slot] = is_level0 ? false : st;
    }
    return;
  }

  // Frozen prev window and its gradient matrix.
  float* iw = win[warp][0];
  float* gxw = win[warp][1];
  float* gyw = win[warp][2];
  float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
  const int texels = C * AREA;
  for (int i = lane; i < texels; i += 32) {
    const int c = i / AREA, rem = i - c * AREA;
    const int r = rem / WIN, cc = rem - r * WIN;
    const uint8_t* p = P + c * plane_size;
    const int y = ipy + PAD + r, x = ipx + PAD + cc;
    iw[i] = bilinear(tap(p, wpad, y, x), tap(p, wpad, y, x + 1), tap(p, wpad, y + 1, x),
                     tap(p, wpad, y + 1, x + 1), b, a);
    float g00x, g00y, g01x, g01y, g10x, g10y, g11x, g11y;
    scharr(p, wpad, y, x, rows, cols, &g00x, &g00y);
    scharr(p, wpad, y, x + 1, rows, cols, &g01x, &g01y);
    scharr(p, wpad, y + 1, x, rows, cols, &g10x, &g10y);
    scharr(p, wpad, y + 1, x + 1, rows, cols, &g11x, &g11y);
    const float gx = bilinear(g00x, g01x, g10x, g11x, b, a);
    const float gy = bilinear(g00y, g01y, g10y, g11y, b, a);
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
  const bool well_posed = (min_eig >= min_eig_thr) && (det >= FLT_EPS);
  const float inv_det = det == 0.0f ? 0.0f : 1.0f / det;
  if (is_level0) st = st && well_posed;

  bool active = well_posed;
  float pdx = 0.0f, pdy = 0.0f;
  for (int j = 0; j < max_iters && active; ++j) {
    const float icx_f = floorf(cx), icy_f = floorf(cy);
    const float fa = cx - icx_f, fb = cy - icy_f;
    const int icx = static_cast<int>(icx_f), icy = static_cast<int>(icy_f);
    if (!in_bounds(icx, icy, rows, cols)) {
      if (is_level0) st = false;
      break;
    }
    float sb1 = 0.0f, sb2 = 0.0f;
    for (int i = lane; i < texels; i += 32) {
      const int c = i / AREA, rem = i - c * AREA;
      const int r = rem / WIN, cc = rem - r * WIN;
      const uint8_t* p = N + c * plane_size;
      const int y = icy + PAD + r, x = icx + PAD + cc;
      const float jw = bilinear(tap(p, wpad, y, x), tap(p, wpad, y, x + 1),
                                tap(p, wpad, y + 1, x), tap(p, wpad, y + 1, x + 1), fb, fa);
      const float diff = jw - iw[i];
      sb1 += diff * gxw[i];
      sb2 += diff * gyw[i];
    }
    const float b1 = warp_sum(sb1) * CV_SCALE;
    const float b2 = warp_sum(sb2) * CV_SCALE;
    const float dx = (a12 * b2 - a22 * b1) * inv_det;
    const float dy = (a12 * b1 - a11 * b2) * inv_det;
    float ncx = cx + dx, ncy = cy + dy;
    const bool converged = (dx * dx + dy * dy) <= eps2;
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
  if (lane == 0) {
    corner_out[2 * slot] = cx;
    corner_out[2 * slot + 1] = cy;
    status_out[slot] = st;
  }
}

}  // namespace

extern "C" int meshflow_lk_level(const void* prev, const void* next, const void* pts,
                                 const void* guess, const void* valid,
                                 const void* status_in, void* corner_out,
                                 void* status_out, int T, int S, int K, int C, int hpad,
                                 int wpad, int rows, int cols, int shift, int max_iters,
                                 float eps2, float min_eig_thr, int is_level0,
                                 void* stream) {
  if (C < 1 || C > MAXC) return static_cast<int>(cudaErrorInvalidValue);
  const long long nslots = static_cast<long long>(T) * S * K;
  if (nslots == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (nslots + WARPS - 1) / WARPS;
  lk_level_kernel<<<static_cast<unsigned int>(blocks), 32 * WARPS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next),
      static_cast<const float*>(pts), static_cast<const float*>(guess),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(status_in),
      static_cast<float*>(corner_out), static_cast<uint8_t*>(status_out), nslots, S, K,
      C, hpad, wpad, rows, cols, shift, max_iters, eps2, min_eig_thr, is_level0);
  return static_cast<int>(cudaGetLastError());
}
