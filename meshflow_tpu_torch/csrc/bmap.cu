// Kernel B: the per-pixel backward map of the mesh warp.
//
// Replaces the JAX package's Pallas kernel `_bmap_kernel`
// (meshflow_tpu/kernels/bmap_pallas.py:90).  The plain PyTorch version it
// is held against is `backward_map_frame_plain` in
// meshflow_tpu_torch/render/stabilize.py.  For each stabilized pixel p:
//   1. three fixed-point steps "q <- H_cell(q)^-1 p", where cell(q) counts
//      the grid lines ceil((L-1) i / n) at or below q, clamped;
//   2. the 3x3 candidate cells around cell(q): a cell covers p when
//      H^-1 p lies strictly inside its integer bbox grown by 1 px; the
//      highest row-major cell index wins;
//   3. uncovered pixels get the sentinel (W+1, H+1) and covered = 0.
//
// What bounds it: a few hundred float operations and 12 table lookups per
// pixel, writing 9 bytes per pixel (map_x, map_y, covered): about 2 MB of
// output per 640x360 frame, so it is bound by arithmetic latency and the
// table reads, not by device memory.
//
// Design: one thread per output pixel (each thread walks 4 rows of a
// 32x32 tile), a third grid dimension over frames.  The frame's table of
// 13 floats per cell (9 coefficients, bbox left/right/top/bottom) is
// staged in shared memory when it fits (16x16 mesh: 13 KB); larger meshes
// (up to 129x129: ~865 KB) read it from global memory through L1
// (__ldg).  The grid lines are the bboxes of the first row and column of
// cells.  Exact coverage against the plain version needs identical
// rounding: the build uses --fmad=false and IEEE division, and the
// homography is evaluated as d = h6*px + h7*py + h8, then
// (h0*px + h1*py + h2) / d, in the plain version's order, with the same
// |d| < 1e-10 clamp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 32;
constexpr int BLOCK_Y = 8;
constexpr int NCOEF = 13;
constexpr int SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float ld(const float* t, int i, bool smem) {
  return smem ? t[i] : __ldg(t + i);
}

__device__ __forceinline__ void apply_cell(const float* t, int cell, bool smem, float px,
                                           float py, float* qx, float* qy) {
  const int o = cell * NCOEF;
  float d = ld(t, o + 6, smem) * px + ld(t, o + 7, smem) * py + ld(t, o + 8, smem);
  if (fabsf(d) < 1e-10f) d = 1e-10f;
  *qx = (ld(t, o + 0, smem) * px + ld(t, o + 1, smem) * py + ld(t, o + 2, smem)) / d;
  *qy = (ld(t, o + 3, smem) * px + ld(t, o + 4, smem) * py + ld(t, o + 5, smem)) / d;
}

// Number of interior grid lines <= q along one axis, clamped to a cell.
// Lines are the left (top) edges of cells 1..n-1 of the first row (column).
__device__ __forceinline__ int line_count(const float* t, bool smem, float q, int n,
                                          int stride, int field) {
  int k = 0;
  for (int j = 1; j < n; ++j) k += (q >= ld(t, j * stride * NCOEF + field, smem)) ? 1 : 0;
  return k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
}

__global__ void __launch_bounds__(TILE_X * BLOCK_Y)
bmap_kernel(const float* __restrict__ tables, float* __restrict__ map_x,
            float* __restrict__ map_y, uint8_t* __restrict__ covered, int H, int W, int rc,
            int cc, int use_smem) {
  extern __shared__ float stage[];
  const int cells = rc * cc;
  const long long frame = blockIdx.z;
  const float* gtab = tables + frame * cells * NCOEF;
  const bool smem = use_smem != 0;
  if (smem) {
    for (int i = threadIdx.y * TILE_X + threadIdx.x; i < cells * NCOEF;
         i += TILE_X * BLOCK_Y)
      stage[i] = gtab[i];
    __syncthreads();
  }
  const float* t = smem ? stage : gtab;

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  if (x >= W) return;
  for (int yy = threadIdx.y; yy < TILE_Y; yy += BLOCK_Y) {
    const int y = blockIdx.y * TILE_Y + yy;
    if (y >= H) break;
    const float px = static_cast<float>(x), py = static_cast<float>(y);
    float qx = px, qy = py;
    for (int it = 0; it < 3; ++it) {
      const int row = line_count(t, smem, qy, rc, cc, 11);
      const int col = line_count(t, smem, qx, cc, 1, 9);
      apply_cell(t, row * cc + col, smem, px, py, &qx, &qy);
    }
    const int row0 = line_count(t, smem, qy, rc, cc, 11);
    const int col0 = line_count(t, smem, qx, cc, 1, 9);

    int best_key = -1;
    float bqx = static_cast<float>(W + 1), bqy = static_cast<float>(H + 1);
    for (int dr = -1; dr <= 1; ++dr) {
      for (int dc = -1; dc <= 1; ++dc) {
        const int row = row0 + dr, col = col0 + dc;
        if (row < 0 || row >= rc || col < 0 || col >= cc) continue;
        const int key = row * cc + col;
        float cqx, cqy;
        apply_cell(t, key, smem, px, py, &cqx, &cqy);
        const int o = key * NCOEF;
        const bool member = cqx > ld(t, o + 9, smem) - 1.0f &&
                            cqx < ld(t, o + 10, smem) + 1.0f &&
                            cqy > ld(t, o + 11, smem) - 1.0f &&
                            cqy < ld(t, o + 12, smem) + 1.0f;
        if (member && key > best_key) {
          best_key = key;
          bqx = cqx;
          bqy = cqy;
        }
      }
    }
    const long long out = (frame * H + y) * W + x;
    map_x[out] = bqx;
    map_y[out] = bqy;
    covered[out] = best_key >= 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" int meshflow_bmap(const void* tables, void* map_x, void* map_y, void* covered,
                             int F, int H, int W, int rc, int cc, void* stream) {
  if (F == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const int bytes = rc * cc * NCOEF * static_cast<int>(sizeof(float));
  const int use_smem = bytes <= SMEM_LIMIT ? 1 : 0;
  const dim3 block(TILE_X, BLOCK_Y);
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, F);
  bmap_kernel<<<grid, block, use_smem ? bytes : 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tables), static_cast<float*>(map_x),
      static_cast<float*>(map_y), static_cast<uint8_t*>(covered), H, W, rc, cc, use_smem);
  return static_cast<int>(cudaGetLastError());
}
