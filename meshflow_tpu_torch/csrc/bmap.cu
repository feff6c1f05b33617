// Kernel B: the per-pixel backward map of the mesh warp, from the mesh's
// corner positions.
//
// Replaces the JAX package's Pallas kernel `_bmap_kernel`
// (meshflow_tpu/kernels/bmap_pallas.py:90).  The plain PyTorch version it
// is held against is `backward_map_plain` in
// meshflow_tpu_torch/render/stabilize.py.  One entry point, two launches
// on one stream:
//   1. table_kernel, one thread per (frame, cell): the cell's
//      stabilized->unstabilized homography from its four corner pairs,
//      operation for operation as `quad_to_quad_homography`
//      (kernels/homography.py): unit_square_to_quad of both quads, the
//      adjugate of the stabilized one, the 3x3 product.  9 coefficients,
//      padded to 12 floats so a cell is three 16-byte loads.
//   2. map_kernel, one thread per output pixel p:
//      a. three fixed-point steps "q <- H_cell(q)^-1 p" (fewer when a step
//         finds the cell of the step before: it would repeat it), where cell(q)
//         counts the grid lines ceil((L-1) j / n), j = 1..n-1, at or below
//         q.  The count is closed-form: 0 unless q >= 0 (so NaN and -inf
//         give 0), else floor((m n) / (L-1)) clamped to n-1, with
//         m = floor(min(q, L)), the division a multiply by a magic number
//         and a shift that the wrapper computes (exact for m n < 2^31);
//      b. the 3x3 candidate cells around cell(q), in descending row-major
//         order: the first whose H^-1 p lies strictly inside its integer
//         bbox grown by 1 px is the highest such cell, which wins;
//      c. uncovered pixels get the sentinel (W+1, H+1) and covered = 0.
//
// What bounds it: its bytes (9 written a pixel) and its float operations
// (about 10 a lookup, 13 with two IEEE divisions a homography, a few
// homographies a pixel) bound it about equally; in practice instruction
// issue, far from both.  Design: a block of 32x8 threads maps a 32x32
// tile, a thread one pixel in each of four rows (a 32x8 tile was slower at
// the main path's 64-frame launch; four pixels a thread with 16-byte
// stores slower at a one-frame launch).  The cell table is staged in
// shared memory when it fits in 48 KB with the bbox edges (a 16x16 mesh:
// 12 KB), read through L1 (__ldg) otherwise (64x64: 192 KB; opting in to
// that much shared memory a block was slower); each block keeps the bbox
// edges (line - 1, next line + 1) of every column and row in shared
// memory.  Exact coverage against the plain
// version needs identical rounding: the build uses --fmad=false and IEEE
// division, and every expression keeps the plain version's association
// (`a - b - c + d` is ((a - b) - c) + d; d = h6*px + h7*py + h8 with the
// |d| < 1e-10 clamp; the 3x3 product is three products and two adds, left
// to right).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 32;
constexpr int BLOCK_Y = 8;
constexpr int THREADS = TILE_X * BLOCK_Y;
constexpr int TABLE_THREADS = 128;
constexpr int NCOEF = 12;  // 9 coefficients and 3 floats of padding
constexpr int SMEM_LIMIT = 48 * 1024;

// One axis of the grid: n cells over L pixels; the count of lines at or
// below q is min(n - 1, ((m n) * magic >> shift) + bias), m = floor(min(q, L)).
struct Axis {
  int n;
  float len;
  unsigned magic;
  int shift;
  int bias;
};

__device__ __forceinline__ int cell_of(float q, const Axis& a) {
  if (!(q >= 0.0f)) return 0;
  const unsigned m = static_cast<unsigned>(__float2int_rd(fminf(q, a.len)));
  const unsigned long long prod =
      static_cast<unsigned long long>(m * static_cast<unsigned>(a.n)) * a.magic;
  return min(static_cast<int>(prod >> a.shift) + a.bias, a.n - 1);
}

template <bool SMEM>
__device__ __forceinline__ float4 ld4(const float* t, int i) {
  const float4* p = reinterpret_cast<const float4*>(t + i);
  return SMEM ? *p : __ldg(p);
}

template <bool SMEM>
__device__ __forceinline__ void apply_cell(const float* t, int cell, float px, float py,
                                           float* qx, float* qy) {
  const int o = cell * NCOEF;
  const float4 a = ld4<SMEM>(t, o), b = ld4<SMEM>(t, o + 4), c = ld4<SMEM>(t, o + 8);
  float d = b.z * px + b.w * py + c.x;
  if (fabsf(d) < 1e-10f) d = 1e-10f;
  *qx = (a.x * px + a.y * py + a.z) / d;
  *qy = (a.w * px + b.x * py + b.y) / d;
}

// Heckbert's projective map from the unit square onto the quad
// [a (0,0), b (1,0), c (0,1), d (1,1)] (`unit_square_to_quad`).
__device__ __forceinline__ void unit_square_to_quad(const float* p, int ia, int ib, int ic,
                                                    int id, float m[9]) {
  const float ax = p[2 * ia], ay = p[2 * ia + 1], bx = p[2 * ib], by = p[2 * ib + 1];
  const float cx = p[2 * ic], cy = p[2 * ic + 1], dx = p[2 * id], dy = p[2 * id + 1];
  const float s0 = ax - bx - cx + dx, s1 = ay - by - cy + dy;
  const float d10 = bx - dx, d11 = by - dy, d20 = cx - dx, d21 = cy - dy;
  float den = d10 * d21 - d11 * d20;
  if (fabsf(den) < 1e-12f) den = 1e-12f;
  const float g = (s0 * d21 - s1 * d20) / den;
  const float h = (d10 * s1 - d11 * s0) / den;
  m[0] = bx - ax + g * bx;
  m[1] = cx - ax + h * cx;
  m[2] = ax;
  m[3] = by - ay + g * by;
  m[4] = cy - ay + h * cy;
  m[5] = ay;
  m[6] = g;
  m[7] = h;
  m[8] = 1.0f;
}

__global__ void __launch_bounds__(TABLE_THREADS)
table_kernel(const float* __restrict__ stab_pos, const float* __restrict__ unstab,
             float* __restrict__ tables, int F, int rc, int cc) {
  const int cells = rc * cc;
  const long long t = static_cast<long long>(blockIdx.x) * TABLE_THREADS + threadIdx.x;
  if (t >= static_cast<long long>(F) * cells) return;
  const int f = static_cast<int>(t / cells), cell = static_cast<int>(t % cells);
  const int vc = cc + 1, i00 = (cell / cc) * vc + cell % cc;
  float s[9], u[9];
  unit_square_to_quad(stab_pos + static_cast<long long>(f) * (rc + 1) * vc * 2, i00, i00 + 1,
                      i00 + vc, i00 + vc + 1, s);
  unit_square_to_quad(unstab, i00, i00 + 1, i00 + vc, i00 + vc + 1, u);
  // adjugate3 of s (its [2][2] entry is 1.0)
  const float adj[9] = {
      s[4] * s[8] - s[5] * s[7], s[2] * s[7] - s[1] * s[8], s[1] * s[5] - s[2] * s[4],
      s[5] * s[6] - s[3] * s[8], s[0] * s[8] - s[2] * s[6], s[2] * s[3] - s[0] * s[5],
      s[3] * s[7] - s[4] * s[6], s[1] * s[6] - s[0] * s[7], s[0] * s[4] - s[1] * s[3],
  };
  float h[NCOEF];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      h[3 * i + j] = u[3 * i] * adj[j] + u[3 * i + 1] * adj[3 + j] + u[3 * i + 2] * adj[6 + j];
  h[9] = h[10] = h[11] = 0.0f;
  float4* out = reinterpret_cast<float4*>(tables + t * NCOEF);
  out[0] = make_float4(h[0], h[1], h[2], h[3]);
  out[1] = make_float4(h[4], h[5], h[6], h[7]);
  out[2] = make_float4(h[8], h[9], h[10], h[11]);
}

// Shared memory of a map block: the bbox edges of every column and row
// (float2 (line - 1, next line + 1)), then, with SMEM, the frame's table.
__host__ __device__ constexpr int edges_floats(int rc, int cc) {
  return (2 * (rc + cc) + 3) / 4 * 4;
}

// One pixel's map (steps a-c above); returns covered.
template <bool SMEM>
__device__ __forceinline__ uint8_t map_pixel(const float* t, const float2* col_edges,
                                             const float2* row_edges, int x, int y, int H,
                                             int W, const Axis& ay, const Axis& ax, float* mx,
                                             float* my) {
  const int rc = ay.n, cc = ax.n;
  const float px = static_cast<float>(x), py = static_cast<float>(y);
  // q and the cell whose homography gave it: a step that finds that cell
  // again would repeat the same operations on the same operands, so the
  // search stops there, and that candidate's point is q itself.
  float qx = px, qy = py;
  int row0, col0, qcell = -1;
  for (int it = 0;; ++it) {
    row0 = cell_of(qy, ay);
    col0 = cell_of(qx, ax);
    const int cell = row0 * cc + col0;
    if (it == 3 || cell == qcell) break;
    apply_cell<SMEM>(t, cell, px, py, &qx, &qy);
    qcell = cell;
  }
  for (int dr = 1; dr >= -1; --dr) {
    const int row = row0 + dr;
    if (row < 0 || row >= rc) continue;
    const float2 ye = row_edges[row];
    for (int dc = 1; dc >= -1; --dc) {
      const int col = col0 + dc;
      if (col < 0 || col >= cc) continue;
      float cqx = qx, cqy = qy;
      if (row * cc + col != qcell) apply_cell<SMEM>(t, row * cc + col, px, py, &cqx, &cqy);
      const float2 xe = col_edges[col];
      if (cqx > xe.x && cqx < xe.y && cqy > ye.x && cqy < ye.y) {
        *mx = cqx;
        *my = cqy;
        return 1;
      }
    }
  }
  *mx = static_cast<float>(W + 1);
  *my = static_cast<float>(H + 1);
  return 0;
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
map_kernel(const float* __restrict__ tables, float* __restrict__ map_x,
           float* __restrict__ map_y, uint8_t* __restrict__ covered, int H, int W, Axis ay,
           Axis ax) {
  extern __shared__ __align__(16) float smem[];
  const int rc = ay.n, cc = ax.n, cells = rc * cc;
  float2* col_edges = reinterpret_cast<float2*>(smem);
  float2* row_edges = col_edges + cc;
  const long long frame = blockIdx.z;
  const float* gtab = tables + frame * cells * NCOEF;
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  for (int i = tid; i < cc + rc; i += THREADS) {
    const bool col = i < cc;
    const int j = col ? i : i - cc, n = col ? cc : rc, d = col ? W - 1 : H - 1;
    const int lo = (d * j + n - 1) / n, hi = (d * (j + 1) + n - 1) / n;  // grid_line
    (col ? col_edges : row_edges)[j] =
        make_float2(static_cast<float>(lo) - 1.0f, static_cast<float>(hi) + 1.0f);
  }
  float* stage = smem + edges_floats(rc, cc);
  if (SMEM) {
    for (int i = tid; i < cells * NCOEF / 4; i += THREADS)
      reinterpret_cast<float4*>(stage)[i] = __ldg(reinterpret_cast<const float4*>(gtab) + i);
  }
  __syncthreads();
  const float* t = SMEM ? stage : gtab;

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  if (x >= W) return;
  for (int yy = threadIdx.y; yy < TILE_Y; yy += BLOCK_Y) {
    const int y = blockIdx.y * TILE_Y + yy;
    if (y >= H) break;
    const long long out = (frame * H + y) * W + x;
    covered[out] = map_pixel<SMEM>(t, col_edges, row_edges, x, y, H, W, ay, ax, map_x + out,
                                   map_y + out);
  }
}

bool smem_table(int rc, int cc) {
  return (edges_floats(rc, cc) + rc * cc * NCOEF) * static_cast<int>(sizeof(float)) <=
         SMEM_LIMIT;
}

int smem_bytes(int rc, int cc) {
  return (edges_floats(rc, cc) + (smem_table(rc, cc) ? rc * cc * NCOEF : 0)) *
         static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" int meshflow_bmap(const void* stab_pos, const void* unstab, void* tables,
                             void* map_x, void* map_y, void* covered, int F, int H, int W,
                             int rc, int cc, unsigned magic_y, int shift_y, int bias_y,
                             unsigned magic_x, int shift_x, int bias_x, void* stream) {
  if (F == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long entries = static_cast<long long>(F) * rc * cc;
  table_kernel<<<static_cast<unsigned>((entries + TABLE_THREADS - 1) / TABLE_THREADS),
                 TABLE_THREADS, 0, s>>>(static_cast<const float*>(stab_pos),
                                        static_cast<const float*>(unstab),
                                        static_cast<float*>(tables), F, rc, cc);
  const Axis ay{rc, static_cast<float>(H), magic_y, shift_y, bias_y};
  const Axis ax{cc, static_cast<float>(W), magic_x, shift_x, bias_x};
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, F);
  const int bytes = smem_bytes(rc, cc);
  auto launch = [&](auto kernel) {
    kernel<<<grid, dim3(TILE_X, BLOCK_Y), bytes, s>>>(
        static_cast<const float*>(tables), static_cast<float*>(map_x),
        static_cast<float*>(map_y), static_cast<uint8_t*>(covered), H, W, ay, ax);
  };
  if (smem_table(rc, cc))
    launch(map_kernel<true>);
  else
    launch(map_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

// The map kernel's launch shape for an rc x cc mesh: resident warps per SM,
// shared bytes per block, registers per thread.
extern "C" int meshflow_bmap_occupancy(int rc, int cc, int* warps_per_sm, int* smem_per_block,
                                       int* regs) {
  const bool staged = smem_table(rc, cc);
  const int bytes = smem_bytes(rc, cc);
  const void* kernel = staged ? reinterpret_cast<const void*>(map_kernel<true>)
                              : reinterpret_cast<const void*>(map_kernel<false>);
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, bytes);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  *warps_per_sm = blocks * THREADS / 32;
  *smem_per_block = bytes;
  *regs = attr.numRegs;
  return static_cast<int>(err);
}
