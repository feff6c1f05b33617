// Probe D: what a per-feature band fetch costs against a full-plane
// one-hot row select, at 1080p level-0 tile geometry (plane 328x664 f32).
//
// Replaces the three Pallas kernels of scripts/probe_dynslice_fetch.py:
// `copy_kernel` (:40), `fine_kernel` (:57) and `onehot_kernel` (:81).
// The plain PyTorch versions they are held against are in
// meshflow_tpu_torch/probes/dynslice_fetch.py.  Each launch runs `reps`
// rounds (the probe's REPS = 50), so the time of one round is the launch
// time over reps.
//
// Every round does its work.  The outputs are the last round's (one-hot's
// out also sums every round's corner), but each round fetches its whole
// band from the plane into shared memory with cp.async: an asm volatile
// instruction whose effect is a write to shared memory, which neither the
// compiler nor ptxas removes, whether or not a later round overwrites it.
// A one-hot row outside the plane is a cp.async with a source size of 0,
// which writes 16 bytes of zeros.  D fine stages with cp.async too and
// stores every round's product with __stcg.
//
// * dynslice_copy: per round r and feature i, the 48x256 band at the
//   8-aligned row and 128-aligned column of idx[2i], idx[2i+1] (shifted
//   by r, as the probe shifts it), clamped into the plane by dyn_start.
//   The column start is a multiple of 4 floats and a plane row of
//   W % 4 == 0 floats keeps every row 16-byte aligned.
//   What bounds it: bytes into the SMs.  A round moves B * 48 KB and
//   computes nothing.  The plane (871 KB) stays in L2 (50 MB), and the
//   rows a block re-reads stay in its SM's L1, so the rate is L1's and
//   L2's, not HBM's: the bound chip_smoke.py states (one round's HBM
//   bytes) is a floor.  The earlier kernel gave each feature one block,
//   16 of 132 SMs at B = 16, and waited for each round's 48 KB before it
//   issued the next round, so no two rounds' copies were ever in flight.
//   Design: a feature's band is split by column into 8 slices of 32
//   columns, one block of 128 threads each (128 blocks at B = 16, 6 KB a
//   round); a thread owns 3 fixed float4 of its slice and a ring of RING
//   round buffers.  Before it refills a buffer it waits
//   (cp.async.wait_group RING - 1) only for the round that filled it last,
//   so RING rounds' copies are in flight.  A thread reads back only what
//   it copied itself, so no barrier is needed.  The copies are
//   cp.async.ca, so a slice's rows at the four round offsets (18 KB a
//   block) are read from L1 after the first rounds, and the launch asks
//   for a shared-memory carveout of 100 KB, which leaves L1 156 KB: at
//   B = 64 and 128 the default carveout left L1 too small for the blocks
//   an SM holds and the copy ran at L2's rate, 2.2x and 2x slower.
//   Measured slower: cp.async.cg (L2 only), 1.8-2.3x; one bulk copy
//   (cp.async.bulk on an mbarrier) a slice row, 4.5-10x; 16-column slices
//   of 64 threads, or 384 threads of one float4.
// * dynslice_fine: the copy, then rows[p][c] = sum_k rsel[p][k] band[k][c]
//   (40x48 by 48x256), the sum taken in k order from 0.0 with separate
//   multiply and add (--fmad=false), as the plain version takes it, so the
//   kernel is bit-equal to it for any rsel.  rsel is an input: the probe's
//   own kernel reads a scratch that nothing writes.  Every round's rows are
//   stored with __stcg, an inline asm store the compiler cannot drop, so
//   no round's product is dead code.
// * onehot_rowsel: per round, all B*40 rows of the band the one-hot
//   select forms, row k = plane[idx[0] + r % 4 + k % 40] or zero outside
//   the plane; out sums rows 0..7, columns 0..127, over rounds in round
//   order; band is the last round's.  The TPU kernel keeps each round's
//   band on chip and writes only out.  The earlier kernel stored every
//   round's band to global memory (85 MB a launch at B = 16), and those
//   stores set its time.  What bounds it now: the band's bytes into shared
//   memory, B * 40 * W * 4 a round (1.70 MB at B = 16), read from only 43
//   distinct plane rows (114 KB), which stay in L1 after the first rounds.
//   Design: four blocks an SM (526 blocks of 224 threads at B = 16), each
//   owning a contiguous range of the band's float4, with the block's width
//   chosen so that a thread's last pass over the range is mostly busy.
//   Each round a thread copies its float4 (at most 3) with cp.async.ca
//   into a ring of RING round buffers, as the copy does; a row outside the
//   plane is the same copy with a source size of 0, which costs no more.
//   The threads that own rows 0..7, columns 0..127 also load that round's
//   values into registers and add them to their sums in round order, from
//   0.0, as the plain version adds.  After the last round a thread writes
//   its float4 of the last buffer to `band`, one coalesced pass, and its
//   sums to `out`: no earlier round touches global memory.  Measured no
//   faster: the sums taken from the ring in shared memory, or their loads
//   issued a round ahead; slower: one or two blocks an SM, 128 threads.
//
// What bounds the fine select on the H100: instruction issue.  A round is
// 40*48*256 multiply-adds per feature, and --fmad=false (which keeps the
// bits) makes each a separate FMUL and FADD: two issue slots, the floor,
// at 128 float lanes per SM and clock about 7,400 cycles a round at
// B = 128 (about 4 us).  Shared memory delivers 32 floats per SM and
// clock, so each value a thread loads from it has to feed more than one
// multiply-add.  Its bytes (48 KB in, 40 KB out per feature) are far
// below either.  One block per feature ran 256 threads on 16 SMs at
// B = 16, loaded two shared values per multiply-add, and waited for each
// band before its product.  Design: a feature's outputs are split by
// column into 8 slices of 32 columns, one block each (128 blocks at
// B = 16), and a block stages only the 48 x 32 band columns its outputs
// read.  A thread owns two output rows and four columns: each k is an
// 8-byte load of its two rsel values (staged once, k-major) and a 16-byte
// load of four band values, then eight FMUL + FADD pairs (18 instructions
// for 16 of the floor, 0.75 shared floats a multiply-add).  Holding the
// two rsel rows in registers instead (96 of them, three blocks an SM) was
// measured slower at B = 16 and 64 and no faster at 128.  The band is
// double-buffered: round r + 1's slice is fetched with cp.async while
// round r's product runs, so one barrier a round remains, where a buffer
// is reused.

#include <cstdint>
#include <cuda_runtime.h>

#include "probes.cuh"

namespace {

constexpr int PN = 40;
constexpr int BAND_R = PN + 8;
constexpr int BAND_C = 256;
constexpr int RING = 4;  // rounds of copies in flight, a thread (copy and one-hot)
// The shared-memory share of an SM's 256 KB that copy and one-hot ask for,
// in percent of the most (228 KB): 100 KB, which holds four copy blocks or
// the one-hot's four at B = 16 and leaves L1 156 KB for the plane rows the
// rounds re-read.
constexpr int CARVEOUT = 44;

// The offset in the plane of feature (ri, ci)'s band of round r, plus c0.
__device__ __forceinline__ long long band_origin(int ri, int ci, int r, int c0, int H, int W) {
  const int rs = probes::dyn_start(probes::floor_div(ri + 8 * (r % 4), 8) * 8, H, BAND_R);
  const int cs = probes::dyn_start(probes::floor_div(ci + 128 * (r % 2), 128) * 128, W, BAND_C);
  return static_cast<long long>(rs) * W + cs + c0;
}

constexpr int COPY_COLS = 32;                           // band columns a copy block moves
constexpr int COPY_SLICES = BAND_C / COPY_COLS;         // copy blocks per feature
constexpr int COPY_Q = COPY_COLS / 4;                   // float4 per slice row
constexpr int COPY_THREADS = 128;
constexpr int COPY_PER = BAND_R * COPY_Q / COPY_THREADS;  // float4 a thread owns
static_assert(BAND_R * COPY_Q % COPY_THREADS == 0, "a slice splits evenly over the threads");

__global__ void __launch_bounds__(COPY_THREADS)
dynslice_copy_kernel(const int* __restrict__ idx, const float* __restrict__ plane, int H,
                     int W, int B, int reps, float* __restrict__ out,
                     float* __restrict__ bands) {
  __shared__ __align__(16) float4 ring[RING][COPY_PER][COPY_THREADS];
  const int i = blockIdx.x / COPY_SLICES;
  const int c0 = (blockIdx.x % COPY_SLICES) * COPY_COLS;
  const int ri = __ldg(idx + 2 * i), ci = __ldg(idx + 2 * i + 1);
  int off[COPY_PER];  // this thread's float4 in a slice: band row * W + column
#pragma unroll
  for (int j = 0; j < COPY_PER; ++j) {
    const int q = threadIdx.x + j * COPY_THREADS;
    off[j] = (q / COPY_Q) * W + (q % COPY_Q) * 4;
  }
  for (int r = 0; r < reps; ++r) {
    probes::cp_async_wait_group<RING - 1>();  // round r - RING, the last to fill this buffer
    const float* src = plane + band_origin(ri, ci, r, c0, H, W);
#pragma unroll
    for (int j = 0; j < COPY_PER; ++j)
      probes::cp_async16_ca(&ring[r % RING][j][threadIdx.x], src + off[j]);
    probes::cp_async_commit();
  }
  probes::cp_async_wait_group<0>();
  // bands[i] <- this thread's float4 of the last round; out <- feature B - 1's
  // top-left 8x128 corner (plus the probe's `r * 0.0`)
  const float zero = static_cast<float>(reps - 1) * 0.0f;
#pragma unroll
  for (int j = 0; j < COPY_PER; ++j) {
    const int q = threadIdx.x + j * COPY_THREADS;
    const int row = q / COPY_Q, col = c0 + (q % COPY_Q) * 4;
    const float4 v = ring[(reps - 1) % RING][j][threadIdx.x];
    *reinterpret_cast<float4*>(bands + (static_cast<long long>(i) * BAND_R + row) * BAND_C +
                               col) = v;
    if (i == B - 1 && row < 8 && col < 128)
      *reinterpret_cast<float4*>(out + row * 128 + col) =
          make_float4(v.x + zero, v.y + zero, v.z + zero, v.w + zero);
  }
}

constexpr int FINE_COLS = 32;                      // band columns a fine block reads
constexpr int FINE_SLICES = BAND_C / FINE_COLS;    // fine blocks per feature
constexpr int FINE_Q = FINE_COLS / 4;              // float4 per slice row
constexpr int FINE_THREADS = (PN / 2) * (FINE_COLS / 4);  // 2 rows x 4 columns a thread
constexpr int FINE_SLICE = BAND_R * FINE_COLS;     // floats of one staged slice

// Start copying the 48 x 32 slice at column c0 of feature (ri, ci)'s band
// of round r into `dst`, as one cp.async group.
__device__ __forceinline__ void stage_slice(const float* __restrict__ plane, int H, int W,
                                            int ri, int ci, int r, int c0, float* dst) {
  const int rs = probes::dyn_start(probes::floor_div(ri + 8 * (r % 4), 8) * 8, H, BAND_R);
  const int cs =
      probes::dyn_start(probes::floor_div(ci + 128 * (r % 2), 128) * 128, W, BAND_C) + c0;
  for (int q = threadIdx.x; q < BAND_R * FINE_Q; q += FINE_THREADS)
    probes::cp_async16(dst + q * 4,
                       plane + static_cast<long long>(rs + q / FINE_Q) * W + cs + (q % FINE_Q) * 4);
  probes::cp_async_commit();
}

__global__ void __launch_bounds__(FINE_THREADS, 5)
dynslice_fine_kernel(const int* __restrict__ idx, const float* __restrict__ plane,
                     const float* __restrict__ rsel, int H, int W, int B, int reps,
                     float* __restrict__ out, float* __restrict__ bands,
                     float* __restrict__ rows) {
  __shared__ __align__(16) float buf[2][FINE_SLICE];
  __shared__ __align__(16) float2 ssel[BAND_R][PN / 2];  // rsel[i][p][k], rsel[i][p + 1][k]
  const int i = blockIdx.x / FINE_SLICES;
  const int c0 = (blockIdx.x % FINE_SLICES) * FINE_COLS;
  const int p = (threadIdx.x / (FINE_COLS / 4)) * 2;    // this thread's rows p, p + 1
  const int c = c0 + (threadIdx.x % (FINE_COLS / 4)) * 4;  // and columns c .. c + 3
  const int ri = __ldg(idx + 2 * i), ci = __ldg(idx + 2 * i + 1);
  stage_slice(plane, H, W, ri, ci, 0, c0, buf[0]);

  for (int q = threadIdx.x; q < PN * BAND_R; q += FINE_THREADS) {  // the same every round
    const int pr = q / BAND_R, k = q % BAND_R;
    reinterpret_cast<float*>(&ssel[k][pr / 2])[pr % 2] =
        __ldg(rsel + static_cast<long long>(i) * PN * BAND_R + q);
  }
  const float2* sel = &ssel[0][p / 2];
  float* dst = rows + (static_cast<long long>(i) * PN + p) * BAND_C + c;
  const bool corner = i == B - 1 && p < 8 && c < 128;  // out: rows 0..7, columns 0..127

  for (int r = 0; r < reps; ++r) {
    probes::cp_async_wait_group<0>();  // this thread's copies of round r
    __syncthreads();  // everyone's copies of round r landed; round r - 1's buffer is free
    if (r + 1 < reps) stage_slice(plane, H, W, ri, ci, r + 1, c0, buf[(r + 1) & 1]);
    const float* band = buf[r & 1] + (c - c0);
    float4 a0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), a1 = a0;
#pragma unroll
    for (int k = 0; k < BAND_R; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(band + k * FINE_COLS);
      const float2 sk = sel[k * (PN / 2)];
      a0.x = a0.x + sk.x * v.x;
      a0.y = a0.y + sk.x * v.y;
      a0.z = a0.z + sk.x * v.z;
      a0.w = a0.w + sk.x * v.w;
      a1.x = a1.x + sk.y * v.x;
      a1.y = a1.y + sk.y * v.y;
      a1.z = a1.z + sk.y * v.z;
      a1.w = a1.w + sk.y * v.w;
    }
    __stcg(reinterpret_cast<float4*>(dst), a0);  // asm stores: no round's product is dead
    __stcg(reinterpret_cast<float4*>(dst + BAND_C), a1);
    if (corner && r == reps - 1) {
      const float zero = static_cast<float>(r) * 0.0f;
      *reinterpret_cast<float4*>(out + p * 128 + c) =
          make_float4(a0.x + zero, a0.y + zero, a0.z + zero, a0.w + zero);
      *reinterpret_cast<float4*>(out + (p + 1) * 128 + c) =
          make_float4(a1.x + zero, a1.y + zero, a1.z + zero, a1.w + zero);
    }
  }
  // bands[i] <- this block's columns of the last round's band
  const float4* last = reinterpret_cast<const float4*>(buf[(reps - 1) & 1]);
  for (int q = threadIdx.x; q < BAND_R * FINE_Q; q += FINE_THREADS)
    reinterpret_cast<float4*>(bands + (static_cast<long long>(i) * BAND_R + q / FINE_Q) * BAND_C +
                              c0)[q % FINE_Q] = last[q];
}

constexpr int ONEHOT_THREADS = 256;  // the most a one-hot block has
constexpr int ONEHOT_PER = 3;        // the most float4 a one-hot thread owns
constexpr int ONEHOT_BLOCKS_PER_SM = 4;

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x = acc.x + v.x;
  acc.y = acc.y + v.y;
  acc.z = acc.z + v.z;
  acc.w = acc.w + v.w;
}

// Block b owns the band's float4 [b * span, (b + 1) * span) (of `total`),
// `per` passes of blockDim.x; dynamic shared memory: RING x per x blockDim.x
// float4.
__global__ void __launch_bounds__(ONEHOT_THREADS)
onehot_rowsel_kernel(const int* __restrict__ idx, const float* __restrict__ plane, int H,
                     int W, int total, int span, int per, int reps, float* __restrict__ out,
                     float* __restrict__ band) {
  extern __shared__ __align__(16) float4 onehot_ring[];
  const int nt = blockDim.x, wq = W / 4;
  const int first = blockIdx.x * span, end = min(first + span, total);
  int row[ONEHOT_PER], col[ONEHOT_PER];  // band row % PN (-1: no float4) and column
  bool corner[ONEHOT_PER];               // rows 0..7, columns 0..127
  float4 acc[ONEHOT_PER];
#pragma unroll
  for (int j = 0; j < ONEHOT_PER; ++j) {
    const int q = first + j * nt + threadIdx.x;
    const bool own = j < per && q < end;
    row[j] = own ? (q / wq) % PN : -1;
    col[j] = (q % wq) * 4;
    corner[j] = own && q / wq < 8 && col[j] < 128;
    acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int t0 = __ldg(idx);
  for (int r = 0; r < reps; ++r) {
    probes::cp_async_wait_group<RING - 1>();  // round r - RING, the last to fill this buffer
    float4* slot = onehot_ring + (r % RING) * per * nt + threadIdx.x;
#pragma unroll
    for (int j = 0; j < ONEHOT_PER; ++j) {
      if (row[j] < 0) continue;
      const int t = t0 + r % 4 + row[j];
      const bool inside = t >= 0 && t < H;
      const float* src = plane + static_cast<long long>(inside ? t : 0) * W + col[j];
      probes::cp_async16_ca(slot + j * nt, src, inside ? 16 : 0);  // zeros outside
      if (corner[j])  // the corner's values of round r, from the plane, summed in order
        add4(acc[j], inside ? __ldg(reinterpret_cast<const float4*>(src))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    probes::cp_async_commit();
  }
  probes::cp_async_wait_group<0>();
  const float4* last = onehot_ring + ((reps - 1) % RING) * per * nt + threadIdx.x;
#pragma unroll
  for (int j = 0; j < ONEHOT_PER; ++j) {
    if (row[j] < 0) continue;
    const int q = first + j * nt + threadIdx.x;
    reinterpret_cast<float4*>(band)[q] = last[j * nt];
    if (corner[j]) *reinterpret_cast<float4*>(out + (q / wq) * 128 + col[j]) = acc[j];
  }
}

}  // namespace

extern "C" int meshflow_probe_dynslice_copy(const void* idx, const void* plane, void* out,
                                            void* bands, int H, int W, int B, int reps,
                                            void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = cudaFuncSetAttribute(
      dynslice_copy_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, CARVEOUT);
  if (err != cudaSuccess) return static_cast<int>(err);
  dynslice_copy_kernel<<<B * COPY_SLICES, COPY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(plane), H, W, B, reps,
      static_cast<float*>(out), static_cast<float*>(bands));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meshflow_probe_dynslice_fine(const void* idx, const void* plane,
                                            const void* rsel, void* out, void* bands,
                                            void* rows, int H, int W, int B, int reps,
                                            void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  dynslice_fine_kernel<<<B * FINE_SLICES, FINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(plane),
      static_cast<const float*>(rsel), H, W, B, reps, static_cast<float*>(out),
      static_cast<float*>(bands), static_cast<float*>(rows));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meshflow_probe_onehot_rowsel(const void* idx, const void* plane, void* out,
                                            void* band, int H, int W, int B, int reps,
                                            void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(onehot_rowsel_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, CARVEOUT);
  if (err != cudaSuccess) return static_cast<int>(err);
  // ONEHOT_BLOCKS_PER_SM blocks an SM unless a thread would own more than
  // ONEHOT_PER float4; each block's range in passes of whole warps, as few
  // as fit, so the last pass is mostly busy
  const int total = B * PN * (W / 4);
  int blocks = ONEHOT_BLOCKS_PER_SM * sms;
  if (total > blocks * ONEHOT_PER * ONEHOT_THREADS)
    blocks = (total + ONEHOT_PER * ONEHOT_THREADS - 1) / (ONEHOT_PER * ONEHOT_THREADS);
  const int span = (total + blocks - 1) / blocks;
  blocks = (total + span - 1) / span;
  const int per = (span + ONEHOT_THREADS - 1) / ONEHOT_THREADS;
  const int threads = ((span + per - 1) / per + 31) / 32 * 32;
  const size_t smem = sizeof(float4) * RING * per * threads;
  onehot_rowsel_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(plane), H, W, total, span, per,
      reps, static_cast<float*>(out), static_cast<float*>(band));
  return static_cast<int>(cudaGetLastError());
}
