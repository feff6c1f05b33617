// eig9: the eigenvector of the smallest eigenvalue of a batch of 9x9
// symmetric float64 matrices, the null vector of the DLT's normal matrix
// (kernels/homography.py `dlt_homography`).
//
// A hand kernel with no TPU counterpart: the JAX package takes a float32
// SVD of the weighted design matrix (meshflow_tpu/kernels/homography.py:74
// `dlt_homography`); the port forms the 9x9 normal matrix in float64 and
// took its null vector from torch.linalg.eigh, which synchronizes the host
// with the card for CUDA inputs and so cannot be captured in a CUDA graph.
// The plain version is that eigh call (`eig9_cuda.null_vector_plain`);
// `eig9_cuda.null_vector_jacobi` repeats this kernel's operations in
// PyTorch, in the same order.
//
// Cyclic Jacobi: sweeps over the 36 pairs (p, q), p < q, in row order, a
// rotation that zeroes A[p][q] wherever it is not 0 already:
//   theta = (A[q][q] - A[p][p]) / (2 A[p][q]),
//   t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1),
//   s = t c; A[p][p] -= t A[p][q], A[q][q] += t A[p][q], A[p][q] = 0;
//   for k != p, q: A[k][p] = c A[k][p] - s A[k][q], A[k][q] = s A[k][p] + c A[k][q]
//   (and the symmetric entries); for every k: the same on V[k][p], V[k][q].
// A sweep starts only while the off-diagonal sum of squares exceeds
// TOL2 times the whole sum of squares (both summed row by row, checked on
// the card), at most MAX_SWEEPS sweeps; a matrix with a NaN stops at once.
// The result is the column of V at the first smallest diagonal entry.
// The input's lower triangle is read, as eigh reads it.
//
// What bounds it: neither bytes (81 + 9 doubles a matrix) nor float64
// operations (about 110 a rotation, 36 rotations a sweep, 5-8 sweeps) come
// near the card's rates at the DLT's batch (hundreds of matrices); a
// rotation is a chain of dependent float64 divisions and square roots, so
// the latency of one matrix's chain bounds it.  Design: one warp a
// matrix, A and V in shared memory, lane k (k < 9) rotating row k of both,
// so a rotation costs one chain, not nine; 4 warps a block.  Built with
// --fmad=false and IEEE division and square root, every operation rounds
// as the PyTorch emulation's does.

#include <cuda_runtime.h>

namespace {

constexpr int N = 9;
constexpr int WARPS = 4;
constexpr int MAX_SWEEPS = 20;
constexpr double TOL2 = 1e-30;

__global__ void __launch_bounds__(WARPS * 32)
eig9_kernel(const double* __restrict__ normal, double* __restrict__ out, int batch) {
  __shared__ double sa[WARPS][N][N];
  __shared__ double sv[WARPS][N][N];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long m = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (m >= batch) return;  // the whole warp leaves together
  double (*a)[N] = sa[warp];
  double (*v)[N] = sv[warp];
  const double* src = normal + m * N * N;
  for (int i = lane; i < N * N; i += 32) {
    const int r = i / N, c = i % N;
    a[r][c] = r >= c ? src[r * N + c] : src[c * N + r];
    v[r][c] = r == c ? 1.0 : 0.0;
  }
  __syncwarp();

  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0, total = 0.0;
    for (int r = 0; r < N; ++r) {
      for (int c = 0; c < N; ++c) {
        const double x2 = a[r][c] * a[r][c];
        total = total + x2;
        if (r != c) off = off + x2;
      }
    }
    if (!(off > TOL2 * total)) break;  // converged, all zero, or NaN
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const double apq = a[p][q];
        if (apq == 0.0) continue;  // the same value in every lane
        const double app = a[p][p];
        const double aqq = a[q][q];
        const double theta = (aqq - app) / (2.0 * apq);
        double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double s = t * c;
        double akp = 0.0, akq = 0.0, vkp = 0.0, vkq = 0.0;
        if (lane < N) {
          akp = a[lane][p];
          akq = a[lane][q];
          vkp = v[lane][p];
          vkq = v[lane][q];
        }
        __syncwarp();
        if (lane < N) {
          if (lane == p) {
            a[p][p] = app - t * apq;
            a[p][q] = 0.0;
          } else if (lane == q) {
            a[q][q] = aqq + t * apq;
            a[q][p] = 0.0;
          } else {
            const double nkp = c * akp - s * akq;
            const double nkq = s * akp + c * akq;
            a[lane][p] = nkp;
            a[p][lane] = nkp;
            a[lane][q] = nkq;
            a[q][lane] = nkq;
          }
          v[lane][p] = c * vkp - s * vkq;
          v[lane][q] = s * vkp + c * vkq;
        }
        __syncwarp();
      }
    }
  }
  int best = 0;
  double least = a[0][0];
  for (int i = 1; i < N; ++i) {
    if (a[i][i] < least) {
      least = a[i][i];
      best = i;
    }
  }
  if (lane < N) out[m * N + lane] = v[lane][best];
}

}  // namespace

// normal: (batch, 9, 9) float64; out: (batch, 9) float64.  Returns the
// launch's cudaError_t.
extern "C" int meshflow_eig9(const void* normal, void* out, int batch, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((batch + WARPS - 1) / WARPS);
  eig9_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(normal), static_cast<double*>(out), batch);
  return static_cast<int>(cudaGetLastError());
}
