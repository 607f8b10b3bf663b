// B8: batched Cholesky + triangular inverse, lanes-last, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/chol.py:127
// batched_chol_rinv_pallas (kernel body _chol_kernel, chol.py:22), the
// round-1 lanes-last formulation.  Per SPD (n, n) matrix H it computes
// the same function as K1 (Rinv = (L^{-1})' with H = R'R) in that
// kernel's expression order:
//   an unblocked right-looking Cholesky that reads row j of the
//   symmetric working matrix, scales it by piv = sqrt(max(d, tiny)) from
//   the diagonal on (so L[j][j] = d / piv), and applies the rank-1
//   trailing update; then the row-wise forward substitution
//   X[i][c] = (e_i[c] - sum_{k<i} L[i][k] X[k][c]) / L[i][i]
//   (a division, where K1 multiplies by 1 / L[i][i]).
//
// Design: the TPU kernel's lanes-last layout carried over as an idea.
// One thread owns one matrix, and the batch is the fastest index of the
// (n, n, B) working buffer in device memory, so a warp reads element
// (i, j) of 32 neighbouring matrices in one 128-byte line.  No shared
// memory, hence no n limit from it; no padding, masks or lane tiles.
// The buffer holds H on entry; phase 1 keeps the trailing matrix in the
// upper triangle and writes L into the lower one; phase 2 overwrites L
// with X = L^{-1} row by row (column c of row i is read last by column
// c itself) and zeroes the upper triangle.  The wrapper transposes the
// buffer back to (B, n, n) Rinv with torch ops.
//
// What bounds it on an H100: neither bytes (2 n^2 floats per matrix) nor
// FLOPs (~n^3 / 3 FMAs per matrix): each thread runs the whole O(n^3)
// dependent chain alone, from L1/L2, and B threads are B / 32 warps (320
// at B = 10240, ~2.4 per SM), far too few to hide load latency.  It is
// expected to lose to K1 (a block per matrix) at n = 50 and to be
// closest at small n.  No fast-math: division and sqrt are IEEE.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
chol_lanes_kernel(float* __restrict__ A, int B, int n, float tiny) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t ld = static_cast<size_t>(B);
  // element (i, j) of this thread's matrix
  auto at = [&](int i, int j) -> float& {
    return A[(static_cast<size_t>(i) * n + j) * ld + b];
  };

  // phase 1: right-looking Cholesky; row j of the trailing matrix sits
  // in the upper triangle, column j of L goes to the lower one
  for (int j = 0; j < n; ++j) {
    const float d = at(j, j);
    const float piv = sqrtf(d < tiny ? tiny : d);   // a NaN stays NaN
    at(j, j) = d / piv;
    for (int i = j + 1; i < n; ++i) at(i, j) = at(j, i) / piv;
    for (int r = j + 1; r < n; ++r) {
      const float lr = at(r, j);
      for (int c = r; c < n; ++c) at(r, c) = at(r, c) - lr * at(c, j);
    }
  }

  // phase 2: X = L^{-1} in place, row by row, top down
  for (int i = 0; i < n; ++i) {
    const float lii = at(i, i);
    for (int c = 0; c < i; ++c) {
      float acc = 0.0f;
      for (int k = c; k < i; ++k) acc += at(i, k) * at(k, c);
      at(i, c) = (0.0f - acc) / lii;
    }
    at(i, i) = 1.0f / lii;
    for (int c = i + 1; c < n; ++c) at(i, c) = 0.0f;
  }
}

}  // namespace

// A: the (n, n, B) lanes-last buffer, H on entry, X = L^{-1} on exit
extern "C" int chol_lanes_f32(float* A, int B, int n, float tiny,
                              void* stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  chol_lanes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, n, tiny);
  return static_cast<int>(cudaGetLastError());
}
