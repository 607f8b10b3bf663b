// B9: batched Cholesky + triangular inverse, one warp per matrix, f32,
// sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/chol.py:563
// batched_chol_rinv_dense (kernel body _chol_kernel_dense, chol.py:448).
// Per SPD (n, n) matrix H it computes K1's function, Rinv = (L^{-1})'
// with H = R'R and pivots clamped to `tiny`, with that kernel's step
// structure:
//   phase 1, column j: extract column j and scale it (the TPU kernel's
//   one-hot contraction), then ONE fused pass over the trailing lower
//   triangle that writes column j of L (piv on the diagonal) and applies
//   the rank-1 Schur downdate everywhere right of it;
//   phase 2, row i: one pass accumulates acc[c] = sum_{k<i} L[i][k]
//   X[k][c] over the finished rows of X, then row i of X = L^{-1} is
//   written in place, full width: -acc / L[i][i] left of the diagonal
//   (as -inv * acc), inv on it, zeros right of it.
// The masks of the TPU kernel (Mosaic's workaround for dynamic slices)
// are gone: a lane touches only the elements its step changes.
//
// Design: one warp per matrix, the matrix in shared memory with an odd
// row stride (n|1, as K1) plus one row of scratch, n (n|1) + n floats;
// W = blockDim.x / 32 matrices share a block (the wrapper picks W from
// n: 4 at n = 50, 41.6 KB).  A warp needs no block barrier: __syncwarp()
// orders its steps, so the n + n dependent steps cost a warp-local sync
// each instead of K1's two block barriers, at 32 lanes of parallel work
// per step instead of 128.  Rows of the trailing triangle are spread over
// the lanes by column, so a warp's accesses hit consecutive banks.
//
// What bounds it on an H100: latency.  Bytes (2 n^2 floats per matrix)
// and FLOPs (~2 n^3 / 3 per matrix) are far below the card's rates; each
// warp runs 2n dependent steps of at most ~n^2 / 64 elements per lane.
// No fast-math: division and sqrt are IEEE.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 8;       // columns per lane in phase 2: n <= 256

__global__ void chol_dense_kernel(const float* __restrict__ H,
                                  float* __restrict__ Rinv, int B, int n,
                                  float tiny) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= B) return;                  // whole warps leave; no block sync
  const int ld = n | 1;
  float* A = smem + static_cast<size_t>(warp) * (n * ld + n);
  float* s = A + n * ld;               // scaled column j, then unused
  const size_t off = static_cast<size_t>(b) * n * n;
  const float* h = H + off;

  for (int idx = lane; idx < n * n; idx += 32)
    A[(idx / n) * ld + idx % n] = h[idx];
  __syncwarp();

  // phase 1: right-looking Cholesky on the lower triangle
  for (int j = 0; j < n; ++j) {
    const float d = A[j * ld + j];
    const float piv = sqrtf(d < tiny ? tiny : d);   // a NaN stays NaN
    for (int r = j + 1 + lane; r < n; r += 32) s[r] = A[r * ld + j] / piv;
    __syncwarp();
    // fused pass: column j <- L[:, j]; columns c > j <- Schur downdate
    for (int r = j; r < n; ++r) {
      const float sr = s[r];
      for (int c = j + lane; c <= r; c += 32)
        A[r * ld + c] = c == j ? (r == j ? piv : sr)
                               : A[r * ld + c] - sr * s[c];
    }
    __syncwarp();
  }

  // phase 2: X = L^{-1} in place, row by row, top down
  const int groups = (n + 31) / 32;
  for (int i = 0; i < n; ++i) {
    const float inv = 1.0f / A[i * ld + i];
    float acc[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) acc[g] = 0.0f;
    for (int k = 0; k < i; ++k) {
      const float w = A[i * ld + k];                // L[i][k]
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        const int c = lane + 32 * g;
        if (g < groups && c <= k) acc[g] += w * A[k * ld + c];
      }
    }
    __syncwarp();                      // row i is read; now overwrite it
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int c = lane + 32 * g;
      if (g < groups && c < n)
        A[i * ld + c] = c < i ? -inv * acc[g] : (c == i ? inv : 0.0f);
    }
    __syncwarp();
  }

  // store Rinv = X' (upper); X's upper triangle is zero
  float* out = Rinv + off;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int r = idx / n, c = idx % n;
    out[idx] = A[c * ld + r];
  }
}

}  // namespace

// warps: matrices per block (1..32); shared memory per block is
// warps * (n (n|1) + n) floats
extern "C" int chol_dense_f32(const float* H, float* Rinv, int B, int n,
                              int warps, float tiny, void* stream) {
  if (n > 32 * kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warps) *
                      (static_cast<size_t>(n) * (n | 1) + n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  const int grid = (B + warps - 1) / warps;
  chol_dense_kernel<<<grid, 32 * warps, smem,
                      static_cast<cudaStream_t>(stream)>>>(H, Rinv, B, n,
                                                            tiny);
  return static_cast<int>(cudaGetLastError());
}
