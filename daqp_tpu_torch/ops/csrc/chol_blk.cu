// B10: batched Cholesky + triangular inverse, panel-blocked, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/chol.py:644 batched_chol_rinv_blk
// (kernel body _tile_chol_kernel_blk, chol.py:319), the panel-8 variant.
// Per SPD (n, n) matrix H it computes K1's function, X = L^{-1} with
// H = L L' and pivots clamped to `tiny` (the wrapper returns Rinv = X'),
// in that kernel's order:
//   phase 1, panel j0 (8 columns): factor the panel by 8 micro-steps
//   (pivot, column scale, update of the panel's remaining columns), then
//   ONE rank-8 Schur downdate of the trailing lower triangle, t = 0..7 in
//   turn per element (chol.py:395-397);
//   phase 2, rows i0..i0+7: ONE pass over the finished rows of X
//   accumulates acc[t][c] = sum_{k<i0} L[i0+t][k] X[k][c] for all 8 rows,
//   then the 8x8 diagonal block is solved row by row,
//   X[i][c] = -inv_i (acc + sum_{s<t} L[i][i0+s] X[i0+s][c]).
// A ragged last panel (n = 50: six of 8 and one of 2) is masked; there is
// no identity padding.
//
// Design: one block per matrix, and the matrix lives in DEVICE memory:
// the output buffer is the working matrix, in place, as the TPU kernel's
// Hc (H is copied into it first).  Shared memory holds only the current
// panel, n x 8 in phase 1 and the 8 L rows in phase 2 (stride 9), 9n
// floats: 18 KB at n = 500, so shared memory puts no limit on n (K1 keeps
// the whole matrix there and stops at n = 240).  In the downdate a warp
// owns a row of the trailing triangle and each lane a column of it; every
// element is read and written once per panel, with 8 FMAs from the panel
// in shared memory.  In phase 2 each thread owns columns of the 8 new
// rows and keeps their 8 sums in registers.
//
// What bounds it on an H100: at n <= 100 latency (n / 8 panels of 8
// dependent micro-steps, each behind two block barriers, plus n / 8 row
// blocks); at n = 500 the trailing matrix's traffic through L2 (each
// panel re-reads and re-writes it: ~n^3 / 12 floats each way per matrix)
// against ~2 n^3 / 3 FLOPs.  No fast-math: division and sqrt are IEEE.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPB = 8;            // panel width
constexpr int kLdp = kPB + 1;     // panel row stride in shared memory

__global__ void __launch_bounds__(kThreads)
chol_blk_kernel(const float* __restrict__ H, float* __restrict__ X, int n,
                float tiny) {
  extern __shared__ float P[];     // n x kLdp
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  float* A = X + off;
  const float* h = H + off;
  for (int idx = t; idx < n * n; idx += kThreads) A[idx] = h[idx];
  __syncthreads();

  // ---- phase 1: blocked right-looking Cholesky on the lower triangle
  for (int j0 = 0; j0 < n; j0 += kPB) {
    const int w = min(kPB, n - j0);
    // the panel's lower part: rows j0..n-1 of columns j0..j0+w-1
    for (int idx = t; idx < (n - j0) * w; idx += kThreads) {
      const int r = j0 + idx / w, c = idx % w;
      P[r * kLdp + c] = A[r * n + j0 + c];
    }
    __syncthreads();
    for (int s = 0; s < w; ++s) {
      const int j = j0 + s;
      const float d = P[j * kLdp + s];
      const float piv = sqrtf(d < tiny ? tiny : d);  // a NaN stays NaN
      for (int r = j + 1 + t; r < n; r += kThreads)
        P[r * kLdp + s] = P[r * kLdp + s] / piv;
      __syncthreads();
      if (t == 0) P[j * kLdp + s] = piv;
      // the panel's remaining columns, lower part only
      const int rest = w - 1 - s;
      for (int idx = t; idx < (n - j - 1) * rest; idx += kThreads) {
        const int r = j + 1 + idx / rest, c = s + 1 + idx % rest;
        if (r >= j0 + c)
          P[r * kLdp + c] = P[r * kLdp + c] -
                            P[r * kLdp + s] * P[(j0 + c) * kLdp + s];
      }
      __syncthreads();
    }
    for (int idx = t; idx < (n - j0) * w; idx += kThreads) {
      const int r = j0 + idx / w, c = idx % w;
      if (r >= j0 + c) A[r * n + j0 + c] = P[r * kLdp + c];
    }
    // one rank-8 downdate of the trailing lower triangle (a ragged panel
    // is the last one: nothing trails it)
    const int j1 = j0 + w;
    for (int r = j1 + warp; r < n; r += kWarps) {
      float pr[kPB];
#pragma unroll
      for (int s = 0; s < kPB; ++s) pr[s] = P[r * kLdp + s];
      for (int c = j1 + lane; c <= r; c += 32) {
        float a = A[r * n + c];
#pragma unroll
        for (int s = 0; s < kPB; ++s) a = a - pr[s] * P[c * kLdp + s];
        A[r * n + c] = a;
      }
    }
    __syncthreads();
  }

  // ---- phase 2: X = L^{-1} in place, 8 rows at a time, top down
  for (int i0 = 0; i0 < n; i0 += kPB) {
    const int w = min(kPB, n - i0);
    const int cend = i0 + w;          // the new rows' nonzero columns
    // the w L rows, columns 0..cend-1 (P[s * n + k] = L[i0 + s][k])
    for (int idx = t; idx < w * cend; idx += kThreads) {
      const int s = idx / cend, k = idx % cend;
      P[s * n + k] = A[(i0 + s) * n + k];
    }
    __syncthreads();
    // each thread owns columns c of the w new rows and writes them as it
    // goes: the pass reads only the rows above i0 and the panel
    for (int c = t; c < n; c += kThreads) {
      if (c >= cend) {
        for (int s = 0; s < w; ++s) A[(i0 + s) * n + c] = 0.0f;
        continue;
      }
      float acc[kPB], x[kPB];
#pragma unroll
      for (int s = 0; s < kPB; ++s) acc[s] = 0.0f;
      // off-block: one pass over the finished rows c..i0-1 of X
      for (int k = c; k < i0; ++k) {
        const float xk = A[k * n + c];
#pragma unroll
        for (int s = 0; s < kPB; ++s)
          if (s < w) acc[s] += P[s * n + k] * xk;
      }
      // the diagonal block, row by row
#pragma unroll
      for (int s = 0; s < kPB; ++s) {
        if (s < w) {
          const int i = i0 + s;
          const float inv = 1.0f / P[s * n + i];
          float r = acc[s];
#pragma unroll
          for (int u = 0; u < kPB; ++u)
            if (u < s) r = r + P[s * n + i0 + u] * x[u];
          x[s] = c == i ? inv : (c > i ? 0.0f : -inv * r);
          A[i * n + c] = x[s];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// H (B, n, n) in; X (B, n, n) out, the working matrix: X = L^{-1}
// (lower).  Shared memory per block: 9 n floats.
extern "C" int chol_blk_f32(const float* H, float* X, int B, int n,
                            float tiny, void* stream) {
  const size_t smem = static_cast<size_t>(n) * kLdp * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_blk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  chol_blk_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      H, X, n, tiny);
  return static_cast<int>(cudaGetLastError());
}
