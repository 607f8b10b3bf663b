// K1: batched Cholesky fused with the triangular inverse, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/chol.py:607 batched_chol_rinv_tile
// (kernel body _tile_chol_kernel_loop, chol.py:235).  For each SPD
// (n, n) matrix H of the batch it returns the upper Rinv with H = R'R,
// i.e. Rinv = (L^{-1})' for the lower Cholesky factor L.  A pivot below
// `tiny` clamps to it (never NaN), so the caller's pivot-ratio test
// (chol.py:805-812) flags the lane instead of reading garbage.
//
// What bounds it on an H100: not bytes (2 n^2 floats per matrix, 20 KB
// at n = 50) and not FLOPs (~n^3 per matrix), but latency: the
// factorization is n dependent column steps and the inverse n dependent
// rows, each a handful of shared-memory passes separated by barriers,
// with little parallel work per step ((n-j)^2 / 2 trailing elements).
//
// Design: one thread block per matrix, the whole matrix resident in
// shared memory (n (n|1) + n floats, 10.4 KB at n = 50) so a block never
// touches device memory between its load and its store; many such
// blocks fit on one SM and hide each other's barrier latency.  The row
// stride is odd (n|1) so a warp reading a column hits 32 distinct banks.
// Phase 1 is the right-looking factorization of the TPU kernel (pivot,
// column scale, rank-1 trailing update restricted to the lower
// triangle), two barriers per column.  Phase 2 is the row-wise forward
// substitution X = L^{-1} in place (row i reads L[i, :i] and the rows of
// X above it), two barriers per row.  The store writes X' (upper Rinv).
// No fast-math: division and sqrt are IEEE, as in the JAX kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
chol_rinv_kernel(const float* __restrict__ H, float* __restrict__ Rinv,
                 int n, float tiny) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  float* A = smem;              // n x ld: H, then L (lower), then X = L^{-1}
  float* S = smem + n * ld;     // one row of scratch
  const int t = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const float* h = H + off;

  for (int idx = t; idx < n * n; idx += blockDim.x)
    A[(idx / n) * ld + idx % n] = h[idx];
  __syncthreads();

  // phase 1: in-place right-looking Cholesky on the lower triangle
  for (int j = 0; j < n; ++j) {
    float d = A[j * ld + j];
    d = d < tiny ? tiny : d;             // clamp; a NaN stays NaN
    const float piv = sqrtf(d);
    for (int r = j + 1 + t; r < n; r += blockDim.x)
      A[r * ld + j] = A[r * ld + j] / piv;
    __syncthreads();
    if (t == 0) A[j * ld + j] = piv;     // every thread has read A[j][j]
    const int k = n - j - 1;
    for (int idx = t; idx < k * k; idx += blockDim.x) {
      const int r = j + 1 + idx / k;
      const int c = j + 1 + idx % k;
      if (c <= r) A[r * ld + c] = A[r * ld + c] - A[r * ld + j] * A[c * ld + j];
    }
    __syncthreads();
  }

  // phase 2: in-place X = L^{-1}, row by row, top down
  for (int i = 0; i < n; ++i) {
    const float inv = 1.0f / A[i * ld + i];
    for (int c = t; c < i; c += blockDim.x) {
      float acc = 0.0f;
      for (int k = c; k < i; ++k) acc += A[i * ld + k] * A[k * ld + c];
      S[c] = -inv * acc;
    }
    __syncthreads();
    for (int c = t; c < i; c += blockDim.x) A[i * ld + c] = S[c];
    if (t == 0) A[i * ld + i] = inv;
    __syncthreads();
  }

  // store Rinv = X' (upper); the strictly lower part is zero
  float* out = Rinv + off;
  for (int idx = t; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    out[idx] = c >= r ? A[c * ld + r] : 0.0f;
  }
}

}  // namespace

extern "C" int chol_rinv_f32(const float* H, float* Rinv, int B, int n,
                             float tiny, void* stream) {
  const size_t smem = (static_cast<size_t>(n) * (n | 1) + n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_rinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  chol_rinv_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      H, Rinv, n, tiny);
  return static_cast<int>(cudaGetLastError());
}
