// The warp per matrix that K1 (chol_rinv.cu) and B9 (chol_dense.cu)
// share: batched Cholesky + triangular inverse, f32, sm_90a.
//
// Per SPD (n, n) matrix H both compute Rinv = (L^{-1})' with H = R'R and
// pivots clamped to `tiny`, in the expression order their TPU kernels
// share (_tile_chol_kernel_loop and _chol_kernel_dense):
//   phase 1, column j: piv = sqrt(max(d, tiny)) is L[j][j], the column
//   below it is divided by piv, then the trailing lower triangle is
//   downdated, (r, c) - L[r][j] L[c][j] (one multiply-add);
//   phase 2, row i: acc[c] = sum_{k<i} L[i][k] X[k][c] over the finished
//   rows of X = L^{-1}, in ascending k, then row i of X is -inv * acc
//   left of the diagonal and inv = 1 / L[i][i] on it, in place of row i
//   of L.
// It reads H's lower triangle, as the twins do.
//
// What bounds it on an H100: bytes (2 n^2 floats per matrix, 0.0611 ms
// at B = 10240, n = 50) and FLOPs (~2 n^3 / 3 per matrix) are far below
// the card's rates.  A matrix is 2n dependent steps.  Across the 40
// warps an SM holds at n = 50, phase 1's shared-memory accesses (five an
// element: the table, the two column values, the element and its store)
// come next; a small batch (a few matrices an SM) waits on each
// matrix's chain of steps.
//
// Design: one warp per matrix and no barrier between the warps of a
// block after its start, so a step is ordered by __syncwarp() alone.
// The warp holds the lower triangle packed column by column, (r, c) at
// cs(c) + r - c, n (n + 1) / 2 floats (5.1 KB at n = 50, half of a
// square), so that many matrices fit on an SM.  Column by column, the
// trailing triangle of step j is the packed array's suffix from
// cs(j + 1): the warp spreads it over its 32 lanes as one flat range,
// kUnroll elements a lane in flight, and reads each element's row and
// column from a table of the block, rc[p] = r | c << 8, built once
// before the block's one barrier.  Phase 2 gives lane l the columns
// l + 32 g (g < G, the kernels' template: 1, 2, 4 or 8 groups for n up to
// 32, 64, 128, 256); a lane reads and writes only its own columns, so
// the rows need no sync: row i of L comes into registers, L[i][k]
// reaches every lane by __shfl_sync, and the sums of the column groups
// left of k's group take every term, only k's own group tests c <= k.
// The block loads H's rows by cp.async and writes Rinv's rows, zeros
// below the diagonal included.  For a small batch (config 4's retry of
// 256 matrices) the template's P = kSmallP warps share one matrix, a
// block each: phase 1's range, the loads and the stores spread over
// their 128 threads, a block barrier a step, and phase 2 runs on the
// first warp.  The wrappers pick the matrices a block (1, 2, 4, 8) and P
// from n and B.  No fast-math: division and sqrt are IEEE.
#pragma once

#include <cuda_runtime.h>

#include "chol_probe.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kMaxGroups = 8;       // column groups a lane holds: n <= 256
constexpr int kMaxWarps = 8;        // warps a block: matrices at P = 1
constexpr int kUnroll = 4;          // phase 1's elements a lane in flight
constexpr int kSmallP = 4;          // warps a matrix for a small batch

// column c of the packed lower triangle (rows c..n-1) starts at cs(c)
__device__ __forceinline__ int cs(int c, int n) {
  return c * n - (c * (c - 1)) / 2;
}

// floats per block: `per_block` packed triangles, then the (row,
// column) table, n (n + 1) / 2 16-bit words
size_t warp_floats(int n, int per_block) {
  const size_t T = static_cast<size_t>(n) * (n + 1) / 2;
  return per_block * T + (T + 1) / 2;
}

// a step's sync among the P warps of a matrix: the warp's own, or the
// block's (P > 1 runs one matrix a block)
template <int P>
__device__ __forceinline__ void sync_matrix() {
  if (P == 1)
    __syncwarp();
  else
    __syncthreads();
}

// the body of both kernels: G column groups of 32 a lane in phase 2, P
// warps a matrix (1, or kSmallP with one matrix a block); smem is the
// block's dynamic shared memory
template <int G, int P>
__device__ __forceinline__ void chol_warp(const float* __restrict__ H,
                                          float* __restrict__ Rinv, int B,
                                          int n, float tiny, float* smem) {
  constexpr int NT = 32 * P;           // threads a matrix
  const int W = blockDim.x / NT, m = threadIdx.x / NT;
  const int t = threadIdx.x % NT, lane = t % 32;
  const int T = n * (n + 1) / 2;
  const int b = blockIdx.x * W + m;
  const bool live = b < B;
  float* A = smem + m * T;
  unsigned short* rc = reinterpret_cast<unsigned short*>(smem + W * T);
  const size_t off = static_cast<size_t>(b) * n * n;
  CHOL_PROBE_INIT(live && t == 0)

  // ---- load: row r of H's lower triangle, (r, c) to cs(c) + r - c, all
  // copies in flight while the block builds the table
  if (live) {
    const float* h = H + off;
    for (int r = 0; r < n; ++r)
      for (int c = t; c <= r; c += NT)
        cp_async4(A + cs(c, n) + r - c, h + r * n + c);
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    for (int r = c, p = cs(c, n); r < n; ++r, ++p)
      rc[p] = static_cast<unsigned short>(r | c << 8);
  cp_async_wait_all();
  __syncthreads();                     // the table; then no block barrier
  if (!live) return;                   // (P > 1: the whole block)
  CHOL_PROBE_MARK(0)

  // ---- phase 1: right-looking Cholesky, column by column
  for (int j = 0; j < n; ++j) {
    const int pj = cs(j, n);           // (j, j); (r, j) at cj + r
    const int cj = pj - j;
    const float d = A[pj];
    const float piv = sqrtf(d < tiny ? tiny : d);   // a NaN stays NaN
    for (int r = j + 1 + t; r < n; r += NT) A[cj + r] = A[cj + r] / piv;
    sync_matrix<P>();                  // column j of L; every lane read d
    if (t == 0) A[pj] = piv;
    // the trailing triangle: (r, c) -= L[r][j] L[c][j], the suffix
    for (int p = pj + n - j + t; p < T; p += NT * kUnroll) {
      float a[kUnroll], x[kUnroll], y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = p + NT * u;
        if (q < T) {
          const unsigned v = rc[q];
          a[u] = A[q];
          x[u] = A[cj + (v & 255)];
          y[u] = A[cj + (v >> 8)];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + NT * u < T) A[p + NT * u] = fmaf(-x[u], y[u], a[u]);
    }
    sync_matrix<P>();
  }
  CHOL_PROBE_MARK(1)

  // ---- phase 2 (the matrix's first warp): X = L^{-1} in place, row by
  // row; lane l owns the columns c = l + 32 g, (i, c) at base[g] + i
  if (t < 32) {
    int base[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = lane + 32 * g;
      base[g] = c < n ? cs(c, n) - c : 0;
    }
    for (int i = 0; i < n; ++i) {
      float li[G], acc[G];             // L[i][c]; the sums
      float dsel = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        li[g] = lane + 32 * g <= i ? A[base[g] + i] : 0.0f;
        acc[g] = 0.0f;
        if ((i >> 5) == g) dsel = li[g];
      }
      const float inv = 1.0f / __shfl_sync(0xffffffffu, dsel, i & 31);
#pragma unroll
      for (int kb = 0; kb < G; ++kb) {
        const int k0 = 32 * kb;
        if (k0 >= i) break;
        const int k1 = i < k0 + 32 ? i : k0 + 32;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) {
          const float w = __shfl_sync(0xffffffffu, li[kb], k - k0);
#pragma unroll
          for (int g = 0; g <= kb; ++g)
            if (g < kb || lane <= k - k0)        // c <= k
              acc[g] = fmaf(w, A[base[g] + k], acc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = lane + 32 * g;
        if (c < i)
          A[base[g] + i] = -inv * acc[g];
        else if (c == i)
          A[base[g] + i] = inv;
      }
    }
  }
  sync_matrix<P>();
  CHOL_PROBE_MARK(2)

  // ---- store: Rinv[c][i] = X[i][c] = (i, c) for i >= c, zero below; a
  // warp a row
  float* out = Rinv + off;
  for (int c = t / 32; c < n; c += P) {
    const int pc = cs(c, n) - c;
    for (int i = lane; i < n; i += 32)
      out[c * n + i] = i >= c ? A[pc + i] : 0.0f;
  }
  CHOL_PROBE_MARK(3)
  CHOL_PROBE_FLUSH(b)
}

// The launch that K1 and B9 share.  Each .cu wraps chol_warp<G, P> in
// its own __global__ template and passes a struct K whose
// K::at<G, P>() is that template's instance; the instance for n and P
// warps a matrix (1 or kSmallP) has G column groups of 32 a lane, n <=
// 32 G.
using WarpKernel = void (*)(const float*, float*, int, int, float);

template <class K, int P>
WarpKernel kernel_for(int n) {
  return n <= 32    ? K::template at<1, P>()
         : n <= 64  ? K::template at<2, P>()
         : n <= 128 ? K::template at<4, P>()
                    : K::template at<8, P>();
}

template <class K>
WarpKernel kernel_for(int n, int P) {
  return P == 1 ? kernel_for<K, 1>(n) : kernel_for<K, kSmallP>(n);
}

// shapes the kernels take: n <= 32 kMaxGroups, per_block matrices a
// block of P warps each, 1 to kMaxWarps at P = 1, or 1 at P = kSmallP
bool shape_ok(int n, int per_block, int P) {
  return n <= 32 * kMaxGroups && per_block >= 1 && per_block <= kMaxWarps &&
         (P == 1 || (P == kSmallP && per_block == 1));
}

// a C entry's launch: the shared memory the block needs (opted in past
// 48 KB, warp_floats(n, per_block) floats), then ceil(B / per_block)
// blocks of 32 per_block P threads
template <class K>
int launch_warp(const float* H, float* Rinv, int B, int n, int per_block,
                int P, float tiny, void* stream) {
  if (!shape_ok(n, per_block, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const WarpKernel kernel = kernel_for<K>(n, P);
  const size_t smem = warp_floats(n, per_block) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  const int grid = (B + per_block - 1) / per_block;
  kernel<<<grid, 32 * per_block * P, smem,
           static_cast<cudaStream_t>(stream)>>>(H, Rinv, B, n, tiny);
  return static_cast<int>(cudaGetLastError());
}

#ifdef CHOL_OCCUPANCY
// resident blocks of K's kernel per SM at n and `per_block` matrices a
// block of P warps each, by the occupancy calculator (chip_profile.py
// --probe k1 | k9 builds it with -DCHOL_OCCUPANCY, without the marks)
template <class K>
int occupancy_warp(int n, int per_block, int P, int* blocks) {
  if (!shape_ok(n, per_block, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const WarpKernel kernel = kernel_for<K>(n, P);
  const size_t smem = warp_floats(n, per_block) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, 32 * per_block * P, smem);
  return static_cast<int>(e);
}
#endif

}  // namespace
