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
// below the diagonal included.
//
// A batch smaller than the card (config 4's retry of 256 matrices, the
// flat grid's 64 at n = 100 and 16 at n = 200) leaves SMs idle, and each
// launch waits on one matrix's chain.  There P = 4 or 8 warps (kWarpsP)
// share one matrix, a block each, in a body of its own,
// chol_wide, on the same packed triangle, which computes the same
// expressions in the same order (the same bits, at every P):
// - phase 1 left-looking, kRows = 4 columns at a time: a thread owns
//   rows and adds to each element (r, c) the terms j < c in ascending j,
//   the four columns' chains at once, L[c0..c0+3][j] read once for them;
//   the 4 x 4 diagonal block's partial sums go to a scratch, and after
//   one barrier every thread finishes that block itself (its pivots and
//   divisions), then its own rows below it: two barriers a block of
//   columns instead of two a column, and no read-modify-write of the
//   trailing triangle a step;
// - phase 2 on every warp that owns columns (warp w's lane l owns c = l
//   + 32 (w + P g)), kRows rows at a time: L[i0..i0+3][k] read once for
//   the warp, X[k][c] once for the four sums, the terms inside the block
//   from registers, then one barrier among those warps (row i of X is
//   written over row i of L) and the four rows' stores.
// The probe (chip_profile.py --probe k1) put the parent's phase 2, one
// warp at P = 4, at 51-64% of the flat grid's matrices.  The wrappers
// pick the matrices a block (1, 2, 4, 8) at P = 1, or P, from n, B and
// the SMs (chol.warp_shape).  No fast-math: division and sqrt are IEEE.
#pragma once

#include <cuda_runtime.h>

#include "chol_probe.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kMaxGroups = 8;       // column groups a lane holds: n <= 256
constexpr int kMaxWarps = 8;        // warps a block: matrices at P = 1
constexpr int kUnroll = 4;          // phase 1's elements a lane in flight
constexpr int kWarpsP[] = {4, 8};  // warps a matrix, a block each
constexpr int kRows = 4;            // chol_wide's rows (columns) a block

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

// the body of both kernels at one warp a matrix: G column groups of 32
// a lane in phase 2; smem is the block's dynamic shared memory
template <int G>
__device__ __forceinline__ void chol_warp(const float* __restrict__ H,
                                          float* __restrict__ Rinv, int B,
                                          int n, float tiny, float* smem) {
  const int W = blockDim.x / 32, m = threadIdx.x / 32;
  const int t = threadIdx.x % 32, lane = t;
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
      for (int c = t; c <= r; c += 32)
        cp_async4(A + cs(c, n) + r - c, h + r * n + c);
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    for (int r = c, p = cs(c, n); r < n; ++r, ++p)
      rc[p] = static_cast<unsigned short>(r | c << 8);
  cp_async_wait_all();
  __syncthreads();                     // the table; then no block barrier
  if (!live) return;
  CHOL_PROBE_MARK(0)

  // ---- phase 1: right-looking Cholesky, column by column
  for (int j = 0; j < n; ++j) {
    const int pj = cs(j, n);           // (j, j); (r, j) at cj + r
    const int cj = pj - j;
    const float d = A[pj];
    const float piv = sqrtf(d < tiny ? tiny : d);   // a NaN stays NaN
    for (int r = j + 1 + t; r < n; r += 32) A[cj + r] = A[cj + r] / piv;
    __syncwarp();                      // column j of L; every lane read d
    if (t == 0) A[pj] = piv;
    // the trailing triangle: (r, c) -= L[r][j] L[c][j], the suffix
    for (int p = pj + n - j + t; p < T; p += 32 * kUnroll) {
      float a[kUnroll], x[kUnroll], y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = p + 32 * u;
        if (q < T) {
          const unsigned v = rc[q];
          a[u] = A[q];
          x[u] = A[cj + (v & 255)];
          y[u] = A[cj + (v >> 8)];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + 32 * u < T) A[p + 32 * u] = fmaf(-x[u], y[u], a[u]);
    }
    __syncwarp();
  }
  CHOL_PROBE_MARK(1)

  // ---- phase 2: X = L^{-1} in place, row by row; lane l owns the
  // columns c = l + 32 g, (i, c) at base[g] + i
  {
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
  __syncwarp();
  CHOL_PROBE_MARK(2)

  // ---- store: Rinv[c][i] = X[i][c] = (i, c) for i >= c, zero below; a
  // row at a time
  float* out = Rinv + off;
  for (int c = 0; c < n; ++c) {
    const int pc = cs(c, n) - c;
    for (int i = lane; i < n; i += 32)
      out[c * n + i] = i >= c ? A[pc + i] : 0.0f;
  }
  CHOL_PROBE_MARK(3)
  CHOL_PROBE_FLUSH(b)
}

// floats of chol_wide's block: the packed lower triangle, the reads of
// four rows past the last one (2, rounded up to 4), then the diagonal
// block's scratch (16)
size_t wide_floats(int n) {
  return static_cast<size_t>(n) * (n + 1) / 2 + 4 + 16;
}

// the body of both kernels at P > 1: one matrix a block of P warps, its
// rows (phase 1) and columns (phase 2) in G groups of 32, n <= 32 G; the
// lower triangle packed by columns as chol_warp's, (r, c) at cs(c) + r -
// c
template <int G, int P>
__device__ __forceinline__ void chol_wide(const float* __restrict__ H,
                                          float* __restrict__ Rinv, int n,
                                          float tiny, float* A) {
  constexpr int NT = 32 * P;
  constexpr int GW = (G + P - 1) / P;  // rows / columns a thread
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const int T = n * (n + 1) / 2;
  float* D = A + T + 4;                // the diagonal block's partial sums
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  CHOL_PROBE_INIT(t == 0)

  // ---- load: (r, c) of H's lower triangle to cs(c) + r - c
  const float* h = H + off;
  for (int r = 0; r < n; ++r)
    for (int c = t; c <= r; c += NT) cp_async4(A + cs(c, n) + r - c, h + r * n + c);
  cp_async_wait_all();
  __syncthreads();
  CHOL_PROBE_MARK(0)

  // ---- phase 1, left-looking, kRows columns at a time: element (r, c)
  // takes fmaf(-L[r][j], L[c][j], a) for j = 0 .. c - 1 in ascending j,
  // then L[c][c] = sqrt(max(a, tiny)) or L[r][c] = a / L[c][c], as
  // chol_warp's right-looking steps do; thread t owns rows t + NT u (a
  // row past n reads row n - 1 and stores nothing)
  int rows[GW];
#pragma unroll
  for (int u = 0; u < GW; ++u) {
    const int r = t + NT * u;
    rows[u] = r < n ? r : n - 1;
  }
  for (int c0 = 0; c0 < n; c0 += kRows) {
    const int nq = n - c0 < kRows ? n - c0 : kRows;
    float a[GW][kRows];
    bool busy = false;                 // a row of the thread left: r >= c0
#pragma unroll
    for (int u = 0; u < GW; ++u) {
      const int r = t + NT * u;
      busy = busy || (r >= c0 && r < n);
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        a[u][q] = r < n && q < nq && c0 + q <= r
                      ? A[cs(c0 + q, n) + r - c0 - q] : 0.0f;
    }
    // the terms of the finished columns j < c0, L[c0 .. c0 + 3][j] read
    // once for the thread's rows
    int pj = 0;                        // cs(j, n) - j
#pragma unroll 4
    for (int j = 0; j < (busy ? c0 : 0); ++j) {
      float lc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) lc[q] = A[pj + c0 + q];
#pragma unroll
      for (int u = 0; u < GW; ++u) {
        const float lr = A[pj + rows[u]];
#pragma unroll
        for (int q = 0; q < kRows; ++q) a[u][q] = fmaf(-lr, lc[q], a[u][q]);
      }
      pj += n - j - 1;
    }
    // the diagonal block's rows hand their partial sums over; every
    // thread then finishes that block in the steps' order
#pragma unroll
    for (int u = 0; u < GW; ++u) {
      const int q2 = t + NT * u - c0;
      if (q2 >= 0 && q2 < nq)
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (q <= q2) D[q2 * kRows + q] = a[u][q];
    }
    __syncthreads();
    float d[kRows][kRows];             // d[q2][q]: L[c0 + q2][c0 + q]
#pragma unroll
    for (int q2 = 0; q2 < kRows; ++q2)
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        d[q2][q] = q <= q2 && q2 < nq ? D[q2 * kRows + q] : 0.0f;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (q < nq) {
#pragma unroll
        for (int q2 = q; q2 < kRows; ++q2)
#pragma unroll
          for (int jj = 0; jj < q; ++jj)
            d[q2][q] = fmaf(-d[q2][jj], d[q][jj], d[q2][q]);
        const float dd = d[q][q];
        const float piv = sqrtf(dd < tiny ? tiny : dd);  // a NaN stays NaN
        d[q][q] = piv;
#pragma unroll
        for (int q2 = q + 1; q2 < kRows; ++q2) d[q2][q] = d[q2][q] / piv;
      }
    }
    // the thread's rows: below the block, the terms j = c0 .. c - 1 from
    // the block, the division, the store; inside it, the block's values
#pragma unroll
    for (int u = 0; u < GW; ++u) {
      const int r = t + NT * u;
      if (r >= c0 + kRows && r < n) {
        float l[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
#pragma unroll
          for (int jj = 0; jj < q; ++jj)
            a[u][q] = fmaf(-l[jj], d[q][jj], a[u][q]);
          l[q] = a[u][q] / d[q][q];
          A[cs(c0 + q, n) + r - c0 - q] = l[q];
        }
      } else if (r >= c0 && r - c0 < nq) {
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (q <= r - c0) A[cs(c0 + q, n) + r - c0 - q] = d[r - c0][q];
      }
    }
    __syncthreads();
  }
  CHOL_PROBE_MARK(1)

  // ---- phase 2: X = L^{-1} in place on the nw warps that own columns,
  // kRows rows a barrier; column c takes the terms k >= c in ascending k,
  // fmaf(L[i][k], X[k][c], acc), as chol_warp's phase 2 does
  const int nw = P < (n + 31) / 32 ? P : (n + 31) / 32;
  if (w < nw) {
    int col[GW], base[GW];
#pragma unroll
    for (int g = 0; g < GW; ++g) {
      col[g] = lane + 32 * (w + P * g);
      base[g] = col[g] < n ? cs(col[g], n) - col[g] : 0;
    }
    for (int i0 = 0; i0 < n; i0 += kRows) {
      float acc[kRows][GW], x[kRows][GW];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < GW; ++g) acc[r][g] = x[r][g] = 0.0f;
      // the terms k < i0 from the warp's first column on: L[i0 .. i0 +
      // 3][k] read once for its lanes, X[k][c] once for the four sums; a
      // term k < c is computed and not kept
      int pk = cs(32 * w, n) - 32 * w; // cs(k, n) - k
#pragma unroll 4
      for (int k = 32 * w; k < i0; ++k) {
        float lk[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) lk[r] = A[pk + i0 + r];
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          const float xk = A[base[g] + k];
          const bool keep = col[g] <= k;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float f = fmaf(lk[r], xk, acc[r][g]);
            acc[r][g] = keep ? f : acc[r][g];
          }
        }
        pk += n - k - 1;
      }
      // the terms inside the block, k = i0 .. i - 1, from the rows just
      // computed; then row i of X: -inv acc left of the diagonal, inv on
      // it
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < n) {
#pragma unroll
          for (int q = 0; q < r; ++q) {
            const int k = i0 + q;
            const float lik = A[cs(k, n) + i - k];
#pragma unroll
            for (int g = 0; g < GW; ++g)
              if (col[g] <= k) acc[r][g] = fmaf(lik, x[q][g], acc[r][g]);
          }
          const float inv = 1.0f / A[cs(i, n)];
#pragma unroll
          for (int g = 0; g < GW; ++g)
            x[r][g] = col[g] < i ? -inv * acc[r][g] : inv;
        }
      }
      // every warp has read rows i0 .. i0 + kRows - 1 of L
      asm volatile("bar.sync 1, %0;" ::"r"(32 * nw) : "memory");
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < GW; ++g)
          if (i0 + r < n && col[g] <= i0 + r)
            A[base[g] + i0 + r] = x[r][g];
    }
  }
  __syncthreads();
  CHOL_PROBE_MARK(2)

  // ---- store: Rinv[c][i] = X[i][c] for i >= c, zero below; a warp a row
  float* out = Rinv + off;
  for (int c = w; c < n; c += P) {
    const int pc = cs(c, n) - c;
    for (int i = lane; i < n; i += 32)
      out[c * n + i] = i >= c ? A[pc + i] : 0.0f;
  }
  CHOL_PROBE_MARK(3)
  CHOL_PROBE_FLUSH(blockIdx.x)
}

// the kernels' body: chol_warp at P = 1, chol_wide past it
template <int G, int P>
__device__ __forceinline__ void chol_body(const float* __restrict__ H,
                                          float* __restrict__ Rinv, int B,
                                          int n, float tiny, float* smem) {
  if constexpr (P == 1)
    chol_warp<G>(H, Rinv, B, n, tiny, smem);
  else
    chol_wide<G, P>(H, Rinv, n, tiny, smem);
}

// The launch that K1 and B9 share.  Each .cu wraps chol_body<G, P> in
// its own __global__ template and passes a struct K whose
// K::at<G, P>() is that template's instance; the instance for n and P
// warps a matrix (1 or one of kWarpsP) has G column groups of 32, n <=
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
  return P == 1   ? kernel_for<K, 1>(n)
         : P == 4 ? kernel_for<K, 4>(n)
                  : kernel_for<K, 8>(n);
}

// shapes the kernels take: n <= 32 kMaxGroups, per_block matrices a
// block of P warps each, 1 to kMaxWarps at P = 1, or 1 at P of kWarpsP
bool shape_ok(int n, int per_block, int P) {
  bool wide = false;
  for (int p : kWarpsP) wide = wide || P == p;
  return n <= 32 * kMaxGroups && per_block >= 1 && per_block <= kMaxWarps &&
         (P == 1 || (wide && per_block == 1));
}

// floats of a block: warp_floats at P = 1, wide_floats past it
size_t block_floats(int n, int per_block, int P) {
  return P == 1 ? warp_floats(n, per_block) : wide_floats(n);
}

// a C entry's launch: the shared memory the block needs (opted in past
// 48 KB, block_floats(n, per_block, P) floats), then ceil(B / per_block)
// blocks of 32 per_block P threads
template <class K>
int launch_warp(const float* H, float* Rinv, int B, int n, int per_block,
                int P, float tiny, void* stream) {
  if (!shape_ok(n, per_block, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const WarpKernel kernel = kernel_for<K>(n, P);
  const size_t smem = block_floats(n, per_block, P) * sizeof(float);
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
  const size_t smem = block_floats(n, per_block, P) * sizeof(float);
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
