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
// Every output is one chain of its terms in ascending order, as in the
// twin; only a multiply-add may be fused.
//
// What bounds it on an H100: bytes, 2 n^2 floats per matrix (0.0611 ms
// at B = 10240, n = 50); the n^3 / 3 multiply-adds per matrix come next,
// and each takes its operands from shared memory, so after the bytes the
// shared-memory issue rate (one 32-wide access per clock per SM, three
// per multiply-add in phase 1 and two in phase 2) is the limit.
//
// Design: the TPU kernel's idea, the batch on the fastest axis, moved to
// shared memory.  One block of 256 threads owns a tile of LB matrices
// (lanes, LB = 1..32, chosen by the wrapper) and holds their upper
// triangles packed row by row, lanes last: element e of lane l at
// S[e * LB + e / (32 / LB) + l], one pad word per 32 floats, so that a
// warp touching 32 / LB elements of all LB lanes and a warp touching 32
// elements of one lane are both free of bank conflicts.  Packed row j is
// the working row j of the symmetric matrix until step j makes it column
// j of L, and phase 2 turns packed column i into row i of X = L^{-1}, so
// packed row c ends as row c of Rinv.  The trailing diagonal sits in a
// separate n-vector during phase 1.
//   The block copies its lanes' rows of H from (B, n, n) with cp.async,
//   a warp along a row, all in flight at once.  Phase 1 has one barrier
//   per step: a warp takes a trailing row at a time, 32 / LB columns by
//   LB lanes per pass (32 consecutive words), so an element costs two
//   loads, one multiply-add and one store; the warp on row j + 1 computes
//   that row's new diagonal and pivot and stores the row as column j + 1
//   of L, scaled.  Phase 2 writes row i of X to one of two row buffers,
//   because it overwrites the L[i][.] that the rest of the row still
//   reads; the previous row's buffer is copied into place in the same
//   pass, one barrier per row.  The block writes Rinv (B, n, n), zeros
//   below the diagonal included: no permuting copy on either side.  The
//   wrapper picks LB: more blocks per SM beat more lanes per block (a
//   block is latency-bound between its barriers).  No fast-math: division
//   and sqrt are IEEE.
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the packed row r of the upper triangle starts at off(r)
__device__ __forceinline__ int off(int r, int n) {
  return r * n - (r * (r - 1)) / 2;
}

template <int LB>
struct Lanes {
  static constexpr int kLogG = LB == 32 ? 0 : LB == 16 ? 1 : LB == 8 ? 2
                               : LB == 4 ? 3 : LB == 2 ? 4 : 5;
  static constexpr int kSlots = kThreads / LB;     // elements per pass
  static constexpr int kStride = 33;                // at(p + 32 / LB) - at(p)
  // shared-memory word of packed element p, lane l
  __device__ __forceinline__ static int at(int p, int l) {
    return p * LB + (p >> kLogG) + l;
  }
  // floats per block: n (n + 1) / 2 elements, two n-vectors (the
  // trailing diagonal in phase 1, the two row buffers in phase 2)
  static size_t floats(int n) {
    const size_t e = static_cast<size_t>(n) * (n + 1) / 2 + 2 * n;
    return e * LB + ((e - 1) >> kLogG);
  }
};

template <int LB>
__global__ void __launch_bounds__(kThreads)
chol_lanes_kernel(const float* __restrict__ H, float* __restrict__ out,
                  int B, int n, float tiny) {
  extern __shared__ float S[];
  using Ln = Lanes<LB>;
  constexpr int kSlots = Ln::kSlots, kStride = Ln::kStride;
  constexpr int kG = 32 / LB;                 // elements a warp covers
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int l = t % LB, slot = t / LB, g = lane / LB;
  const int b0 = blockIdx.x * LB;
  const int T = n * (n + 1) / 2;              // packed elements
  const int D = T;                            // the diagonal / buffer 0

  // ---- load: packed row r of lane ll from H[b][r][r..n-1] and the
  // diagonal to D, by cp.async (all loads in flight at once); then row 0
  // is scaled by step 0's pivot
  for (int task = warp; task < LB * n; task += kThreads / 32) {
    const int ll = task / n, r = task - ll * n;
    if (b0 + ll >= B) continue;
    const float* h = H + (static_cast<size_t>(b0 + ll) * n + r) * n;
    const int base = off(r, n) - r;
    for (int c = r + lane; c < n; c += 32) {
      if (c == r) cp_async4(S + Ln::at(D + r, ll), h + c);
      if (c != r || r == 0) cp_async4(S + Ln::at(base + c, ll), h + c);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  {
    const float d = S[Ln::at(D, l)];
    const float piv = sqrtf(d < tiny ? tiny : d);     // a NaN stays NaN
    for (int c = slot; c < n; c += kSlots)
      S[Ln::at(c, l)] = S[Ln::at(c, l)] / piv;        // (0, 0): d / piv
  }
  __syncthreads();

  // ---- phase 1: step j applies column j of L (packed row j) to rows
  // j+1..n-1 and finishes row j+1 as column j+1 of L.  A warp takes a
  // row at a time, kG columns by LB lanes per pass (32 consecutive words),
  // so an element costs two loads, a multiply-add and a store.
  for (int j = 0; j + 1 < n; ++j) {
    const int oj = off(j, n) - j;             // (j, c) is at oj + c
    for (int r = j + 1 + warp; r < n; r += kWarps) {
      const float lr = S[Ln::at(oj + r, l)];                  // L[r][j]
      const int pd = Ln::at(D + r, l);
      int pa = Ln::at(off(r, n) + g, l);                      // (r, r + g)
      int pc = Ln::at(oj + r + g, l);                         // (j, r + g)
      if (r == j + 1) {
        // column j+1 of L: (j+1, j+1) is d1 / piv, with d1 the diagonal
        // after this step's update
        const float d1 = fmaf(-lr, lr, S[pd]);
        const float piv = sqrtf(d1 < tiny ? tiny : d1);   // a NaN stays NaN
        for (int c = r + g; c < n; c += kG, pa += kStride, pc += kStride)
          S[pa] = fmaf(-lr, S[pc], S[c == r ? pd : pa]) / piv;
      } else {
        for (int c = r + g; c < n; c += kG, pa += kStride, pc += kStride) {
          const int e = c == r ? pd : pa;
          S[e] = fmaf(-lr, S[pc], S[e]);
        }
      }
    }
    __syncthreads();
  }

  // ---- phase 2: X = L^{-1} row by row; row i goes to buffer i & 1, the
  // previous row's buffer to packed column i - 1 (X[i-1][c] at (c, i-1))
  for (int i = 0; i < n; ++i) {
    const int cur = D + n * (i & 1), prev = D + n * ((i & 1) ^ 1);
    const float lii = S[Ln::at(off(i, n), l)];
    for (int c = slot; c <= i; c += kSlots) {
      float x;
      if (c == i) {
        x = 1.0f / lii;
      } else {
        float acc = 0.0f;
        int pl = off(c, n) + i - c;            // (k, i): L[i][k], k = c
        int px = off(c, n);                    // (c, k): X[k][c], k = c
#pragma unroll 4
        for (int k = c; k < i - 1; ++k) {
          acc = fmaf(S[Ln::at(pl, l)], S[Ln::at(px, l)], acc);
          pl += n - k - 1;
          ++px;
        }
        acc = fmaf(S[Ln::at(pl, l)], S[Ln::at(prev + c, l)], acc);
        x = (0.0f - acc) / lii;
      }
      S[Ln::at(cur + c, l)] = x;
    }
    for (int c = slot; c < i; c += kSlots)
      S[Ln::at(off(c, n) + i - 1 - c, l)] = S[Ln::at(prev + c, l)];
    __syncthreads();
  }
  const int last = D + n * ((n - 1) & 1);
  for (int c = slot; c < n; c += kSlots)
    S[Ln::at(off(c, n) + n - 1 - c, l)] = S[Ln::at(last + c, l)];
  __syncthreads();

  // ---- store: Rinv[b][c][i] = X[i][c] = packed (c, i), zero for i < c
  for (int task = warp; task < LB * n; task += kThreads / 32) {
    const int ll = task / n, c = task - ll * n;
    if (b0 + ll >= B) continue;
    float* o = out + (static_cast<size_t>(b0 + ll) * n + c) * n;
    const int base = off(c, n) - c;
    for (int i = lane; i < n; i += 32)
      o[i] = i >= c ? S[Ln::at(base + i, ll)] : 0.0f;
  }
}

template <int LB>
int launch(const float* H, float* out, int B, int n, float tiny,
           cudaStream_t stream) {
  const size_t smem = Lanes<LB>::floats(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_lanes_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  const int grid = (B + LB - 1) / LB;
  chol_lanes_kernel<LB><<<grid, kThreads, smem, stream>>>(H, out, B, n, tiny);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// H (B, n, n) in; Rinv (B, n, n) out; `lanes` matrices per block (1, 2,
// 4, 8, 16 or 32).  Shared memory per block: Lanes<lanes>::floats(n).
extern "C" int chol_lanes_f32(const float* H, float* out, int B, int n,
                              int lanes, float tiny, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 32: return launch<32>(H, out, B, n, tiny, s);
    case 16: return launch<16>(H, out, B, n, tiny, s);
    case 8: return launch<8>(H, out, B, n, tiny, s);
    case 4: return launch<4>(H, out, B, n, tiny, s);
    case 2: return launch<2>(H, out, B, n, tiny, s);
    case 1: return launch<1>(H, out, B, n, tiny, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
