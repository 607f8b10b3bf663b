// B10: batched Cholesky + triangular inverse, panel-blocked, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/chol.py:644 batched_chol_rinv_blk
// (kernel body _tile_chol_kernel_blk, chol.py:319), the panel-8 variant.
// Per SPD (n, n) matrix H it computes K1's function, Rinv = X' with
// X = L^{-1}, H = L L' and pivots clamped to `tiny` (L[j][j] = piv), in
// that kernel's per-element order, which no panel width changes:
//   an element of the trailing lower triangle takes its rank-1
//   subtractions L[r][t] L[c][t] one at a time, t ascending; column j is
//   then divided by piv = sqrt(max(d, tiny));
//   X[i][c] = -(1 / L[i][i]) (sum_{k<i} L[i][k] X[k][c]), one chain with
//   k ascending (the terms with k < c are exact zeros), X[i][i] = 1 / L[i][i].
// Each output keeps one accumulator that takes its terms in that order,
// so any panel width reproduces the twin up to the multiply-adds the
// kernel fuses.  No sum is split over threads.
//
// What bounds it on an H100: at B = 256 the 2 n^3 / 3 operations per
// matrix, 0.0688 ms at n = 300 and 0.318 ms at n = 500; at B = 1024 the
// bytes, 2 n^2 floats per matrix, 0.0245 / 0.0978 ms at n = 100 / 200,
// and at B = 10240, n = 50 0.0611 ms.  One block per matrix: B = 256 is
// 1.94 blocks per SM, so at n >= 300 the multiply-adds must run near the
// f32 rate (register tiles, 16-byte shared reads), while at n <= 200 the
// chain of n dependent column steps and the trips to device memory set
// the time and the blocks an SM holds hide them.
//
// Design: one block per matrix, 64 threads up to n = 64, 128 up to 256
// and 256 above (more blocks per SM where the steps are short, more
// threads per block where the products are long); the matrix stays in
// device memory, the output buffer is the working matrix (H is read where
// an element is first touched).  Phase 1, per panel of kNB = 32 columns
// (64 needed 185-255 registers and twice the shared memory, and was
// slower at every width): the panel's rows j0..n-1 are copied to shared
// memory with cp.async in 16-byte pieces (4-byte where n % 4 != 0).  Its
// kNB x kNB diagonal block is factored with one barrier per column:
// column s takes its last update (from column s - 1) and its scale in the
// same pass in which the later columns take theirs, the pass's elements
// split evenly over the threads, and a thread that scales an element
// recomputes the pivot from the diagonal it reads.  Each row below the
// block is then one thread's forward solve in registers against the block
// (its own chain of kNB steps, no barrier).  The trailing lower triangle
// takes its rank-kNB update as a register-tiled SYRK: a 4 x 4 micro-tile
// per thread read once from device memory, kNB multiply-adds per element
// from the panel in shared memory (16-byte reads), written once; the next
// tile's elements are loaded into registers while this one computes (no
// barrier between tiles, where a cp.async ring would need two).  Each
// element is read and written once per kNB columns, not once per 8.
// Phase 2, per kNB rows i0..: one thread per column c holds the kNB sums
// of its column in registers; the finished rows of X stream through
// shared memory in 16-deep k-tiles (cp.async, two stages) with the L
// rows' k-tile transposed beside them, so a thread reads four L values
// per 16-byte broadcast, and a warp whose columns lie right of a k-tile
// skips it; then the same thread solves the kNB x kNB diagonal block down
// its column, row by row, in registers.  X[i][c] is written transposed,
// to (c, i), and each block of L rows is zeroed below the diagonal once
// read, so the buffer ends as Rinv: no transposing copy.  No fast-math:
// division and sqrt are IEEE.
#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kNB = 32;            // panel width
constexpr int kN64 = 64;           // up to this n 64 threads a block,
constexpr int kN128 = 256;         // up to this one 128, then 256
constexpr int kTC = 64;            // SYRK tile columns
constexpr int kKT = 16;            // phase 2 k-tile depth
constexpr int kXLd = kKT + 4;      // row stride of the X k-tile

template <int NT>
struct Blk {
  static constexpr int kLdp = kNB + 4;        // panel / block row stride
  static constexpr int kStage = NT * kXLd + kKT * kLdp;
  // phase 1: the panel (n rows), kNB pivots, the diagonal block's L
  // transposed; phase 2: the diagonal block, kNB inverse pivots and, where
  // a second block of rows exists, two stages of (X k-tile, L k-tile)
  static size_t floats(int n) {
    const size_t p1 = static_cast<size_t>(n) * kLdp + kNB + kNB * kLdp;
    const size_t p2 = kNB * kLdp + kNB + (n > kNB ? 2 * kStage : 0);
    return p1 > p2 ? p1 : p2;
  }
};

template <int NT>
__global__ void __launch_bounds__(NT)
chol_blk_kernel(const float* __restrict__ H, float* __restrict__ X, int n,
                float tiny, int vec) {
  extern __shared__ __align__(16) float sm[];
  using Bk = Blk<NT>;
  constexpr int kLdp = Bk::kLdp, kThreads = NT;
  constexpr int kRowT = NT / 16;     // SYRK: kRowT x 16 threads, 4 x 4 each
  constexpr int kTR = 4 * kRowT;     // SYRK tile rows
  const int t = threadIdx.x;
  const size_t moff = static_cast<size_t>(blockIdx.x) * n * n;
  const float* h = H + moff;
  float* A = X + moff;

  // ================= phase 1: blocked right-looking Cholesky
  float* Pn = sm;                                 // row r - j0 of the panel
  float* PV = sm + static_cast<size_t>(n) * kLdp; // pivots of the panel
  float* LdT = PV + kNB;                          // LdT[s][u] = L[j0+u][j0+s]
  // this thread's elements of a diagonal block's step, q = t + k kThreads
  // in the row-major lower triangle: local row and column, packed r << 8 | u
  constexpr int kPer = (kNB * (kNB + 1) / 2 + kThreads - 1) / kThreads;
  int rc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = t + k * kThreads;
    int r = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
    if ((r + 1) * (r + 2) / 2 <= q) ++r;
    if (r * (r + 1) / 2 > q) --r;
    rc[k] = r << 8 | (q - r * (r + 1) / 2);
  }
  for (int j0 = 0; j0 < n; j0 += kNB) {
    const int w = min(kNB, n - j0), j1 = j0 + w, rows = n - j0;
    const float* src = j0 == 0 ? h : A;           // first touch reads H
    if (vec) {
      for (int idx = t; idx < rows * (kNB / 4); idx += kThreads) {
        const int r = idx / (kNB / 4), c4 = 4 * (idx % (kNB / 4));
        if (c4 < w)
          cp_async16(Pn + r * kLdp + c4,
                     src + static_cast<size_t>(j0 + r) * n + j0 + c4);
      }
    } else {
      for (int idx = t; idx < rows * kNB; idx += kThreads) {
        const int r = idx / kNB, c = idx % kNB;
        if (c < w)
          cp_async4(Pn + r * kLdp + c,
                    src + static_cast<size_t>(j0 + r) * n + j0 + c);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // the diagonal block, one barrier per column: at step s column s
    // takes the update from column s - 1 and its scale, columns u > s the
    // update from column s - 1 (the diagonal element stays in place until
    // the write-back; its pivot goes to PV).  The step's elements, the
    // lower triangle of rows and columns s..w-1, are split evenly over the
    // threads by their fixed local coordinates (rc); every load comes
    // before any store, and only a thread with an element of column s
    // computes the pivot.
    for (int s = 0; s < w; ++s) {
      const int m = w - s, tri = m * (m + 1) / 2;
      float a[kPer], x[kPer], y[kPer];
      bool need = false;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int r = s + (rc[k] >> 8), u = s + (rc[k] & 255);
        const bool ok = t + k * kThreads < tri;
        a[k] = ok ? Pn[r * kLdp + u] : 0.0f;
        x[k] = ok && s > 0 ? Pn[r * kLdp + s - 1] : 0.0f;   // L[r][s-1]
        y[k] = ok && s > 0 ? Pn[u * kLdp + s - 1] : 0.0f;   // L[u][s-1]
        need = need || (ok && u == s);
      }
      float piv = 0.0f;
      if (need) {
        float d = Pn[s * kLdp + s];
        if (s > 0) {
          const float ls = Pn[s * kLdp + s - 1];
          d = fmaf(-ls, ls, d);
        }
        piv = sqrtf(d < tiny ? tiny : d);               // a NaN stays NaN
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int r = s + (rc[k] >> 8), u = s + (rc[k] & 255);
        if (t + k * kThreads >= tri || (s == 0 && u > s)) continue;
        if (r == s) {                                    // the diagonal
          PV[s] = piv;
          continue;
        }
        float v = s > 0 ? fmaf(-x[k], y[k], a[k]) : a[k];
        if (u == s) {
          v = v / piv;
          LdT[s * kLdp + r] = v;
        }
        Pn[r * kLdp + u] = v;
      }
      __syncthreads();
    }

    if (j1 < n) {
      // each row below the block: its own forward solve against the block
      for (int r = kNB + t; r < rows; r += kThreads) {
        float a[kNB];
        float4* pr = reinterpret_cast<float4*>(Pn + r * kLdp);
#pragma unroll
        for (int q = 0; q < kNB / 4; ++q) {
          const float4 v = pr[q];
          a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z;
          a[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int s = 0; s < kNB; ++s) {
          a[s] = a[s] / PV[s];
          const float4* ld = reinterpret_cast<const float4*>(LdT + s * kLdp);
#pragma unroll
          for (int q = (s + 1) / 4; q < kNB / 4; ++q) {
            const float4 v = ld[q];
            if (4 * q > s) a[4 * q] = fmaf(-a[s], v.x, a[4 * q]);
            if (4 * q + 1 > s) a[4 * q + 1] = fmaf(-a[s], v.y, a[4 * q + 1]);
            if (4 * q + 2 > s) a[4 * q + 2] = fmaf(-a[s], v.z, a[4 * q + 2]);
            a[4 * q + 3] = fmaf(-a[s], v.w, a[4 * q + 3]);
          }
        }
#pragma unroll
        for (int q = 0; q < kNB / 4; ++q)
          pr[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2],
                              a[4 * q + 3]);
      }
      __syncthreads();
    }

    // write the panel's L back (lower part, the pivot on the diagonal)
    for (int idx = t; idx < rows * kNB; idx += kThreads) {
      const int r = idx / kNB, c = idx % kNB;
      if (c < w && r >= c)
        A[static_cast<size_t>(j0 + r) * n + j0 + c] =
            r == c ? PV[c] : Pn[r * kLdp + c];
    }

    if (j1 < n) {
      // rank-kNB SYRK of the trailing lower triangle in kTR x kTC tiles
      const int m = rows - kNB;
      const int ntr = (m + kTR - 1) / kTR, ntc = (m + kTC - 1) / kTC;
      auto last_bj = [&](int bi) { return min(ntc - 1, (bi * kTR + kTR - 1) / kTC); };
      const int ty = t / 16, tx = t % 16;
      float cur[4][4], nxt[4][4];
      auto load = [&](int bi, int bj, float (&v)[4][4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = j1 + bi * kTR + ty + kRowT * i;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = j1 + bj * kTC + tx + 16 * jj;
            v[i][jj] = r < n && c <= r ? src[static_cast<size_t>(r) * n + c]
                                       : 0.0f;
          }
        }
      };
      int bi = 0, bj = 0;
      load(0, 0, cur);
      while (bi < ntr) {
        int ni = bi, nj = bj + 1;
        if (nj > last_bj(ni)) { ++ni; nj = 0; }
        if (ni < ntr) load(ni, nj, nxt);
        const int r0 = kNB + bi * kTR + ty, c0 = kNB + bj * kTC + tx;
        int orow[4], ocol[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          orow[i] = min(r0 + kRowT * i, rows - 1) * kLdp;
          ocol[i] = min(c0 + 16 * i, rows - 1) * kLdp;
        }
#pragma unroll 2
        for (int q = 0; q < kNB / 4; ++q) {
          float4 vr[4], vc[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            vr[i] = *reinterpret_cast<const float4*>(Pn + orow[i] + 4 * q);
            vc[i] = *reinterpret_cast<const float4*>(Pn + ocol[i] + 4 * q);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float a = cur[i][jj];
              a = fmaf(-vr[i].x, vc[jj].x, a);
              a = fmaf(-vr[i].y, vc[jj].y, a);
              a = fmaf(-vr[i].z, vc[jj].z, a);
              a = fmaf(-vr[i].w, vc[jj].w, a);
              cur[i][jj] = a;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = j1 + bi * kTR + ty + kRowT * i;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = j1 + bj * kTC + tx + 16 * jj;
            if (r < n && c <= r) A[static_cast<size_t>(r) * n + c] = cur[i][jj];
            cur[i][jj] = nxt[i][jj];
          }
        }
        bi = ni;
        bj = nj;
      }
    }
    __syncthreads();
  }

  // ================= phase 2: X = L^{-1}, kNB rows at a time
  float* Ld = sm;                                 // Ld[s][u] = L[i0+s][i0+u]
  float* INV = sm + kNB * kLdp;
  float* stage = INV + kNB;
  for (int i0 = 0; i0 < n; i0 += kNB) {
    const int w = min(kNB, n - i0), iend = i0 + w;
    for (int idx = t; idx < w * kNB; idx += kThreads) {
      const int s = idx / kNB, u = idx % kNB;
      if (u <= s) Ld[s * kLdp + u] = A[static_cast<size_t>(i0 + s) * n + i0 + u];
    }
    if (t < w) INV[t] = 1.0f / A[static_cast<size_t>(i0 + t) * n + i0 + t];
    __syncthreads();

    for (int c0 = 0; c0 < iend; c0 += kThreads) {
      const int c = c0 + t;
      float acc[kNB];
#pragma unroll
      for (int s = 0; s < kNB; ++s) acc[s] = 0.0f;
      if (c0 < i0) {
        // off-block sums over the finished rows k = c0..i0-1
        const int nk = (i0 - c0) / kKT, crows = min(kThreads, i0 - c0);
        constexpr int kL = kNB * kKT / kThreads;   // L k-tile values a thread
        float lreg[kL];
        auto issue = [&](int kt, int buf) {
          float* XT = stage + buf * Bk::kStage;
          const float* g = A + static_cast<size_t>(c0) * n + c0 + kt * kKT;
          if (vec) {
            for (int idx = t; idx < crows * (kKT / 4); idx += kThreads) {
              const int cc = idx / (kKT / 4), k4 = 4 * (idx % (kKT / 4));
              cp_async16(XT + cc * kXLd + k4, g + static_cast<size_t>(cc) * n + k4);
            }
          } else {
            for (int idx = t; idx < crows * kKT; idx += kThreads) {
              const int cc = idx / kKT, kk = idx % kKT;
              cp_async4(XT + cc * kXLd + kk, g + static_cast<size_t>(cc) * n + kk);
            }
          }
          cp_async_commit();
        };
        auto lload = [&](int kt) {
          const int k0 = c0 + kt * kKT;
#pragma unroll
          for (int e = 0; e < kL; ++e) {
            const int idx = t + e * kThreads, s = idx / kKT, kk = idx % kKT;
            lreg[e] = s < w ? A[static_cast<size_t>(i0 + s) * n + k0 + kk]
                            : 0.0f;
          }
        };
        auto lstore = [&](int buf) {
          float* LT = stage + buf * Bk::kStage + kThreads * kXLd;
#pragma unroll
          for (int e = 0; e < kL; ++e) {
            const int idx = t + e * kThreads, s = idx / kKT, kk = idx % kKT;
            LT[kk * kLdp + s] = lreg[e];
          }
        };
        issue(0, 0);
        lload(0);
        for (int kt = 0; kt < nk; ++kt) {
          const int buf = kt & 1;
          lstore(buf);
          if (kt + 1 < nk) {
            issue(kt + 1, buf ^ 1);
            lload(kt + 1);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const float* XT = stage + buf * Bk::kStage;
          const float* LT = XT + kThreads * kXLd;
          const int k0 = c0 + kt * kKT;
          // a warp whose columns all lie right of the tile, or at or past
          // i0, has only zero terms here
          const int cw = c0 + (t & ~31);
#pragma unroll
          for (int q = 0; q < kKT / 4; ++q) {
            if (cw >= i0 || k0 + kKT <= cw) break;
            const float4 xv = *reinterpret_cast<const float4*>(XT + t * kXLd + 4 * q);
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = k0 + 4 * q + e;
              const float x = c < i0 && k >= c ? xs[e] : 0.0f;
              const float4* lt = reinterpret_cast<const float4*>(
                  LT + (4 * q + e) * kLdp);
#pragma unroll
              for (int s4 = 0; s4 < kNB / 4; ++s4) {
                const float4 lv = lt[s4];
                acc[4 * s4] = fmaf(lv.x, x, acc[4 * s4]);
                acc[4 * s4 + 1] = fmaf(lv.y, x, acc[4 * s4 + 1]);
                acc[4 * s4 + 2] = fmaf(lv.z, x, acc[4 * s4 + 2]);
                acc[4 * s4 + 3] = fmaf(lv.w, x, acc[4 * s4 + 3]);
              }
            }
          }
          __syncthreads();
        }
      }
      if (c < iend) {
        // the diagonal block down column c; acc[s] becomes X[i0+s][c]
#pragma unroll
        for (int s = 0; s < kNB; ++s) {
          if (s < w) {
            const int i = i0 + s;
            float r = acc[s];
            const float4* ld = reinterpret_cast<const float4*>(Ld + s * kLdp);
#pragma unroll
            for (int q = 0; q < (s + 3) / 4; ++q) {
              const float4 v = ld[q];
              r = fmaf(v.x, acc[4 * q], r);
              if (4 * q + 1 < s) r = fmaf(v.y, acc[4 * q + 1], r);
              if (4 * q + 2 < s) r = fmaf(v.z, acc[4 * q + 2], r);
              if (4 * q + 3 < s) r = fmaf(v.w, acc[4 * q + 3], r);
            }
            acc[s] = c == i ? INV[s] : (c > i ? 0.0f : -INV[s] * r);
          }
        }
        float* o = A + static_cast<size_t>(c) * n + i0;   // (c, i0..)
        if (vec) {
#pragma unroll
          for (int q = 0; q < kNB / 4; ++q)
            if (4 * q < w)
              reinterpret_cast<float4*>(o)[q] = make_float4(
                  acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
        } else {
#pragma unroll
          for (int s = 0; s < kNB; ++s)
            if (s < w) o[s] = acc[s];
        }
      }
    }
    __syncthreads();
    // the block's L rows are read: zero them left of the block
    for (int s = 0; s < w; ++s)
      for (int k = t; k < i0; k += kThreads)
        A[static_cast<size_t>(i0 + s) * n + k] = 0.0f;
  }
}

template <int NT>
int launch(const float* H, float* X, int B, int n, float tiny,
           cudaStream_t stream) {
  const size_t smem = Blk<NT>::floats(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_blk_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(H) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(X) % 16 == 0;
  chol_blk_kernel<NT><<<B, NT, smem, stream>>>(H, X, n, tiny, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_threads(const float* H, float* X, int B, int n, float tiny,
                   cudaStream_t stream) {
  return n <= kN64 ? launch<64>(H, X, B, n, tiny, stream)
         : n <= kN128 ? launch<128>(H, X, B, n, tiny, stream)
                      : launch<256>(H, X, B, n, tiny, stream);
}

}  // namespace

// H (B, n, n) in; Rinv (B, n, n) out, the working matrix; 64, 128 or 256
// threads a block by n (launch_threads).  Shared memory per block:
// Blk<threads>::floats(n).
extern "C" int chol_blk_f32(const float* H, float* X, int B, int n,
                            float tiny, void* stream) {
  return launch_threads(H, X, B, n, tiny, static_cast<cudaStream_t>(stream));
}
