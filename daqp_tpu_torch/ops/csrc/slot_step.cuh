// The slot-space dual active-set step on a block of 128 threads, run by
// K2 (slot_round.cu), B3 (mpc_segment.cu) and B4 (prox_segment.cu) at
// every shape and by B5 (avi_segment.cu) and B6 (lp_segment.cu) where
// their warp bodies do not run; dense_round.cu (B7) takes its helpers.
// It is written once over a StepCfg: each kernel but B3's horizon body
// runs it at the run-time shape as it stood before StepCfg (the same
// SASS); B3's horizon body (K, n <= 64, m <= 128) runs it with its loops
// bounded at compile time and its E update reading before it writes.
// B5 and B6 at K, n <= 32 run the warp step of slot_warp.cuh, which
// computes this step with the same bits: it keeps every sum below in the
// same tree (an item's chains j = q mod 8, or j = hq mod 16 then
// slot_pair8, slot_tsum8; each warp's partial butterflied, then combined
// as slot_reduce and block_reduce do), since K2 replays their inner
// solves and must end on the same slot state (chip_smoke.py k5 (a), k6
// (a)).  A change to a sum here is a change there.
//
// It is the step of daqp_tpu/ops/pallas_slot.py:256-612 (_solve_tile_live,
// :188, which the TPU kernels _kernel_body, _mpc_kernel_body,
// _prox_kernel_body, _avi_kernel_body and _lp_kernel_body all call): the
// blocking min-ratio search, u = -W'(lam* o used) and mu = M u, Dantzig
// (or Bland) pricing, the pending retry or priced add, the deletion with
// its pivot guard (-> kRefactor), the relative singularity gate and the
// n_true cap (-> pending), the W/E rank-one updates and the next
// lam* = -E (dsl o used), a_p = E (W prow o used).  The multi_add >= 2 and
// ablate variants of the TPU kernel are not carried over.
//
// One thread block of kThreads = 128 runs one QP.  E (K x K), W (K x n)
// and M (m x n) of the lane live in dynamic shared memory with odd row
// strides, the (m,), (K,) and (n,) vectors beside them (slot_carve gives
// the layout); the lane's scalars live in registers, computed identically
// by every thread from block-wide reductions.  Every argmin returns the
// LOWEST index on ties (and the first NaN), as jnp.argmin does: the
// blocking slot, the priced row (Bland's rule rests on it) and the free
// slot all depend on that.  No fast-math: the ratio test depends on
// isfinite and IEEE division.
//
// What bounds it on an H100: latency.  A step is a chain of dependent
// phases on ~48 KB of shared state (n = 50, m = 100, K = 51): ~30 kFLOP
// at k = 40 used slots, a small share of the time the chain takes.  The
// probe (chip_profile.py --probe k2, k5, k6) measured 13.1k SM cycles a
// step at config 2 and still 11.2-11.3k at configAVI (K = 21) and
// configLP (K = 11): the barriers and reductions set a floor that does
// not shrink with the shape, hence B5's and B6's warp step there.  The
// design shortens each phase's chains and its barriers:
// - Every matrix-vector product runs on groups of kSG = 8 lanes, each
//   group 8 output items at once: lane q sums the inputs j = q (mod 8)
//   in independent chains, and a transposing butterfly (7 shuffles, one
//   fixed order) leaves one thread with the full sum of each item, which
//   it then owns: the per-item epilogue (ratio test, pricing, the slot
//   and pending bookkeeping) runs once, in that thread.  The products
//   whose items are the used slots (the Gram column g_k, the Schur
//   vector a, and lam*, a_p with the E update; k ~ 40 items) give each
//   8 items to a pair of groups, each summing half the inputs (j = 8 h +
//   q mod 16), so the chains halve.  Rows 8 apart at an odd stride fall
//   in different banks.
// - E is zero off used x used and W zero on unused rows (every producer
//   of the state keeps it so: tests/test_torch_slot_invariant.py; this
//   step, chip_smoke's k2), so the E and W walks and the E update run over
//   a list of the used slots, k of K.  Every warp counts the used slots
//   with ballots before it prices; the last warp also writes them.  The
//   list keeps slot order, so no argmin's tie rule moves; lam* and a_p
//   are 0 off it.  A removed slot stays on the update's list (its row and
//   column go to 0) and an added one is appended.
// - The W update touches two rows (the removed one to 0, the free one to
//   the added row).  The E update (2-D: 8 rows to a pair of groups,
//   columns by lane, no division) runs beside the add's bookkeeping,
//   taking the added slot's values from registers, and computes the next
//   step's lam* = -E (dsl o used) from the fresh values (a_p = E g_p, in
//   a pass of its own, only while an entry is pending).
// - Five barriers per step: after u, one in each of the three block
//   reductions (double-buffered scratch, the warps' partials combined by
//   a butterfly: no trailing barrier; the Gram column's owners sum e.g_k
//   and max|e| into the second, the Schur vector's owners g_k.a_post
//   into the third, beside the removal), and after the E update.  A step
//   that leaves an entry pending adds one, for a_p = E g_p on the new E.
#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;          // DAQP_INF
constexpr int kRunning = 99;
constexpr int kOptimal = 1;
constexpr int kInfeasible = -1;
constexpr int kCycle = -2;
constexpr int kRefactor = 90;
constexpr int kRedStride = 6;          // reduction words per warp
constexpr int kSG = 8;                 // items per group of lanes

struct Tol {
  float dtol, ptol, pivtol, singtol, progtol, cyctol;
  int bland;
};

// The lane's scalar state, one copy per thread, identical in all threads.
struct Ctl {
  float pd, plm, plo, pid, pdd, fv, bf, cy, rp, it;
  int stt;
  float fb;
};

// Shared-memory views of one lane's state.
struct Lane {
  float *E, *W, *M, *du, *dl, *sc, *im, *au, *al, *lo_okv;
  float *dsl, *used, *sid, *slo, *simm, *lam, *ls, *lstar, *a_p, *delta;
  float *g_k, *e, *a, *w, *g_p, *prow, *u, *u_new, *add_row, *red, *end;
  int* list;                   // the used slots, in slot order
  int ldK, ldn;
};

// The step's settings, fixed at compile time.  MaxK, MaxN, MaxM: 0 runs
// every loop to the run-time shape (K2, B4 and the 128-thread bodies of
// B3, B5 and B6); else the slots, columns and rows the shape stays within
// (B3's horizon body), so that each loop over them is one pass of turns
// known at compile time, each turn taken where it falls in the shape, and
// the list walks unroll.  LoadsFirst: the E update, the add's bookkeeping,
// the W update and the act rows read their values before they store (a
// store to shared memory holds back every later load: the compiler cannot
// tell the arrays apart).  Neither changes a sum's order.  The step is
// written for two settings: the run-time shape storing first (ShapeStep),
// and ceilings with loads-first (B3's HorizonStep).
template <int MaxK, int MaxN, int MaxM, bool LoadsFirst>
struct StepCfg {
  static constexpr int kK = MaxK, kN = MaxN, kM = MaxM;
  static constexpr bool kFixed = MaxK > 0;
  static constexpr bool kLoadsFirst = LoadsFirst;
  static_assert(kFixed == kLoadsFirst, "loads-first only under ceilings");
  // one pass: the slots fit the pairs of groups (64 items), the columns
  // and rows the block's threads
  static_assert(!kFixed || (MaxK <= 64 && MaxN > 0 && MaxN <= 128 &&
                            MaxM > 0 && MaxM <= 128), "ceilings");
};
using ShapeStep = StepCfg<0, 0, 0, false>;

// Mirrored by ops/smem.py slot_floats.
__host__ __device__ inline size_t slot_smem_floats(int m, int n, int K) {
  const int ldK = K | 1, ldn = n | 1;
  return static_cast<size_t>(K) * ldK + static_cast<size_t>(K) * ldn +
         static_cast<size_t>(m) * ldn + 7 * m + 16 * K + 4 * n +
         2 * kWarps * kRedStride;
}

__device__ __forceinline__ Lane slot_carve(float* sm, int m, int n, int K) {
  Lane L;
  L.ldK = K | 1;
  L.ldn = n | 1;
  L.E = sm;
  L.W = L.E + K * L.ldK;
  L.M = L.W + K * L.ldn;
  L.du = L.M + m * L.ldn;
  L.dl = L.du + m;
  L.sc = L.dl + m;
  L.im = L.sc + m;
  L.au = L.im + m;
  L.al = L.au + m;
  L.lo_okv = L.al + m;
  L.dsl = L.lo_okv + m;
  L.used = L.dsl + K;
  L.sid = L.used + K;
  L.slo = L.sid + K;
  L.simm = L.slo + K;
  L.lam = L.simm + K;
  L.ls = L.lam + K;
  L.lstar = L.ls + K;
  L.a_p = L.lstar + K;
  L.delta = L.a_p + K;
  L.g_k = L.delta + K;
  L.e = L.g_k + K;
  L.a = L.e + K;               // a_pre, then a_post
  L.w = L.a + K;
  L.g_p = L.w + K;
  L.prow = L.g_p + K;
  L.u = L.prow + n;
  L.u_new = L.u + n;
  L.add_row = L.u_new + n;
  L.red = L.add_row + n;       // block_reduce's words, then the second half
  L.list = reinterpret_cast<int*>(L.red + 2 * kWarps * kRedStride);
  L.end = L.red + 2 * kWarps * kRedStride + K;
  return L;
}

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || ai < bi);
  return av < bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Block-wide reduction: NS sums, one max and one lowest-index argmin.
// Every thread returns the same values (same combination order).  Two
// barriers; uses the first kWarps * kRedStride words of `red`.
template <int NS>
__device__ void block_reduce(float (&s)[NS], float& mx, float& av, int& ai,
                             float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    for (int q = 0; q < NS; ++q) s[q] += __shfl_xor_sync(kFull, s[q], o);
    mx = max_nan(mx, __shfl_xor_sync(kFull, mx, o));
    const float ov = __shfl_xor_sync(kFull, av, o);
    const int oi = __shfl_xor_sync(kFull, ai, o);
    if (better(ov, oi, av, ai)) { av = ov; ai = oi; }
  }
  float* r = red + wid * kRedStride;
  if (lane == 0) {
    for (int q = 0; q < NS; ++q) r[q] = s[q];
    r[3] = mx;
    r[4] = av;
    r[5] = __int_as_float(ai);
  }
  __syncthreads();
  for (int q = 0; q < NS; ++q) s[q] = red[q];
  mx = red[3];
  av = red[4];
  ai = __float_as_int(red[5]);
  for (int w = 1; w < kWarps; ++w) {
    const float* rw = red + w * kRedStride;
    for (int q = 0; q < NS; ++q) s[q] += rw[q];
    mx = max_nan(mx, rw[3]);
    const int wi = __float_as_int(rw[5]);
    if (better(rw[4], wi, av, ai)) { av = rw[4]; ai = wi; }
  }
  __syncthreads();
}

// Block-wide NaN-propagating max; every thread returns the same value.
__device__ __forceinline__ float block_max(float mx, float* red) {
  float s[1] = {0.f};
  float av = INFINITY;
  int ai = INT_MAX;
  block_reduce<1>(s, mx, av, ai, red);
  return mx;
}

__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void copy_rows_in(float* dst, int ld,
                                             const float* src, int rows,
                                             int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[(i / cols) * ld + i % cols] = src[i];
}

__device__ __forceinline__ void copy_rows_out(float* dst, const float* src,
                                              int ld, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[i] = src[(i / cols) * ld + i % cols];
}

// Re-derive the slot table's active-side bound values from sid/slo and
// the bounds in L.du / L.dl (slot_refresh_bounds, pallas_slot.py:2317, as
// the segment kernels do it in-kernel at :811-818).  The caller syncs.
__device__ __forceinline__ void slot_refresh_dsl(const Lane& L, int m,
                                                 int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int id = static_cast<int>(L.sid[k]);
    const bool hit = id >= 0 && id < m && static_cast<float>(id) == L.sid[k];
    const float du_sel = hit ? L.du[id] : 0.f;
    const float dl_sel = hit ? L.dl[id] : 0.f;
    L.dsl[k] = (L.slo[k] * dl_sel + (1.f - L.slo[k]) * du_sel) * L.used[k];
  }
}

// The per-solve control reset of a warm re-solve (mpc.py:105-111,
// batch.py:788-795) for a lane that runs.
__device__ __forceinline__ void ctl_reset(Ctl& c) {
  c.stt = kRunning;
  c.it = 0.f;
  c.cy = 0.f;
  c.rp = 0.f;
  c.bf = -1.f;
  c.pd = 0.f;
}

// A group of 8 lanes holds partial sums v[p] of 8 items; lane q gets the
// full sum of item q (a transposing butterfly: 4 + 2 + 1 shuffles, one
// fixed order).  The whole warp calls it.
__device__ __forceinline__ float slot_tsum8(float (&v)[kSG], int q) {
#pragma unroll
  for (int h = kSG / 2; h > 0; h >>= 1) {
    const bool hi = (q & h) != 0;
#pragma unroll
    for (int p = 0; p < h; ++p) {
      const float send = hi ? v[p] : v[p + h];
      const float keep = hi ? v[p + h] : v[p];
      v[p] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

// f(i) for i = i0, i0 + Stride, ... below end (i0 < Stride), under a
// ceiling Turns * Stride >= end: Turns turns unrolled, each taken where
// i < end.
template <int Turns, int Stride, class F>
__device__ __forceinline__ void slot_turns(int i0, int end, F f) {
#pragma unroll
  for (int u = 0; u < Turns; ++u) {
    const int i = i0 + u * Stride;
    if (i < end) f(i);
  }
}

// acc[p] += A[off[p] + j] x(j) over the columns j = j0, j0 + stride, ...
// below n; under a ceiling Cap >= n, Cap / stride turns unrolled.  (The
// loop at the run-time n is written apart: the same code in a helper
// compiles to other SASS.)
template <int Cap = 0, int Stride = 0, class X>
__device__ __forceinline__ void slot_rows8(float (&acc)[kSG], const float* A,
                                           const int (&off)[kSG], int n,
                                           int j0, int stride, X x) {
  if constexpr (Cap == 0) {
    for (int j = j0; j < n; j += stride) {
      const float xj = x(j);
#pragma unroll
      for (int p = 0; p < kSG; ++p) acc[p] += A[off[p] + j] * xj;
    }
  } else {
    slot_turns<Cap / Stride, Stride>(j0, n, [&](int j) {
      const float xj = x(j);
#pragma unroll
      for (int p = 0; p < kSG; ++p) acc[p] += A[off[p] + j] * xj;
    });
  }
}

// Two groups of 8 lanes (t and t ^ 8) that summed halves of the same 8
// items' inputs: each ends with the pair's sums (one fixed order).
__device__ __forceinline__ void slot_pair8(float (&v)[kSG]) {
#pragma unroll
  for (int p = 0; p < kSG; ++p) v[p] += __shfl_xor_sync(kFull, v[p], kSG);
}

// Block-wide reduction of the step: NS sums, then one NaN-propagating max
// (kMax) and NA lowest-index argmins.  Every thread returns the same
// values (the same combination order).  One barrier: consecutive calls
// pass alternate halves of the scratch.
template <int NS, int NA, bool kMax>
__device__ __forceinline__ void slot_reduce(float (&s)[NS], float& mx,
                                            float (&av)[2], int (&ai)[2],
                                            float* red) {
  static_assert(NS + (kMax ? 1 : 0) + 2 * NA <= kRedStride, "scratch");
  constexpr int kA = NS + (kMax ? 1 : 0);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    for (int q = 0; q < NS; ++q) s[q] += __shfl_xor_sync(kFull, s[q], o);
    if (kMax) mx = max_nan(mx, __shfl_xor_sync(kFull, mx, o));
    for (int c = 0; c < NA; ++c) {
      const float ov = __shfl_xor_sync(kFull, av[c], o);
      const int oi = __shfl_xor_sync(kFull, ai[c], o);
      if (better(ov, oi, av[c], ai[c])) { av[c] = ov; ai[c] = oi; }
    }
  }
  float* r = red + wid * kRedStride;
  if (lane == 0) {
    for (int q = 0; q < NS; ++q) r[q] = s[q];
    if (kMax) r[NS] = mx;
    for (int c = 0; c < NA; ++c) {
      r[kA + 2 * c] = av[c];
      r[kA + 2 * c + 1] = __int_as_float(ai[c]);
    }
  }
  __syncthreads();
  // lane l takes warp l's partials and a butterfly over the warps
  // combines them, in the same order in every warp
  const float* rw = red + (lane % kWarps) * kRedStride;
  for (int q = 0; q < NS; ++q) s[q] = rw[q];
  if (kMax) mx = rw[NS];
  for (int c = 0; c < NA; ++c) {
    av[c] = rw[kA + 2 * c];
    ai[c] = __float_as_int(rw[kA + 2 * c + 1]);
  }
  for (int o = 1; o < kWarps; o <<= 1) {
    for (int q = 0; q < NS; ++q) s[q] += __shfl_xor_sync(kFull, s[q], o);
    if (kMax) mx = max_nan(mx, __shfl_xor_sync(kFull, mx, o));
    for (int c = 0; c < NA; ++c) {
      const float ov = __shfl_xor_sync(kFull, av[c], o);
      const int oi = __shfl_xor_sync(kFull, ai[c], o);
      if (better(ov, oi, av[c], ai[c])) { av[c] = ov; ai[c] = oi; }
    }
  }
}

// The number of used slots; the last warp also writes them, in slot
// order, to L.list.  Every warp calls it; the caller syncs before the
// list is read.  Cap: a ceiling on K, or 0.
template <int Cap = 0>
__device__ __forceinline__ int slot_list(const Lane& L, int K) {
  const int lane = threadIdx.x & 31;
  const bool write = (threadIdx.x >> 5) == kWarps - 1;
  int k = 0;
  for (int base = 0; base < (Cap ? Cap : K); base += 32) {
    const int s = base + lane;
    const bool on = s < K && L.used[s] > 0.f;
    const unsigned bal = __ballot_sync(kFull, on);
    if (write && on) L.list[k + __popc(bal & ((1u << lane) - 1u))] = s;
    k += __popc(bal);
  }
  return k;
}

// The per-phase cycle probe (chip_profile.py --probe k2): built only into
// an instrumented copy of K2 (-DSLOT_PROBE); thread 0 of each block adds
// the SM clock's cycles of each phase of slot_steps, and the steps run,
// to slot_probe_cycles.
#ifdef SLOT_PROBE
constexpr int kProbePhases = 6;
__device__ unsigned long long slot_probe_cycles[kProbePhases + 1];
#define SLOT_PROBE_INIT                      \
  long long pr_t = clock64();                \
  long long pr_acc[kProbePhases + 1] = {};
#define SLOT_PROBE_MARK(ph)                  \
  if (threadIdx.x == 0) {                    \
    const long long pr_now = clock64();      \
    pr_acc[ph] += pr_now - pr_t;             \
    pr_t = pr_now;                           \
  }
#define SLOT_PROBE_STEP ++pr_acc[kProbePhases];
// the segment kernels' probe (segment.cuh) also counts each block's
// in-kernel cold retries, and keeps each block's cycles per phase and
// steps, for its first kProbeBlocks blocks
constexpr int kProbeBlocks = 1024;
__device__ unsigned long long slot_probe_retries[kProbeBlocks];
__device__ unsigned long long
    slot_probe_block_phases[kProbeBlocks * (kProbePhases + 1)];
#define SLOT_PROBE_FLUSH                                            \
  if (threadIdx.x == 0)                                             \
    for (int ph = 0; ph <= kProbePhases; ++ph) {                    \
      atomicAdd(&slot_probe_cycles[ph],                             \
                static_cast<unsigned long long>(pr_acc[ph]));       \
      if (blockIdx.x < kProbeBlocks)                                \
        atomicAdd(&slot_probe_block_phases[blockIdx.x *             \
                                           (kProbePhases + 1) + ph], \
                  static_cast<unsigned long long>(pr_acc[ph]));     \
    }
#define SLOT_PROBE_RETRY                                            \
  if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks)                \
    atomicAdd(&slot_probe_retries[blockIdx.x], 1ull);
#else
#define SLOT_PROBE_INIT
#define SLOT_PROBE_MARK(ph)
#define SLOT_PROBE_STEP
#define SLOT_PROBE_FLUSH
#define SLOT_PROBE_RETRY
#endif

// Up to `steps` iterations of a RUNNING lane on its shared-memory state,
// with the bounds du / dl (m,).  Starts with the round prefix from the
// stored E and used (pallas_slot.py:614-617), so E may have changed since
// the last step; leaves the shared state consistent (ends on a barrier).
// A lane that is not RUNNING returns at once; a lane that turns terminal
// stops, which equals the TPU kernel's masked no-op steps.  Cfg: the
// step's settings (StepCfg); under ceilings (K <= Cfg::kK, n <= Cfg::kN,
// m <= Cfg::kM) each loop over the slots, rows or columns is one pass
// and each list walk and column product unrolls (slot_turns).
template <class Cfg = ShapeStep>
__device__ __forceinline__ void slot_steps(const Lane& L, Ctl& c,
                                           const float* du, const float* dl,
                                           int m, int n, int K, int n_true,
                                           int steps, const Tol& tol) {
  if (c.stt != kRunning) return;
  const int t = threadIdx.x;
  const int q = t & (kSG - 1);
  // items of a product: group t / 8 sums items 8 (t / 8) + p, p < 8, and
  // thread t ends with item t.  u and the add's row run on vt = t ^ 64,
  // the other half of the block from the ratio test and the Gram column
  // beside them
  const int vt = t ^ (kThreads / 2);
  const int g8 = kSG * (t / kSG), v8 = kSG * (vt / kSG);
  // products on pairs of groups: the pair t / 16 sums items r16 + p,
  // p < 8; half h = (t / 8) mod 2 of it takes the inputs j = hq (mod 16),
  // and lane q of half 0 owns item r16 + q
  const int hq = t & (2 * kSG - 1), r16 = kSG * (t / (2 * kSG));
  const bool h0 = hq < kSG;
  constexpr int kPairItems = kThreads / 2;
  const int ldK = L.ldK, ldn = L.ldn;
  float* E = L.E;
  float* W = L.W;
  const float* M = L.M;
  const float* sc = L.sc;
  const float* im = L.im;
  float* au = L.au;
  float* al = L.al;
  float* lo_okv = L.lo_okv;
  float* dsl = L.dsl;
  float* used = L.used;
  float* sid = L.sid;
  float* slo = L.slo;
  const float* simm = L.simm;
  float* lam = L.lam;
  float* ls = L.ls;
  float* lstar = L.lstar;
  float* a_p = L.a_p;
  float* delta = L.delta;
  float* g_k = L.g_k;
  float* e = L.e;
  float* a = L.a;
  float* g_p = L.g_p;
  float* prow = L.prow;
  float* u = L.u;
  float* u_new = L.u_new;
  float* add_row = L.add_row;
  int* list = L.list;
  float pd = c.pd, plm = c.plm, plo = c.plo, pid = c.pid, pdd = c.pdd;
  float fv = c.fv, bf = c.bf, cy = c.cy, it = c.it;
  const float rp = c.rp, fb = c.fb;
  int stt = c.stt;
  const int half = kWarps * kRedStride;
  int rb = 0;                       // the scratch half of the next reduction
  auto red = [&]() { rb ^= 1; return L.red + (rb ^ 1) * half; };
  SLOT_PROBE_INIT
  __syncthreads();

  // round-start prefix from the stored E: the list; lam* = a_p = 0 off
  // it; g_p = (W prow) o used; then lam* = -E (dsl o used), a_p = E g_p
  // on the list
  int k = slot_list<Cfg::kK>(L, K);
  for (int s = t; s < (Cfg::kFixed ? t + kThreads : K); s += kThreads)
    if ((!Cfg::kFixed || s < K) && !(used[s] > 0.f)) {
      lstar[s] = 0.f;
      a_p[s] = 0.f;
    }
  for (int base = 0; base < (Cfg::kFixed ? 1 : K); base += kThreads) {
    float acc[kSG] = {};
    if (pd > 0.f && base + g8 < K) {
      int off[kSG];
#pragma unroll
      for (int p = 0; p < kSG; ++p) off[p] = min(base + g8 + p, K - 1) * ldn;
      slot_rows8<Cfg::kN, kSG>(acc, W, off, n, q, kSG,
                               [&](int j) { return prow[j]; });
    }
    const float sp = slot_tsum8(acc, q);
    const int s = base + t;
    if (s < K) g_p[s] = sp * used[s];
  }
  __syncthreads();
  for (int base = 0; base < (Cfg::kFixed ? 1 : k); base += kPairItems) {
    const int p0 = base + r16;
    float s1[kSG] = {}, s2[kSG] = {};
    if (p0 < k) {
      int off[kSG];
#pragma unroll
      for (int p = 0; p < kSG; ++p) off[p] = list[min(p0 + p, k - 1)] * ldK;
      // (each list walk of the step is written twice: unrolled under the
      // ceilings, and as the loop at the run-time shape, whose SASS K2, B4
      // and the 128-thread bodies keep)
      if constexpr (Cfg::kFixed) {
        slot_turns<Cfg::kK / (2 * kSG), 2 * kSG>(hq, k, [&](int cc) {
          const int j = list[cc];
          const float dj = dsl[j] * used[j], gj = g_p[j];
#pragma unroll
          for (int p = 0; p < kSG; ++p) {
            const float eij = E[off[p] + j];
            s1[p] += eij * dj;
            s2[p] += eij * gj;
          }
        });
      } else {
        for (int cc = hq; cc < k; cc += 2 * kSG) {
          const int j = list[cc];
          const float dj = dsl[j] * used[j], gj = g_p[j];
#pragma unroll
          for (int p = 0; p < kSG; ++p) {
            const float eij = E[off[p] + j];
            s1[p] += eij * dj;
            s2[p] += eij * gj;
          }
        }
      }
    }
    slot_pair8(s1);
    slot_pair8(s2);
    const float l1 = slot_tsum8(s1, q), l2 = slot_tsum8(s2, q);
    if (h0 && p0 + q < k) {
      const int i = list[p0 + q];
      lstar[i] = -l1;
      a_p[i] = l2;
    }
  }
  __syncthreads();
  int kU = k;                       // the update's list: used, + removed
  SLOT_PROBE_MARK(0)

  for (int step = 0; step < steps; ++step) {
    const float sgn_p = 1.f - 2.f * plo;

    // blocking min-ratio search over the slots (pallas_slot.py:269-299)
    // and, on the other half, u = -W'(lam* o used) over the update's list
    // (:302-303)
    float r1[1] = {0.f};
    float mx = -INFINITY;
    float av[2] = {INFINITY, INFINITY};
    int ai[2] = {INT_MAX, INT_MAX};
    for (int s = t; s < (Cfg::kFixed ? t + kThreads : K); s += kThreads) {
      if (Cfg::kFixed && s >= K) continue;
      const float sdir = -a_p[s] * sgn_p;
      const float dk = pd * sdir + (1.f - pd) * (lstar[s] - lam[s]);
      const float signv = pd * sdir + (1.f - pd) * lstar[s];
      delta[s] = dk;
      const float infeas =
          slo[s] * (signv > tol.dtol ? 1.f : 0.f) +
          (1.f - slo[s]) * (signv < -tol.dtol ? 1.f : 0.f);
      const float elig = infeas * used[s] * (1.f - simm[s]);
      float ratio = -lam[s] / dk;
      ratio = isfinite(ratio) ? fmaxf(ratio, 0.f) : 0.f;
      const float cand = elig > 0.f ? ratio : kBig;
      if (better(cand, s, av[0], ai[0])) { av[0] = cand; ai[0] = s; }
    }
    for (int base = 0; base < (Cfg::kFixed ? 1 : n); base += kThreads) {
      const int j0 = base + v8;
      float acc[kSG] = {};
      if constexpr (Cfg::kFixed) {
        if (j0 < n)
          slot_turns<Cfg::kK / kSG, kSG>(q, kU, [&](int cc) {
            const int s = list[cc];
            const float v = lstar[s] * used[s];
            const float* Ws = W + s * ldn + j0;
#pragma unroll
            for (int p = 0; p < kSG; ++p) acc[p] += Ws[p] * v;
          });
      } else {
        if (j0 < n)
          for (int cc = q; cc < kU; cc += kSG) {
            const int s = list[cc];
            const float v = lstar[s] * used[s];
            const float* Ws = W + s * ldn + j0;    // columns past n dropped
#pragma unroll
            for (int p = 0; p < kSG; ++p) acc[p] += Ws[p] * v;
          }
      }
      const float sj = slot_tsum8(acc, q);
      const int j = base + vt;
      if (j < n) {
        u_new[j] = -sj;
        r1[0] += sj * sj;
      }
    }
    __syncthreads();
    SLOT_PROBE_MARK(1)

    // every warp counts this step's used slots (the last lists them);
    // pricing on mu = M u (:304-337); one reduction for both searches
    k = slot_list<Cfg::kK>(L, K);
    for (int base = 0; base < (Cfg::kFixed ? 1 : m); base += kThreads) {
      float acc[kSG] = {};
      if (base + g8 < m) {
        int off[kSG];
#pragma unroll
        for (int p = 0; p < kSG; ++p) off[p] = min(base + g8 + p, m - 1) * ldn;
        slot_rows8<Cfg::kN, kSG>(acc, M, off, n, q, kSG,
                                 [&](int j) { return u_new[j]; });
      }
      const float mu = slot_tsum8(acc, q);
      const int i = base + t;
      if (i < m) {
        const float bound = -tol.ptol * sc[i];
        const float v_up = du[i] - mu;
        const float v_lo = mu - dl[i];
        const float pblock = pd * (static_cast<float>(i) == pid ? 1.f : 0.f);
        const bool blocked = (au[i] + al[i]) > 0.f || im[i] > 0.f ||
                             pblock > 0.f;
        const bool up_ok = v_up < bound && !blocked;
        const bool lo_ok = v_lo < bound && !blocked && !up_ok;
        float cand = up_ok ? v_up : (lo_ok ? v_lo : kBig);
        if (tol.bland)
          cand = (up_ok || lo_ok) ? static_cast<float>(i) - kBig : kBig;
        lo_okv[i] = lo_ok ? 1.f : 0.f;
        if (better(cand, i, av[1], ai[1])) { av[1] = cand; ai[1] = i; }
      }
    }
    slot_reduce<1, 2, false>(r1, mx, av, ai, red());
    SLOT_PROBE_MARK(2)
    const float fv_new = r1[0];
    const float rmin = av[0], vmin = av[1];
    const int rm = ai[0], jr = ai[1];
    const float do_rm0 = rmin < kBig ? 1.f : 0.f;
    const float rm_id = sid[rm];
    const float rm_lo = slo[rm];
    const float found = vmin < 0.f ? 1.f : 0.f;
    const float j_lo = lo_okv[jr];
    const float d_j = j_lo * dl[jr] + (1.f - j_lo) * du[jr];

    // add candidate: pending retry after a removal, or the priced row
    // (:363-380)
    const float retry = pd * do_rm0;
    const float price0 = (1.f - do_rm0) * (1.f - pd);
    const float padd0 = price0 * found;
    const float add_lo = retry * plo + padd0 * j_lo;
    const float add_lam = retry * plm + padd0 * (1.f - 2.f * j_lo);
    const float add_id = retry * pid + padd0 * static_cast<float>(jr);
    const float add_d = retry * pdd + padd0 * d_j;
    const float* mj = M + jr * ldn;
    auto xadd = [&](int j) { return retry * prow[j] + padd0 * mj[j]; };

    // Gram column of the add over the list, g_k = (W add_row) o used o
    // keep0, the removed column e = E[list, rm] (:381-400), e.g_k and
    // the deletion pivot's max|e| (:400-416; e is zero off the list);
    // beside them the add's row and its ||.||^2
    float r3[2] = {0.f, 0.f};
    float emax = -INFINITY;
    for (int base = 0; base < (Cfg::kFixed ? 1 : k); base += kPairItems) {
      const int p0 = base + r16;
      float acc[kSG] = {};
      if (p0 < k) {
        int off[kSG];
#pragma unroll
        for (int p = 0; p < kSG; ++p) off[p] = list[min(p0 + p, k - 1)] * ldn;
        slot_rows8<Cfg::kN, 2 * kSG>(acc, W, off, n, hq, 2 * kSG, xadd);
      }
      slot_pair8(acc);
      const float sg = slot_tsum8(acc, q);
      if (h0 && p0 + q < k) {
        const int s = list[p0 + q];
        const float keep0 = 1.f - (s == rm ? 1.f : 0.f) * do_rm0;
        const float gs = sg * used[s] * keep0;
        const float es = E[s * ldK + rm];
        g_k[s] = gs;
        e[s] = es;
        r3[0] += es * gs;
        emax = max_nan(emax, fabsf(es));
      }
    }
    for (int j = vt; j < (Cfg::kFixed ? vt + kThreads : n); j += kThreads) {
      if (Cfg::kFixed && j >= n) continue;
      const float x = xadd(j);
      add_row[j] = x;
      r3[1] += x * x;
    }
    slot_reduce<2, 0, true>(r3, emax, av, ai, red());
    SLOT_PROBE_MARK(3)
    const float err = E[rm * ldK + rm];            // e[rm]
    const float dii = r3[1];
    const bool bad = do_rm0 > 0.f && err < tol.pivtol * emax;
    const float err_s = err != 0.f ? err : 1.f;
    const float ec = r3[0] / err_s;
    if (bad) stt = kRefactor;
    const float do_rm = bad ? 0.f : do_rm0;
    const float alpha = do_rm * (rmin < kBig ? rmin : 0.f);
    plm = plm + alpha * sgn_p * pd;

    // exits (:431-454)
    if (stt == kRunning && pd > 0.f && do_rm == 0.f)
      stt = rp > 0.f ? kInfeasible : kCycle;
    if (price0 > 0.f && stt == kRunning && fv_new > fb) stt = kInfeasible;
    const float price = stt == kRunning ? price0 : 0.f;
    if (price > 0.f && found == 0.f) stt = kOptimal;
    const bool no_prog =
        fv_new - bf < tol.progtol * (1.f + fabsf(fv_new));
    if (price > 0.f) {
      cy = no_prog ? cy + 1.f : 0.f;
      if (!no_prog) bf = fv_new;
      if (cy > tol.cyctol && stt == kRunning) stt = kCycle;
      fv = fv_new;
    }
    const float padd = stt == kRunning ? padd0 : 0.f;

    // the Schur vector a_pre = E g_k over the list, then a_post and its
    // pivot g_k.a_post (:400-416, :474-481); the dual step, the removal
    // (:416-429), lam <- lam* before a priced add and the lam* record
    // (:456-462), and the first free slot for the add
    float r4[1] = {0.f};
    float fmx = -INFINITY;
    float fv_free[2] = {INFINITY, INFINITY};
    int free_i[2] = {INT_MAX, INT_MAX};
    for (int base = 0; base < (Cfg::kFixed ? 1 : k); base += kPairItems) {
      const int p0 = base + r16;
      float acc[kSG] = {};
      if (p0 < k) {
        int off[kSG];
#pragma unroll
        for (int p = 0; p < kSG; ++p) off[p] = list[min(p0 + p, k - 1)] * ldK;
        if constexpr (Cfg::kFixed) {
          slot_turns<Cfg::kK / (2 * kSG), 2 * kSG>(hq, k, [&](int cc) {
            const int j = list[cc];
            const float gj = g_k[j];
#pragma unroll
            for (int p = 0; p < kSG; ++p) acc[p] += E[off[p] + j] * gj;
          });
        } else {
          for (int cc = hq; cc < k; cc += 2 * kSG) {
            const int j = list[cc];
            const float gj = g_k[j];
#pragma unroll
            for (int p = 0; p < kSG; ++p) acc[p] += E[off[p] + j] * gj;
          }
        }
      }
      slot_pair8(acc);
      const float sa = slot_tsum8(acc, q);
      if (h0 && p0 + q < k) {
        const int s = list[p0 + q];
        const float keep = 1.f - (s == rm ? 1.f : 0.f) * do_rm;
        const float ap = keep * (sa - do_rm * e[s] * ec);
        a[s] = ap;
        r4[0] += g_k[s] * ap;
      }
    }
    for (int s = t; s < (Cfg::kFixed ? t + kThreads : K); s += kThreads) {
      if (Cfg::kFixed && s >= K) continue;
      const float keep = 1.f - (s == rm ? 1.f : 0.f) * do_rm;
      lam[s] = (lam[s] + alpha * delta[s] * used[s]) * keep;
      used[s] *= keep;
      dsl[s] *= keep;
      slo[s] *= keep;
      sid[s] = sid[s] * keep - (1.f - keep);
      if (padd > 0.f) lam[s] = lstar[s] * used[s];
      ls[s] = lstar[s];
      const float fc = static_cast<float>(s) + used[s] * kBig;
      if (better(fc, s, fv_free[0], free_i[0])) {
        fv_free[0] = fc;
        free_i[0] = s;
      }
    }
    slot_reduce<1, 1, false>(r4, fmx, fv_free, free_i, red());
    SLOT_PROBE_MARK(4)
    const int free_k = free_i[0];
    const float kcnt = static_cast<float>(k) - do_rm;   // used after it

    // Schur complement and the relative singularity gate (:463-481)
    const float sval = dii - r4[0];
    const float gate = fmaxf(tol.singtol, 1e-4f * dii);
    const bool sing = sval < gate || kcnt >= static_cast<float>(n_true);
    const float do_add = retry * (bad ? 0.f : 1.f) + padd;
    const float ok = sing ? 0.f : do_add;
    const float mk_pend = sing ? do_add : 0.f;
    const float c_del = -do_rm / err_s;
    const float c_add = ok / (sval != 0.f ? sval : 1.f);
    pd = fminf((1.f - retry) * pd + mk_pend, 1.f);
    if (mk_pend > 0.f) {
      plm = add_lam;
      plo = add_lo;
      pid = add_id;
      pdd = add_d;
    }
    // the free slot joins the update's list unless it is the removed one
    const bool rm_free = do_rm > 0.f && free_k == rm;
    const int kN = k + (ok > 0.f && !rm_free ? 1 : 0);
    // the last step of the round computes no next lam*: ls is the record
    const bool last = stt != kRunning || step + 1 == steps;
    const bool has_pn = !last && pd > 0.f;
    // the update's list and the new table's values there, taken before
    // the bookkeeping below writes the added slot: the free slot's are
    // those of the add
    auto slot_of = [&](int idx) { return idx < k ? list[idx] : free_k; };
    auto added = [&](int s) { return ok > 0.f && s == free_k; };

    // a pending entry's Gram column g_p = (W prow) o used on the new
    // table (:587-588), over the update's list, when one is pending: W's
    // new rows are its rows but the removed one's (dropped: its new used
    // is 0) and the added one's (the added row); the new prow is the
    // added row if it was parked, else prow
    if (has_pn) {
      const bool from_add = mk_pend > 0.f;
      for (int base = 0; base < (Cfg::kFixed ? 1 : kN); base += kThreads) {
        const int p0 = base + g8;
        float acc[kSG] = {};
        if (p0 < kN) {
          // W's rows, the added row read as W[add_off + j]
          const int add_off = static_cast<int>(add_row - W);
          int off[kSG];
#pragma unroll
          for (int p = 0; p < kSG; ++p) {
            const int s = slot_of(min(p0 + p, kN - 1));
            off[p] = added(s) || (do_rm > 0.f && s == rm) ? add_off
                                                          : s * ldn;
          }
          slot_rows8<Cfg::kN, kSG>(acc, W, off, n, q, kSG, [&](int j) {
            return from_add ? add_row[j] : prow[j];
          });
        }
        const float sg = slot_tsum8(acc, q);
        const int idx = base + t;
        if (idx < kN) {
          const int s = slot_of(idx);
          g_p[s] = sg * (added(s) ? 1.f : used[s]);
        }
      }
    }

    if constexpr (Cfg::kLoadsFirst) {
      // E <- (E + c_del e e') o keep keep' + c_add w w' (:590-596) on the
      // update's list as below, and the next lam*, first: the add's
      // bookkeeping, the W update and the act rows after it (the E update
      // reads none of what they write), each reading its values before it
      // stores.  Each turn of columns reads its column's records and its 8
      // entries before it writes the new ones: the same values, summed in
      // the same order
      auto e_of = [&](int i) { return added(i) && !rm_free ? 0.f : e[i]; };
      auto w_of = [&](int i) {
        return i == free_k ? -1.f : (used[i] > 0.f ? a[i] * used[i] : 0.f);
      };
      auto d_of = [&](int i) { return added(i) ? add_d : dsl[i] * used[i]; };
      {
        const int p0 = r16;            // one pass: kN <= K <= kPairItems
        float s1[kSG] = {};
        if (p0 < kN) {
          int off[kSG];
          float ce[kSG], ca[kSG], ki[kSG];
#pragma unroll
          for (int p = 0; p < kSG; ++p) {
            const int i = slot_of(min(p0 + p, kN - 1));
            off[p] = i * ldK;
            ce[p] = c_del * e_of(i);
            ca[p] = c_add * w_of(i);
            ki[p] = i == rm ? 1.f - do_rm : 1.f;
          }
          auto turn = [&](int cc) {
            const int j = slot_of(cc);
            const float kj = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
            const float ej = e_of(j), wj = w_of(j), dj = d_of(j);
            float ev[kSG];
#pragma unroll
            for (int p = 0; p < kSG; ++p) ev[p] = E[off[p] + j];
#pragma unroll
            for (int p = 0; p < kSG; ++p) {
              const float v = (ev[p] + ce[p] * ej) * ki[p] * kj + ca[p] * wj;
              if (p0 + p < kN) E[off[p] + j] = v;
              s1[p] += v * dj;
            }
          };
          slot_turns<Cfg::kK / (2 * kSG), 2 * kSG>(hq, kN, turn);
        }
        if (!last) {
          slot_pair8(s1);
          const float l1 = slot_tsum8(s1, q);
          if (h0 && p0 + q < kN) {
            const int i = slot_of(p0 + q);
            lstar[i] = -l1;
            a_p[i] = 0.f;
          }
        }
      }
      if (t == 0) {
        if (ok > 0.f) {
          const float used_f = used[free_k], sid_f = sid[free_k];
          const float slo_f = slo[free_k], dsl_f = dsl[free_k];
          const float lam_f = lam[free_k];
          used[free_k] = fminf(used_f + ok, 1.f);
          sid[free_k] = sid_f + ok * (add_id + 1.f);
          slo[free_k] = slo_f + ok * add_lo;
          dsl[free_k] = dsl_f + ok * add_d;
          lam[free_k] = lam_f + ok * add_lam;
        }
        if (kN > k) list[k] = free_k;
      }
      if (const int j = vt; j < n) {
        const float xj = add_row[j], uj = u_new[j];
        if (do_rm > 0.f) W[rm * ldn + j] = 0.f;
        if (ok > 0.f) W[free_k * ldn + j] = xj;
        if (price > 0.f) u[j] = uj;
        if (mk_pend > 0.f) prow[j] = xj;
      }
      if (const int i = vt; i < m) {
        const float fi = static_cast<float>(i);
        const float oh_rm = (fi == rm_id ? 1.f : 0.f) * do_rm;
        const float up0 = au[i], lo0 = al[i];
        const float up = up0 * (1.f - oh_rm * (1.f - rm_lo));
        const float lo = lo0 * (1.f - oh_rm * rm_lo);
        const float add_oh = retry * (fi == pid ? 1.f : 0.f) +
                             padd * (i == jr ? 1.f : 0.f);
        au[i] = fminf(up + ok * add_oh * (1.f - add_lo), 1.f);
        al[i] = fminf(lo + ok * add_oh * add_lo, 1.f);
      }
    } else {
      // the add's slot, m-space and pending bookkeeping (:456-462,
      // :545-581); the W update: the removed row to 0, the added row into
      // the free slot (W is zero there)
      if (t == 0) {
        if (kN > k) list[k] = free_k;
        if (ok > 0.f) {
          used[free_k] = fminf(used[free_k] + ok, 1.f);
          sid[free_k] = sid[free_k] + ok * (add_id + 1.f);
          slo[free_k] = slo[free_k] + ok * add_lo;
          dsl[free_k] = dsl[free_k] + ok * add_d;
          lam[free_k] = lam[free_k] + ok * add_lam;
        }
      }
      for (int j = vt; j < n; j += kThreads) {
        if (do_rm > 0.f) W[rm * ldn + j] = 0.f;
        if (ok > 0.f) W[free_k * ldn + j] = add_row[j];
        if (price > 0.f) u[j] = u_new[j];
        if (mk_pend > 0.f) prow[j] = add_row[j];
      }
      for (int i = vt; i < m; i += kThreads) {
        const float fi = static_cast<float>(i);
        const float oh_rm = (fi == rm_id ? 1.f : 0.f) * do_rm;
        float up = au[i] * (1.f - oh_rm * (1.f - rm_lo));
        float lo = al[i] * (1.f - oh_rm * rm_lo);
        // a retry keeps pid (add_id = pid), so pid is the retried row
        const float add_oh = retry * (fi == pid ? 1.f : 0.f) +
                             padd * (i == jr ? 1.f : 0.f);
        au[i] = fminf(up + ok * add_oh * (1.f - add_lo), 1.f);
        al[i] = fminf(lo + ok * add_oh * add_lo, 1.f);
      }

      // beside it, E <- (E + c_del e e') o keep keep' + c_add w w'
      // (:590-596) on the update's list, 8 rows to a pair of groups and
      // columns by lane, with w = a_post o used - e_free and e zero at the
      // added slot; from the new values the next step's lam* = -E (dsl o
      // used) and a_p = E g_p (:604-605)
      auto e_of = [&](int i) { return added(i) && !rm_free ? 0.f : e[i]; };
      auto w_of = [&](int i) {
        return i == free_k ? -1.f : (used[i] > 0.f ? a[i] * used[i] : 0.f);
      };
      auto d_of = [&](int i) { return added(i) ? add_d : dsl[i] * used[i]; };
      for (int base = 0; base < kN; base += kPairItems) {
        const int p0 = base + r16;
        float s1[kSG] = {};
        if (p0 < kN) {
          int off[kSG];
          float ce[kSG], ca[kSG];
          const int rm_off = rm * ldK;
          const float k_rm = 1.f - do_rm;
#pragma unroll
          for (int p = 0; p < kSG; ++p) {
            const int i = slot_of(min(p0 + p, kN - 1));
            off[p] = i * ldK;
            ce[p] = c_del * e_of(i);
            ca[p] = c_add * w_of(i);
          }
          for (int cc = hq; cc < kN; cc += 2 * kSG) {
            const int j = slot_of(cc);
            const float kj = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
            const float ej = e_of(j), wj = w_of(j), dj = d_of(j);
#pragma unroll
            for (int p = 0; p < kSG; ++p) {
              float* ep = E + off[p] + j;
              const float ki = off[p] == rm_off ? k_rm : 1.f;
              const float v = (*ep + ce[p] * ej) * ki * kj + ca[p] * wj;
              if (p0 + p < kN) *ep = v;
              s1[p] += v * dj;
            }
          }
        }
        if (!last) {
          slot_pair8(s1);
          const float l1 = slot_tsum8(s1, q);
          if (h0 && p0 + q < kN) {
            const int i = slot_of(p0 + q);
            lstar[i] = -l1;
            a_p[i] = 0.f;
          }
        }
      }
    }
    __syncthreads();
    // with an entry pending, a_p = E g_p (:605) from the new E
    if (has_pn) {
      for (int base = 0; base < (Cfg::kFixed ? 1 : kN); base += kPairItems) {
        const int p0 = base + r16;
        float s2[kSG] = {};
        if (p0 < kN) {
          int off[kSG];
#pragma unroll
          for (int p = 0; p < kSG; ++p)
            off[p] = slot_of(min(p0 + p, kN - 1)) * ldK;
          if constexpr (Cfg::kFixed) {
            slot_turns<Cfg::kK / (2 * kSG), 2 * kSG>(hq, kN, [&](int cc) {
              const int j = slot_of(cc);
              const float gj = g_p[j];
#pragma unroll
              for (int p = 0; p < kSG; ++p) s2[p] += E[off[p] + j] * gj;
            });
          } else {
            for (int cc = hq; cc < kN; cc += 2 * kSG) {
              const int j = slot_of(cc);
              const float gj = g_p[j];
#pragma unroll
              for (int p = 0; p < kSG; ++p) s2[p] += E[off[p] + j] * gj;
            }
          }
        }
        slot_pair8(s2);
        const float l2 = slot_tsum8(s2, q);
        if (h0 && p0 + q < kN) a_p[slot_of(p0 + q)] = l2;
      }
      __syncthreads();
    }
    SLOT_PROBE_MARK(5)
    SLOT_PROBE_STEP
    kU = kN;
    it += 1.f;
    if (stt != kRunning) break;
  }
  SLOT_PROBE_FLUSH
  c.pd = pd;
  c.plm = plm;
  c.plo = plo;
  c.pid = pid;
  c.pdd = pdd;
  c.fv = fv;
  c.bf = bf;
  c.cy = cy;
  c.it = it;
  c.stt = stt;
}

// A warm solve of the segment kernels: slot_steps, then, on CYCLE or
// REFACTOR, the in-kernel cold retry (pallas_slot.py:834-870): the lane's
// table, E, W, lam, u and fval are cleared and the step runs again.
// `it` is not reset before the retry, so it counts both attempts.
template <class Cfg = ShapeStep>
__device__ __forceinline__ void slot_solve_retry(const Lane& L, Ctl& c,
                                                 int m, int n, int K,
                                                 int n_true, int steps,
                                                 const Tol& tol) {
  for (int attempt = 0; attempt < 2; ++attempt) {
    slot_steps<Cfg>(L, c, L.du, L.dl, m, n, K, n_true, steps, tol);
    if (attempt == 1 || (c.stt != kCycle && c.stt != kRefactor)) break;
    SLOT_PROBE_RETRY
    __syncthreads();
    for (int i = threadIdx.x; i < K * L.ldK; i += blockDim.x) L.E[i] = 0.f;
    for (int i = threadIdx.x; i < K * L.ldn; i += blockDim.x) L.W[i] = 0.f;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      L.au[i] = 0.f;
      L.al[i] = 0.f;
    }
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      L.used[k] = 0.f;
      L.dsl[k] = 0.f;
      L.slo[k] = 0.f;
      L.sid[k] = -1.f;
      L.lam[k] = 0.f;
      L.ls[k] = 0.f;
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) L.u[j] = 0.f;
    c.pd = 0.f;
    c.fv = 0.f;
    c.bf = -1.f;
    c.cy = 0.f;
    c.stt = kRunning;
  }
  __syncthreads();
}

}  // namespace
