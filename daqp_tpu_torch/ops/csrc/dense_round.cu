// B7: one round of the dense-mask dual active-set solver, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_batch.py:751 run_kernel_round
// (pallas_call at :798; kernel body _kernel_body -> _solve_tile_live,
// pallas_batch.py:105-748).  Per QP it runs up to `steps` iterations of
// the step at pallas_batch.py:304-722: the CSP lam* = -E d_W with the
// pending Gram column, the blocking min-ratio search, u = -M'(lam* o act)
// and mu = M u, Dantzig (or Bland) pricing with the upper side before the
// lower, the pending retry or priced add, the deletion with its pivot
// guard (-> kRefactor), the relative singularity gate (soft variant
// clamped below rho_soft) and the rank cap (-> pending), and one combined
// deletion + bordered-add update of E.  `has_soft`, `has_sw` and `bland`
// are runtime flags: the TPU kernel's three compile-time variants (plain,
// soft and SOFT_WEIGHTS) are all this kernel, SOFT_WEIGHTS as its own
// template instantiation.
//
// The SOFT_WEIGHTS variant (has_sw; every `if has_sw` branch of the TPU
// body, reference auxiliary.c:199-274, factorization.c:31-40, 92-97)
// carries the slack state machine: per-row slack bounds d_ls / d_us and
// per-side weights rho_ls / rho_us, the FIXED flags sfix (rows) and pfix
// (the pending entry).  It adds the FREE slacks' shift of d_W, slack-dual
// blocking with the FIXED/FREE skip rules and the kink guard, the pending
// entry's own transition as one more blocking candidate (ties to the
// rows), the 1.001 step past the transition, the re-adds of a blocker
// (flipped) and of a blocked pending entry, and the double add (a pending
// retry beside a FIXED soft blocker re-adds both).  E pass 2 gains the
// blocker's Schur column and the E update its rank-one term; the main
// add's Schur data chain through it algebraically.
//
// The working set is keyed by row: a row's own row and column of E
// (m x m) are its slot.  Where the TPU kernel selects with f32 one-hot
// masks, this one selects by row index, with the lowest index on ties.
//
// What bounds it on an H100: latency, not bytes or flops.  A step is a
// chain of dependent phases (two E contractions, the E update, three or
// four M passes, three block reductions), ~40 kFLOP at m = 100, n = 50
// and k = 40 active rows on ~60 KB of shared-memory state; the round's
// bound is a small share of its time, and a lane alone on an SM is barely
// faster than one beside others.  So the design shortens each lane's
// chains and keeps three lanes on every SM.
//
// Design (kDenseThreads = 128 threads per QP, one block per QP):
// - E and M of the lane in dynamic shared memory at odd row strides (m|1,
//   n|1), the m- and n-vectors beside them, the lane's scalars in
//   registers, identical in every thread.  68.2 KB at m = 100, n = 50
//   (SOFT_WEIGHTS 71.0 KB): three blocks per SM by shared memory, and by
//   registers (__launch_bounds__(128, 3): 166 / 168 a thread, no spills,
//   ptxas on sm_90a).
// - Every matrix-vector product runs on groups of kG = 8 lanes, each group
//   8 output rows (columns) at once: lane q sums the columns (rows) j = q
//   (mod 8) into 8 independent chains, and a transposing butterfly
//   (7 shuffles, one fixed order) leaves thread t with the full sum of
//   item t, which it then owns: the per-row work after a product (ratio
//   test, pricing, bookkeeping) runs once per row, in the thread that
//   holds its sum.  A product's chain of m (or n) dependent FMAs becomes
//   8 independent chains of ceil(n / 8).  The four groups of a warp read rows
//   8 apart: at an odd stride their banks differ in bits 3-4 and the
//   lanes fill bits 0-2, so M and E walks are conflict-free.  Products
//   over columns or over the active list run on the other half of the
//   block (thread t ^ 64) from the per-row work beside them.
// - E is zero outside the active block (every producer of the state
//   keeps it so: dense_init, dense_activate, exact_repair,
//   newton_refresh, dense_add_row, dense_reactivate and the twin's round,
//   tests/test_torch_dense_invariant.py; this kernel's round, chip_smoke's
//   k7), so the E contractions and the update walk a list of the active
//   rows, k x k instead of m x m (k ~ 40 of 100 at config 2).  The last
//   warp rebuilds the list each step with ballots while the others
//   price, and counts the active and soft rows for the rank cap on the
//   way.
// - The E update (2-D: 8 rows to a group, columns by lane, no division)
//   also computes the next step's lam* = -E d_W and a_p = E g_p from the
//   fresh values, so E pass 1 costs no pass of its own; d_W and g_p are
//   built once per step beside the row bookkeeping.
// - Seven barriers per step (was 13): after u, one in each of the three
//   block reductions (double-buffered scratch, and the warps' partials
//   combined by a butterfly: no trailing barrier), after the Gram column,
//   before and after the E update.
// A lane that is not RUNNING is copied through from global to global and
// does no step.
#include "slot_step.cuh"

namespace {

constexpr int kDenseThreads = 128;
constexpr int kDenseWarps = kDenseThreads / 32;
constexpr int kG = 8;                          // items per group of lanes
constexpr int kDenseRed = 6;                   // reduction words per warp
constexpr int kSoftOptimal = 2;
// the kink guard's floor, 64 f32 ulps (pallas_batch.py:259)
constexpr float kEpsK = 64.f * 1.1920928955078125e-7f;

// Pointer table, in the order of ops/dense.py CONST + STATE (in, out),
// then SW_CONST + SW_STATE (in) and SW_STATE (out), null unless has_sw.
enum Ptr {
  M_, DU_, DL_, SC_, IM_, SF_, FB_,
  AU_, AL_, E_, LAM_, LS_, PD_, PID_, PLM_, PLO_, U_, FV_, BF_, CY_, RP_,
  IT_, STT_,
  kNumIn,
  kNumState = kNumIn - AU_,
  DLS_ = kNumIn + kNumState, DUS_, RLS_, RUS_, SFX_, PFX_, SFX_O_, PFX_O_,
  kNumPtrs
};

struct Ptrs {
  const void* p[kNumPtrs];
};

struct DenseLane {
  float *E, *M, *du, *dl, *sc, *im, *sf, *au, *al, *act, *lam, *lstar;
  float *delta, *g, *e, *a, *w, *aux, *u, *u_new, *red, *cnt;
  int* list;
  // SOFT_WEIGHTS only: slack data and state, the blocker's Gram column
  // g_bk and Schur column (ab_pre, ab_post, then w_b), 2 scalars
  float *dls, *dus, *rls, *rus, *sfx, *gb, *ab, *xs;
  int ldm, ldn;
};

// Mirrored by ops/smem.py dense_floats.
__host__ __device__ inline size_t dense_smem_floats(int m, int n,
                                                    bool has_sw) {
  return static_cast<size_t>(m) * (m | 1) + static_cast<size_t>(m) * (n | 1) +
         17 * static_cast<size_t>(m) + 2 * n + 2 * kDenseWarps * kDenseRed +
         4 + (has_sw ? 7 * static_cast<size_t>(m) + 2 : 0);
}

__device__ __forceinline__ DenseLane dense_carve(float* sm, int m, int n) {
  DenseLane L;
  L.ldm = m | 1;
  L.ldn = n | 1;
  L.E = sm;
  L.M = L.E + m * L.ldm;
  L.du = L.M + m * L.ldn;
  L.dl = L.du + m;
  L.sc = L.dl + m;
  L.im = L.sc + m;
  L.sf = L.im + m;
  L.au = L.sf + m;
  L.al = L.au + m;
  L.act = L.al + m;
  L.lam = L.act + m;
  L.lstar = L.lam + m;
  L.delta = L.lstar + m;
  L.g = L.delta + m;         // g_k, then the raw pending Gram column
  L.e = L.g + m;
  L.a = L.e + m;             // a_p, then a_pre, then a_post
  L.w = L.a + m;
  L.aux = L.w + m;           // lo_ok flags in pricing, then d_W
  L.list = reinterpret_cast<int*>(L.aux + m);   // the active rows
  L.u = L.aux + 2 * m;
  L.u_new = L.u + n;
  L.red = L.u_new + n;       // two halves, used in turn
  L.cnt = L.red + 2 * kDenseWarps * kDenseRed;  // k, sum act, soft count
  L.dls = L.cnt + 4;
  L.dus = L.dls + m;
  L.rls = L.dus + m;
  L.rus = L.rls + m;
  L.sfx = L.rus + m;
  L.gb = L.sfx + m;
  L.ab = L.gb + m;
  L.xs = L.ab + m;
  return L;
}

struct DenseTol {
  Tol t;
  float rho;
  int has_soft, has_sw;
};

__device__ __forceinline__ float flag(bool b) { return b ? 1.f : 0.f; }

// A group of 8 lanes holds partial sums v[p] of 8 items; lane q gets the
// full sum of item q (a transposing butterfly: 4 + 2 + 1 shuffles, one
// fixed order).
__device__ __forceinline__ float transpose_sum8(float (&v)[kG], int q) {
#pragma unroll
  for (int h = kG / 2; h > 0; h >>= 1) {
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

// Block-wide reduction: NS sums, then one NaN-propagating max (kMax) or
// NA lowest-index argmins.  Every thread returns the same values (the
// same combination order).  One barrier: consecutive calls must pass
// alternate halves of the scratch.
template <int NS, int NA, bool kMax>
__device__ __forceinline__ void dense_reduce(float (&s)[NS], float& mx,
                                             float (&av)[2], int (&ai)[2],
                                             float* red) {
  static_assert(NS + (kMax ? 1 : 0) + 2 * NA <= kDenseRed, "scratch");
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
  float* r = red + wid * kDenseRed;
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
  const float* rw = red + (lane % kDenseWarps) * kDenseRed;
  for (int q = 0; q < NS; ++q) s[q] = rw[q];
  if (kMax) mx = rw[NS];
  for (int c = 0; c < NA; ++c) {
    av[c] = rw[kA + 2 * c];
    ai[c] = __float_as_int(rw[kA + 2 * c + 1]);
  }
  for (int o = 1; o < kDenseWarps; o <<= 1) {
    for (int q = 0; q < NS; ++q) s[q] += __shfl_xor_sync(kFull, s[q], o);
    if (kMax) mx = max_nan(mx, __shfl_xor_sync(kFull, mx, o));
    for (int c = 0; c < NA; ++c) {
      const float ov = __shfl_xor_sync(kFull, av[c], o);
      const int oi = __shfl_xor_sync(kFull, ai[c], o);
      if (better(ov, oi, av[c], ai[c])) { av[c] = ov; ai[c] = oi; }
    }
  }
}

// Lane q of the group of rows r0 .. r0 + 7: acc[p] += M[r0 + p, j] x(j)
// over the columns j = q (mod 8); rows past m repeat row m - 1 (their sums
// are dropped).  transpose_sum8 then gives thread r0 + q its row's sum.
template <class X>
__device__ __forceinline__ void rows_dot8(float (&acc)[kG], const float* M,
                                          int ldn, int m, int n, int r0,
                                          int q, X x) {
  int off[kG];
#pragma unroll
  for (int p = 0; p < kG; ++p) off[p] = min(r0 + p, m - 1) * ldn;
  for (int j = q; j < n; j += kG) {
    const float xj = x(j);
#pragma unroll
    for (int p = 0; p < kG; ++p) acc[p] += M[off[p] + j] * xj;
  }
}

// One warp: the rows with act > 0 into `list` in row order; cnt[0] their
// number, cnt[1] the sum of act, cnt[2] the soft (under SOFT_WEIGHTS the
// FREE soft) actives of the rank cap.  The caller syncs.
template <bool kSW>
__device__ __forceinline__ void build_list(const DenseLane& L,
                                           const float* act, int m) {
  const int lane = threadIdx.x & 31;
  int k = 0;
  float s_act = 0.f, s_soft = 0.f;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    const float ai = i < m ? act[i] : 0.f;
    const bool on = ai > 0.f;
    const unsigned bal = __ballot_sync(kFull, on);
    if (on) L.list[k + __popc(bal & ((1u << lane) - 1u))] = i;
    k += __popc(bal);
    if (i < m) {
      s_act += ai;
      s_soft += kSW ? ai * L.sf[i] * (1.f - L.sfx[i]) : ai * L.sf[i];
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s_act += __shfl_xor_sync(kFull, s_act, o);
    s_soft += __shfl_xor_sync(kFull, s_soft, o);
  }
  if (lane == 0) {
    reinterpret_cast<int*>(L.cnt)[0] = k;
    L.cnt[1] = s_act;
    L.cnt[2] = s_soft;
  }
}

// kSW: the SOFT_WEIGHTS variant, a separate instantiation so that the
// plain and soft variants compile to the code they had without it
// three blocks to an SM: at m = 100, n = 50 three fit its shared memory
template <bool kSW>
__global__ void __launch_bounds__(kDenseThreads, 3)
dense_round_kernel(Ptrs P, int m, int n, int n_true, int steps,
                   DenseTol dt) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const int lane = t & 31, wid = t >> 5;
  const int q = t & (kG - 1);
  // items of a pass: group t / 8 sums items 8 (t / 8) + p, p < 8, and
  // thread t ends with item t.  Passes over columns or over the active
  // list run on vt = t ^ (threads / 2), the other half of the block from
  // the row-owner work beside them
  const int vt = t ^ (kDenseThreads / 2);
  const int g8 = kG * (t / kG), v8 = kG * (vt / kG);
  constexpr int kLast = kDenseWarps - 1;       // lists the active rows
  const size_t b = blockIdx.x;
  const Tol& tol = dt.t;
  const float rho = dt.rho;
  constexpr bool has_sw = kSW;
  const bool has_soft = dt.has_soft != 0 || has_sw;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  auto sw_out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[i]));
  };
  const size_t mm = static_cast<size_t>(m) * m;

  int stt = static_cast<const int*>(P.p[STT_])[b];
  if (stt != kRunning || steps <= 0) {
    // terminal or held lane: state passes through unchanged
    for (size_t i = t; i < mm; i += kDenseThreads)
      out(E_)[b * mm + i] = in(E_)[b * mm + i];
    for (int i = t; i < m; i += kDenseThreads) {
      out(AU_)[b * m + i] = in(AU_)[b * m + i];
      out(AL_)[b * m + i] = in(AL_)[b * m + i];
      out(LAM_)[b * m + i] = in(LAM_)[b * m + i];
      out(LS_)[b * m + i] = in(LS_)[b * m + i];
      if (has_sw) sw_out(SFX_O_)[b * m + i] = in(SFX_)[b * m + i];
    }
    for (int j = t; j < n; j += kDenseThreads)
      out(U_)[b * n + j] = in(U_)[b * n + j];
    if (t == 0) {
      const int scalars[] = {PD_, PID_, PLM_, PLO_, FV_, BF_, CY_, RP_, IT_};
      for (int k : scalars) out(k)[b] = in(k)[b];
      reinterpret_cast<int*>(out(STT_))[b] = stt;
      if (has_sw) sw_out(PFX_O_)[b] = in(PFX_)[b];
    }
    return;
  }

  const DenseLane L = dense_carve(sm, m, n);
  const int ldm = L.ldm, ldn = L.ldn;
  float* E = L.E;
  float* M = L.M;
  for (int i = wid; i < m; i += kDenseWarps) {
    for (int j = lane; j < m; j += 32)
      E[i * ldm + j] = in(E_)[b * mm + static_cast<size_t>(i) * m + j];
    for (int j = lane; j < n; j += 32)
      M[i * ldn + j] = in(M_)[(b * m + i) * n + j];
  }
  copy_vec(L.du, in(DU_) + b * m, m);
  copy_vec(L.dl, in(DL_) + b * m, m);
  copy_vec(L.sc, in(SC_) + b * m, m);
  copy_vec(L.im, in(IM_) + b * m, m);
  copy_vec(L.sf, in(SF_) + b * m, m);
  copy_vec(L.au, in(AU_) + b * m, m);
  copy_vec(L.al, in(AL_) + b * m, m);
  copy_vec(L.lam, in(LAM_) + b * m, m);
  copy_vec(L.u, in(U_) + b * n, n);
  float pfx = 0.f;
  if (has_sw) {
    copy_vec(L.dls, in(DLS_) + b * m, m);
    copy_vec(L.dus, in(DUS_) + b * m, m);
    copy_vec(L.rls, in(RLS_) + b * m, m);
    copy_vec(L.rus, in(RUS_) + b * m, m);
    copy_vec(L.sfx, in(SFX_) + b * m, m);
    pfx = in(PFX_)[b];
  }
  float pd = in(PD_)[b], pid = in(PID_)[b], plm = in(PLM_)[b];
  float plo = in(PLO_)[b], fv = in(FV_)[b], bf = in(BF_)[b];
  float cy = in(CY_)[b], it = in(IT_)[b];
  const float rp = in(RP_)[b], fb = in(FB_)[b];
  const float* du = L.du;
  const float* dl = L.dl;
  const float* sc = L.sc;
  const float* im = L.im;
  const float* sf = L.sf;
  float* au = L.au;
  float* al = L.al;
  float* act = L.act;
  float* lam = L.lam;
  float* lstar = L.lstar;
  float* delta = L.delta;
  float* g = L.g;
  float* e = L.e;
  float* a = L.a;
  float* w = L.w;
  float* aux = L.aux;
  int* list = L.list;
  float* u_new = L.u_new;
  const float* dls = L.dls;
  const float* dus = L.dus;
  const float* rls = L.rls;
  const float* rus = L.rus;
  float* sfx = L.sfx;
  float* gb = L.gb;
  float* ab = L.ab;
  float* xs = L.xs;
  const int half = kDenseWarps * kDenseRed;
  int rb = 0;                       // the scratch half of the next reduction
  auto red = [&]() { rb ^= 1; return L.red + (rb ^ 1) * half; };
  __syncthreads();

  // d_W with, under SOFT_WEIGHTS, the FREE soft slacks' shift
  // (pallas_batch.py:315-319)
  auto d_w = [&](int i, float ai) {
    float d = au[i] * du[i] + al[i] * dl[i];
    if (has_sw)
      d += ai * sf[i] * (1.f - sfx[i]) *
           (al[i] * (rls[i] * dls[i]) - au[i] * (rus[i] * dus[i]));
    return d;
  };

  // round prologue: act, d_W, the active list and the lane's smallest
  // per-side weight over its soft rows, the clamp of the add gate under
  // SOFT_WEIGHTS (pallas_batch.py:257, :667-670)
  for (int i = t; i < m; i += kDenseThreads) {
    const float ai = au[i] + al[i];
    act[i] = ai;
    aux[i] = d_w(i, ai);
  }
  __syncthreads();
  if (wid == kLast) build_list<kSW>(L, act, m);
  float rho_min = kBig;
  {
    float s0[1] = {0.f}, mx0 = -INFINITY, av[2] = {INFINITY, INFINITY};
    int ai[2] = {INT_MAX, INT_MAX};
    if (has_sw)
      for (int i = t; i < m; i += kDenseThreads) {
        const float v = sf[i] > 0.f ? fminf(rls[i], rus[i]) : kBig;
        if (better(v, i, av[0], ai[0])) { av[0] = v; ai[0] = i; }
      }
    dense_reduce<1, 1, false>(s0, mx0, av, ai, red());
    rho_min = av[0];
  }
  int k = reinterpret_cast<const int*>(L.cnt)[0];
  // the pending Gram column g_p = M (M' po) o act (:313-323), then
  // lam* = -E d_W and a_p = E g_p (:325-326) on the active block
  {
    const int pi = static_cast<int>(pid);
    const bool has_p = pd > 0.f && pi >= 0 && pi < m;
    for (int base = 0; base < m; base += kDenseThreads) {
      float acc[kG] = {};
      if (has_p && base + g8 < m)
        rows_dot8(acc, M, ldn, m, n, base + g8, q,
                  [&](int j) { return M[pi * ldn + j]; });
      const float sp = has_p ? transpose_sum8(acc, q) : 0.f;
      const int i = base + t;
      if (i < m) {
        g[i] = pd * sp * act[i];
        if (!(act[i] > 0.f)) {
          lstar[i] = 0.f;
          a[i] = 0.f;
        }
      }
    }
    __syncthreads();
    for (int base = 0; base < k; base += kDenseThreads) {
      const int p0 = base + v8;
      float s1[kG] = {}, s2[kG] = {};
      if (p0 < k) {
        int off[kG];
#pragma unroll
        for (int p = 0; p < kG; ++p) off[p] = list[min(p0 + p, k - 1)] * ldm;
        for (int c = q; c < k; c += kG) {
          const int j = list[c];
          const float dj = aux[j], gj = g[j];
#pragma unroll
          for (int p = 0; p < kG; ++p) {
            const float eij = E[off[p] + j];
            s1[p] += eij * dj;
            s2[p] += eij * gj;
          }
        }
      }
      const float l1 = transpose_sum8(s1, q), l2 = transpose_sum8(s2, q);
      if (base + vt < k) {
        const int i = list[base + vt];
        lstar[i] = -l1;
        a[i] = l2;
      }
    }
    __syncthreads();
  }
  int kU = k;                      // the list's length as the update left it

  for (int step = 0; step < steps; ++step) {
    const int pi = static_cast<int>(pid);
    const bool has_p = pd > 0.f && pi >= 0 && pi < m;
    const float sgn_p = 1.f - 2.f * plo;

    // blocking min-ratio search over active mutable rows (:333-374; under
    // SOFT_WEIGHTS on the slack dual with the skip rules and the kink
    // guard), the soft slack, and u = -M'(lam* o act) (:415-427) over the
    // rows the last update touched (a superset of the active ones)
    float r1[2] = {0.f, 0.f};
    float mx = -INFINITY;
    float amin[2] = {INFINITY, INFINITY};
    int aidx[2] = {INT_MAX, INT_MAX};
    for (int i = t; i < m; i += kDenseThreads) {
      const float sdir = -a[i] * sgn_p;
      const float di = pd * sdir + (1.f - pd) * (lstar[i] - lam[i]);
      const float signv = pd * sdir + (1.f - pd) * lstar[i];
      delta[i] = di;
      float elig, ratio;
      if (has_sw) {
        const float fw = 1.f - sfx[i], fx = sfx[i];
        const float neg = flag(di < 0.f), pos = flag(di > 0.f);
        const float sk_lo_f =
            flag(di < tol.dtol || signv <= -dls[i] + tol.dtol);
        const float sk_lo_x =
            flag(signv <= tol.dtol && signv + tol.dtol >= -dls[i]) *
            (1.f - pd);
        const float sk_up_f = flag(di > -tol.dtol || signv >= dus[i]);
        const float sk_up_x =
            flag(signv >= -tol.dtol && signv <= tol.dtol + dus[i]) *
            (1.f - pd);
        const float kt_us = fmaxf(tol.dtol, kEpsK * (1.f + fabsf(dus[i])));
        const float kt_ls = fmaxf(tol.dtol, kEpsK * (1.f + fabsf(dls[i])));
        const float at_us = flag(fabsf(lam[i] - dus[i]) <= kt_us);
        const float at_ls = flag(fabsf(lam[i] + dls[i]) <= kt_ls);
        const float kink = sf[i] * (al[i] * at_ls * (fw + fx * neg) +
                                    au[i] * at_us * (fw + fx * pos));
        const float skip = al[i] * (fw * sk_lo_f + fx * sk_lo_x) +
                           au[i] * (fw * sk_up_f + fx * sk_up_x) + kink;
        const float lam_slack = lam[i] + al[i] * dls[i] * (fw + fx * neg) -
                                au[i] * dus[i] * (fw + fx * pos);
        elig = act[i] * (1.f - im[i]) * flag(skip < 0.5f);
        ratio = -lam_slack / di;
      } else {
        const float infeas = al[i] * flag(signv > tol.dtol) +
                             (1.f - al[i]) * flag(signv < -tol.dtol);
        elig = infeas * act[i] * (1.f - im[i]);
        ratio = -lam[i] / di;
      }
      ratio = isfinite(ratio) ? fmaxf(ratio, 0.f) : 0.f;
      const float cand = elig > 0.f ? ratio : kBig;
      if (better(cand, i, amin[0], aidx[0])) { amin[0] = cand; aidx[0] = i; }
      if (has_sw)
        r1[1] += sf[i] * act[i] * (al[i] * rls[i] + au[i] * rus[i]) *
                 lstar[i] * lstar[i];
      else if (has_soft)
        r1[1] += sf[i] * act[i] * lstar[i] * lstar[i];
    }
    for (int base = 0; base < n; base += kDenseThreads) {
      const int j0 = base + v8;
      float acc[kG] = {};
      if (j0 < n)
        for (int c = q; c < kU; c += kG) {
          const int i = list[c];
          const float v = lstar[i] * act[i];
          const float* Mi = M + i * ldn + j0;    // columns past n dropped
#pragma unroll
          for (int p = 0; p < kG; ++p) acc[p] += Mi[p] * v;
        }
      const float s = transpose_sum8(acc, q);
      const int j = base + vt;
      if (j < n) {
        u_new[j] = -s;
        r1[0] += s * s;
      }
    }
    __syncthreads();

    // the last warp lists this step's active rows; pricing on mu = M u, upper
    // side first, first row on ties (:428-444), mu only where a row can
    // enter; then one reduction for both searches and both sums
    if (wid == kLast) build_list<kSW>(L, act, m);
    for (int base = 0; base < m; base += kDenseThreads) {
      float acc[kG] = {};
      if (base + g8 < m)
        rows_dot8(acc, M, ldn, m, n, base + g8, q,
                  [&](int j) { return u_new[j]; });
      const float mu = transpose_sum8(acc, q);
      const int i = base + t;
      if (i < m) {
        const bool blocked = act[i] > 0.f || im[i] > 0.f ||
                             (has_p && i == pi);
        const float bound = -tol.ptol * sc[i];
        const float v_up = du[i] - mu;
        const float v_lo = mu - dl[i];
        const bool up_ok = v_up < bound && !blocked;
        const bool lo_ok = v_lo < bound && !blocked && !up_ok;
        float cand = up_ok ? v_up : (lo_ok ? v_lo : kBig);
        if (tol.bland)
          cand = (up_ok || lo_ok) ? static_cast<float>(i) - kBig : kBig;
        aux[i] = lo_ok ? 1.f : 0.f;
        if (better(cand, i, amin[1], aidx[1])) { amin[1] = cand; aidx[1] = i; }
      }
    }
    dense_reduce<2, 2, false>(r1, mx, amin, aidx, red());
    const float rmin = amin[0], vmin = amin[1];
    const int rm = aidx[0], jr = aidx[1];
    k = reinterpret_cast<const int*>(L.cnt)[0];
    const float r2[2] = {L.cnt[1], L.cnt[2]};
    const float soft_slack = has_sw ? r1[1] : (has_soft ? rho * r1[1] : 0.f);
    const float fv_new = r1[0] + soft_slack;
    const float found = vmin < 0.f ? 1.f : 0.f;
    const float j_lo = aux[jr];

    // under SOFT_WEIGHTS the pending entry's own slack transition is one
    // more candidate; ties go to the rows (:375-409)
    float pend_block = 0.f, step0 = 0.f;
    if (has_sw) {
      const float p_dls = has_p ? pd * dls[pi] : 0.f;
      const float p_dus = has_p ? pd * dus[pi] : 0.f;
      const float p_soft = has_p ? pd * sf[pi] : 0.f;
      const float p_imm = has_p ? pd * im[pi] : 0.f;
      const float p_free = 1.f - pfx;
      const float p_neg = flag(sgn_p < 0.f), p_pos = flag(sgn_p > 0.f);
      const float pskip =
          plo * p_free * flag(sgn_p < tol.dtol || sgn_p <= -p_dls + tol.dtol) +
          (1.f - plo) * p_free * flag(sgn_p > -tol.dtol || sgn_p >= p_dus);
      const float pkt_us = fmaxf(tol.dtol, kEpsK * (1.f + fabsf(p_dus)));
      const float pkt_ls = fmaxf(tol.dtol, kEpsK * (1.f + fabsf(p_dls)));
      const float p_at_us = flag(fabsf(plm - p_dus) <= pkt_us);
      const float p_at_ls = flag(fabsf(plm + p_dls) <= pkt_ls);
      const float pkink = p_soft * (plo * p_at_ls * (p_free + pfx * p_neg) +
                                    (1.f - plo) * p_at_us *
                                        (p_free + pfx * p_pos));
      const float p_lam_slack = plm + plo * p_dls * (p_free + pfx * p_neg) -
                                (1.f - plo) * p_dus * (p_free + pfx * p_pos);
      const float p_ratio = max_nan(-p_lam_slack / sgn_p, 0.f);
      const float p_elig = pd * (1.f - p_imm) * flag(pskip + pkink < 0.5f);
      const float pend_cand = p_elig > 0.f ? p_ratio : kBig;
      pend_block = flag(pend_cand < rmin && pend_cand < kBig);
      step0 = pend_block > 0.f ? (pend_cand < kBig ? pend_cand : 0.f)
                               : (rmin < kBig ? rmin : 0.f);
    }
    const float do_rm0 = (1.f - pend_block) * flag(rmin < kBig);

    // add candidate: pending retry after a removal, or the priced row
    // (:452-495); under SOFT_WEIGHTS also the blocker re-add and the
    // blocked pending entry's re-add (:446-485).  add_w is the weight of
    // its one-hot (0 or 1)
    const float retry = pd * do_rm0;
    const float price0 = (1.f - do_rm0) * (1.f - pd);
    const float padd0 = price0 * found;
    float add_w, add_lo, add_lam, add_id;
    int add_i;
    float ls_rm = 0.f, rm_sf = 0.f, rm_lo = 0.f, rm_fix = 0.f;
    float pend_readd = 0.f, sw_readd = 0.f, both0 = 0.f;
    if (has_sw) {
      // the step goes just past the transition (:458-461)
      const float alpha0 = (do_rm0 + pend_block) * step0 * 1.001f;
      ls_rm = lam[rm] + alpha0 * delta[rm] * act[rm];
      const float plm_new = plm + alpha0 * sgn_p * pd;
      rm_sf = sf[rm];
      rm_lo = al[rm];
      rm_fix = sfx[rm];
      const float crossed =
          rm_lo * flag(ls_rm > 0.f) + (1.f - rm_lo) * flag(ls_rm < 0.f);
      const float pend_crossed =
          plo * flag(plm_new > 0.f) + (1.f - plo) * flag(plm_new < 0.f);
      pend_readd = pend_block * (1.f - pend_crossed);
      sw_readd = do_rm0 * (1.f - pd) * rm_sf * (1.f - crossed);
      both0 = retry * rm_sf * (1.f - crossed) * rm_fix;
      const float pend_take = retry + pend_readd;
      add_w = pend_take + sw_readd + padd0;
      add_i = pend_take > 0.f ? pi : (sw_readd > 0.f ? rm : jr);
      add_lo = pend_take * plo + sw_readd * rm_lo + padd0 * j_lo;
      add_lam = pend_take * plm_new + sw_readd * ls_rm +
                padd0 * (1.f - 2.f * j_lo);
      add_id = pend_take * pid + sw_readd * static_cast<float>(rm) +
               padd0 * static_cast<float>(jr);
    } else {
      add_w = retry + padd0;
      add_i = retry > 0.f ? pi : jr;
      add_lo = retry * plo + padd0 * j_lo;
      add_lam = retry * plm + padd0 * (1.f - 2.f * j_lo);
      add_id = retry * pid + padd0 * static_cast<float>(jr);
    }
    const float add_soft = has_soft ? add_w * sf[add_i] : 0.f;
    const bool add_was_act = act[add_i] > 0.f;
    const float* mj = M + add_i * ldn;          // times add_w
    const float* mb = M + rm * ldn;             // the blocker's row

    // Gram column of the add, g_k = (M m_j) o act o keep0, and the removed
    // column e = E[:, rm] (:490-504); under SOFT_WEIGHTS the blocker's
    // g_bk, its unkept entry g[rm] and ||m_rm||^2 (:498-502)
    for (int base = 0; base < m; base += kDenseThreads) {
      const int r0 = base + g8;
      float acc[kG] = {}, accb[kG] = {};
      if (r0 < m) {
        int off[kG];
#pragma unroll
        for (int p = 0; p < kG; ++p) off[p] = min(r0 + p, m - 1) * ldn;
        for (int j = q; j < n; j += kG) {
          const float xj = add_w * mj[j];
          const float bj = has_sw ? mb[j] : 0.f;
#pragma unroll
          for (int p = 0; p < kG; ++p) {
            const float mij = M[off[p] + j];
            acc[p] += mij * xj;
            if (has_sw) accb[p] += mij * bj;
          }
        }
      }
      const float s = transpose_sum8(acc, q);
      const float sb = has_sw ? transpose_sum8(accb, q) : 0.f;
      const int i = base + t;
      if (i < m) {
        const float keep0 = 1.f - (i == rm ? 1.f : 0.f) * do_rm0;
        g[i] = s * act[i] * keep0;
        e[i] = E[i * ldm + rm];
        if (has_sw) {
          gb[i] = sb * act[i] * keep0;
          if (i == rm) {
            xs[0] = s * act[i];
            xs[1] = sb;
          }
        }
      }
    }
    __syncthreads();

    // E pass 2 on the active block: a_pre = E g_k [, ab_pre = E g_bk]
    // (:504-515); e.g_k [, e.g_bk], max|e| and ||m_j||^2
    for (int base = 0; base < k; base += kDenseThreads) {
      const int p0 = base + v8;
      float acc[kG] = {}, accb[kG] = {};
      if (p0 < k) {
        int off[kG];
#pragma unroll
        for (int p = 0; p < kG; ++p) off[p] = list[min(p0 + p, k - 1)] * ldm;
        for (int c = q; c < k; c += kG) {
          const int j = list[c];
          const float gj = g[j], gbj = has_sw ? gb[j] : 0.f;
#pragma unroll
          for (int p = 0; p < kG; ++p) {
            const float eij = E[off[p] + j];
            acc[p] += eij * gj;
            if (has_sw) accb[p] += eij * gbj;
          }
        }
      }
      const float s = transpose_sum8(acc, q);
      const float sb = has_sw ? transpose_sum8(accb, q) : 0.f;
      if (base + vt < k) {
        const int i = list[base + vt];
        a[i] = s;
        if (has_sw) ab[i] = sb;
      }
    }
    float r3[3] = {0.f, 0.f, 0.f};
    float emax = -INFINITY;
    for (int i = t; i < m; i += kDenseThreads) {
      r3[0] += e[i] * g[i];
      if (has_sw) r3[2] += e[i] * gb[i];
      emax = max_nan(emax, fabsf(e[i]));
    }
    for (int j = t; j < n; j += kDenseThreads) {
      const float v = add_w * mj[j];
      r3[1] += v * v;
    }
    dense_reduce<3, 0, true>(r3, emax, amin, aidx, red());
    const float err = e[rm];
    const bool bad = do_rm0 > 0.f && err < tol.pivtol * emax;
    if (bad) stt = kRefactor;
    const float do_rm = bad ? 0.f : do_rm0;
    const float err_s = err != 0.f ? err : 1.f;
    const float ec = r3[0] / err_s;
    const float ecb = r3[2] / err_s;
    const float alpha = has_sw ? (do_rm + pend_block) * step0 * 1.001f
                               : do_rm * (rmin < kBig ? rmin : 0.f);
    const float rm_soft = do_rm * sf[rm];

    // post-deletion Schur vector(s) and the dual line step (:513-533);
    // under SOFT_WEIGHTS also g_bk.ab_post and w_b.g_k (:606-635).  E is
    // zero off the active block, so a_pre and ab_pre are zero there
    float r4[3] = {0.f, 0.f, 0.f};
    for (int i = t; i < m; i += kDenseThreads) {
      const bool on = act[i] > 0.f;
      const float keep = 1.f - (i == rm ? 1.f : 0.f) * do_rm;
      const float ap = on ? keep * (a[i] - do_rm * e[i] * ec) : 0.f;
      a[i] = ap;
      lam[i] = (lam[i] + alpha * delta[i] * act[i]) * keep;
      au[i] *= keep;
      al[i] *= keep;
      r4[0] += g[i] * ap;
      if (has_sw) {
        const float abp = on ? keep * (ab[i] - do_rm * e[i] * ecb) : 0.f;
        ab[i] = abp;
        r4[1] += gb[i] * abp;
        r4[2] += (i == rm ? -1.f : abp * act[i]) * g[i];
      }
    }
    if (has_sw)
      dense_reduce<3, 0, false>(r4, mx, amin, aidx, red());
    else {
      float r4p[1] = {r4[0]};
      dense_reduce<1, 0, false>(r4p, mx, amin, aidx, red());
      r4[0] = r4p[0];
    }
    plm = plm + alpha * sgn_p * pd;

    // exits (:535-563); a pending-transition block is not stuck
    if (stt == kRunning && pd > 0.f && do_rm == 0.f && pend_block == 0.f)
      stt = rp > 0.f ? kInfeasible : kCycle;
    if (price0 > 0.f && stt == kRunning && fv_new > fb) stt = kInfeasible;
    const float price = stt == kRunning ? price0 : 0.f;
    if (price > 0.f && found == 0.f)
      stt = (has_soft && soft_slack > tol.ptol) ? kSoftOptimal : kOptimal;
    const bool no_prog = fv_new - bf < tol.progtol * (1.f + fabsf(fv_new));
    if (price > 0.f) {
      cy = no_prog ? cy + 1.f : 0.f;
      if (!no_prog) bf = fv_new;
      if (cy > tol.cyctol && stt == kRunning) stt = kCycle;
      fv = fv_new;
    }
    const float padd = stt == kRunning ? padd0 : 0.f;

    // Schur complement, the relative gate and the rank cap, counted after
    // the removal (:572-677)
    float dii, sval, kk, ns_act, gate;
    float free_main = 0.f, ok_b = 0.f, c_b = 0.f, cross = 0.f;
    if (has_sw) {
      // per-side weight on the diagonal when the entering slack is FREE;
      // the re-add paths enter flipped (:573-593)
      const float rho_side =
          add_lo * (add_w * rls[add_i]) + (1.f - add_lo) * (add_w * rus[add_i]);
      const float d_ls_add = add_w * dls[add_i];
      const float d_us_add = add_w * dus[add_i];
      const float free_der = add_lo * flag(add_lam <= -d_ls_add) +
                             (1.f - add_lo) * flag(add_lam >= d_us_add);
      const float override_ = sw_readd + pend_readd;
      const float free_val = pend_readd * pfx + sw_readd * rm_fix;
      free_main = override_ * free_val + (1.f - override_) * free_der;
      const float contributes = add_soft * free_main;
      dii = r3[1] + rho_side * contributes;
      // the double add: the blocker re-enters FREE after its own deletion
      // (:600-641); a singular both-add is skipped, not parked
      const float rho_b = rm_lo * rls[rm] + (1.f - rm_lo) * rus[rm];
      const float dii_b = xs[1] + rho_b;
      const float sval_b = dii_b - r4[1];
      const float both = bad ? 0.f : both0;
      const float k_rm = r2[0] - do_rm;
      const float fs_cnt = r2[1];
      const float fs_rm = do_rm * rm_sf * (1.f - rm_fix);
      const float gate_b =
          fmaxf(tol.singtol, fminf(1e-4f * dii_b, 0.25f * rho_b));
      const bool sing_b =
          sval_b < gate_b ||
          k_rm >= static_cast<float>(n_true) + fs_cnt - fs_rm + 1.f;
      ok_b = sing_b ? 0.f : both;
      c_b = ok_b / (sval_b != 0.f ? sval_b : 1.f);
      const float g_rm = xs[0];
      cross = r4[2] - ok_b * g_rm;
      // a_main = a_post + c_b w_b cross, with w_b[rm] = -1
      const float a_main_rm = a[rm] + c_b * -1.f * cross;
      sval = dii - ((r4[0] + c_b * cross * r4[2]) + ok_b * g_rm * a_main_rm);
      kk = k_rm + ok_b;
      // the rank cap counts FREE soft actives only
      ns_act = fs_cnt - fs_rm + ok_b + contributes;
      gate = fmaxf(tol.singtol, fminf(1e-4f * dii, 0.25f * rho_min));
    } else {
      dii = r3[1] + rho * add_soft;
      sval = dii - r4[0];
      kk = r2[0] - do_rm;
      ns_act = has_soft ? r2[1] - rm_soft + add_soft : 0.f;
      float rel = 1e-4f * dii;
      if (has_soft) rel = fminf(rel, 0.25f * rho);
      gate = fmaxf(tol.singtol, rel);
    }
    const bool sing =
        sval < gate || kk >= static_cast<float>(n_true) + ns_act;
    const float do_add =
        (has_sw ? retry + pend_readd + sw_readd : retry) * (bad ? 0.f : 1.f) +
        padd;
    const float ok = sing ? 0.f : do_add;
    const float mk_pend = sing ? do_add : 0.f;
    const float c_del = -do_rm / err_s;
    const float c_add = ok / (sval != 0.f ? sval : 1.f);
    const bool appended = ok > 0.f && !add_was_act;

    // the pending entry for the next step
    if (has_sw) {
      pd = fminf(pd * (1.f - retry) * (1.f - pend_block) + mk_pend, 1.f);
      if (mk_pend > 0.f) pfx = 1.f - free_main;
    } else {
      pd = fminf((1.f - retry) * pd + mk_pend, 1.f);
    }
    if (mk_pend > 0.f) {
      pid = add_id;
      plm = add_lam;
      plo = add_lo;
    }
    // the last step of the round leaves lam* as it is: it is the record
    const bool last = stt != kRunning || step + 1 == steps;
    const int pi_n = static_cast<int>(pid);
    const bool has_pn = !last && pd > 0.f && pi_n >= 0 && pi_n < m;

    // row bookkeeping: lam <- lam* before a priced add, the add's Schur
    // border w, the masks (:565-570, :685-710); under SOFT_WEIGHTS the
    // blocker re-add first, w_b into ab, and sfix.  Then the next step's
    // act, d_W and g_p = M (M' po) o act; rows the update does not touch
    // get lam* = a_p = 0
    for (int base = 0; base < m; base += kDenseThreads) {
      float acc[kG] = {};
      if (has_pn && base + g8 < m)
        rows_dot8(acc, M, ldn, m, n, base + g8, q,
                  [&](int j) { return M[pi_n * ldn + j]; });
      const float sp = has_pn ? transpose_sum8(acc, q) : 0.f;
      const int i = base + t;
      if (i >= m) continue;
      const float act_i = act[i];
      if (padd > 0.f) lam[i] = lstar[i] * act_i;
      const float oh = (i == add_i ? 1.f : 0.f) * add_w;
      if (has_sw) {
        const float ohb = i == rm ? 1.f : 0.f;
        const float wbi = i == rm ? -1.f : ab[i] * act_i;
        ab[i] = wbi;
        w[i] = oh > 0.f ? -1.f : (a[i] + c_b * wbi * cross) * act_i;
        au[i] = fminf(au[i] + ok_b * ohb * (1.f - rm_lo), 1.f);
        al[i] = fminf(al[i] + ok_b * ohb * rm_lo, 1.f);
        lam[i] = lam[i] + ok_b * ohb * ls_rm;
        sfx[i] = sfx[i] * (1.f - ok_b * ohb);
      } else {
        w[i] = oh > 0.f ? -1.f : a[i] * act_i;
      }
      au[i] = fminf(au[i] + ok * oh * (1.f - add_lo), 1.f);
      al[i] = fminf(al[i] + ok * oh * add_lo, 1.f);
      lam[i] = lam[i] + ok * oh * add_lam;
      if (has_sw)
        sfx[i] = sfx[i] * (1.f - ok * oh) + ok * oh * (1.f - free_main);
      if (!last) {
        const float ai = au[i] + al[i];
        act[i] = ai;
        aux[i] = d_w(i, ai);
        g[i] = pd * sp * ai;
        if (!(act_i > 0.f) && !(i == add_i && appended)) {
          lstar[i] = 0.f;
          a[i] = 0.f;
        }
      }
    }
    if (price > 0.f)
      for (int j = t; j < n; j += kDenseThreads) L.u[j] = u_new[j];
    if (appended && t == 0) list[k] = add_i;
    kU = k + (appended ? 1 : 0);
    __syncthreads();

    // E <- (E + c_del e e') o keep keep' [+ c_b w_b w_b'] + c_add w w'
    // (:271-287, :686-699) on the touched block, 8 rows to a group of
    // lanes and columns by lane; from the new values the next step's
    // lam* = -E d_W and a_p = E g_p (:325-326)
    for (int base = 0; base < kU; base += kDenseThreads) {
      const int p0 = base + v8;
      float s1[kG] = {}, s2[kG] = {};
      if (p0 < kU) {
        const int rm_off = rm * ldm;
        const float k_rm = 1.f - do_rm;
        int off[kG];
        float ce[kG], ca[kG], cb[kG];
#pragma unroll
        for (int p = 0; p < kG; ++p) {
          const int i = list[min(p0 + p, kU - 1)];
          off[p] = i * ldm;
          ce[p] = c_del * e[i];
          ca[p] = c_add * w[i];
          cb[p] = has_sw ? c_b * ab[i] : 0.f;
        }
        for (int c = q; c < kU; c += kG) {
          const int j = list[c];
          const float kj = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
          const float ej = e[j], wj = w[j], dj = aux[j], gj = g[j];
          const float bj = has_sw ? ab[j] : 0.f;
#pragma unroll
          for (int p = 0; p < kG; ++p) {
            float* ep = E + off[p] + j;
            const float ki = off[p] == rm_off ? k_rm : 1.f;
            float v = (*ep + ce[p] * ej) * ki * kj;
            if (has_sw) v = v + cb[p] * bj;
            v = v + ca[p] * wj;
            if (p0 + p < kU) *ep = v;
            s1[p] += v * dj;
            s2[p] += v * gj;
          }
        }
      }
      if (!last) {
        const float l1 = transpose_sum8(s1, q), l2 = transpose_sum8(s2, q);
        if (base + vt < kU) {
          const int i = list[base + vt];
          lstar[i] = -l1;
          a[i] = l2;
        }
      }
    }
    __syncthreads();
    it += 1.f;
    if (stt != kRunning) break;
  }

  // write the lane's state back
  for (int i = wid; i < m; i += kDenseWarps)
    for (int j = lane; j < m; j += 32)
      out(E_)[b * mm + static_cast<size_t>(i) * m + j] = E[i * ldm + j];
  for (int i = t; i < m; i += kDenseThreads) {
    out(AU_)[b * m + i] = au[i];
    out(AL_)[b * m + i] = al[i];
    out(LAM_)[b * m + i] = lam[i];
    out(LS_)[b * m + i] = lstar[i];
    if (has_sw) sw_out(SFX_O_)[b * m + i] = sfx[i];
  }
  for (int j = t; j < n; j += kDenseThreads) out(U_)[b * n + j] = L.u[j];
  if (t == 0) {
    out(PD_)[b] = pd;
    out(PID_)[b] = pid;
    out(PLM_)[b] = plm;
    out(PLO_)[b] = plo;
    out(FV_)[b] = fv;
    out(BF_)[b] = bf;
    out(CY_)[b] = cy;
    out(RP_)[b] = rp;
    out(IT_)[b] = it;
    reinterpret_cast<int*>(out(STT_))[b] = stt;
    if (has_sw) sw_out(PFX_O_)[b] = pfx;
  }
}

}  // namespace

extern "C" int dense_round_f32(const void* const* ptrs, int B, int m, int n,
                               int n_true, int steps, float dual_tol,
                               float primal_tol, float pivot_tol,
                               float sing_tol, float progress_tol,
                               float cycle_tol, int bland, float rho_soft,
                               int has_soft, int has_sw, void* stream) {
  Ptrs P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  const DenseTol dt{{dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol,
                     cycle_tol, bland},
                    rho_soft, has_soft, has_sw};
  const size_t smem = dense_smem_floats(m, n, has_sw != 0) * sizeof(float);
  auto kernel = has_sw ? dense_round_kernel<true> : dense_round_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  kernel<<<B, kDenseThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, m, n, n_true, steps, dt);
  return static_cast<int>(cudaGetLastError());
}
