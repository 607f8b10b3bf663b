// B6: P adaptive-eps LP outer passes per launch, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:1468 run_lp_segment
// (pallas_call at :1522; kernel body _lp_kernel_body, :1191-1465), the LP
// regime of daqp_prox.c:21-271 with Rinv = I.  Per lane and pass, while the
// lane runs (lane_run > 0 and not failed):
//   v = f eps - x, d = b_s + M v, dsl refreshed from sid/slo, the per-solve
//   control reset, the shared slot step (slot_step.cuh) with the in-kernel
//   cold retry; x_new = u - v; the fixed-point test ||x_new - x||_inf <
//   eta eps; the stagnation count on ||x_new - x||_inf / eps (a vertex pass
//   of one iteration that does not improve best by 10% counts; three
//   converge); then the gradient step (daqp_prox.c:201-271, :1363-1420) on
//   a lane whose one-iteration solve left it off a vertex: along x_new +
//   alpha (x_new - x), the first blocking bound of an original row that is
//   neither active nor immutable (A x = M x / scaling against the raw
//   bounds; lowest row on ties, the lower side only where its step is
//   strictly shorter) is activated by a bordered add into the first free
//   slot, gated by sval >= max(sing_tol, 1e-4 |m_j|^2) and the slot count;
//   a lane with no blocking row exits UNBOUNDED.  eps x10 on an interior
//   stall, x0.9 otherwise, capped at 1e3, from the lane's second pass on;
//   a lane exiting on an inner failure keeps its last x; tot += iterations.
// A lane whose inner solve ends RUNNING, CYCLE or REFACTOR after the retry
// raises `failed`, keeps lane_run = 1 and does no further pass: the LP tier
// resumes it in the next launch.  A lane that stops is left as it is (the
// TPU kernel's tile keeps touching the stall and best carries of its
// stopped lanes while other lanes of the 128-lane tile run).
//
// What bounds it on an H100: latency, as for K2; each pass adds two m x n
// matrix-vector products (d, and the ray search's A x_new, A delta) and an
// O(K n + K^2) bordered add to a warm solve of a few steps.  The lane's
// state sits in shared memory (~6.5 KB at n = 10, m = 50), so a pass reads
// nothing from device memory.
//
// The per-pass probe (segment.cuh, chip_profile.py --probe k6) puts the
// step at ~95% of a pass at configLP, and the 128-thread step at 11.2k
// SM cycles there (PERF.md, section 6).
//
// Design: two bodies, chosen by the C entry.  Up to K, n = 32 (configLP
// has K = 11, n = 10), where its block fits, one warp runs an LP
// (lp_segment_warp_kernel) on the warp step of slot_warp.cuh, ~8.3k SM
// cycles a step at configLP; elsewhere one thread block of 128 runs an
// LP (lp_segment_kernel) on slot_step.cuh's step.  Both compute the same
// bits: the warp step keeps every sum of the 128-thread step in its
// chains and tree (slot_warp.cuh), and the pass's own work is, in both,
// one thread per product item summed in the order j = 0, 1, ..., its
// reductions in block_reduce's order.  Each LP's state is the step's
// layout (slot_carve, or slot_warp_carve) followed by the pass vectors;
// du / dl of the layout hold the pass's bounds.  After the solve, the
// step's scratch (g_k, a, w, lo_okv) serves the gradient step.  The
// 128-thread body's pass runs 5 barriers outside the step, 13 when it
// adds a row: products on groups of 8, 4, 2 lanes, ballots for the free
// slot, fewer barriers and copying a stopped lane global to global were
// measured no faster at configLP, and another sum order moved its
// slowest lane from 186 to 232 steps (PERF.md, section 6).
#include "slot_warp.cuh"

namespace {

constexpr int kUnbounded = -3;

// Pointer table, in the order of ops/slot.py run_lp_segment: SEG_CONST, fz,
// bus, bls, bur, blr, STATE, LP_LANE (in), STATE, LP_LANE (out), failed,
// and the last pass's bounds du, dl (B, m) or null.
enum Ptr {
  M_, SC_, IM_, SIMM_, FB_, FZ_, BUS_, BLS_, BUR_, BLR_,
  AU_, AL_, W_, E_, DSL_, USED_, SID_, SLO_, LAM_, LS_, PD_, PROW_, PLM_,
  PLO_, PID_, PDD_, U_, FV_, BF_, CY_, RP_, IT_, STT_,
  X_, EPS_, STL_, BD_, LR_, LF_, TT_, PS_,
  kNumIn,
  kNumState = kNumIn - AU_,
  FAIL_ = kNumIn + kNumState,
  DUO_,
  DLO_,
  kNumPtrs
};

struct Ptrs {
  const void* p[kNumPtrs];
};

__host__ __device__ inline size_t lp_smem_floats(int m, int n, int K) {
  return slot_smem_floats(m, n, K) + 5 * n + 4 * m;
}

// jnp.minimum: NaN if either side is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
lp_segment_kernel(Ptrs P, int m, int n, int K, int n_true, int steps, int nP,
                  Tol tol, float eta) {
  extern __shared__ float sm[];
  SEG_PROBE_INIT
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  const Lane L = slot_carve(sm, m, n, K);
  const int ldn = L.ldn, ldK = L.ldK;
  float* x = L.end;
  float* v = x + n;
  float* xn = v + n;             // x_new, then the point after the ray step
  float* dlt = xn + n;           // x_new - x
  float* fz = dlt + n;
  float* bus = fz + n;
  float* bls = bus + m;
  float* bur = bls + m;
  float* blr = bur + m;

  copy_rows_in(L.E, ldK, in(E_) + b * K * K, K, K);
  copy_rows_in(L.W, ldn, in(W_) + b * K * n, K, n);
  copy_rows_in(L.M, ldn, in(M_) + b * m * n, m, n);
  copy_vec(L.sc, in(SC_) + b * m, m);
  copy_vec(L.im, in(IM_) + b * m, m);
  copy_vec(bus, in(BUS_) + b * m, m);
  copy_vec(bls, in(BLS_) + b * m, m);
  copy_vec(bur, in(BUR_) + b * m, m);
  copy_vec(blr, in(BLR_) + b * m, m);
  copy_vec(L.au, in(AU_) + b * m, m);
  copy_vec(L.al, in(AL_) + b * m, m);
  copy_vec(L.dsl, in(DSL_) + b * K, K);
  copy_vec(L.used, in(USED_) + b * K, K);
  copy_vec(L.sid, in(SID_) + b * K, K);
  copy_vec(L.slo, in(SLO_) + b * K, K);
  copy_vec(L.simm, in(SIMM_) + b * K, K);
  copy_vec(L.lam, in(LAM_) + b * K, K);
  copy_vec(L.ls, in(LS_) + b * K, K);
  copy_vec(L.prow, in(PROW_) + b * n, n);
  copy_vec(L.u, in(U_) + b * n, n);
  copy_vec(x, in(X_) + b * n, n);
  copy_vec(fz, in(FZ_) + b * n, n);
  Ctl c;
  c.pd = in(PD_)[b];
  c.plm = in(PLM_)[b];
  c.plo = in(PLO_)[b];
  c.pid = in(PID_)[b];
  c.pdd = in(PDD_)[b];
  c.fv = in(FV_)[b];
  c.bf = in(BF_)[b];
  c.cy = in(CY_)[b];
  c.rp = in(RP_)[b];
  c.it = in(IT_)[b];
  c.stt = static_cast<const int*>(P.p[STT_])[b];
  c.fb = in(FB_)[b];
  float eps = in(EPS_)[b], stl = in(STL_)[b], bd = in(BD_)[b];
  float lr = in(LR_)[b], tt = in(TT_)[b], ps = in(PS_)[b];
  int lf = static_cast<const int*>(P.p[LF_])[b];
  bool failed = false;
  int p = 0;
  __syncthreads();
  SEG_PROBE_MARK(0)

  for (; p < nP && lr > 0.f && !failed; ++p) {
    // v = f eps - x, rounded after the product and after the difference
    // as the reference's expression (no fused multiply-add: with eps up to
    // 1e3, one rounding of v moves x_new = u - v by ~1e-4), and the pass's
    // bounds d = b_s + M v
    for (int j = t; j < n; j += kThreads)
      v[j] = __fsub_rn(__fmul_rn(fz[j], eps), x[j]);
    __syncthreads();
    for (int i = t; i < m; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += L.M[i * ldn + j] * v[j];
      L.du[i] = bus[i] + s;
      L.dl[i] = bls[i] + s;
    }
    __syncthreads();
    slot_refresh_dsl(L, m, K);
    ctl_reset(c);
    SEG_PROBE_MARK(1)
    slot_solve_retry(L, c, m, n, K, n_true, steps, tol);
    SEG_PROBE_MARK(2)
    failed = c.stt == kRunning || c.stt == kCycle || c.stt == kRefactor;
    const bool run2 = !failed;
    const bool inner_ok = c.stt > 0 && run2;

    // x_new = u - v, ||x_new - x||_inf and the slot count (:1348-1361)
    float r1[1] = {0.f};
    float md = -INFINITY, av = INFINITY;
    int ai = INT_MAX;
    for (int j = t; j < n; j += kThreads) {
      const float xj = L.u[j] - v[j];
      xn[j] = xj;
      dlt[j] = xj - x[j];
      md = max_nan(md, fabsf(xj - x[j]));
    }
    for (int k = t; k < K; k += kThreads) r1[0] += L.used[k];
    block_reduce<1>(r1, md, av, ai, L.red);
    const bool it1 = c.it <= 1.f;
    const bool at_vx = r1[0] >= static_cast<float>(n_true);
    bool converged = md < eta * eps;
    const float ndiff = md / eps;
    const bool improved = ndiff < 0.9f * bd;
    bd = min_nan(ndiff, bd);
    stl = (improved || !it1 || !at_vx || !run2) ? 0.f : stl + 1.f;
    converged = converged || (inner_ok && stl >= 3.f);
    const bool need = it1 && !at_vx && !converged && inner_ok;

    // the gradient step; every thread holds the same scalars, so the
    // branches below are uniform across the block
    bool found = false;
    if (need) {
      // ray search over the original rows (:1366-1386)
      float r2[1] = {0.f};
      float mx = -INFINITY, alpha = INFINITY;
      int jr = INT_MAX;
      for (int i = t; i < m; i += kThreads) {
        float sx = 0.f, sd = 0.f;
        for (int j = 0; j < n; ++j) {
          sx += L.M[i * ldn + j] * xn[j];
          sd += L.M[i * ldn + j] * dlt[j];
        }
        const float ax = sx / L.sc[i], ds = sd / L.sc[i];
        const bool skip = (L.au[i] + L.al[i]) > 0.f || L.im[i] > 0.f;
        const bool up_ok = !skip && ds > 0.f && bur[i] < kBig;
        const bool lo_ok = !skip && ds < 0.f && blr[i] > -kBig;
        const float a_up = up_ok ? (bur[i] - ax) / ds : kBig;
        const float a_lo = lo_ok ? (blr[i] - ax) / ds : kBig;
        L.lo_okv[i] = a_lo < a_up ? 1.f : 0.f;
        const float cand = min_nan(a_up, a_lo);
        if (better(cand, i, alpha, jr)) { alpha = cand; jr = i; }
      }
      block_reduce<1>(r2, mx, alpha, jr, L.red);
      found = alpha < kBig;
      if (found) {
        const float is_lo = L.lo_okv[jr];
        const float dval = is_lo > 0.f ? L.dl[jr] : L.du[jr];
        for (int j = t; j < n; j += kThreads)
          xn[j] = __fadd_rn(xn[j], __fmul_rn(alpha, dlt[j]));
        // bordered add of row jr (:1390-1420): g = W m_j, a = E g
        for (int k = t; k < K; k += kThreads) {
          float s = 0.f;
          for (int j = 0; j < n; ++j) s += L.W[k * ldn + j] * L.M[jr * ldn + j];
          L.g_k[k] = s * L.used[k];
        }
        __syncthreads();
        for (int k = t; k < K; k += kThreads) {
          float s = 0.f;
          for (int j = 0; j < K; ++j) s += L.E[k * ldK + j] * L.g_k[j];
          L.a[k] = s;
        }
        __syncthreads();
        // dii, g'a and the slot count; the first free slot
        float r3[3] = {0.f, 0.f, 0.f};
        float mx3 = -INFINITY, fv_free = INFINITY;
        int free_k = INT_MAX;
        for (int j = t; j < n; j += kThreads)
          r3[0] += L.M[jr * ldn + j] * L.M[jr * ldn + j];
        for (int k = t; k < K; k += kThreads) {
          r3[1] += L.g_k[k] * L.a[k];
          r3[2] += L.used[k];
          const float fc = static_cast<float>(k) + L.used[k] * kBig;
          if (better(fc, k, fv_free, free_k)) { fv_free = fc; free_k = k; }
        }
        block_reduce<3>(r3, mx3, fv_free, free_k, L.red);
        const float dii = r3[0];
        const float sval = dii - r3[1];
        const float gate = fmaxf(tol.singtol, 1e-4f * dii);
        const bool okadd = sval >= gate && r3[2] < static_cast<float>(n_true);
        if (okadd) {
          // sval >= gate > 0 here; the JAX code's zero guard is moot
          const float cadd = 1.f / sval;
          for (int k = t; k < K; k += kThreads)
            L.w[k] = L.a[k] * L.used[k] - (k == free_k ? 1.f : 0.f);
          __syncthreads();
          for (int idx = t; idx < K * K; idx += kThreads) {
            const int i = idx / K, j = idx % K;
            L.E[i * ldK + j] += cadd * L.w[i] * L.w[j];
          }
          for (int j = t; j < n; j += kThreads)
            L.W[free_k * ldn + j] += L.M[jr * ldn + j];
          if (t == 0) {
            L.used[free_k] = fminf(L.used[free_k] + 1.f, 1.f);
            L.sid[free_k] += static_cast<float>(jr) + 1.f;
            L.slo[free_k] += is_lo;
            L.dsl[free_k] += dval;
            L.lam[free_k] += 1.f - 2.f * is_lo;
            L.au[jr] = fminf(L.au[jr] + (1.f - is_lo), 1.f);
            L.al[jr] = fminf(L.al[jr] + is_lo, 1.f);
          }
        }
      }
      __syncthreads();
    }

    // adaptive eps, exits and the carries (:1422-1441)
    const bool unbounded = need && !found;
    const bool grow = it1 && !at_vx;
    if (ps > 0.f && run2) eps = min_nan(eps * (grow ? 10.f : 0.9f), 1e3f);
    const bool done = run2 && (converged || !(c.stt > 0) || unbounded);
    if (done) lf = unbounded ? kUnbounded : (c.stt > 0 ? kOptimal : c.stt);
    if (run2 && !(done && !(c.stt > 0)))
      for (int j = t; j < n; j += kThreads) x[j] = xn[j];
    if (done) lr = 0.f;
    tt += c.it;
    SEG_PROBE_STEPS(c.it)
    ps += 1.f;
    __syncthreads();
    SEG_PROBE_MARK(3)
    SEG_PROBE_PASS
  }

  copy_rows_out(out(E_) + b * K * K, L.E, ldK, K, K);
  copy_rows_out(out(W_) + b * K * n, L.W, ldn, K, n);
  for (int i = t; i < m; i += kThreads) {
    out(AU_)[b * m + i] = L.au[i];
    out(AL_)[b * m + i] = L.al[i];
  }
  if (P.p[DUO_] != nullptr && p > 0)
    for (int i = t; i < m; i += kThreads) {
      static_cast<float*>(const_cast<void*>(P.p[DUO_]))[b * m + i] = L.du[i];
      static_cast<float*>(const_cast<void*>(P.p[DLO_]))[b * m + i] = L.dl[i];
    }
  for (int k = t; k < K; k += kThreads) {
    out(DSL_)[b * K + k] = L.dsl[k];
    out(USED_)[b * K + k] = L.used[k];
    out(SID_)[b * K + k] = L.sid[k];
    out(SLO_)[b * K + k] = L.slo[k];
    out(LAM_)[b * K + k] = L.lam[k];
    out(LS_)[b * K + k] = L.ls[k];
  }
  for (int j = t; j < n; j += kThreads) {
    out(PROW_)[b * n + j] = L.prow[j];
    out(U_)[b * n + j] = L.u[j];
    out(X_)[b * n + j] = x[j];
  }
  if (t == 0) {
    out(PD_)[b] = c.pd;
    out(PLM_)[b] = c.plm;
    out(PLO_)[b] = c.plo;
    out(PID_)[b] = c.pid;
    out(PDD_)[b] = c.pdd;
    out(FV_)[b] = c.fv;
    out(BF_)[b] = c.bf;
    out(CY_)[b] = c.cy;
    out(RP_)[b] = c.rp;
    out(IT_)[b] = c.it;
    reinterpret_cast<int*>(out(STT_))[b] = c.stt;
    out(EPS_)[b] = eps;
    out(STL_)[b] = stl;
    out(BD_)[b] = bd;
    out(LR_)[b] = lr;
    reinterpret_cast<int*>(out(LF_))[b] = lf;
    out(TT_)[b] = tt;
    out(PS_)[b] = ps;
    static_cast<float*>(const_cast<void*>(P.p[FAIL_]))[b] =
        failed ? 1.f : 0.f;
  }
  SEG_PROBE_MARK(4)
  SEG_PROBE_FLUSH
}

// The warp body (K, n <= kWarpMaxK): a lane's state in the layout of
// slot_warp_carve followed by the arrays of lp_smem_floats.
__host__ __device__ inline size_t lp_warp_smem_floats(int m, int n, int K) {
  return slot_warp_smem_floats(m, n, K) + 5 * n + 4 * m;
}

// lp_segment_kernel with one warp a lane (a block) and the warp step
// (slot_warp.cuh); the pass's own work as there, one lane an item, and
// its reductions in block_reduce's order.
__global__ void __launch_bounds__(32)
lp_segment_warp_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                       int nP, Tol tol, float eta) {
  extern __shared__ float sm[];
  const int t = warp_lane();
  const size_t b = blockIdx.x;
  SEG_PROBE_INIT
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  const Lane L = slot_warp_carve(sm, m, n, K);
  const int ldn = L.ldn, ldK = L.ldK;
  float* x = L.end;
  float* v = x + n;
  float* xn = v + n;             // x_new, then the point after the ray step
  float* dlt = xn + n;           // x_new - x
  float* fz = dlt + n;
  float* bus = fz + n;
  float* bls = bus + m;
  float* bur = bls + m;
  float* blr = bur + m;

  warp_rows_async(L.E, ldK, in(E_) + b * K * K, K, K);
  warp_rows_async(L.W, ldn, in(W_) + b * K * n, K, n);
  warp_rows_async(L.M, ldn, in(M_) + b * m * n, m, n);
  warp_vec_async(L.sc, in(SC_) + b * m, m);
  warp_vec_async(L.im, in(IM_) + b * m, m);
  warp_vec_async(bus, in(BUS_) + b * m, m);
  warp_vec_async(bls, in(BLS_) + b * m, m);
  warp_vec_async(bur, in(BUR_) + b * m, m);
  warp_vec_async(blr, in(BLR_) + b * m, m);
  warp_vec_async(L.au, in(AU_) + b * m, m);
  warp_vec_async(L.al, in(AL_) + b * m, m);
  warp_vec_async(L.dsl, in(DSL_) + b * K, K);
  warp_vec_async(L.used, in(USED_) + b * K, K);
  warp_vec_async(L.sid, in(SID_) + b * K, K);
  warp_vec_async(L.slo, in(SLO_) + b * K, K);
  warp_vec_async(L.simm, in(SIMM_) + b * K, K);
  warp_vec_async(L.lam, in(LAM_) + b * K, K);
  warp_vec_async(L.ls, in(LS_) + b * K, K);
  warp_vec_async(L.prow, in(PROW_) + b * n, n);
  warp_vec_async(L.u, in(U_) + b * n, n);
  warp_vec_async(x, in(X_) + b * n, n);
  warp_vec_async(fz, in(FZ_) + b * n, n);
  Ctl c;
  c.pd = in(PD_)[b];
  c.plm = in(PLM_)[b];
  c.plo = in(PLO_)[b];
  c.pid = in(PID_)[b];
  c.pdd = in(PDD_)[b];
  c.fv = in(FV_)[b];
  c.bf = in(BF_)[b];
  c.cy = in(CY_)[b];
  c.rp = in(RP_)[b];
  c.it = in(IT_)[b];
  c.stt = static_cast<const int*>(P.p[STT_])[b];
  c.fb = in(FB_)[b];
  float eps = in(EPS_)[b], stl = in(STL_)[b], bd = in(BD_)[b];
  float lr = in(LR_)[b], tt = in(TT_)[b], ps = in(PS_)[b];
  int lf = static_cast<const int*>(P.p[LF_])[b];
  bool failed = false;
  int p = 0;
  cp_async_wait_all();
  __syncwarp();
  SEG_PROBE_MARK(0)

  for (; p < nP && lr > 0.f && !failed; ++p) {
    // v = f eps - x, rounded as the reference's expression, and the
    // pass's bounds d = b_s + M v
    for (int j = t; j < n; j += 32)
      v[j] = __fsub_rn(__fmul_rn(fz[j], eps), x[j]);
    __syncwarp();
    // two rows a lane at once (each its own sum)
    for (int i = t; i < m; i += 64) {
      const int i2 = i + 32 < m ? i + 32 : i;
      float s = 0.f, s2 = 0.f;
      for (int j = 0; j < n; ++j) {
        s += L.M[i * ldn + j] * v[j];
        s2 += L.M[i2 * ldn + j] * v[j];
      }
      L.du[i] = bus[i] + s;
      L.dl[i] = bls[i] + s;
      if (i + 32 < m) {
        L.du[i2] = bus[i2] + s2;
        L.dl[i2] = bls[i2] + s2;
      }
    }
    __syncwarp();
    warp_refresh_dsl(L, m, K);
    ctl_reset(c);
    SEG_PROBE_MARK(1)
    slot_warp_solve_retry(L, c, m, n, K, n_true, steps, tol);
    SEG_PROBE_MARK(2)
    failed = c.stt == kRunning || c.stt == kCycle || c.stt == kRefactor;
    const bool run2 = !failed;
    const bool inner_ok = c.stt > 0 && run2;

    // x_new = u - v, ||x_new - x||_inf and the slot count
    float r1[1] = {0.f};
    float md = -INFINITY;
    for (int j = t; j < n; j += 32) {
      const float xj = L.u[j] - v[j];
      xn[j] = xj;
      dlt[j] = xj - x[j];
      md = max_nan(md, fabsf(xj - x[j]));
    }
    if (t < K) r1[0] += L.used[t];        // K <= 32: warp 0's items
    warp_reduce<1, true>(r1, md);
    __syncwarp();
    // block_reduce's ((w0 + w1) + w2) + w3, the other warps' sums +0
    const float nused = ((r1[0] + 0.f) + 0.f) + 0.f;
    const bool it1 = c.it <= 1.f;
    const bool at_vx = nused >= static_cast<float>(n_true);
    bool converged = md < eta * eps;
    const float ndiff = md / eps;
    const bool improved = ndiff < 0.9f * bd;
    bd = min_nan(ndiff, bd);
    stl = (improved || !it1 || !at_vx || !run2) ? 0.f : stl + 1.f;
    converged = converged || (inner_ok && stl >= 3.f);
    const bool need = it1 && !at_vx && !converged && inner_ok;

    // the gradient step; the scalars are the warp's, so the branches
    // below are uniform across it
    bool found = false;
    if (need) {
      // ray search over the original rows
      float alpha = INFINITY;
      int jr = INT_MAX;
      for (int i = t; i < m; i += 32) {
        float sx = 0.f, sd = 0.f;
        for (int j = 0; j < n; ++j) {
          sx += L.M[i * ldn + j] * xn[j];
          sd += L.M[i * ldn + j] * dlt[j];
        }
        const float ax = sx / L.sc[i], ds = sd / L.sc[i];
        const bool skip = (L.au[i] + L.al[i]) > 0.f || L.im[i] > 0.f;
        const bool up_ok = !skip && ds > 0.f && bur[i] < kBig;
        const bool lo_ok = !skip && ds < 0.f && blr[i] > -kBig;
        const float a_up = up_ok ? (bur[i] - ax) / ds : kBig;
        const float a_lo = lo_ok ? (blr[i] - ax) / ds : kBig;
        L.lo_okv[i] = a_lo < a_up ? 1.f : 0.f;
        const float cand = min_nan(a_up, a_lo);
        if (better(cand, i, alpha, jr)) { alpha = cand; jr = i; }
      }
      warp_argmin(alpha, jr);
      __syncwarp();
      found = alpha < kBig;
      if (found) {
        const float is_lo = L.lo_okv[jr];
        const float dval = is_lo > 0.f ? L.dl[jr] : L.du[jr];
        for (int j = t; j < n; j += 32)
          xn[j] = __fadd_rn(xn[j], __fmul_rn(alpha, dlt[j]));
        // bordered add of row jr: g = W m_j, a = E g
        for (int k = t; k < K; k += 32) {
          float s = 0.f;
          for (int j = 0; j < n; ++j)
            s += L.W[k * ldn + j] * L.M[jr * ldn + j];
          L.g_k[k] = s * L.used[k];
        }
        __syncwarp();
        for (int k = t; k < K; k += 32) {
          float s = 0.f;
          for (int j = 0; j < K; ++j) s += L.E[k * ldK + j] * L.g_k[j];
          L.a[k] = s;
        }
        __syncwarp();
        // dii, g'a and the slot count; the first free slot
        float r3[3] = {0.f, 0.f, 0.f};     // n, K <= 32: warp 0's items
        float mx3 = -INFINITY, fv_free = INFINITY;
        int free_k = INT_MAX;
        if (t < n) r3[0] += L.M[jr * ldn + t] * L.M[jr * ldn + t];
        if (t < K) {
          r3[1] += L.g_k[t] * L.a[t];
          r3[2] += L.used[t];
          const float fc = static_cast<float>(t) + L.used[t] * kBig;
          if (better(fc, t, fv_free, free_k)) { fv_free = fc; free_k = t; }
        }
        warp_reduce<3, false>(r3, mx3);
        warp_argmin(fv_free, free_k);
        // block_reduce's ((w0 + w1) + w2) + w3, the other warps' sums +0
        const float dii = ((r3[0] + 0.f) + 0.f) + 0.f;
        const float sval = dii - (((r3[1] + 0.f) + 0.f) + 0.f);
        const float gate = fmaxf(tol.singtol, 1e-4f * dii);
        const bool okadd = sval >= gate &&
                           ((r3[2] + 0.f) + 0.f) + 0.f <
                               static_cast<float>(n_true);
        if (okadd) {
          // sval >= gate > 0 here; the JAX code's zero guard is moot
          const float cadd = 1.f / sval;
          for (int k = t; k < K; k += 32)
            L.w[k] = L.a[k] * L.used[k] - (k == free_k ? 1.f : 0.f);
          __syncwarp();
          for (int idx = t; idx < K * K; idx += 32) {
            const int i = idx / K, j = idx % K;
            L.E[i * ldK + j] += cadd * L.w[i] * L.w[j];
          }
          for (int j = t; j < n; j += 32)
            L.W[free_k * ldn + j] += L.M[jr * ldn + j];
          __syncwarp();
          if (t == 0) {
            L.used[free_k] = fminf(L.used[free_k] + 1.f, 1.f);
            L.sid[free_k] += static_cast<float>(jr) + 1.f;
            L.slo[free_k] += is_lo;
            L.dsl[free_k] += dval;
            L.lam[free_k] += 1.f - 2.f * is_lo;
            L.au[jr] = fminf(L.au[jr] + (1.f - is_lo), 1.f);
            L.al[jr] = fminf(L.al[jr] + is_lo, 1.f);
          }
        }
      }
      __syncwarp();
    }

    // adaptive eps, exits and the carries
    const bool unbounded = need && !found;
    const bool grow = it1 && !at_vx;
    if (ps > 0.f && run2) eps = min_nan(eps * (grow ? 10.f : 0.9f), 1e3f);
    const bool done = run2 && (converged || !(c.stt > 0) || unbounded);
    if (done) lf = unbounded ? kUnbounded : (c.stt > 0 ? kOptimal : c.stt);
    if (run2 && !(done && !(c.stt > 0)))
      for (int j = t; j < n; j += 32) x[j] = xn[j];
    if (done) lr = 0.f;
    tt += c.it;
    SEG_PROBE_STEPS(c.it)
    ps += 1.f;
    __syncwarp();
    SEG_PROBE_MARK(3)
    SEG_PROBE_PASS
  }

  warp_rows_out(out(E_) + b * K * K, L.E, ldK, K, K);
  warp_rows_out(out(W_) + b * K * n, L.W, ldn, K, n);
  for (int i = t; i < m; i += 32) {
    out(AU_)[b * m + i] = L.au[i];
    out(AL_)[b * m + i] = L.al[i];
  }
  if (P.p[DUO_] != nullptr && p > 0)
    for (int i = t; i < m; i += 32) {
      static_cast<float*>(const_cast<void*>(P.p[DUO_]))[b * m + i] = L.du[i];
      static_cast<float*>(const_cast<void*>(P.p[DLO_]))[b * m + i] = L.dl[i];
    }
  if (t < K) {
    out(DSL_)[b * K + t] = L.dsl[t];
    out(USED_)[b * K + t] = L.used[t];
    out(SID_)[b * K + t] = L.sid[t];
    out(SLO_)[b * K + t] = L.slo[t];
    out(LAM_)[b * K + t] = L.lam[t];
    out(LS_)[b * K + t] = L.ls[t];
  }
  for (int j = t; j < n; j += 32) {
    out(PROW_)[b * n + j] = L.prow[j];
    out(U_)[b * n + j] = L.u[j];
    out(X_)[b * n + j] = x[j];
  }
  if (t == 0) {
    out(PD_)[b] = c.pd;
    out(PLM_)[b] = c.plm;
    out(PLO_)[b] = c.plo;
    out(PID_)[b] = c.pid;
    out(PDD_)[b] = c.pdd;
    out(FV_)[b] = c.fv;
    out(BF_)[b] = c.bf;
    out(CY_)[b] = c.cy;
    out(RP_)[b] = c.rp;
    out(IT_)[b] = c.it;
    reinterpret_cast<int*>(out(STT_))[b] = c.stt;
    out(EPS_)[b] = eps;
    out(STL_)[b] = stl;
    out(BD_)[b] = bd;
    out(LR_)[b] = lr;
    reinterpret_cast<int*>(out(LF_))[b] = lf;
    out(TT_)[b] = tt;
    out(PS_)[b] = ps;
    static_cast<float*>(const_cast<void*>(P.p[FAIL_]))[b] =
        failed ? 1.f : 0.f;
  }
  SEG_PROBE_MARK(4)
  SEG_PROBE_FLUSH
}

}  // namespace

// The body by shape: the warp step up to kWarpMaxK slots and columns where
// its block fits the device's opt-in shared memory, else the 128-thread
// block (ops/smem.py lp_floats mirrors the choice).
extern "C" int lp_segment_f32(const void* const* ptrs, int B, int m, int n,
                              int K, int n_true, int steps, int nP,
                              float dual_tol, float primal_tol,
                              float pivot_tol, float sing_tol,
                              float progress_tol, float cycle_tol, int bland,
                              float eta, void* stream) {
  Ptrs P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  const Tol tol{dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol,
                cycle_tol, bland};
  const size_t warp = lp_warp_smem_floats(m, n, K) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (K <= kWarpMaxK && n <= kWarpMaxK && warp <= static_cast<size_t>(optin))
    return seg_launch(lp_segment_warp_kernel, B, 32, warp, stream, P, m, n,
                      K, n_true, steps, nP, tol, eta);
  return seg_launch(lp_segment_kernel, B, kThreads,
                    lp_smem_floats(m, n, K) * sizeof(float), stream, P, m, n,
                    K, n_true, steps, nP, tol, eta);
}
