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
// blocker's Schur column and E pass 3 its rank-one term; the main add's
// Schur data chain through it algebraically, so SOFT_WEIGHTS costs one
// more M pass and one more E contraction per step, no extra E pass.
//
// The working set is keyed by row: a row's own row and column of E
// (m x m) are its slot.  Where the TPU kernel selects with f32 one-hot
// masks, this one selects by row index, with the lowest index on ties.
//
// What bounds it on an H100: latency.  A step is ~(10 m^2 + 6 m n) flops
// per QP (E passes 1 and 2, the rank-one E update, three M passes; under
// SOFT_WEIGHTS + 4 m^2 + 2 m n) in a chain of four block reductions and
// four more barriers; at m = 100, n = 50 that is ~130 kFLOP against
// ~60 KB of state that every step reads.
//
// Design: one thread block per QP, E and M of the lane in dynamic shared
// memory (odd row strides: conflict-free row walks), the m- and n-vectors
// beside them, the lane's scalars in registers, identical in every thread
// (shared helpers and tie rules from slot_step.cuh).  ~69 KB at m = 100,
// n = 50 (+3.2 KB of SOFT_WEIGHTS vectors): three blocks per SM.  A lane
// that is not RUNNING is copied through from global to global and does no
// step.
#include "slot_step.cuh"

namespace {

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
  float *E, *M, *du, *dl, *sc, *im, *sf, *au, *al, *act, *lam, *ls, *lstar;
  float *delta, *g, *e, *a, *w, *lo_okv, *u, *u_new, *red;
  // SOFT_WEIGHTS only: slack data and state, d_W, the blocker's Gram
  // column g_bk and Schur column (ab_pre, ab_post, then w_b), 2 scalars
  float *dls, *dus, *rls, *rus, *sfx, *dw, *gb, *ab, *xs;
  int ldm, ldn;
};

__host__ __device__ inline size_t dense_smem_floats(int m, int n,
                                                    bool has_sw) {
  return static_cast<size_t>(m) * (m | 1) + static_cast<size_t>(m) * (n | 1) +
         17 * static_cast<size_t>(m) + 2 * n + kWarps * kRedStride +
         (has_sw ? 8 * static_cast<size_t>(m) + 2 : 0);
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
  L.ls = L.lam + m;
  L.lstar = L.ls + m;
  L.delta = L.lstar + m;
  L.g = L.delta + m;         // g_p, then g_k
  L.e = L.g + m;
  L.a = L.e + m;             // a_p, then a_pre, then a_post
  L.w = L.a + m;
  L.lo_okv = L.w + m;
  L.u = L.lo_okv + m;
  L.u_new = L.u + n;
  L.red = L.u_new + n;
  L.dls = L.red + kWarps * kRedStride;
  L.dus = L.dls + m;
  L.rls = L.dus + m;
  L.rus = L.rls + m;
  L.sfx = L.rus + m;
  L.dw = L.sfx + m;
  L.gb = L.dw + m;
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

// kSW: the SOFT_WEIGHTS variant, a separate instantiation so that the
// plain and soft variants compile to the code they had without it
template <bool kSW>
__global__ void __launch_bounds__(kThreads)
dense_round_kernel(Ptrs P, int m, int n, int n_true, int steps,
                   DenseTol dt) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
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
  if (stt != kRunning) {
    // terminal or held lane: state passes through unchanged
    for (size_t i = t; i < mm; i += kThreads)
      out(E_)[b * mm + i] = in(E_)[b * mm + i];
    for (int i = t; i < m; i += kThreads) {
      out(AU_)[b * m + i] = in(AU_)[b * m + i];
      out(AL_)[b * m + i] = in(AL_)[b * m + i];
      out(LAM_)[b * m + i] = in(LAM_)[b * m + i];
      out(LS_)[b * m + i] = in(LS_)[b * m + i];
      if (has_sw) sw_out(SFX_O_)[b * m + i] = in(SFX_)[b * m + i];
    }
    for (int j = t; j < n; j += kThreads) out(U_)[b * n + j] = in(U_)[b * n + j];
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
  copy_rows_in(E, ldm, in(E_) + b * mm, m, m);
  copy_rows_in(M, ldn, in(M_) + b * m * n, m, n);
  copy_vec(L.du, in(DU_) + b * m, m);
  copy_vec(L.dl, in(DL_) + b * m, m);
  copy_vec(L.sc, in(SC_) + b * m, m);
  copy_vec(L.im, in(IM_) + b * m, m);
  copy_vec(L.sf, in(SF_) + b * m, m);
  copy_vec(L.au, in(AU_) + b * m, m);
  copy_vec(L.al, in(AL_) + b * m, m);
  copy_vec(L.lam, in(LAM_) + b * m, m);
  copy_vec(L.ls, in(LS_) + b * m, m);
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
  float* lo_okv = L.lo_okv;
  float* u_new = L.u_new;
  float* red = L.red;
  const float* dls = L.dls;
  const float* dus = L.dus;
  const float* rls = L.rls;
  const float* rus = L.rus;
  float* sfx = L.sfx;
  float* dw = L.dw;
  float* gb = L.gb;
  float* ab = L.ab;
  float* xs = L.xs;
  __syncthreads();

  // the lane's smallest per-side weight over its soft rows: the clamp of
  // the add gate under SOFT_WEIGHTS (pallas_batch.py:257, :667-670)
  float rho_min = kBig;
  if (has_sw) {
    float s0[1] = {0.f};
    float mx0 = -INFINITY, av = INFINITY;
    int ai = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
      const float v = sf[i] > 0.f ? fminf(rls[i], rus[i]) : kBig;
      if (better(v, i, av, ai)) { av = v; ai = i; }
    }
    block_reduce<1>(s0, mx0, av, ai, red);
    rho_min = av;
  }

  for (int step = 0; step < steps; ++step) {
    const int pi = static_cast<int>(pid);
    const bool has_p = pd > 0.f && pi >= 0 && pi < m;
    const float sgn_p = 1.f - 2.f * plo;

    // top-of-step working set and the pending Gram column
    // g_p = M (M' po) o act (pallas_batch.py:313-323); under SOFT_WEIGHTS
    // d_W with the FREE soft slacks' shift (:315-319)
    for (int i = t; i < m; i += kThreads) {
      const float ai = au[i] + al[i];
      act[i] = ai;
      float s = 0.f;
      if (has_p)
        for (int j = 0; j < n; ++j) s += M[i * ldn + j] * M[pi * ldn + j];
      g[i] = (has_p ? pd : 0.f) * s * ai;
      if (has_sw)
        dw[i] = (au[i] * du[i] + al[i] * dl[i]) +
                ai * sf[i] * (1.f - sfx[i]) *
                    (al[i] * (rls[i] * dls[i]) - au[i] * (rus[i] * dus[i]));
    }
    __syncthreads();

    // E pass 1: lam* = -E d_W, a_p = E g_p (:325-326)
    for (int i = t; i < m; i += kThreads) {
      float s1 = 0.f, s2 = 0.f;
      if (has_sw) {
        for (int j = 0; j < m; ++j) {
          const float eij = E[i * ldm + j];
          s1 += eij * dw[j];
          s2 += eij * g[j];
        }
      } else {
        for (int j = 0; j < m; ++j) {
          const float eij = E[i * ldm + j];
          s1 += eij * (au[j] * du[j] + al[j] * dl[j]);
          s2 += eij * g[j];
        }
      }
      lstar[i] = -s1;
      a[i] = s2;
    }
    __syncthreads();

    // blocking min-ratio search over active mutable rows (:333-374; under
    // SOFT_WEIGHTS on the slack dual with the skip rules and the kink
    // guard), the new primal u = -M'(lam* o act), ||u||^2 and the soft
    // slack (:415-427)
    float r1[2] = {0.f, 0.f};
    float mx = -INFINITY, rmin = INFINITY;
    int rm = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
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
      if (better(cand, i, rmin, rm)) { rmin = cand; rm = i; }
      if (has_sw)
        r1[1] += sf[i] * act[i] * (al[i] * rls[i] + au[i] * rus[i]) *
                 lstar[i] * lstar[i];
      else if (has_soft)
        r1[1] += sf[i] * act[i] * lstar[i] * lstar[i];
    }
    for (int j = t; j < n; j += kThreads) {
      float s = 0.f;
      for (int i = 0; i < m; ++i) s += M[i * ldn + j] * (lstar[i] * act[i]);
      u_new[j] = -s;
      r1[0] += s * s;
    }
    block_reduce<2>(r1, mx, rmin, rm, red);
    const float soft_slack = has_sw ? r1[1] : (has_soft ? rho * r1[1] : 0.f);
    const float fv_new = r1[0] + soft_slack;

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

    // pricing on mu = M u, upper side first, first row on ties (:428-444);
    // the active counts for the rank cap ride along (FREE soft actives
    // under SOFT_WEIGHTS)
    float r2[2] = {0.f, 0.f};
    float vmin = INFINITY;
    int jr = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
      float mu = 0.f;
      for (int j = 0; j < n; ++j) mu += M[i * ldn + j] * u_new[j];
      const float bound = -tol.ptol * sc[i];
      const float v_up = du[i] - mu;
      const float v_lo = mu - dl[i];
      const bool blocked = act[i] > 0.f || im[i] > 0.f || (has_p && i == pi);
      const bool up_ok = v_up < bound && !blocked;
      const bool lo_ok = v_lo < bound && !blocked && !up_ok;
      float cand = up_ok ? v_up : (lo_ok ? v_lo : kBig);
      if (tol.bland)
        cand = (up_ok || lo_ok) ? static_cast<float>(i) - kBig : kBig;
      lo_okv[i] = lo_ok ? 1.f : 0.f;
      if (better(cand, i, vmin, jr)) { vmin = cand; jr = i; }
      r2[0] += act[i];
      r2[1] += has_sw ? act[i] * sf[i] * (1.f - sfx[i]) : act[i] * sf[i];
    }
    block_reduce<2>(r2, mx, vmin, jr, red);
    const float found = vmin < 0.f ? 1.f : 0.f;
    const float j_lo = lo_okv[jr];

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
    const float* mj = M + add_i * ldn;          // times add_w
    const float* mb = M + rm * ldn;             // the blocker's row

    // Gram column of the add, g_k = (M m_j) o act o keep0, and the removed
    // column e = E[:, rm] (:490-504); under SOFT_WEIGHTS the blocker's
    // g_bk, its unkept entry g[rm] and ||m_rm||^2 (:498-502)
    for (int i = t; i < m; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += M[i * ldn + j] * (add_w * mj[j]);
      const float keep0 = 1.f - (i == rm ? 1.f : 0.f) * do_rm0;
      g[i] = s * act[i] * keep0;
      e[i] = E[i * ldm + rm];
      if (has_sw) {
        float sb = 0.f;
        for (int j = 0; j < n; ++j) sb += M[i * ldn + j] * mb[j];
        gb[i] = sb * act[i] * keep0;
        if (i == rm) {
          xs[0] = s * act[i];
          xs[1] = sb;
        }
      }
    }
    __syncthreads();

    // E pass 2: a_pre = E g_k [, ab_pre = E g_bk]; e.g_k [, e.g_bk],
    // max|e| and ||m_j||^2 (:504-515)
    float r3[3] = {0.f, 0.f, 0.f};
    float emax = -INFINITY, dv = INFINITY;
    int di_ = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
      float s = 0.f, sb = 0.f;
      if (has_sw) {
        for (int j = 0; j < m; ++j) {
          const float eij = E[i * ldm + j];
          s += eij * g[j];
          sb += eij * gb[j];
        }
        ab[i] = sb;
        r3[2] += e[i] * gb[i];
      } else {
        for (int j = 0; j < m; ++j) s += E[i * ldm + j] * g[j];
      }
      a[i] = s;
      r3[0] += e[i] * g[i];
      emax = max_nan(emax, fabsf(e[i]));
    }
    for (int j = t; j < n; j += kThreads) {
      const float v = add_w * mj[j];
      r3[1] += v * v;
    }
    if (has_sw) {
      block_reduce<3>(r3, emax, dv, di_, red);
    } else {
      float r3p[2] = {r3[0], r3[1]};
      block_reduce<2>(r3p, emax, dv, di_, red);
      r3[0] = r3p[0];
      r3[1] = r3p[1];
    }
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
    // under SOFT_WEIGHTS also g_bk.ab_post and w_b.g_k (:606-635)
    float r4[3] = {0.f, 0.f, 0.f};
    float mx4 = -INFINITY, dv4 = INFINITY;
    int di4 = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
      const float keep = 1.f - (i == rm ? 1.f : 0.f) * do_rm;
      const float ap = keep * (a[i] - do_rm * e[i] * ec);
      a[i] = ap;
      lam[i] = (lam[i] + alpha * delta[i] * act[i]) * keep;
      au[i] *= keep;
      al[i] *= keep;
      r4[0] += g[i] * ap;
      if (has_sw) {
        const float abp = keep * (ab[i] - do_rm * e[i] * ecb);
        ab[i] = abp;
        r4[1] += gb[i] * abp;
        r4[2] += (i == rm ? -1.f : abp * act[i]) * g[i];
      }
    }
    if (has_sw) {
      block_reduce<3>(r4, mx4, dv4, di4, red);
    } else {
      float r4p[1] = {r4[0]};
      block_reduce<1>(r4p, mx4, dv4, di4, red);
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
    float dii, sval, k, ns_act, gate;
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
      const bool sing_b = sval_b < gate_b ||
                          k_rm >= static_cast<float>(n_true) + fs_cnt - fs_rm + 1.f;
      ok_b = sing_b ? 0.f : both;
      c_b = ok_b / (sval_b != 0.f ? sval_b : 1.f);
      const float g_rm = xs[0];
      cross = r4[2] - ok_b * g_rm;
      // a_main = a_post + c_b w_b cross, with w_b[rm] = -1
      const float a_main_rm = a[rm] + c_b * -1.f * cross;
      sval = dii - ((r4[0] + c_b * cross * r4[2]) + ok_b * g_rm * a_main_rm);
      k = k_rm + ok_b;
      // the rank cap counts FREE soft actives only
      ns_act = fs_cnt - fs_rm + ok_b + contributes;
      gate = fmaxf(tol.singtol, fminf(1e-4f * dii, 0.25f * rho_min));
    } else {
      dii = r3[1] + rho * add_soft;
      sval = dii - r4[0];
      k = r2[0] - do_rm;
      ns_act = has_soft ? r2[1] - rm_soft + add_soft : 0.f;
      float rel = 1e-4f * dii;
      if (has_soft) rel = fminf(rel, 0.25f * rho);
      gate = fmaxf(tol.singtol, rel);
    }
    const bool sing =
        sval < gate || k >= static_cast<float>(n_true) + ns_act;
    const float do_add =
        (has_sw ? retry + pend_readd + sw_readd : retry) * (bad ? 0.f : 1.f) +
        padd;
    const float ok = sing ? 0.f : do_add;
    const float mk_pend = sing ? do_add : 0.f;
    const float c_del = -do_rm / err_s;
    const float c_add = ok / (sval != 0.f ? sval : 1.f);

    // row bookkeeping: lam* record, lam <- lam* before a priced add, the
    // add's Schur border w, the masks (:565-570, :685-710); under
    // SOFT_WEIGHTS the blocker re-add first, w_b into ab, and sfix
    for (int i = t; i < m; i += kThreads) {
      L.ls[i] = lstar[i];
      if (padd > 0.f) lam[i] = lstar[i] * act[i];
      const float oh = (i == add_i ? 1.f : 0.f) * add_w;
      if (has_sw) {
        const float ohb = i == rm ? 1.f : 0.f;
        const float wbi = i == rm ? -1.f : ab[i] * act[i];
        ab[i] = wbi;
        w[i] = oh > 0.f ? -1.f : (a[i] + c_b * wbi * cross) * act[i];
        au[i] = fminf(au[i] + ok_b * ohb * (1.f - rm_lo), 1.f);
        al[i] = fminf(al[i] + ok_b * ohb * rm_lo, 1.f);
        lam[i] = lam[i] + ok_b * ohb * ls_rm;
        sfx[i] = sfx[i] * (1.f - ok_b * ohb);
      } else {
        w[i] = oh > 0.f ? -1.f : a[i] * act[i];
      }
      au[i] = fminf(au[i] + ok * oh * (1.f - add_lo), 1.f);
      al[i] = fminf(al[i] + ok * oh * add_lo, 1.f);
      lam[i] = lam[i] + ok * oh * add_lam;
      if (has_sw)
        sfx[i] = sfx[i] * (1.f - ok * oh) + ok * oh * (1.f - free_main);
    }
    if (price > 0.f)
      for (int j = t; j < n; j += kThreads) L.u[j] = u_new[j];
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
    __syncthreads();

    // E pass 3: E <- (E + c_del e e') o keep keep' [+ c_b w_b w_b']
    // + c_add w w' (:271-287, :686-699)
    if (has_sw) {
      for (int idx = t; idx < m * m; idx += kThreads) {
        const int i = idx / m, j = idx % m;
        const float ki = 1.f - (i == rm ? 1.f : 0.f) * do_rm;
        const float kj = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
        E[i * ldm + j] = ((E[i * ldm + j] + c_del * e[i] * e[j]) * ki * kj +
                          c_b * ab[i] * ab[j]) +
                         c_add * w[i] * w[j];
      }
    } else {
      for (int idx = t; idx < m * m; idx += kThreads) {
        const int i = idx / m, j = idx % m;
        const float ki = 1.f - (i == rm ? 1.f : 0.f) * do_rm;
        const float kj = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
        E[i * ldm + j] = (E[i * ldm + j] + c_del * e[i] * e[j]) * ki * kj +
                         c_add * w[i] * w[j];
      }
    }
    __syncthreads();
    it += 1.f;
    if (stt != kRunning) break;
  }

  // write the lane's state back
  copy_rows_out(out(E_) + b * mm, E, ldm, m, m);
  for (int i = t; i < m; i += kThreads) {
    out(AU_)[b * m + i] = au[i];
    out(AL_)[b * m + i] = al[i];
    out(LAM_)[b * m + i] = lam[i];
    out(LS_)[b * m + i] = L.ls[i];
    if (has_sw) sw_out(SFX_O_)[b * m + i] = sfx[i];
  }
  for (int j = t; j < n; j += kThreads) out(U_)[b * n + j] = L.u[j];
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
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, m, n, n_true, steps, dt);
  return static_cast<int>(cudaGetLastError());
}
