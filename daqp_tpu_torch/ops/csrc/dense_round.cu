// B7: one round of the dense-mask dual active-set solver, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_batch.py:751 run_kernel_round
// (pallas_call at :798; kernel body _kernel_body -> _solve_tile_live,
// pallas_batch.py:105-748, without the SOFT_WEIGHTS branches).  Per QP it
// runs up to `steps` iterations of the step at pallas_batch.py:304-722:
// the CSP lam* = -E d_W with the pending Gram column, the blocking
// min-ratio search, u = -M'(lam* o act) and mu = M u, Dantzig (or Bland)
// pricing with the upper side before the lower, the pending retry or
// priced add, the deletion with its pivot guard (-> kRefactor), the
// relative singularity gate (soft variant clamped below rho_soft) and the
// rank cap (-> pending), and one combined deletion + bordered-add update
// of E.  `has_soft` and `bland` are runtime flags: the TPU kernel's two
// compile-time variants (plain and soft) are both this kernel.
//
// The working set is keyed by row: a row's own row and column of E
// (m x m) are its slot.  Where the TPU kernel selects with f32 one-hot
// masks, this one selects by row index, with the lowest index on ties.
//
// What bounds it on an H100: latency.  A step is ~(10 m^2 + 6 m n) flops
// per QP (E passes 1 and 2, the rank-one E update, three M passes) in a
// chain of four block reductions and four more barriers; at m = 100,
// n = 50 that is ~130 kFLOP against ~60 KB of state that every step reads.
//
// Design: one thread block per QP, E and M of the lane in dynamic shared
// memory (odd row strides: conflict-free row walks), the m- and n-vectors
// beside them, the lane's scalars in registers, identical in every thread
// (shared helpers and tie rules from slot_step.cuh).  ~69 KB at m = 100,
// n = 50: three blocks per SM.  A lane that is not RUNNING is copied
// through from global to global and does no step.
#include "slot_step.cuh"

namespace {

constexpr int kSoftOptimal = 2;

// Pointer table, in the order of ops/dense.py CONST + STATE (in, out).
enum Ptr {
  M_, DU_, DL_, SC_, IM_, SF_, FB_,
  AU_, AL_, E_, LAM_, LS_, PD_, PID_, PLM_, PLO_, U_, FV_, BF_, CY_, RP_,
  IT_, STT_,
  kNumIn,
  kNumState = kNumIn - AU_,
  kNumPtrs = kNumIn + kNumState
};

struct Ptrs {
  const void* p[kNumPtrs];
};

struct DenseLane {
  float *E, *M, *du, *dl, *sc, *im, *sf, *au, *al, *act, *lam, *ls, *lstar;
  float *delta, *g, *e, *a, *w, *lo_okv, *u, *u_new, *red;
  int ldm, ldn;
};

__host__ __device__ inline size_t dense_smem_floats(int m, int n) {
  return static_cast<size_t>(m) * (m | 1) + static_cast<size_t>(m) * (n | 1) +
         17 * static_cast<size_t>(m) + 2 * n + kWarps * kRedStride;
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
  return L;
}

struct DenseTol {
  Tol t;
  float rho;
  int has_soft;
};

__global__ void __launch_bounds__(kThreads)
dense_round_kernel(Ptrs P, int m, int n, int n_true, int steps,
                   DenseTol dt) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  const Tol& tol = dt.t;
  const float rho = dt.rho;
  const bool has_soft = dt.has_soft != 0;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
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
    }
    for (int j = t; j < n; j += kThreads) out(U_)[b * n + j] = in(U_)[b * n + j];
    if (t == 0) {
      const int scalars[] = {PD_, PID_, PLM_, PLO_, FV_, BF_, CY_, RP_, IT_};
      for (int k : scalars) out(k)[b] = in(k)[b];
      reinterpret_cast<int*>(out(STT_))[b] = stt;
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
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int pi = static_cast<int>(pid);
    const bool has_p = pd > 0.f && pi >= 0 && pi < m;
    const float sgn_p = 1.f - 2.f * plo;

    // top-of-step working set and the pending Gram column
    // g_p = M (M' po) o act (pallas_batch.py:313-323)
    for (int i = t; i < m; i += kThreads) {
      const float ai = au[i] + al[i];
      act[i] = ai;
      float s = 0.f;
      if (has_p)
        for (int j = 0; j < n; ++j) s += M[i * ldn + j] * M[pi * ldn + j];
      g[i] = (has_p ? pd : 0.f) * s * ai;
    }
    __syncthreads();

    // E pass 1: lam* = -E d_W, a_p = E g_p (:325-326)
    for (int i = t; i < m; i += kThreads) {
      float s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < m; ++j) {
        const float eij = E[i * ldm + j];
        s1 += eij * (au[j] * du[j] + al[j] * dl[j]);
        s2 += eij * g[j];
      }
      lstar[i] = -s1;
      a[i] = s2;
    }
    __syncthreads();

    // blocking min-ratio search over active mutable rows (:333-374), the
    // new primal u = -M'(lam* o act), ||u||^2 and the soft slack (:415-427)
    float r1[2] = {0.f, 0.f};
    float mx = -INFINITY, rmin = INFINITY;
    int rm = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
      const float sdir = -a[i] * sgn_p;
      const float di = pd * sdir + (1.f - pd) * (lstar[i] - lam[i]);
      const float signv = pd * sdir + (1.f - pd) * lstar[i];
      delta[i] = di;
      const float infeas = al[i] * (signv > tol.dtol ? 1.f : 0.f) +
                           (1.f - al[i]) * (signv < -tol.dtol ? 1.f : 0.f);
      const float elig = infeas * act[i] * (1.f - im[i]);
      float ratio = -lam[i] / di;
      ratio = isfinite(ratio) ? fmaxf(ratio, 0.f) : 0.f;
      const float cand = elig > 0.f ? ratio : kBig;
      if (better(cand, i, rmin, rm)) { rmin = cand; rm = i; }
      if (has_soft) r1[1] += sf[i] * act[i] * lstar[i] * lstar[i];
    }
    for (int j = t; j < n; j += kThreads) {
      float s = 0.f;
      for (int i = 0; i < m; ++i) s += M[i * ldn + j] * (lstar[i] * act[i]);
      u_new[j] = -s;
      r1[0] += s * s;
    }
    block_reduce<2>(r1, mx, rmin, rm, red);
    const float soft_slack = has_soft ? rho * r1[1] : 0.f;
    const float fv_new = r1[0] + soft_slack;
    const float do_rm0 = rmin < kBig ? 1.f : 0.f;

    // pricing on mu = M u, upper side first, first row on ties (:428-444);
    // the active counts for the rank cap ride along
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
      r2[1] += act[i] * sf[i];
    }
    block_reduce<2>(r2, mx, vmin, jr, red);
    const float found = vmin < 0.f ? 1.f : 0.f;
    const float j_lo = lo_okv[jr];

    // add candidate: pending retry after a removal, or the priced row
    // (:452-495); add_w is the weight of its one-hot (0 or 1)
    const float retry = pd * do_rm0;
    const float price0 = (1.f - do_rm0) * (1.f - pd);
    const float padd0 = price0 * found;
    const float add_w = retry + padd0;
    const int add_i = retry > 0.f ? pi : jr;
    const float add_lo = retry * plo + padd0 * j_lo;
    const float add_lam = retry * plm + padd0 * (1.f - 2.f * j_lo);
    const float add_id = retry * pid + padd0 * static_cast<float>(jr);
    const float add_soft = has_soft ? add_w * sf[add_i] : 0.f;
    const float* mj = M + add_i * ldn;          // times add_w

    // Gram column of the add, g_k = (M m_j) o act o keep0, and the removed
    // column e = E[:, rm] (:490-504)
    for (int i = t; i < m; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += M[i * ldn + j] * (add_w * mj[j]);
      const float keep0 = 1.f - (i == rm ? 1.f : 0.f) * do_rm0;
      g[i] = s * act[i] * keep0;
      e[i] = E[i * ldm + rm];
    }
    __syncthreads();

    // E pass 2: a_pre = E g_k; e.g_k, max|e| and ||m_j||^2 (:504-515)
    float r3[2] = {0.f, 0.f};
    float emax = -INFINITY, dv = INFINITY;
    int di_ = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < m; ++j) s += E[i * ldm + j] * g[j];
      a[i] = s;
      r3[0] += e[i] * g[i];
      emax = max_nan(emax, fabsf(e[i]));
    }
    for (int j = t; j < n; j += kThreads) {
      const float v = add_w * mj[j];
      r3[1] += v * v;
    }
    block_reduce<2>(r3, emax, dv, di_, red);
    const float err = e[rm];
    const bool bad = do_rm0 > 0.f && err < tol.pivtol * emax;
    if (bad) stt = kRefactor;
    const float do_rm = bad ? 0.f : do_rm0;
    const float err_s = err != 0.f ? err : 1.f;
    const float ec = r3[0] / err_s;
    const float alpha = do_rm * (rmin < kBig ? rmin : 0.f);
    const float rm_soft = do_rm * sf[rm];

    // post-deletion Schur vector and the dual line step (:513-533)
    float r4[1] = {0.f};
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
    }
    block_reduce<1>(r4, mx4, dv4, di4, red);
    plm = plm + alpha * sgn_p * pd;

    // exits (:535-563)
    if (stt == kRunning && pd > 0.f && do_rm == 0.f)
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
    const float dii = r3[1] + rho * add_soft;
    const float sval = dii - r4[0];
    const float k = r2[0] - do_rm;
    const float ns_act = has_soft ? r2[1] - rm_soft + add_soft : 0.f;
    float rel = 1e-4f * dii;
    if (has_soft) rel = fminf(rel, 0.25f * rho);
    const float gate = fmaxf(tol.singtol, rel);
    const bool sing =
        sval < gate || k >= static_cast<float>(n_true) + ns_act;
    const float do_add = retry * (bad ? 0.f : 1.f) + padd;
    const float ok = sing ? 0.f : do_add;
    const float mk_pend = sing ? do_add : 0.f;
    const float c_del = -do_rm / err_s;
    const float c_add = ok / (sval != 0.f ? sval : 1.f);

    // row bookkeeping: lam* record, lam <- lam* before a priced add, the
    // add's Schur border w, the masks (:565-570, :685-702)
    for (int i = t; i < m; i += kThreads) {
      L.ls[i] = lstar[i];
      if (padd > 0.f) lam[i] = lstar[i] * act[i];
      const float oh = (i == add_i ? 1.f : 0.f) * add_w;
      w[i] = oh > 0.f ? -1.f : a[i] * act[i];
      au[i] = fminf(au[i] + ok * oh * (1.f - add_lo), 1.f);
      al[i] = fminf(al[i] + ok * oh * add_lo, 1.f);
      lam[i] = lam[i] + ok * oh * add_lam;
    }
    if (price > 0.f)
      for (int j = t; j < n; j += kThreads) L.u[j] = u_new[j];
    pd = fminf((1.f - retry) * pd + mk_pend, 1.f);
    if (mk_pend > 0.f) {
      pid = add_id;
      plm = add_lam;
      plo = add_lo;
    }
    __syncthreads();

    // E pass 3: E <- (E + c_del e e') o keep keep' + c_add w w' (:686-699)
    for (int idx = t; idx < m * m; idx += kThreads) {
      const int i = idx / m, j = idx % m;
      const float ki = 1.f - (i == rm ? 1.f : 0.f) * do_rm;
      const float kj = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
      E[i * ldm + j] = (E[i * ldm + j] + c_del * e[i] * e[j]) * ki * kj +
                       c_add * w[i] * w[j];
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
  }
}

}  // namespace

extern "C" int dense_round_f32(const void* const* ptrs, int B, int m, int n,
                               int n_true, int steps, float dual_tol,
                               float primal_tol, float pivot_tol,
                               float sing_tol, float progress_tol,
                               float cycle_tol, int bland, float rho_soft,
                               int has_soft, void* stream) {
  Ptrs P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  const DenseTol dt{{dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol,
                     cycle_tol, bland},
                    rho_soft, has_soft};
  const size_t smem = dense_smem_floats(m, n) * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(dense_round_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  dense_round_kernel<<<B, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      P, m, n, n_true, steps, dt);
  return static_cast<int>(cudaGetLastError());
}
