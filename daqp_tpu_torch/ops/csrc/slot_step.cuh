// The slot-space dual active-set step, shared by the kernels that run it:
// K2 (slot_round.cu), B3 (mpc_segment.cu) and B4 (prox_segment.cu).
//
// It is the step of daqp_tpu/ops/pallas_slot.py:256-612 (_solve_tile_live,
// which the TPU kernels _kernel_body, _mpc_kernel_body and
// _prox_kernel_body all call): the blocking min-ratio search,
// u = -W'(lam* o used) and mu = M u, Dantzig (or Bland) pricing, the
// pending retry or priced add, the deletion with its pivot guard
// (-> kRefactor), the relative singularity gate (-> pending), the W/E
// rank-one updates and the next lam* = -E (dsl o used), a_p = E (W prow o
// used).  The multi_add >= 2 and ablate variants of the TPU kernel are not
// carried over.
//
// One thread block runs one QP.  E (K x K), W (K x n) and M (m x n) of the
// lane live in dynamic shared memory with odd row strides (conflict-free
// column walks), the (m,), (K,) and (n,) vectors beside them (slot_carve
// gives the layout); the lane's scalars live in registers, computed
// identically by every thread from block-wide reductions (warp shuffles,
// then one barrier).  Every argmin returns the LOWEST index on ties (and
// the first NaN), as jnp.argmin does: the blocking slot, the priced row
// (Bland's rule rests on it) and the free slot all depend on that.
// No fast-math: the ratio test depends on isfinite and IEEE division.
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
constexpr int kRedStride = 6;          // 3 sums, max, argmin value, index

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
  int ldK, ldn;
};

__host__ __device__ inline size_t slot_smem_floats(int m, int n, int K) {
  const int ldK = K | 1, ldn = n | 1;
  return static_cast<size_t>(K) * ldK + static_cast<size_t>(K) * ldn +
         static_cast<size_t>(m) * ldn + 7 * m + 15 * K + 4 * n +
         kWarps * kRedStride;
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
  L.red = L.add_row + n;
  L.end = L.red + kWarps * kRedStride;
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
// Every thread returns the same values (same combination order).
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

// Up to `steps` iterations of a RUNNING lane on its shared-memory state,
// with the bounds du / dl (m,).  Starts with the round prefix from the
// stored E (pallas_slot.py:614-617), so E may have changed since the last
// step; leaves the shared state consistent (ends on a barrier).  A lane
// that is not RUNNING returns at once; a lane that turns terminal stops,
// which equals the TPU kernel's masked no-op steps.
__device__ __forceinline__ void slot_steps(const Lane& L, Ctl& c,
                                           const float* du, const float* dl,
                                           int m, int n, int K, int n_true,
                                           int steps, const Tol& tol) {
  if (c.stt != kRunning) return;
  const int t = threadIdx.x;
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
  float* w = L.w;
  float* g_p = L.g_p;
  float* prow = L.prow;
  float* u = L.u;
  float* u_new = L.u_new;
  float* add_row = L.add_row;
  float* red = L.red;
  float pd = c.pd, plm = c.plm, plo = c.plo, pid = c.pid, pdd = c.pdd;
  float fv = c.fv, bf = c.bf, cy = c.cy, it = c.it;
  const float rp = c.rp, fb = c.fb;
  int stt = c.stt;
  __syncthreads();

  // round-start prefix from the stored E: lam* = -E (dsl o used),
  // a_p = E (W prow o used)
  for (int k = t; k < K; k += kThreads) {
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += W[k * ldn + j] * prow[j];
    g_p[k] = s * used[k];
  }
  __syncthreads();
  for (int i = t; i < K; i += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < K; ++j) {
      s1 += E[i * ldK + j] * (dsl[j] * used[j]);
      s2 += E[i * ldK + j] * g_p[j];
    }
    lstar[i] = -s1;
    a_p[i] = s2;
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const float sgn_p = 1.f - 2.f * plo;

    // blocking min-ratio search over the slots (pallas_slot.py:269-299)
    // and the new primal u = -W'(lam* o used) (:302-303)
    float r1[1] = {0.f};
    float mx = -INFINITY, rmin = INFINITY;
    int rm = INT_MAX;
    for (int k = t; k < K; k += kThreads) {
      const float sdir = -a_p[k] * sgn_p;
      const float dk = pd * sdir + (1.f - pd) * (lstar[k] - lam[k]);
      const float signv = pd * sdir + (1.f - pd) * lstar[k];
      delta[k] = dk;
      const float infeas =
          slo[k] * (signv > tol.dtol ? 1.f : 0.f) +
          (1.f - slo[k]) * (signv < -tol.dtol ? 1.f : 0.f);
      const float elig = infeas * used[k] * (1.f - simm[k]);
      float ratio = -lam[k] / dk;
      ratio = isfinite(ratio) ? fmaxf(ratio, 0.f) : 0.f;
      const float cand = elig > 0.f ? ratio : kBig;
      if (better(cand, k, rmin, rm)) { rmin = cand; rm = k; }
    }
    for (int j = t; j < n; j += kThreads) {
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += W[k * ldn + j] * (lstar[k] * used[k]);
      u_new[j] = -s;
      r1[0] += s * s;
    }
    block_reduce<1>(r1, mx, rmin, rm, red);
    const float fv_new = r1[0];
    const float do_rm0 = rmin < kBig ? 1.f : 0.f;
    const float rm_id = sid[rm];
    const float rm_lo = slo[rm];

    // pricing on mu = M u (:304-337)
    float r2[1] = {0.f};
    float vmin = INFINITY;
    int jr = INT_MAX;
    for (int i = t; i < m; i += kThreads) {
      float mu = 0.f;
      for (int j = 0; j < n; ++j) mu += M[i * ldn + j] * u_new[j];
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
      if (better(cand, i, vmin, jr)) { vmin = cand; jr = i; }
    }
    block_reduce<1>(r2, mx, vmin, jr, red);
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
    for (int j = t; j < n; j += kThreads)
      add_row[j] = retry * prow[j] + padd0 * M[jr * ldn + j];
    __syncthreads();

    // Gram column of the add and the removed column of E (:381-400)
    for (int k = t; k < K; k += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += W[k * ldn + j] * add_row[j];
      const float keep0 = 1.f - (k == rm ? 1.f : 0.f) * do_rm0;
      g_k[k] = s * used[k] * keep0;
      e[k] = E[k * ldK + rm];
    }
    __syncthreads();

    // Schur vector a_pre = E g_k, and the deletion pivot (:400-416)
    float r3[2] = {0.f, 0.f};
    float emax = -INFINITY, dv = INFINITY;
    int di = INT_MAX;
    for (int i = t; i < K; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < K; ++j) s += E[i * ldK + j] * g_k[j];
      a[i] = s;
      r3[0] += e[i] * g_k[i];
      emax = max_nan(emax, fabsf(e[i]));
    }
    for (int j = t; j < n; j += kThreads) r3[1] += add_row[j] * add_row[j];
    block_reduce<2>(r3, emax, dv, di, red);
    const float err = e[rm];
    const float dii = r3[1];
    const bool bad = do_rm0 > 0.f && err < tol.pivtol * emax;
    const float err_s = err != 0.f ? err : 1.f;
    const float ec = r3[0] / err_s;
    if (bad) stt = kRefactor;
    const float do_rm = bad ? 0.f : do_rm0;
    const float alpha = do_rm * (rmin < kBig ? rmin : 0.f);

    // dual step and removal bookkeeping (:416-429); the Schur pivot,
    // slot count and first free slot for the add (:474-487)
    float r4[2] = {0.f, 0.f};
    float fmx = -INFINITY, fv_free = INFINITY;
    int free_k = INT_MAX;
    for (int k = t; k < K; k += kThreads) {
      const float keep = 1.f - (k == rm ? 1.f : 0.f) * do_rm;
      const float ap = keep * (a[k] - do_rm * e[k] * ec);
      a[k] = ap;
      lam[k] = (lam[k] + alpha * delta[k] * used[k]) * keep;
      used[k] *= keep;
      dsl[k] *= keep;
      slo[k] *= keep;
      sid[k] = sid[k] * keep - (1.f - keep);
      r4[0] += g_k[k] * ap;
      r4[1] += used[k];
      const float fc = static_cast<float>(k) + used[k] * kBig;
      if (better(fc, k, fv_free, free_k)) { fv_free = fc; free_k = k; }
    }
    block_reduce<2>(r4, fmx, fv_free, free_k, red);
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

    // Schur complement and the relative singularity gate (:463-481)
    const float sval = dii - r4[0];
    const float gate = fmaxf(tol.singtol, 1e-4f * dii);
    const bool sing = sval < gate || r4[1] >= static_cast<float>(n_true);
    const float do_add = retry * (bad ? 0.f : 1.f) + padd;
    const float ok = sing ? 0.f : do_add;
    const float mk_pend = sing ? do_add : 0.f;
    const float c_del = -do_rm / err_s;
    const float c_add = ok / (sval != 0.f ? sval : 1.f);

    // slot, m-space and pending bookkeeping (:456-462, :545-581)
    for (int k = t; k < K; k += kThreads) {
      const float ohf = k == free_k ? 1.f : 0.f;
      ls[k] = lstar[k];
      if (padd > 0.f) lam[k] = lstar[k] * used[k];
      w[k] = a[k] * used[k] - ohf;
      used[k] = fminf(used[k] + ok * ohf, 1.f);
      sid[k] = sid[k] + ok * ohf * (add_id + 1.f);
      slo[k] = slo[k] + ok * ohf * add_lo;
      dsl[k] = dsl[k] + ok * ohf * add_d;
      lam[k] = lam[k] + ok * ohf * add_lam;
    }
    for (int idx = t; idx < K * n; idx += kThreads) {
      const int k = idx / n, j = idx % n;
      const float keep = 1.f - (k == rm ? 1.f : 0.f) * do_rm;
      const float ohf = k == free_k ? 1.f : 0.f;
      W[k * ldn + j] = W[k * ldn + j] * keep + (ok * ohf) * add_row[j];
    }
    for (int i = t; i < m; i += kThreads) {
      const float fi = static_cast<float>(i);
      const float oh_rm = (fi == rm_id ? 1.f : 0.f) * do_rm;
      float up = au[i] * (1.f - oh_rm * (1.f - rm_lo));
      float lo = al[i] * (1.f - oh_rm * rm_lo);
      const float add_oh = retry * (fi == pid ? 1.f : 0.f) +
                           padd * (i == jr ? 1.f : 0.f);
      au[i] = fminf(up + ok * add_oh * (1.f - add_lo), 1.f);
      al[i] = fminf(lo + ok * add_oh * add_lo, 1.f);
    }
    for (int j = t; j < n; j += kThreads) {
      if (price > 0.f) u[j] = u_new[j];
      if (mk_pend > 0.f) prow[j] = add_row[j];
    }
    pd = fminf((1.f - retry) * pd + mk_pend, 1.f);
    if (mk_pend > 0.f) {
      plm = add_lam;
      plo = add_lo;
      pid = add_id;
      pdd = add_d;
    }
    __syncthreads();

    // E <- (E + c_del e e') o keep keep' + c_add w w' (:590-596) and the
    // pending Gram column on the new table (:587-588)
    for (int idx = t; idx < K * K; idx += kThreads) {
      const int i = idx / K, j = idx % K;
      const float ki = 1.f - (i == rm ? 1.f : 0.f) * do_rm;
      const float kj = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
      E[i * ldK + j] = (E[i * ldK + j] + c_del * e[i] * e[j]) * ki * kj +
                       c_add * w[i] * w[j];
    }
    for (int k = t; k < K; k += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += W[k * ldn + j] * prow[j];
      g_p[k] = s * used[k];
    }
    __syncthreads();

    // next step's lam* = -E (dsl o used) and a_p = E g_p (:604-605)
    for (int i = t; i < K; i += kThreads) {
      float s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < K; ++j) {
        s1 += E[i * ldK + j] * (dsl[j] * used[j]);
        s2 += E[i * ldK + j] * g_p[j];
      }
      lstar[i] = -s1;
      a_p[i] = s2;
    }
    __syncthreads();
    it += 1.f;
    if (stt != kRunning) break;
  }
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
__device__ __forceinline__ void slot_solve_retry(const Lane& L, Ctl& c,
                                                 int m, int n, int K,
                                                 int n_true, int steps,
                                                 const Tol& tol) {
  for (int attempt = 0; attempt < 2; ++attempt) {
    slot_steps(L, c, L.du, L.dl, m, n, K, n_true, steps, tol);
    if (attempt == 1 || (c.stt != kCycle && c.stt != kRefactor)) break;
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
