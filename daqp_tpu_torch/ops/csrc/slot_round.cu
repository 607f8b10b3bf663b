// K2: one round of the slot-space dual active-set solver, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:663 run_slot_round
// (pallas_call at :707; kernel body _kernel_body -> _solve_tile_live,
// pallas_slot.py:102-661).
// Per QP it runs up to `steps` iterations of the step at
// pallas_slot.py:256-612 on the slot state: the blocking min-ratio search,
// u = -W'(lam* o used) and mu = M u, Dantzig (or Bland) pricing, the
// pending retry or priced add, the deletion with its pivot guard
// (-> EXIT_REFACTOR), the relative singularity gate (-> pending), the
// W/E rank-one updates and the next lam* = -E (dsl o used),
// a_p = E (W prow o used).  The multi_add >= 2 and ablate variants of the
// TPU kernel are not carried over.
//
// What bounds it on an H100: latency, not bandwidth or FLOPs.  A step is
// ~20 kFLOP per QP (one M pass m x n, three E passes K x K, four W passes
// K x n) in a chain of dependent phases: two argmin searches, four block
// reductions and the rank-one updates, each separated by barriers.  A
// QP's state (E, W, M: 41 KB at n = 50, m = 100, K = 51) is read every
// step, so it must not live in device memory.
//
// Design: one thread block per QP (batch-leading state).  E (K x K),
// W (K x n) and M (m x n) of the lane stay in dynamic shared memory for
// the whole round with odd row strides (conflict-free column walks), the
// (m,), (K,) and (n,) vectors beside them; the lane's scalars live in
// registers, computed identically by every thread from block-wide
// reductions (warp shuffles, then one barrier).  Every argmin returns
// the LOWEST index on ties (and the first NaN), as jnp.argmin does: the
// blocking slot, the priced row (Bland's rule rests on it) and the free
// slot all depend on that.  A block whose lane is not EXIT_RUNNING
// copies its state through and does no step; a lane that turns terminal
// leaves the loop, which equals the TPU kernel's masked no-op steps.
// No fast-math: the ratio test depends on isfinite and IEEE division.
// wgmma / TMA are left to later work: the per-step products are
// matrix-vector, not matrix-matrix.
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

// Pointer table, in the order of ops/slot.py CONST + STATE (in, out).
enum Ptr {
  M_, DU_, DL_, SC_, IM_, SIMM_, FB_,
  AU_, AL_, W_, E_, DSL_, USED_, SID_, SLO_, LAM_, LS_, PD_, PROW_, PLM_,
  PLO_, PID_, PDD_, U_, FV_, BF_, CY_, RP_, IT_, STT_,
  kNumIn,
  kNumState = kNumIn - AU_,
  kNumPtrs = kNumIn + kNumState
};

struct Ptrs {
  const void* p[kNumPtrs];
};

struct Tol {
  float dtol, ptol, pivtol, singtol, progtol, cyctol;
  int bland;
};

__host__ __device__ inline size_t smem_floats(int m, int n, int K) {
  const int ldK = K | 1, ldn = n | 1;
  return static_cast<size_t>(K) * ldK + static_cast<size_t>(K) * ldn +
         static_cast<size_t>(m) * ldn + 7 * m + 15 * K + 4 * n +
         kWarps * kRedStride;
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

__device__ __forceinline__ void copy_in(float* dst, const float* src, int len) {
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

__global__ void __launch_bounds__(kThreads)
slot_round_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                  Tol tol) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ldK = K | 1, ldn = n | 1;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };

  // shared-memory layout (smem_floats)
  float* E = sm;
  float* W = E + K * ldK;
  float* M = W + K * ldn;
  float* du = M + m * ldn;
  float* dl = du + m;
  float* sc = dl + m;
  float* im = sc + m;
  float* au = im + m;
  float* al = au + m;
  float* lo_okv = al + m;
  float* dsl = lo_okv + m;
  float* used = dsl + K;
  float* sid = used + K;
  float* slo = sid + K;
  float* simm = slo + K;
  float* lam = simm + K;
  float* ls = lam + K;
  float* lstar = ls + K;
  float* a_p = lstar + K;
  float* delta = a_p + K;
  float* g_k = delta + K;
  float* e = g_k + K;
  float* a = e + K;             // a_pre, then a_post
  float* w = a + K;
  float* g_p = w + K;
  float* prow = g_p + K;
  float* u = prow + n;
  float* u_new = u + n;
  float* add_row = u_new + n;
  float* red = add_row + n;

  // load the lane's state
  copy_rows_in(E, ldK, in(E_) + b * K * K, K, K);
  copy_rows_in(W, ldn, in(W_) + b * K * n, K, n);
  copy_in(au, in(AU_) + b * m, m);
  copy_in(al, in(AL_) + b * m, m);
  copy_in(dsl, in(DSL_) + b * K, K);
  copy_in(used, in(USED_) + b * K, K);
  copy_in(sid, in(SID_) + b * K, K);
  copy_in(slo, in(SLO_) + b * K, K);
  copy_in(simm, in(SIMM_) + b * K, K);
  copy_in(lam, in(LAM_) + b * K, K);
  copy_in(ls, in(LS_) + b * K, K);
  copy_in(prow, in(PROW_) + b * n, n);
  copy_in(u, in(U_) + b * n, n);
  float pd = in(PD_)[b], plm = in(PLM_)[b], plo = in(PLO_)[b];
  float pid = in(PID_)[b], pdd = in(PDD_)[b], fv = in(FV_)[b];
  float bf = in(BF_)[b], cy = in(CY_)[b], rp = in(RP_)[b];
  float it = in(IT_)[b];
  int stt = static_cast<const int*>(P.p[STT_])[b];
  const float fb = in(FB_)[b];

  if (stt == kRunning) {
    copy_rows_in(M, ldn, in(M_) + b * m * n, m, n);
    copy_in(du, in(DU_) + b * m, m);
    copy_in(dl, in(DL_) + b * m, m);
    copy_in(sc, in(SC_) + b * m, m);
    copy_in(im, in(IM_) + b * m, m);
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
  }
  __syncthreads();

  // write the lane's state back
  copy_rows_out(out(E_) + b * K * K, E, ldK, K, K);
  copy_rows_out(out(W_) + b * K * n, W, ldn, K, n);
  for (int i = t; i < m; i += kThreads) {
    out(AU_)[b * m + i] = au[i];
    out(AL_)[b * m + i] = al[i];
  }
  for (int k = t; k < K; k += kThreads) {
    out(DSL_)[b * K + k] = dsl[k];
    out(USED_)[b * K + k] = used[k];
    out(SID_)[b * K + k] = sid[k];
    out(SLO_)[b * K + k] = slo[k];
    out(LAM_)[b * K + k] = lam[k];
    out(LS_)[b * K + k] = ls[k];
  }
  for (int j = t; j < n; j += kThreads) {
    out(PROW_)[b * n + j] = prow[j];
    out(U_)[b * n + j] = u[j];
  }
  if (t == 0) {
    out(PD_)[b] = pd;
    out(PLM_)[b] = plm;
    out(PLO_)[b] = plo;
    out(PID_)[b] = pid;
    out(PDD_)[b] = pdd;
    out(FV_)[b] = fv;
    out(BF_)[b] = bf;
    out(CY_)[b] = cy;
    out(RP_)[b] = rp;
    out(IT_)[b] = it;
    reinterpret_cast<int*>(out(STT_))[b] = stt;
  }
}

}  // namespace

extern "C" int slot_round_f32(const void* const* ptrs, int B, int m, int n,
                              int K, int n_true, int steps, float dual_tol,
                              float primal_tol, float pivot_tol,
                              float sing_tol, float progress_tol,
                              float cycle_tol, int bland, void* stream) {
  Ptrs P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  const Tol tol{dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol,
                cycle_tol, bland};
  const size_t smem = smem_floats(m, n, K) * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(slot_round_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  slot_round_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, m, n, K, n_true, steps, tol);
  return static_cast<int>(cudaGetLastError());
}
