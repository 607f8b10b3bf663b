// B5: P Douglas-Rachford passes of the batched AVI per launch, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:1783 run_avi_segment
// (pallas_call at :1841; kernel body _avi_kernel_body, :1545-1781), the
// splitting of daqp_solve_avi (avi.c:6-101).  Per lane and pass, while the
// lane runs (lane_run > 0, not failed, no KKT request):
//   v = Rinv'(G1 x + f) with G1 = H - sym(H) - rho I, d = b_s + M v, dsl
//   refreshed from sid/slo, the per-solve control reset, the shared slot
//   step (slot_step.cuh) with steps = 64 and the in-kernel cold retry;
//   then y = Rinv (u - v), the Newton-step bookkeeping (avi.c:44-61: at
//   ctr == tlim a worse residual ||x - y||^2 than minres reverts x to
//   xold and raises tlim by 5, at most 30), the stable-set counter ctr,
//   and the DR update x = Hri (G2 y + G3 x) with G2 = sym(H)/2 + rho I,
//   G3 = H - sym(H)/2, Hri = (H + rho I)^-1 (avi.c:84-96); tot +=
//   iterations.
// A lane whose inner set was stable (iterations <= 1) for tlim passes
// raises `kkt_req` and does no further pass (its DR update is skipped):
// the driver runs the exact KKT step on the original H.  A lane whose
// inner solve ends RUNNING, CYCLE or REFACTOR after the retry raises
// `failed`, keeps lane_run = 1 and does no further pass: the driver
// resumes it on the per-pass path.  A lane whose solve ends loud stops
// with that flag.  A lane that stops is left as it is; the TPU kernel's
// tile keeps refreshing the bounds and control state of its stopped
// lanes, which the driver refreshes again before any result reads them.
//
// What bounds it on an H100: latency, as for K2 and B4; a pass adds six
// n x n matrix-vector products and M v (12 n^2 + 2 m n flops) to a warm
// solve of a few slot steps.  The per-pass probe (segment.cuh,
// chip_profile.py --probe k5) puts the step at 92-95% of a pass at
// configAVI (the AVI cell's tail lane runs ~10 steps a pass), and the
// 128-thread step at 11.3k SM cycles there: a floor of barriers and
// cross-warp reductions that does not shrink with the shape.  B5 still
// runs that step at every shape.  On the warp step of slot_warp.cuh
// (B6's body at K <= 32, the same bits) it took 9.6-10.1k cycles a step
// and its segment 7% less time, but its one-live-lane tail launch once
// ran 10% slower than this body (PERF.md, section 6), so it stays here.
//
// Design: one thread block of 128 per lane, the K2 layout (slot_carve)
// followed by the lane's five n x n matrices (odd row stride) and the
// pass vectors, so a pass reads nothing from device memory: ~20 KB at
// n = 20, m = 50 (configAVI), ~99 KB at n = 50, m = 100 (dynamic shared
// memory above 48 KB); the five matrices bound the width, 5 n^2 floats.
// The pass's own work is one thread per product item, summed in the
// order j = 0, 1, ..., with 11 barriers a pass outside the step: products
// on groups of 8, 4, 2 lanes, shared sweeps with 6 barriers, cp.async
// loads and copying a stopped lane global to global were measured no
// faster at configAVI (PERF.md, section 6), and another sum order moves
// lanes decided at the f32 noise floor.
#include "segment.cuh"

namespace {

// Pointer table, in the order of ops/slot.py run_avi_segment: SEG_CONST,
// AVI_MATS, fz, bus, bls, STATE, AVI_LANE (in), STATE, AVI_LANE (out),
// then failed and kkt_req, and the last pass's bounds du, dl (B, m) or
// null.
enum Ptr {
  M_, SC_, IM_, SIMM_, FB_, R_, G1_, G2_, G3_, HRI_, FZ_, BUS_, BLS_,
  AU_, AL_, W_, E_, DSL_, USED_, SID_, SLO_, LAM_, LS_, PD_, PROW_, PLM_,
  PLO_, PID_, PDD_, U_, FV_, BF_, CY_, RP_, IT_, STT_,
  X_, Y_, XO_, MR_, CT_, TL_, LR_, LF_, TT_,
  kNumIn,
  kNumState = kNumIn - AU_,
  FAIL_ = kNumIn + kNumState,
  KKT_,
  DUO_,
  DLO_,
  kNumPtrs
};

struct Ptrs {
  const void* p[kNumPtrs];
};

__host__ __device__ inline size_t avi_smem_floats(int m, int n, int K) {
  return slot_smem_floats(m, n, K) + 5 * static_cast<size_t>(n) * (n | 1) +
         7 * n + 2 * m;
}

// out = A w (trans: A' w) for an n x n shared matrix of row stride ld;
// the caller syncs
__device__ __forceinline__ void matvec(float* out, const float* A, int ld,
                                       const float* w, int n, bool trans) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float s = 0.f;
    if (trans)
      for (int j = 0; j < n; ++j) s += A[j * ld + i] * w[j];
    else
      for (int j = 0; j < n; ++j) s += A[i * ld + j] * w[j];
    out[i] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
avi_segment_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                   int nP, Tol tol) {
  extern __shared__ float sm[];
  SEG_PROBE_INIT
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  const Lane L = slot_carve(sm, m, n, K);
  const int ldn = L.ldn;
  const size_t nn = static_cast<size_t>(n) * n;
  float* R = L.end;
  float* G1 = R + n * ldn;
  float* G2 = G1 + n * ldn;
  float* G3 = G2 + n * ldn;
  float* Hri = G3 + n * ldn;
  float* x = Hri + n * ldn;
  float* y = x + n;
  float* xo = y + n;
  float* v = xo + n;
  float* tv = v + n;             // G1 x + f, then u - v, then G2 y + G3 x
  float* tw = tv + n;            // G3 x
  float* fz = tw + n;
  float* bus = fz + n;
  float* bls = bus + m;

  copy_rows_in(L.E, L.ldK, in(E_) + b * K * K, K, K);
  copy_rows_in(L.W, ldn, in(W_) + b * K * n, K, n);
  copy_rows_in(L.M, ldn, in(M_) + b * m * n, m, n);
  copy_rows_in(R, ldn, in(R_) + b * nn, n, n);
  copy_rows_in(G1, ldn, in(G1_) + b * nn, n, n);
  copy_rows_in(G2, ldn, in(G2_) + b * nn, n, n);
  copy_rows_in(G3, ldn, in(G3_) + b * nn, n, n);
  copy_rows_in(Hri, ldn, in(HRI_) + b * nn, n, n);
  copy_vec(L.sc, in(SC_) + b * m, m);
  copy_vec(L.im, in(IM_) + b * m, m);
  copy_vec(bus, in(BUS_) + b * m, m);
  copy_vec(bls, in(BLS_) + b * m, m);
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
  copy_vec(y, in(Y_) + b * n, n);
  copy_vec(xo, in(XO_) + b * n, n);
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
  float mr = in(MR_)[b], ct = in(CT_)[b], tl = in(TL_)[b];
  float lr = in(LR_)[b], tt = in(TT_)[b];
  int lf = static_cast<const int*>(P.p[LF_])[b];
  bool failed = false, kkt = false;
  int p = 0;                     // passes run
  __syncthreads();
  SEG_PROBE_MARK(0)

  for (; p < nP && lr > 0.f && !failed && !kkt; ++p) {
    // v = Rinv'(G1 x + f) and the pass's bounds d = b_s + M v
    // (pallas_slot.py:1659-1670)
    matvec(tv, G1, ldn, x, n, false);
    __syncthreads();
    for (int j = t; j < n; j += kThreads) tv[j] += fz[j];
    __syncthreads();
    matvec(v, R, ldn, tv, n, true);
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

    // y = Rinv (u - v) and the residual ||x - y||^2 (:1723-1729)
    for (int j = t; j < n; j += kThreads) tv[j] = L.u[j] - v[j];
    __syncthreads();
    float* yi = v;                 // v is spent
    float r[1] = {0.f};
    float mx = -INFINITY, av = INFINITY;
    int ai = INT_MAX;
    for (int i = t; i < n; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += R[i * ldn + j] * tv[j];
      yi[i] = s;
      r[0] += (x[i] - s) * (x[i] - s);
    }
    block_reduce<1>(r, mx, av, ai, L.red);
    const float res2 = r[0];

    // Newton-step bookkeeping (avi.c:44-61) and the stable-set counter
    const bool at_limit = ct == tl && run2;
    const bool worse = at_limit && res2 > mr;
    if (worse) tl = fminf(tl + 5.f, 30.f);
    if (at_limit && !worse) mr = res2;
    for (int i = t; i < n; i += kThreads) {
      if (worse) x[i] = xo[i];
      if (run2 && !worse) y[i] = yi[i];
    }
    const bool stable = c.it <= 1.f && run2;
    ct = stable ? ct + 1.f : (run2 ? 0.f : ct);
    const bool do_kkt = stable && ct == tl && inner_ok;
    kkt = kkt || do_kkt;
    __syncthreads();

    // DR update for running, non-KKT lanes (avi.c:84-96)
    if (run2 && !do_kkt && inner_ok) {
      matvec(tv, G2, ldn, y, n, false);
      matvec(tw, G3, ldn, x, n, false);
      __syncthreads();
      for (int j = t; j < n; j += kThreads) tv[j] += tw[j];
      __syncthreads();
      matvec(x, Hri, ldn, tv, n, false);
    }
    if (run2 && !(c.stt > 0)) {
      lf = c.stt;
      lr = 0.f;
    }
    tt += c.it;
    SEG_PROBE_STEPS(c.it)
    __syncthreads();
    SEG_PROBE_MARK(3)
    SEG_PROBE_PASS
  }

  copy_rows_out(out(E_) + b * K * K, L.E, L.ldK, K, K);
  copy_rows_out(out(W_) + b * K * n, L.W, ldn, K, n);
  for (int i = t; i < m; i += kThreads) {
    out(AU_)[b * m + i] = L.au[i];
    out(AL_)[b * m + i] = L.al[i];
  }
  for (int k = t; k < K; k += kThreads) {
    out(DSL_)[b * K + k] = L.dsl[k];
    out(USED_)[b * K + k] = L.used[k];
    out(SID_)[b * K + k] = L.sid[k];
    out(SLO_)[b * K + k] = L.slo[k];
    out(LAM_)[b * K + k] = L.lam[k];
    out(LS_)[b * K + k] = L.ls[k];
  }
  if (P.p[DUO_] != nullptr && p > 0)
    for (int i = t; i < m; i += kThreads) {
      static_cast<float*>(const_cast<void*>(P.p[DUO_]))[b * m + i] = L.du[i];
      static_cast<float*>(const_cast<void*>(P.p[DLO_]))[b * m + i] = L.dl[i];
    }
  for (int j = t; j < n; j += kThreads) {
    out(PROW_)[b * n + j] = L.prow[j];
    out(U_)[b * n + j] = L.u[j];
    out(X_)[b * n + j] = x[j];
    out(Y_)[b * n + j] = y[j];
    out(XO_)[b * n + j] = xo[j];
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
    out(MR_)[b] = mr;
    out(CT_)[b] = ct;
    out(TL_)[b] = tl;
    out(LR_)[b] = lr;
    reinterpret_cast<int*>(out(LF_))[b] = lf;
    out(TT_)[b] = tt;
    static_cast<float*>(const_cast<void*>(P.p[FAIL_]))[b] =
        failed ? 1.f : 0.f;
    static_cast<float*>(const_cast<void*>(P.p[KKT_]))[b] = kkt ? 1.f : 0.f;
  }
  SEG_PROBE_MARK(4)
  SEG_PROBE_FLUSH
}

}  // namespace

extern "C" int avi_segment_f32(const void* const* ptrs, int B, int m, int n,
                               int K, int n_true, int steps, int nP,
                               float dual_tol, float primal_tol,
                               float pivot_tol, float sing_tol,
                               float progress_tol, float cycle_tol, int bland,
                               void* stream) {
  Ptrs P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  const Tol tol{dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol,
                cycle_tol, bland};
  const size_t smem = avi_smem_floats(m, n, K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        avi_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  avi_segment_kernel<<<B, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      P, m, n, K, n_true, steps, nP, tol);
  return static_cast<int>(cudaGetLastError());
}
