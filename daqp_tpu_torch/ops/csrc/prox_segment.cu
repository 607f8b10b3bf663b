// B4: P proximal-point outer passes per launch, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:1110 run_prox_segment
// (pallas_call at :1168; kernel body _prox_kernel_body, :899-1107), the
// full-shift regime of daqp_prox.c:21-189.  Per lane and pass, while the
// lane runs (lane_run > 0 and not failed):
//   v = Rinv'(f - eps x), d = b_s + M v, dsl refreshed from sid/slo, the
//   per-solve control reset, the shared slot step (slot_step.cuh) with
//   steps = 64 and the in-kernel cold retry; then x_new = Rinv (u - v),
//   the fixed-point test ||x_new - x||_inf < tol_stat (= eta / eps; PD
//   lanes, eps = 0, converge after one pass), the stagnation acceptance
//   (best_diff, stall >= 8) and the 1.5x over-relaxation when the active
//   set froze (:1056-1084); tot += iterations.
// A lane whose inner solve ends RUNNING, CYCLE or REFACTOR after the retry
// raises `failed`, keeps lane_run = 1 and does no further pass: the
// driver resumes it on the per-pass path.  A lane that stops running here
// is left as it is; the TPU kernel's tile keeps touching best_diff, stall
// and the control state of its stopped lanes while other lanes of the
// 128-lane tile run, which no result of a stopped lane reads.
//
// What bounds it on an H100: latency, as for K2; each pass adds three
// n x n / m x n matrix-vector products to a warm solve of a few steps.
// The lane's Rinv (n x n) sits in shared memory beside E, W and M
// (+10.2 KB at n = 50), so a pass reads nothing from device memory.  The
// per-pass probe (segment.cuh, chip_profile.py --probe k4) puts the slot
// step at 93% of a pass at config 4; 256 blocks at 3 an SM run in one
// wave, so the launch lasts as long as its slowest lane (75 steps in 8
// passes of the cold segment).
//
// Design: one thread block per QP, the K2 layout (slot_carve) followed by
// Rinv and the pass vectors; du / dl of the layout hold the pass's bounds.
// The state comes in as cp.async copies all in flight at once, through
// one copy body that is not inlined, and goes out through registers
// (segment.cuh): a load-then-store loop waited out one load a float, 39k
// of a block's ~1M cycles.  The pass keeps one thread a product row,
// summed in the order j = 0, 1, ..., behind seven barriers: forming
// f - eps x and u - v inside the sums and a one-barrier reduction (four
// barriers) ran more instructions a pass and measured no faster (PERF.md,
// section 6).
#include "segment.cuh"

namespace {

// Pointer table, in the order of ops/slot.py run_prox_segment: SEG_CONST,
// Rinv, fz, bus, bls, eps, tst, STATE, PROX_LANE (in), STATE, PROX_LANE
// (out), then failed.
enum Ptr {
  M_, SC_, IM_, SIMM_, FB_, R_, FZ_, BUS_, BLS_, EPS_, TST_,
  AU_, AL_, W_, E_, DSL_, USED_, SID_, SLO_, LAM_, LS_, PD_, PROW_, PLM_,
  PLO_, PID_, PDD_, U_, FV_, BF_, CY_, RP_, IT_, STT_,
  X_, LR_, STL_, BD_, LF_, TT_,
  kNumIn,
  kNumState = kNumIn - AU_,
  FAIL_ = kNumIn + kNumState,
  kNumPtrs
};

struct Ptrs {
  const void* p[kNumPtrs];
};

__host__ __device__ inline size_t prox_smem_floats(int m, int n, int K) {
  return slot_smem_floats(m, n, K) + static_cast<size_t>(n) * (n | 1) +
         5 * n + 2 * m;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
prox_segment_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
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
  float* R = L.end;
  float* x = R + n * ldn;
  float* v = x + n;
  float* tv = v + n;             // f - eps x, then u - v
  float* fz = tv + n;
  float* xn = fz + n;
  float* bus = xn + n;
  float* bls = bus + m;

  seg_rows_async(L.E, L.ldK, in(E_) + b * K * K, K, K);
  seg_rows_async(L.W, ldn, in(W_) + b * K * n, K, n);
  seg_rows_async(L.M, ldn, in(M_) + b * m * n, m, n);
  seg_rows_async(R, ldn, in(R_) + b * n * n, n, n);
  seg_vec_async(L.sc, in(SC_) + b * m, m);
  seg_vec_async(L.im, in(IM_) + b * m, m);
  seg_vec_async(bus, in(BUS_) + b * m, m);
  seg_vec_async(bls, in(BLS_) + b * m, m);
  seg_vec_async(L.au, in(AU_) + b * m, m);
  seg_vec_async(L.al, in(AL_) + b * m, m);
  seg_vec_async(L.dsl, in(DSL_) + b * K, K);
  seg_vec_async(L.used, in(USED_) + b * K, K);
  seg_vec_async(L.sid, in(SID_) + b * K, K);
  seg_vec_async(L.slo, in(SLO_) + b * K, K);
  seg_vec_async(L.simm, in(SIMM_) + b * K, K);
  seg_vec_async(L.lam, in(LAM_) + b * K, K);
  seg_vec_async(L.ls, in(LS_) + b * K, K);
  seg_vec_async(L.prow, in(PROW_) + b * n, n);
  seg_vec_async(L.u, in(U_) + b * n, n);
  seg_vec_async(x, in(X_) + b * n, n);
  seg_vec_async(fz, in(FZ_) + b * n, n);
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
  const float eps = in(EPS_)[b], tst = in(TST_)[b];
  float lr = in(LR_)[b], stl = in(STL_)[b], bd = in(BD_)[b], tt = in(TT_)[b];
  int lf = static_cast<const int*>(P.p[LF_])[b];
  bool failed = false;
  cp_async_wait_all();
  __syncthreads();
  SEG_PROBE_MARK(0)

  for (int p = 0; p < nP && lr > 0.f && !failed; ++p) {
    // v = Rinv'(f - eps x) and the pass's bounds d = b_s + M v
    for (int j = t; j < n; j += kThreads) tv[j] = fz[j] - eps * x[j];
    __syncthreads();
    for (int i = t; i < n; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += R[j * ldn + i] * tv[j];
      v[i] = s;
    }
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

    // outer prox update (daqp_prox.c:114-154 semantics)
    for (int j = t; j < n; j += kThreads) tv[j] = L.u[j] - v[j];
    __syncthreads();
    float md = -INFINITY;
    for (int i = t; i < n; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += R[i * ldn + j] * tv[j];
      xn[i] = s;
      md = max_nan(md, fabsf(s - x[i]));
    }
    md = block_max(md, L.red);
    const bool inner_ok = c.stt > 0 && run2;
    bool converged = eps == 0.f || md < tst;
    const bool improved = md < 0.9f * bd;
    bd = min_nan(md, bd);
    stl = (improved || !run2) ? 0.f : stl + 1.f;
    converged = converged || stl >= 8.f;
    const bool froze = c.it <= 1.f && !converged && inner_ok;
    if (run2)
      for (int i = t; i < n; i += kThreads)
        x[i] = froze ? x[i] + 1.5f * (xn[i] - x[i]) : xn[i];
    const bool done = run2 && (converged || !(c.stt > 0));
    if (done) {
      lf = c.stt > 0 ? kOptimal : c.stt;
      lr = 0.f;
    }
    tt += c.it;
    SEG_PROBE_STEPS(c.it)
    __syncthreads();
    SEG_PROBE_MARK(3)
    SEG_PROBE_PASS
  }

  seg_rows_out(out(E_) + b * K * K, L.E, L.ldK, K, K);
  seg_rows_out(out(W_) + b * K * n, L.W, ldn, K, n);
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
    out(LR_)[b] = lr;
    out(STL_)[b] = stl;
    out(BD_)[b] = bd;
    reinterpret_cast<int*>(out(LF_))[b] = lf;
    out(TT_)[b] = tt;
    static_cast<float*>(const_cast<void*>(P.p[FAIL_]))[b] =
        failed ? 1.f : 0.f;
  }
  SEG_PROBE_MARK(4)
  SEG_PROBE_FLUSH
}

}  // namespace

extern "C" int prox_segment_f32(const void* const* ptrs, int B, int m, int n,
                                int K, int n_true, int steps, int nP,
                                float dual_tol, float primal_tol,
                                float pivot_tol, float sing_tol,
                                float progress_tol, float cycle_tol,
                                int bland, void* stream) {
  Ptrs P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  const Tol tol{dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol,
                cycle_tol, bland};
  const size_t smem = prox_smem_floats(m, n, K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prox_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  prox_segment_kernel<<<B, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      P, m, n, K, n_true, steps, nP, tol);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SEG_OCCUPANCY
// Resident blocks of B4 per SM at (m, n, K), by the occupancy calculator:
// chip_profile.py --probe k4 builds it beside the probe, from this source
// without the probe's marks (-DSEG_OCCUPANCY); the normal library has no
// such entry.
extern "C" int prox_segment_occupancy(int m, int n, int K, int* blocks) {
  const size_t smem = prox_smem_floats(m, n, K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      prox_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, prox_segment_kernel, kThreads, smem);
  return static_cast<int>(e);
}
#endif
