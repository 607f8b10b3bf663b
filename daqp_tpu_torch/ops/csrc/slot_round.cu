// K2: one round of the slot-space dual active-set solver, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:663 run_slot_round
// (pallas_call at :707; kernel body _kernel_body -> _solve_tile_live,
// pallas_slot.py:102-661).
// Per QP it runs up to `steps` iterations of the shared slot step
// (slot_step.cuh, the step at pallas_slot.py:256-612) on the slot state.
//
// What bounds it on an H100: latency, not bandwidth or FLOPs.  A step is
// ~56 kFLOP per QP at n = 50, m = 100 (one M pass m x n, five E passes
// K x K, four W passes K x n) in a chain of dependent phases: two argmin searches, four block
// reductions and the rank-one updates, each separated by barriers.  A
// QP's state (E, W, M: 41 KB at n = 50, m = 100, K = 51) is read every
// step, so it must not live in device memory.
//
// Design: one thread block per QP (batch-leading state), with E, W and M
// of the lane in dynamic shared memory for the whole round (layout and
// tie rules in slot_step.cuh).  A block whose lane is not EXIT_RUNNING
// copies its state through and does no step.  wgmma / TMA are left to
// later work: the per-step products are matrix-vector, not
// matrix-matrix.
#include "slot_step.cuh"

namespace {

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

__global__ void __launch_bounds__(kThreads)
slot_round_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                  Tol tol) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  const Lane L = slot_carve(sm, m, n, K);

  // load the lane's state
  copy_rows_in(L.E, L.ldK, in(E_) + b * K * K, K, K);
  copy_rows_in(L.W, L.ldn, in(W_) + b * K * n, K, n);
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

  if (c.stt == kRunning) {
    copy_rows_in(L.M, L.ldn, in(M_) + b * m * n, m, n);
    copy_vec(L.du, in(DU_) + b * m, m);
    copy_vec(L.dl, in(DL_) + b * m, m);
    copy_vec(L.sc, in(SC_) + b * m, m);
    copy_vec(L.im, in(IM_) + b * m, m);
    slot_steps(L, c, L.du, L.dl, m, n, K, n_true, steps, tol);
  }
  __syncthreads();

  // write the lane's state back
  copy_rows_out(out(E_) + b * K * K, L.E, L.ldK, K, K);
  copy_rows_out(out(W_) + b * K * n, L.W, L.ldn, K, n);
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
  const size_t smem = slot_smem_floats(m, n, K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slot_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  slot_round_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, m, n, K, n_true, steps, tol);
  return static_cast<int>(cudaGetLastError());
}
