// K2: one round of the slot-space dual active-set solver, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:663 run_slot_round
// (pallas_call at :707; kernel body _kernel_body -> _solve_tile_live,
// pallas_slot.py:102-661).
// Per QP it runs up to `steps` iterations of the shared slot step
// (slot_step.cuh, the step at pallas_slot.py:256-612) on the slot state.
//
// What bounds it on an H100: latency, not bandwidth or FLOPs (the step's
// note in slot_step.cuh).  A QP's state (E, W, M: 48 KB at n = 50,
// m = 100, K = 51) is read every step, so it lives in shared memory for
// the whole round.
//
// Design: one block of kThreads = 128 per QP (batch-leading state), E, W
// and M in dynamic shared memory, loaded and stored a row to a warp;
// three blocks share an SM (__launch_bounds__(128, 3); at config 2's
// shape three fit its shared memory).  A lane that is not EXIT_RUNNING,
// or a round of no steps, is copied through from global to global.
// wgmma / TMA are left out: the per-step products are matrix-vector, not
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

// three blocks to an SM: at n = 50, m = 100 three fit its shared memory
__global__ void __launch_bounds__(kThreads, 3)
slot_round_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                  Tol tol) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const int lane = t & 31, wid = t >> 5;
  const size_t b = blockIdx.x;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  const size_t KK = static_cast<size_t>(K) * K;
  const size_t Kn = static_cast<size_t>(K) * n;

  const int stt = static_cast<const int*>(P.p[STT_])[b];
  if (stt != kRunning || steps <= 0) {
    // terminal or held lane: the state passes through unchanged
    for (size_t i = t; i < KK; i += kThreads)
      out(E_)[b * KK + i] = in(E_)[b * KK + i];
    for (size_t i = t; i < Kn; i += kThreads)
      out(W_)[b * Kn + i] = in(W_)[b * Kn + i];
    for (int i = t; i < m; i += kThreads) {
      out(AU_)[b * m + i] = in(AU_)[b * m + i];
      out(AL_)[b * m + i] = in(AL_)[b * m + i];
    }
    const int slots[] = {DSL_, USED_, SID_, SLO_, LAM_, LS_};
    for (int k = t; k < K; k += kThreads)
      for (int v : slots) out(v)[b * K + k] = in(v)[b * K + k];
    for (int j = t; j < n; j += kThreads) {
      out(PROW_)[b * n + j] = in(PROW_)[b * n + j];
      out(U_)[b * n + j] = in(U_)[b * n + j];
    }
    if (t == 0) {
      const int scalars[] = {PD_, PLM_, PLO_, PID_, PDD_, FV_, BF_, CY_,
                             RP_, IT_};
      for (int v : scalars) out(v)[b] = in(v)[b];
      reinterpret_cast<int*>(out(STT_))[b] = stt;
    }
    return;
  }

  // load the lane's state
  const Lane L = slot_carve(sm, m, n, K);
  for (int i = wid; i < K; i += kWarps) {
    for (int j = lane; j < K; j += 32)
      L.E[i * L.ldK + j] = in(E_)[b * KK + static_cast<size_t>(i) * K + j];
    for (int j = lane; j < n; j += 32)
      L.W[i * L.ldn + j] = in(W_)[b * Kn + static_cast<size_t>(i) * n + j];
  }
  for (int i = wid; i < m; i += kWarps)
    for (int j = lane; j < n; j += 32)
      L.M[i * L.ldn + j] = in(M_)[(b * m + i) * n + j];
  copy_vec(L.du, in(DU_) + b * m, m);
  copy_vec(L.dl, in(DL_) + b * m, m);
  copy_vec(L.sc, in(SC_) + b * m, m);
  copy_vec(L.im, in(IM_) + b * m, m);
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
  c.stt = stt;
  c.fb = in(FB_)[b];
  slot_steps(L, c, L.du, L.dl, m, n, K, n_true, steps, tol);

  // write the lane's state back (slot_steps ends on a barrier)
  for (int i = wid; i < K; i += kWarps) {
    for (int j = lane; j < K; j += 32)
      out(E_)[b * KK + static_cast<size_t>(i) * K + j] = L.E[i * L.ldK + j];
    for (int j = lane; j < n; j += 32)
      out(W_)[b * Kn + static_cast<size_t>(i) * n + j] = L.W[i * L.ldn + j];
  }
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

#ifdef SLOT_PROBE
// The instrumented copy's probe (chip_profile.py --probe k2): the cycles
// per phase summed over blocks, then the steps run (kProbePhases + 1
// words).
extern "C" int slot_probe_reset() {
  const unsigned long long zero[kProbePhases + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(slot_probe_cycles, zero, sizeof(zero)));
}

extern "C" int slot_probe_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, slot_probe_cycles, (kProbePhases + 1) * sizeof(*host)));
}
#endif
