// B3: P warm MPC horizon steps per launch, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:1866 run_mpc_segment
// (pallas_call at :1921; kernel body _mpc_kernel_body, :728-896).
// Per scenario lane and horizon step p: re-derive the slot bound values
// dsl from sid/slo and the step's bounds duq[p] / dlq[p] (the UPDATE_d
// contract, :809-818), reset the per-solve control state (:822-827), run
// the shared slot step (slot_step.cuh) with the in-kernel cold retry on
// CYCLE / REFACTOR (:836-870), and record u, fval, iterations and status.
// A lane that ends a step RUNNING (step cap), CYCLE or REFACTOR freezes
// for the rest of the segment and raises `failed` (:872-875): the driver
// then redoes the whole segment on the per-step path.  A frozen lane does
// no further step here (and in the plain twin); the TPU kernel keeps
// stepping a frozen RUNNING lane, whose outputs the redo discards anyway.
//
// What bounds it on an H100: latency, as for K2.  A warm step is a few
// iterations of ~60 kFLOP each, in a chain of dependent block-wide phases;
// the state (E, W, M: 41 KB at n = 50, m = 100, K = 51) is staged into
// shared memory once per segment instead of once per horizon step, and
// only the step's bounds (2 m floats) stream in per step.  The probe
// (segment.cuh, chip_profile.py --probe k3) puts the slot step at 96% of
// a horizon step at config 3, and the launch at its slowest lane: one
// lane of 512 runs 314 steps with two cold retries, 5.4x the mean block,
// so the segment's own work is ~2.5% of the launch.
//
// Design: one thread block per scenario lane, the K2 layout
// (slot_carve) in dynamic shared memory; du / dl of the layout hold the
// current step's bounds.  Two bodies of the one segment (mpc_segment),
// chosen by the C entry, the same bits: where K, n <= 64 and m <= 128
// (config 3: K = 51, n = 50, m = 100) the horizon body runs
// slot_step.cuh's step under HorizonStep: every loop one pass of turns
// known at compile time, the list walks and column products unrolled,
// and the E update reading each turn's column records and entries before
// it writes them, ahead of the add's bookkeeping (in turns with the
// parent, scripts/k1_shapes.py --b3: 1.90 ms against the 128-thread
// body's 2.15 at config 3, H100 80GB HBM3 at 700 W; each lever alone in
// PERF.md, section 6); elsewhere the 128-thread body runs the step at the
// run-time shape (ShapeStep), its SASS as before the horizon body.
// Measured against the 128-thread body and not landed: loading the state
// by cp.async (segment.cuh, as B4 does), prefetching the next step's
// bounds, 3 blocks an SM instead of 4; the warp step of slot_warp.cuh
// widened to two items a lane, 39.7k cycles a step against 15.4k; a
// 256-thread step (one config-3 lane silent past mpc's gate: another
// sum order); reading 2 or 4 turns of the E update ahead (other bits).
#include "segment.cuh"

namespace {

// Pointer table, in the order of ops/slot.py run_mpc_segment: SEG_CONST,
// duq, dlq, STATE (in), STATE (out), then useq, fvseq, itseq, stseq,
// failed.
enum Ptr {
  M_, SC_, IM_, SIMM_, FB_, DUQ_, DLQ_,
  AU_, AL_, W_, E_, DSL_, USED_, SID_, SLO_, LAM_, LS_, PD_, PROW_, PLM_,
  PLO_, PID_, PDD_, U_, FV_, BF_, CY_, RP_, IT_, STT_,
  kNumIn,
  kNumState = kNumIn - AU_,
  USEQ_ = kNumIn + kNumState, FVSEQ_, ITSEQ_, STSEQ_, FAIL_,
  kNumPtrs
};

struct Ptrs {
  const void* p[kNumPtrs];
};

// The horizon body's ceilings (K, n <= 64, m <= 128: one pass of each
// loop) and its step: both levers, the ceilings and loads-first.
constexpr int kHorizonK = 64;
constexpr int kHorizonN = 64;
constexpr int kHorizonM = 128;
using HorizonStep = StepCfg<kHorizonK, kHorizonN, kHorizonM, true>;

// A lane's nP horizon steps on the step of Cfg, a lane a block.  The
// pointer table by reference: the 128-thread body reads it in place, as
// its kernel did before the horizon body (the same SASS); the horizon
// body passes a copy, with which ptxas spills 12 B at 128 registers
// against 192 B in place.
template <class Cfg>
__device__ __forceinline__ void mpc_segment(const Ptrs& P, int m, int n,
                                            int K, int n_true, int steps,
                                            int nP, Tol tol) {
  extern __shared__ float sm[];
  SEG_PROBE_INIT
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  auto seq = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[i]));
  };
  const Lane L = slot_carve(sm, m, n, K);

  copy_rows_in(L.E, L.ldK, in(E_) + b * K * K, K, K);
  copy_rows_in(L.W, L.ldn, in(W_) + b * K * n, K, n);
  copy_rows_in(L.M, L.ldn, in(M_) + b * m * n, m, n);
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
  c.stt = static_cast<const int*>(P.p[STT_])[b];
  c.fb = in(FB_)[b];
  bool failed = false;
  __syncthreads();
  SEG_PROBE_MARK(0)

  for (int p = 0; p < nP; ++p) {
    if (!failed) {
      copy_vec(L.du, in(DUQ_) + (b * nP + p) * m, m);
      copy_vec(L.dl, in(DLQ_) + (b * nP + p) * m, m);
      __syncthreads();
      slot_refresh_dsl(L, m, K);
      ctl_reset(c);
      SEG_PROBE_MARK(1)
      slot_solve_retry<Cfg>(L, c, m, n, K, n_true, steps, tol);
      SEG_PROBE_MARK(2)
      SEG_PROBE_STEPS(c.it)
      SEG_PROBE_PASS
      failed = c.stt == kRunning || c.stt == kCycle || c.stt == kRefactor;
    }
    copy_vec(seq(USEQ_) + (b * nP + p) * n, L.u, n);
    if (t == 0) {
      seq(FVSEQ_)[b * nP + p] = c.fv;
      seq(ITSEQ_)[b * nP + p] = c.it;
      reinterpret_cast<int*>(seq(STSEQ_))[b * nP + p] = c.stt;
    }
    SEG_PROBE_MARK_LIVE(3)
  }
  __syncthreads();

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
    seq(FAIL_)[b] = failed ? 1.f : 0.f;
  }
  SEG_PROBE_MARK(4)
  SEG_PROBE_FLUSH
}

__global__ void __launch_bounds__(kThreads)
mpc_segment_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                   int nP, Tol tol) {
  mpc_segment<ShapeStep>(P, m, n, K, n_true, steps, nP, tol);
}

// 4 blocks an SM, as the 128-thread body (128 registers): config 3's 512
// lanes in one wave.  The probe's build lifts it: at 128 registers its
// counters would spill 408 B that the normal build does not carry.
#ifdef SLOT_PROBE
constexpr int kHorizonBlocks = 1;
#else
constexpr int kHorizonBlocks = 4;
#endif

__global__ void __launch_bounds__(kThreads, kHorizonBlocks)
mpc_segment_horizon_kernel(Ptrs P, int m, int n, int K, int n_true,
                           int steps, int nP, Tol tol) {
  const Ptrs table = P;
  mpc_segment<HorizonStep>(table, m, n, K, n_true, steps, nP, tol);
}

// The body: -1 by shape (the horizon body within its ceilings, else the
// 128-thread one; ops/smem.py mpc_horizon mirrors it), 0 the 128-thread
// body, 1 the horizon body (an error past its ceilings).
using MpcKernel = void (*)(Ptrs, int, int, int, int, int, int, Tol);
__host__ inline MpcKernel mpc_body(int m, int n, int K, int body) {
  const bool fits = K <= kHorizonK && n <= kHorizonN && m <= kHorizonM;
  if (body < 0) body = fits ? 1 : 0;
  if (body == 0) return mpc_segment_kernel;
  return body == 1 && fits ? mpc_segment_horizon_kernel : nullptr;
}

}  // namespace

extern "C" int mpc_segment_f32(const void* const* ptrs, int S, int m, int n,
                               int K, int n_true, int steps, int nP,
                               float dual_tol, float primal_tol,
                               float pivot_tol, float sing_tol,
                               float progress_tol, float cycle_tol,
                               int bland, int body, void* stream) {
  Ptrs P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  const Tol tol{dual_tol, primal_tol, pivot_tol, sing_tol, progress_tol,
                cycle_tol, bland};
  const MpcKernel kernel = mpc_body(m, n, K, body);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slot_smem_floats(m, n, K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, m, n, K, n_true, steps, nP, tol);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SEG_OCCUPANCY
// Resident blocks of B3's body `body` (as mpc_segment_f32's) per SM at
// (m, n, K), by the occupancy calculator: chip_profile.py --probe k3
// builds it beside the probe, from this source without the probe's marks
// (-DSEG_OCCUPANCY); the normal library has no such entry.
extern "C" int mpc_segment_occupancy(int m, int n, int K, int body,
                                     int* blocks) {
  const MpcKernel kernel = mpc_body(m, n, K, body);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slot_smem_floats(m, n, K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kThreads, smem);
  return static_cast<int>(e);
}
#endif
