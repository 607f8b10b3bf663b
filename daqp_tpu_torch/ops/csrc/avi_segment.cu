// B5: P Douglas-Rachford passes of the batched AVI per launch, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/pallas_slot.py:1783 run_avi_segment
// (pallas_call at :1841; kernel body _avi_kernel_body, :1545-1781), the
// splitting of daqp_solve_avi (avi.c:6-101).  Per lane and pass, while the
// lane runs (lane_run > 0, not failed, no KKT request):
//   v = Rinv'(G1 x + f) with G1 = H - sym(H) - rho I, d = b_s + M v, dsl
//   refreshed from sid/slo, the per-solve control reset, the slot step
//   (slot_warp.cuh or slot_step.cuh) with steps = 64 and the in-kernel
//   cold retry;
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
// configAVI, and its tail launch at one lane: the last of the 63 launches
// of a configAVI solve holds one live lane for 8 passes of ~10 steps.
//
// Design: two bodies, chosen by the C entry, one pass (avi_segment)
// written once over a body policy.  Up to K, n = 32 (configAVI has K =
// 21, n = 20), where its block fits, one warp runs a lane
// (avi_segment_warp_kernel, WarpBody) on the warp step of slot_warp.cuh:
// ~9.9k SM cycles a step at the tail against the 128-thread step's 11.2k
// (an E update that reads before it writes: PERF.md, section 6).
// Elsewhere (the k5 wide case, n = 40) one thread block of 128 runs a
// lane (avi_segment_kernel, BlockBody) on slot_step.cuh's step.  Both
// compute the same bits (slot_warp.cuh's contract), and the pass's own
// work is, in both, one thread an item summed j = 0, 1, ..., its
// reduction in block_reduce's order.  Each lane's state is the step's
// layout (slot_carve, or slot_warp_carve) followed by its five n x n
// matrices (odd row stride) and the pass vectors, so a pass reads nothing from
// device memory: ~20 KB at n = 20, m = 50 (configAVI), ~99 KB at n = 50,
// m = 100 (dynamic shared memory above 48 KB); the five matrices bound
// the width, 5 n^2 floats.  A 0.546 ms reading of this warp body's tail
// (against the 128-thread body's 0.495) did not recur in 200 calls
// (0.4736-0.4742 ms, the probed SM clock 1993-1995 MHz throughout).  In
// the 128-thread body, products on groups of 8, 4, 2 lanes, shared
// sweeps with 6 barriers, cp.async loads and copying a stopped lane
// global to global were measured no faster at configAVI (PERF.md,
// section 6), and another sum order moves lanes decided at the f32 noise
// floor.
#include "slot_warp.cuh"

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

// The warp body (K, n <= kWarpMaxK): a lane's state in the layout of
// slot_warp_carve followed by the arrays of avi_smem_floats.
__host__ __device__ inline size_t avi_warp_smem_floats(int m, int n, int K) {
  return slot_warp_smem_floats(m, n, K) +
         5 * static_cast<size_t>(n) * (n | 1) + 7 * n + 2 * m;
}

// The 128-thread body: slot_step.cuh's step on a block of kThreads, a
// pass's items one thread each.
struct BlockBody {
  static constexpr int kStride = kThreads;
  __device__ static int lane() { return threadIdx.x; }
  __device__ static Lane carve(float* sm, int m, int n, int K) {
    return slot_carve(sm, m, n, K);
  }
  __device__ static void rows_in(float* dst, int ld, const float* src,
                                 int rows, int cols) {
    copy_rows_in(dst, ld, src, rows, cols);
  }
  __device__ static void vec_in(float* dst, const float* src, int len) {
    copy_vec(dst, src, len);
  }
  __device__ static void rows_out(float* dst, const float* src, int ld,
                                  int rows, int cols) {
    copy_rows_out(dst, src, ld, rows, cols);
  }
  __device__ static void loaded() { __syncthreads(); }
  __device__ static void sync() { __syncthreads(); }

  // out = A w (trans: A' w) for an n x n shared matrix of row stride ld;
  // the caller syncs
  __device__ static void matvec(float* out, const float* A, int ld,
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

  // a' w, summed j = 0, 1, ...
  __device__ static float dot(const float* a, const float* w, int n) {
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += a[j] * w[j];
    return s;
  }

  // the pass's bounds d = b_s + M v; the caller syncs
  __device__ static void bounds(const Lane& L, const float* v,
                                const float* bus, const float* bls, int m,
                                int n) {
    for (int i = threadIdx.x; i < m; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += L.M[i * L.ldn + j] * v[j];
      L.du[i] = bus[i] + s;
      L.dl[i] = bls[i] + s;
    }
  }

  __device__ static void refresh_dsl(const Lane& L, int m, int K) {
    slot_refresh_dsl(L, m, K);
  }
  __device__ static void solve_retry(const Lane& L, Ctl& c, int m, int n,
                                     int K, int n_true, int steps,
                                     const Tol& tol) {
    slot_solve_retry(L, c, m, n, K, n_true, steps, tol);
  }

  // the block's sum of each thread's r
  __device__ static float total(float r, const Lane& L) {
    float s[1] = {r};
    float mx = -INFINITY, av = INFINITY;
    int ai = INT_MAX;
    block_reduce<1>(s, mx, av, ai, L.red);
    return s[0];
  }
};

// The warp body: slot_warp.cuh's step on one warp, a pass's items one
// lane each, summed j = 0, 1, ... as BlockBody, unrolled so that a term's
// loads are in flight before the sums ahead of it (one load's latency a
// term otherwise).
struct WarpBody {
  static constexpr int kStride = 32;
  __device__ static int lane() { return warp_lane(); }
  __device__ static Lane carve(float* sm, int m, int n, int K) {
    return slot_warp_carve(sm, m, n, K);
  }
  __device__ static void rows_in(float* dst, int ld, const float* src,
                                 int rows, int cols) {
    warp_rows_async(dst, ld, src, rows, cols);
  }
  __device__ static void vec_in(float* dst, const float* src, int len) {
    warp_vec_async(dst, src, len);
  }
  __device__ static void rows_out(float* dst, const float* src, int ld,
                                  int rows, int cols) {
    warp_rows_out(dst, src, ld, rows, cols);
  }
  __device__ static void loaded() {
    cp_async_wait_all();
    __syncwarp();
  }
  __device__ static void sync() { __syncwarp(); }

  __device__ static void matvec(float* out, const float* A, int ld,
                                const float* w, int n, bool trans) {
    for (int i = warp_lane(); i < n; i += 32) {
      float s = 0.f;
      if (trans) {
#pragma unroll 4
        for (int j = 0; j < n; ++j) s += A[j * ld + i] * w[j];
      } else {
#pragma unroll 4
        for (int j = 0; j < n; ++j) s += A[i * ld + j] * w[j];
      }
      out[i] = s;
    }
  }

  __device__ static float dot(const float* a, const float* w, int n) {
    float s = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) s += a[j] * w[j];
    return s;
  }

  // two rows a lane at once, each its own sum
  __device__ static void bounds(const Lane& L, const float* v,
                                const float* bus, const float* bls, int m,
                                int n) {
    for (int i = warp_lane(); i < m; i += 64) {
      const int i2 = i + 32 < m ? i + 32 : i;
      float s = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        s += L.M[i * L.ldn + j] * v[j];
        s2 += L.M[i2 * L.ldn + j] * v[j];
      }
      L.du[i] = bus[i] + s;
      L.dl[i] = bls[i] + s;
      if (i + 32 < m) {
        L.du[i2] = bus[i2] + s2;
        L.dl[i2] = bls[i2] + s2;
      }
    }
  }

  __device__ static void refresh_dsl(const Lane& L, int m, int K) {
    warp_refresh_dsl(L, m, K);
  }
  __device__ static void solve_retry(const Lane& L, Ctl& c, int m, int n,
                                     int K, int n_true, int steps,
                                     const Tol& tol) {
    slot_warp_solve_retry(L, c, m, n, K, n_true, steps, tol);
  }

  // block_reduce's ((w0 + w1) + w2) + w3, the other warps' sums +0
  __device__ static float total(float r, const Lane&) {
    float s[1] = {r};
    float mx = -INFINITY;
    warp_reduce<1, false>(s, mx);
    return ((s[0] + 0.f) + 0.f) + 0.f;
  }
};

// A lane's nP passes on the body of Body, a lane a block.
template <class Body>
__device__ __forceinline__ void avi_segment(Ptrs P, int m, int n, int K,
                                            int n_true, int steps, int nP,
                                            Tol tol) {
  extern __shared__ float sm[];
  SEG_PROBE_INIT
  const int t = Body::lane();
  constexpr int S = Body::kStride;
  const size_t b = blockIdx.x;
  auto in = [&](int i) { return static_cast<const float*>(P.p[i]); };
  auto out = [&](int i) {
    return static_cast<float*>(const_cast<void*>(P.p[kNumIn + i - AU_]));
  };
  const Lane L = Body::carve(sm, m, n, K);
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

  Body::rows_in(L.E, L.ldK, in(E_) + b * K * K, K, K);
  Body::rows_in(L.W, ldn, in(W_) + b * K * n, K, n);
  Body::rows_in(L.M, ldn, in(M_) + b * m * n, m, n);
  Body::rows_in(R, ldn, in(R_) + b * nn, n, n);
  Body::rows_in(G1, ldn, in(G1_) + b * nn, n, n);
  Body::rows_in(G2, ldn, in(G2_) + b * nn, n, n);
  Body::rows_in(G3, ldn, in(G3_) + b * nn, n, n);
  Body::rows_in(Hri, ldn, in(HRI_) + b * nn, n, n);
  Body::vec_in(L.sc, in(SC_) + b * m, m);
  Body::vec_in(L.im, in(IM_) + b * m, m);
  Body::vec_in(bus, in(BUS_) + b * m, m);
  Body::vec_in(bls, in(BLS_) + b * m, m);
  Body::vec_in(L.au, in(AU_) + b * m, m);
  Body::vec_in(L.al, in(AL_) + b * m, m);
  Body::vec_in(L.dsl, in(DSL_) + b * K, K);
  Body::vec_in(L.used, in(USED_) + b * K, K);
  Body::vec_in(L.sid, in(SID_) + b * K, K);
  Body::vec_in(L.slo, in(SLO_) + b * K, K);
  Body::vec_in(L.simm, in(SIMM_) + b * K, K);
  Body::vec_in(L.lam, in(LAM_) + b * K, K);
  Body::vec_in(L.ls, in(LS_) + b * K, K);
  Body::vec_in(L.prow, in(PROW_) + b * n, n);
  Body::vec_in(L.u, in(U_) + b * n, n);
  Body::vec_in(x, in(X_) + b * n, n);
  Body::vec_in(y, in(Y_) + b * n, n);
  Body::vec_in(xo, in(XO_) + b * n, n);
  Body::vec_in(fz, in(FZ_) + b * n, n);
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
  Body::loaded();
  SEG_PROBE_MARK(0)

  for (; p < nP && lr > 0.f && !failed && !kkt; ++p) {
    // v = Rinv'(G1 x + f) and the pass's bounds d = b_s + M v
    // (pallas_slot.py:1659-1670)
    Body::matvec(tv, G1, ldn, x, n, false);
    Body::sync();
    for (int j = t; j < n; j += S) tv[j] += fz[j];
    Body::sync();
    Body::matvec(v, R, ldn, tv, n, true);
    Body::sync();
    Body::bounds(L, v, bus, bls, m, n);
    Body::sync();
    Body::refresh_dsl(L, m, K);
    ctl_reset(c);
    SEG_PROBE_MARK(1)
    Body::solve_retry(L, c, m, n, K, n_true, steps, tol);
    SEG_PROBE_MARK(2)
    failed = c.stt == kRunning || c.stt == kCycle || c.stt == kRefactor;
    const bool run2 = !failed;
    const bool inner_ok = c.stt > 0 && run2;

    // y = Rinv (u - v) and the residual ||x - y||^2 (:1723-1729)
    for (int j = t; j < n; j += S) tv[j] = L.u[j] - v[j];
    Body::sync();
    float* yi = v;                 // v is spent
    float r = 0.f;
    for (int i = t; i < n; i += S) {
      const float s = Body::dot(R + i * ldn, tv, n);
      yi[i] = s;
      r += (x[i] - s) * (x[i] - s);
    }
    const float res2 = Body::total(r, L);

    // Newton-step bookkeeping (avi.c:44-61) and the stable-set counter
    const bool at_limit = ct == tl && run2;
    const bool worse = at_limit && res2 > mr;
    if (worse) tl = fminf(tl + 5.f, 30.f);
    if (at_limit && !worse) mr = res2;
    for (int i = t; i < n; i += S) {
      if (worse) x[i] = xo[i];
      if (run2 && !worse) y[i] = yi[i];
    }
    const bool stable = c.it <= 1.f && run2;
    ct = stable ? ct + 1.f : (run2 ? 0.f : ct);
    const bool do_kkt = stable && ct == tl && inner_ok;
    kkt = kkt || do_kkt;
    Body::sync();

    // DR update for running, non-KKT lanes (avi.c:84-96)
    if (run2 && !do_kkt && inner_ok) {
      Body::matvec(tv, G2, ldn, y, n, false);
      Body::matvec(tw, G3, ldn, x, n, false);
      Body::sync();
      for (int j = t; j < n; j += S) tv[j] += tw[j];
      Body::sync();
      Body::matvec(x, Hri, ldn, tv, n, false);
    }
    if (run2 && !(c.stt > 0)) {
      lf = c.stt;
      lr = 0.f;
    }
    tt += c.it;
    SEG_PROBE_STEPS(c.it)
    Body::sync();
    SEG_PROBE_MARK(3)
    SEG_PROBE_PASS
  }

  Body::rows_out(out(E_) + b * K * K, L.E, L.ldK, K, K);
  Body::rows_out(out(W_) + b * K * n, L.W, ldn, K, n);
  for (int i = t; i < m; i += S) {
    out(AU_)[b * m + i] = L.au[i];
    out(AL_)[b * m + i] = L.al[i];
  }
  for (int k = t; k < K; k += S) {
    out(DSL_)[b * K + k] = L.dsl[k];
    out(USED_)[b * K + k] = L.used[k];
    out(SID_)[b * K + k] = L.sid[k];
    out(SLO_)[b * K + k] = L.slo[k];
    out(LAM_)[b * K + k] = L.lam[k];
    out(LS_)[b * K + k] = L.ls[k];
  }
  if (P.p[DUO_] != nullptr && p > 0)
    for (int i = t; i < m; i += S) {
      static_cast<float*>(const_cast<void*>(P.p[DUO_]))[b * m + i] = L.du[i];
      static_cast<float*>(const_cast<void*>(P.p[DLO_]))[b * m + i] = L.dl[i];
    }
  for (int j = t; j < n; j += S) {
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

__global__ void __launch_bounds__(kThreads)
avi_segment_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                   int nP, Tol tol) {
  avi_segment<BlockBody>(P, m, n, K, n_true, steps, nP, tol);
}

__global__ void __launch_bounds__(32)
avi_segment_warp_kernel(Ptrs P, int m, int n, int K, int n_true, int steps,
                        int nP, Tol tol) {
  avi_segment<WarpBody>(P, m, n, K, n_true, steps, nP, tol);
}

}  // namespace

// The body by shape: the warp step up to kWarpMaxK slots and columns where
// its block fits the device's opt-in shared memory, else the 128-thread
// block (ops/smem.py avi_floats mirrors the choice).
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
  const size_t warp = avi_warp_smem_floats(m, n, K) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (K <= kWarpMaxK && n <= kWarpMaxK && warp <= static_cast<size_t>(optin))
    return seg_launch(avi_segment_warp_kernel, B, 32, warp, stream, P, m, n,
                      K, n_true, steps, nP, tol);
  return seg_launch(avi_segment_kernel, B, kThreads,
                    avi_smem_floats(m, n, K) * sizeof(float), stream, P, m,
                    n, K, n_true, steps, nP, tol);
}
