// The cycle probe of the segment kernels B3 (mpc_segment.cu), B4
// (prox_segment.cu), B5 (avi_segment.cu) and B6 (lp_segment.cu), around
// the slot step (slot_step.cuh) and its own probe.  The normal library
// compiles the marks to nothing.
#pragma once

#include "cp_async.cuh"
#include "slot_step.cuh"

namespace {

#ifdef SLOT_PROBE
// chip_profile.py --probe k3 | k4 | k5 | k6 builds one segment kernel
// with -DSLOT_PROBE (beside the step's own probe).  Thread 0 of each block
// adds the SM clock's cycles of each phase of its launch: the loads, each
// pass's (B3: horizon step's) prologue (v and the bounds; B3 the step's
// bounds), inner solve and epilogue (the outer half; B3 the step's
// records), the stores; a block that runs no pass adds its whole time to
// the last phase (stopped), and so does a frozen B3 block's horizon step.
// Then the passes run and the blocks that ran one.  Per block (the first
// kProbeBlocks) it also keeps its whole cycles, its slot steps, its SM
// and its start and end on the global timer (ns); slot_step.cuh counts
// its cold retries.
constexpr int kSegPhases = 6;
constexpr int kSegWords = kSegPhases + 2;
constexpr int kBlockWords = 5;   // cycles, steps, SM, start ns, end ns
__device__ unsigned long long seg_probe_cycles[kSegWords];
__device__ unsigned long long seg_probe_block[kProbeBlocks * kBlockWords];

__device__ __forceinline__ unsigned long long seg_globaltimer() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}

#define SEG_PROBE_INIT                       \
  long long sp_t = clock64();                \
  const long long sp_t0 = sp_t;              \
  const unsigned long long sp_g0 = seg_globaltimer(); \
  long long sp_acc[kSegPhases] = {};         \
  long long sp_passes = 0;                   \
  long long sp_steps = 0;                    \
  bool sp_live = false;
#define SEG_PROBE_MARK(ph)                   \
  if (threadIdx.x == 0) {                    \
    const long long sp_now = clock64();      \
    sp_acc[ph] += sp_now - sp_t;             \
    sp_t = sp_now;                           \
  }
#define SEG_PROBE_PASS                       \
  ++sp_passes;                               \
  sp_live = true;
// phase ph if a pass ran since the last such mark, else stopped
#define SEG_PROBE_MARK_LIVE(ph)              \
  SEG_PROBE_MARK(sp_live ? (ph) : kSegPhases - 1) \
  sp_live = false;
#define SEG_PROBE_STEPS(it) sp_steps += static_cast<long long>(it);
#define SEG_PROBE_FLUSH                                                   \
  if (threadIdx.x == 0) {                                                 \
    if (sp_passes == 0) {                                                 \
      for (int ph = 0; ph < kSegPhases - 1; ++ph) {                       \
        sp_acc[kSegPhases - 1] += sp_acc[ph];                             \
        sp_acc[ph] = 0;                                                   \
      }                                                                   \
    }                                                                     \
    for (int ph = 0; ph < kSegPhases; ++ph)                               \
      atomicAdd(&seg_probe_cycles[ph],                                    \
                static_cast<unsigned long long>(sp_acc[ph]));             \
    atomicAdd(&seg_probe_cycles[kSegPhases],                              \
              static_cast<unsigned long long>(sp_passes));                \
    atomicAdd(&seg_probe_cycles[kSegPhases + 1], sp_passes > 0 ? 1ull     \
                                                               : 0ull);   \
    if (blockIdx.x < kProbeBlocks) {                                      \
      unsigned sp_sm;                                                     \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sp_sm));                  \
      unsigned long long* sp_w =                                          \
          seg_probe_block + blockIdx.x * kBlockWords;                     \
      sp_w[0] = static_cast<unsigned long long>(clock64() - sp_t0);       \
      sp_w[1] = static_cast<unsigned long long>(sp_steps);                \
      sp_w[2] = sp_sm;                                                    \
      sp_w[3] = sp_g0;                                                    \
      sp_w[4] = seg_globaltimer();                                        \
    }                                                                     \
  }
#else
#define SEG_PROBE_INIT
#define SEG_PROBE_MARK(ph)
#define SEG_PROBE_PASS
#define SEG_PROBE_MARK_LIVE(ph)
#define SEG_PROBE_STEPS(it)
#define SEG_PROBE_FLUSH
#endif

// B4's state loads and stores.  A block's state (E, W, M, Rinv and its
// vectors, ~60 KB at n = 50, m = 100) comes in as 4-byte cp.async copies
// (cp_async.cuh), all in flight at once, which the caller then waits for
// (cp_async_wait_all) and syncs: copy_rows_in's load-then-store loop
// waits out one load's latency per element, as the compiler cannot move
// a load of a generic pointer above a store to shared memory (the probe:
// 39k cycles a B4 block, 10k this way).  The copy loop is not inlined,
// so the kernel holds one body for its 21 copies (inlined, B4 grew from
// 9408 to 12880 SASS instructions; a table of the copies walked by one
// loop sat in local memory, a copy a thread, and took 53k cycles a
// block).  The stores read 8 elements into registers before writing
// them.
// rows x cols, row stride ld in shared memory, dense in src
__device__ __noinline__ void seg_rows_async(float* dst, int ld,
                                            const float* src, int rows,
                                            int cols) {
  const int sr = kThreads / cols, sc = kThreads % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    cp_async4(dst + r * ld + c, src + i);
    r += sr;
    c += sc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

__device__ __forceinline__ void seg_vec_async(float* dst, const float* src,
                                              int len) {
  seg_rows_async(dst, len, src, 1, len);
}

__device__ __forceinline__ void seg_rows_out(float* dst, const float* src,
                                             int ld, int rows, int cols) {
  constexpr int kU = 8;
  const int total = rows * cols;
  const int sr = kThreads / cols, sc = kThreads % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  for (int base = threadIdx.x; base < total; base += kU * kThreads) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      v[u] = base + u * kThreads < total ? src[r * ld + c] : 0.f;
      r += sr;
      c += sc;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (base + u * kThreads < total) dst[base + u * kThreads] = v[u];
  }
}

}  // namespace

#ifdef SLOT_PROBE
// The instrumented copy's probe: the step's words (slot_step.cuh: cycles
// per phase, then the steps run), the segment's (kSegWords), the blocks'
// (kProbeBlocks x kBlockWords), then each block's cold retries
// (kProbeBlocks), then each block's step words (kProbeBlocks x
// (kProbePhases + 1)).
extern "C" int seg_probe_reset() {
  const unsigned long long zs[kProbePhases + 1] = {};
  const unsigned long long zg[kSegWords] = {};
  // zeros enough for each of the per-block arrays
  static const unsigned long long zb[kProbeBlocks * (kProbePhases + 1)] = {};
  static_assert(kBlockWords <= kProbePhases + 1, "zeros");
  cudaError_t e = cudaMemcpyToSymbol(slot_probe_cycles, zs, sizeof(zs));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(seg_probe_cycles, zg, sizeof(zg));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(seg_probe_block, zb, sizeof(seg_probe_block));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(slot_probe_retries, zb,
                           sizeof(slot_probe_retries));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(slot_probe_block_phases, zb,
                           sizeof(slot_probe_block_phases));
  return static_cast<int>(e);
}

extern "C" int seg_probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(
      host, slot_probe_cycles, (kProbePhases + 1) * sizeof(*host));
  host += kProbePhases + 1;
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host, seg_probe_cycles,
                             kSegWords * sizeof(*host));
  host += kSegWords;
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host, seg_probe_block,
                             kProbeBlocks * kBlockWords * sizeof(*host));
  host += kProbeBlocks * kBlockWords;
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host, slot_probe_retries,
                             kProbeBlocks * sizeof(*host));
  host += kProbeBlocks;
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host, slot_probe_block_phases,
                             sizeof(slot_probe_block_phases));
  return static_cast<int>(e);
}
#endif
