// The per-pass cycle probe of the segment kernels B5 (avi_segment.cu)
// and B6 (lp_segment.cu), around the slot step (slot_step.cuh) and its
// own probe.  The normal library compiles the marks to nothing.
#pragma once

#include "slot_step.cuh"

namespace {

#ifdef SLOT_PROBE
// chip_profile.py --probe k5 | k6 builds one segment kernel with
// -DSLOT_PROBE (beside the step's own probe).  Thread 0 of each block
// adds the SM clock's cycles of each phase of its launch: the loads, each
// pass's prologue (v and the bounds), inner solve and epilogue (the outer
// half), the stores; a block that runs no pass adds its whole time to the
// last phase (stopped).  Then the passes run and the blocks that ran one.
constexpr int kSegPhases = 6;
constexpr int kSegWords = kSegPhases + 2;
__device__ unsigned long long seg_probe_cycles[kSegWords];
#define SEG_PROBE_INIT                       \
  long long sp_t = clock64();                \
  long long sp_acc[kSegPhases] = {};         \
  long long sp_passes = 0;
#define SEG_PROBE_MARK(ph)                   \
  if (threadIdx.x == 0) {                    \
    const long long sp_now = clock64();      \
    sp_acc[ph] += sp_now - sp_t;             \
    sp_t = sp_now;                           \
  }
#define SEG_PROBE_PASS ++sp_passes;
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
  }
#else
#define SEG_PROBE_INIT
#define SEG_PROBE_MARK(ph)
#define SEG_PROBE_PASS
#define SEG_PROBE_FLUSH
#endif

}  // namespace

#ifdef SLOT_PROBE
// The instrumented copy's probe: the step's words (slot_step.cuh: cycles
// per phase, then the steps run), then the segment's (kSegWords).
extern "C" int seg_probe_reset() {
  const unsigned long long zs[kProbePhases + 1] = {};
  const unsigned long long zg[kSegWords] = {};
  cudaError_t e = cudaMemcpyToSymbol(slot_probe_cycles, zs, sizeof(zs));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(seg_probe_cycles, zg, sizeof(zg));
  return static_cast<int>(e);
}

extern "C" int seg_probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(
      host, slot_probe_cycles, (kProbePhases + 1) * sizeof(*host));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host + kProbePhases + 1, seg_probe_cycles,
                             kSegWords * sizeof(*host));
  return static_cast<int>(e);
}
#endif
