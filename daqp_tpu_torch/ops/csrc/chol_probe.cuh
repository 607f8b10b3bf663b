// The cycle probe of the factorization kernels K1 (chol_rinv.cu) and B9
// (chol_dense.cu).  The normal library compiles the marks to nothing.
//
// chip_profile.py --probe k1 | k9 builds one of them alone with
// -DCHOL_PROBE.  The lead thread of each unit (a K1 block, a B9 warp)
// adds the SM clock's cycles of its load, phase 1 (factorization), phase
// 2 (inverse) and store, and counts the unit; per unit (the first
// kProbeUnits) it also keeps its whole cycles, its SM and its start and
// end on the global timer (ns).  A phase ends where the lead thread
// passes the mark, barrier waits included.
#pragma once

#include <cuda_runtime.h>

#ifdef CHOL_PROBE
namespace {

constexpr int kCholPhases = 4;       // load, phase 1, phase 2, store
constexpr int kProbeUnits = 16384;
constexpr int kUnitWords = 4;        // cycles, SM, start ns, end ns
__device__ unsigned long long chol_probe_cycles[kCholPhases + 1];
__device__ unsigned long long chol_probe_unit[kProbeUnits * kUnitWords];

__device__ __forceinline__ unsigned long long chol_globaltimer() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}

}  // namespace

#define CHOL_PROBE_INIT(lead)                      \
  const bool cp_lead = (lead);                     \
  long long cp_t = clock64();                      \
  const long long cp_t0 = cp_t;                    \
  const unsigned long long cp_g0 = chol_globaltimer(); \
  long long cp_acc[kCholPhases] = {};
#define CHOL_PROBE_MARK(ph)                        \
  if (cp_lead) {                                   \
    const long long cp_now = clock64();            \
    cp_acc[ph] += cp_now - cp_t;                   \
    cp_t = cp_now;                                 \
  }
#define CHOL_PROBE_FLUSH(unit)                                            \
  if (cp_lead) {                                                          \
    for (int ph = 0; ph < kCholPhases; ++ph)                              \
      atomicAdd(&chol_probe_cycles[ph],                                   \
                static_cast<unsigned long long>(cp_acc[ph]));             \
    atomicAdd(&chol_probe_cycles[kCholPhases], 1ull);                     \
    if ((unit) < kProbeUnits) {                                           \
      unsigned cp_sm;                                                     \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(cp_sm));                  \
      unsigned long long* cp_w = chol_probe_unit + (unit) * kUnitWords;   \
      cp_w[0] = static_cast<unsigned long long>(clock64() - cp_t0);       \
      cp_w[1] = cp_sm;                                                    \
      cp_w[2] = cp_g0;                                                    \
      cp_w[3] = chol_globaltimer();                                       \
    }                                                                     \
  }

// The instrumented library's probe: the phases' cycles and the units
// (kCholPhases + 1 words), then the units' words (kProbeUnits x
// kUnitWords).
extern "C" int chol_probe_reset() {
  const unsigned long long zc[kCholPhases + 1] = {};
  static const unsigned long long zu[kProbeUnits * kUnitWords] = {};
  cudaError_t e = cudaMemcpyToSymbol(chol_probe_cycles, zc, sizeof(zc));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(chol_probe_unit, zu, sizeof(zu));
  return static_cast<int>(e);
}

extern "C" int chol_probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, chol_probe_cycles,
                                       (kCholPhases + 1) * sizeof(*host));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(host + kCholPhases + 1, chol_probe_unit,
                             kProbeUnits * kUnitWords * sizeof(*host));
  return static_cast<int>(e);
}
#else
#define CHOL_PROBE_INIT(lead)
#define CHOL_PROBE_MARK(ph)
#define CHOL_PROBE_FLUSH(unit)
#endif
