// B9: batched Cholesky + triangular inverse, one warp per matrix, f32,
// sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/chol.py:563
// batched_chol_rinv_dense (kernel body _chol_kernel_dense, chol.py:448).
// Per SPD (n, n) matrix H it computes K1's function, Rinv = (L^{-1})'
// with H = R'R and pivots clamped to `tiny`, with that kernel's step
// structure: per column j one pass that writes column j of L (piv on the
// diagonal) and downdates the trailing matrix; per row i one pass that
// accumulates sum_{k<i} L[i][k] X[k][:] and writes row i of X = L^{-1}
// in place (-inv acc, inv, zeros).  The masks of the TPU kernel
// (Mosaic's workaround for dynamic slices) are gone: a lane touches only
// the elements its step changes.  That order is K1's too, so B9 runs the
// warp per matrix it shares with K1 (chol_warp.cuh: design and bound).
#include "chol_warp.cuh"

namespace {

template <int G, int P>
__global__ void __launch_bounds__(32 * kMaxWarps)
chol_dense_kernel(const float* __restrict__ H, float* __restrict__ Rinv,
                  int B, int n, float tiny) {
  extern __shared__ float smem[];
  chol_body<G, P>(H, Rinv, B, n, tiny, smem);
}

// its instances, for launch_warp
struct B9Kernel {
  template <int G, int P>
  static WarpKernel at() { return &chol_dense_kernel<G, P>; }
};

}  // namespace

// per_block matrices a block of P warps each (chol_warp.cuh shape_ok);
// anything else returns cudaErrorInvalidValue before a launch
extern "C" int chol_dense_f32(const float* H, float* Rinv, int B, int n,
                              int per_block, int P, float tiny,
                              void* stream) {
  return launch_warp<B9Kernel>(H, Rinv, B, n, per_block, P, tiny, stream);
}

#ifdef CHOL_OCCUPANCY
// Resident blocks of B9 per SM at n with `per_block` matrices a block
// of `P` warps each (chip_profile.py --probe k9; the normal library
// has no such entry).
extern "C" int chol_dense_occupancy(int n, int per_block, int P,
                                    int* blocks) {
  return occupancy_warp<B9Kernel>(n, per_block, P, blocks);
}
#endif
