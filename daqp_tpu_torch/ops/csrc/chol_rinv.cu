// K1: batched Cholesky fused with the triangular inverse, f32, sm_90a.
//
// Replaces the TPU kernel daqp_tpu/ops/chol.py:607 batched_chol_rinv_tile
// (kernel body _tile_chol_kernel_loop, chol.py:235).  For each SPD
// (n, n) matrix H of the batch it returns the upper Rinv with H = R'R,
// i.e. Rinv = (L^{-1})' for the lower Cholesky factor L.  A pivot below
// `tiny` clamps to it (never NaN), so the caller's pivot-ratio test
// (chol.py:805-812) flags the lane instead of reading garbage.  In that
// kernel's expression order: step j's pivot piv = sqrt(max(d, tiny)) is
// L[j][j], the column below it is divided by piv, then the rank-1
// trailing update; row i of X = L^{-1} is -inv * sum_{k<i} L[i][k]
// X[k][c] left of the diagonal and inv = 1 / L[i][i] on it.  That order
// is B9's too, and K1 runs the warp per matrix it shares with B9
// (chol_warp.cuh: design and bound): config 2's 10240 matrices run a
// warp each, 8 a block; config 4's retry batch of 256 and the flat
// grid's batches run one matrix a block of 4 or 8 warps (chol_wide),
// which shortens each launch's chain of steps.
#include "chol_warp.cuh"

namespace {

template <int G, int P>
__global__ void __launch_bounds__(32 * kMaxWarps)
chol_rinv_kernel(const float* __restrict__ H, float* __restrict__ Rinv,
                 int B, int n, float tiny) {
  extern __shared__ float smem[];
  chol_body<G, P>(H, Rinv, B, n, tiny, smem);
}

// its instances, for launch_warp
struct K1Kernel {
  template <int G, int P>
  static WarpKernel at() { return &chol_rinv_kernel<G, P>; }
};

}  // namespace

// per_block matrices a block of P warps each (chol_warp.cuh shape_ok);
// anything else returns cudaErrorInvalidValue before a launch
extern "C" int chol_rinv_f32(const float* H, float* Rinv, int B, int n,
                             int per_block, int P, float tiny,
                             void* stream) {
  return launch_warp<K1Kernel>(H, Rinv, B, n, per_block, P, tiny, stream);
}

#ifdef CHOL_OCCUPANCY
// Resident blocks of K1 per SM at n with `per_block` matrices a block
// of `P` warps each (chip_profile.py --probe k1; the normal library
// has no such entry).
extern "C" int chol_rinv_occupancy(int n, int per_block, int P,
                                   int* blocks) {
  return occupancy_warp<K1Kernel>(n, per_block, P, blocks);
}
#endif
