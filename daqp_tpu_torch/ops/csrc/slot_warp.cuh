// The slot-space dual active-set step on one warp a lane, for K <= 32
// slots and n <= 32 columns: the body of B5 (avi_segment.cu) and B6
// (lp_segment.cu) at those shapes where a lane's state fits one block.
// Elsewhere, and in K2, B3 and B4 at every shape, the 128-thread step of
// slot_step.cuh runs.  B3 at config 3 (n = 50, K = 51)
// is past it: the same step with two items a lane (K, n <= 64) took 39.7k
// SM cycles a step there against the 128-thread step's 15.4k, one warp
// running 4 rows of 50-term products and two items' E update a lane
// (PERF.md, section 6), so it was not kept.
//
// It computes slot_step.cuh's step (slot_steps; pallas_slot.py:256-612)
// with the same bits.  K2 replays a segment's inner solves from the
// kernel's own bounds, and the slot state must come out equal (chip_smoke's
// k5 (a), k6 (a)): a lane decided at the f32 noise floor goes elsewhere
// under another sum order (one moved configLP's slowest lane from 186 to
// 232 steps, PERF.md section 6).  The contract:
// - every item's sum keeps its chains, in the 128-thread step's order
//   (the inputs j = x mod 8 of a group of 8 lanes, or j = x mod 16 over
//   the used list, each chain from +0 in increasing j), and their
//   combination: slot_tsum8's transposing butterfly adds, for every item,
//   ((P0 + P4) + (P2 + P6)) + ((P1 + P5) + (P3 + P7)) (tree8; float
//   addition commutes, so the lane that ends with the item does not
//   matter), after slot_pair8's Q_x = S_x + S_x+8 (tree16);
// - a block reduction butterflies, in lanes placed as in the warp of the
//   128-thread block that held the items (xor 16 ... 1), and combines the
//   warps' sums as (w0 + w1) + (w2 + w3) (slot_reduce) or ((w0 + w1) +
//   w2) + w3 (block_reduce), a warp without items counting +0: the
//   columns of u and the add's row sat in warp 2 (t ^ 64), the used
//   list's items 0-15 in warp 0 and 16-31 in warp 1 (pair_item); a step
//   past 32 (K = 33-64, two items a lane) puts the items 32-47
//   as warp 2 held them and 48-63 as warp 3, the columns 32-63 as warp 3,
//   each as 0-31 sit in warps 0-1 and 2, and adds (w0 + w1) + (w2 + w3);
// - an argmin (lowest index on ties and on NaN, `better`) and a max do
//   not depend on the order; the other expressions are slot_steps' own,
//   and a value read back from shared memory is the value written, so a
//   sum may take it from the register that wrote it.
// So one lane computes a whole item (one lane an item: a row of M, a
// column of u, an item of the used list), its chains in registers, and
// no product runs a shuffle; what a term needs of another item, that
// item's lane first stages in shared memory (R4, R2).
//
// What bounds it: latency, as the 128-thread step; one warp issues the
// whole step.  The probe of the 128-thread step (chip_profile.py --probe
// k5 k6, PERF.md section 6) measured 11.2-11.3k SM cycles a step at
// configAVI and configLP: five block barriers and three two-level
// reductions through shared scratch, on four warps that mostly hold
// nothing at n = 10-20.  Here a step has no block barrier (__syncwarp
// where slot_steps has __syncthreads), the reductions stay in registers,
// a phase's independent loads are issued before its products, and the
// products run unrolled blocks of 8 terms with no branch a term.  A store
// to shared memory holds back every load after it (the compiler cannot
// tell the arrays apart), so the E update reads each block of 8 columns,
// their records and entries before it writes, and the bookkeeping, the W
// update and the act rows read before they write; a_p = E g_p, a pass of
// its own in slot_steps, rides in the E update's (the E update and
// bookkeeping from 3.7k to 2.8k cycles at B5's tail).  The probe puts
// the step at ~9.9k cycles at B5's tail, ~9.3k in its cold segment and
// ~8.3k at configLP.  The state stays in shared memory in slot_carve's
// layout, the reduction scratch giving way to the list and the records
// (slot_warp_carve).
#pragma once

#include "segment.cuh"

namespace {

constexpr int kWarpMaxK = 32;          // slots of the warp step: one ballot

constexpr int kPosArrays = 6;          // the warp step's per-position values

// Mirrored by ops/smem.py slot_warp_floats.
__host__ __device__ inline size_t slot_warp_smem_floats(int m, int n, int K) {
  const int ldK = K | 1, ldn = n | 1;
  return static_cast<size_t>(K) * ldK + static_cast<size_t>(K) * ldn +
         static_cast<size_t>(m) * ldn + 7 * m + 15 * K + 4 * n +
         (1 + kPosArrays) * kWarpMaxK + 4;
}

// slot_carve's layout without the reduction scratch; where it was, the
// used-slot list (kWarpMaxK entries: a product reads its positions past
// the used count, which hold earlier slots, all below K) and the
// per-position records of slot_warp_steps from L.red, 16-byte aligned.
__device__ __forceinline__ Lane slot_warp_carve(float* sm, int m, int n,
                                                int K) {
  Lane L = slot_carve(sm, m, n, K);
  L.list = reinterpret_cast<int*>(L.add_row + n);
  float* red = L.add_row + n + kWarpMaxK;
  L.red = red + ((4 - (reinterpret_cast<size_t>(red) >> 2)) & 3);
  L.end = red + kPosArrays * kWarpMaxK + 4;
  return L;
}

__device__ __forceinline__ int warp_lane() { return threadIdx.x & 31; }

// The butterfly of a warp of the 128-thread block (xor 16 ... 1), on the
// NS sums s and, with kMax, the NaN-propagating max mx, in one unrolled
// loop so that their shuffles overlap.  Every lane ends with the same
// values.
template <int NS, bool kMax>
__device__ __forceinline__ void warp_reduce(float (&s)[NS], float& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < NS; ++q) s[q] += __shfl_xor_sync(kFull, s[q], o);
    if (kMax) mx = max_nan(mx, __shfl_xor_sync(kFull, mx, o));
  }
}

// better's order as one unsigned key: NaN lowest, then the value, -0 as
// +0; the index breaks ties
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0u;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The lowest-index argmin of (av, ai) over the warp, as a butterfly of
// `better` finds it (its order is total, so every tree finds the same
// winner), by two min-reductions and the winner's value; every lane ends
// with it.
__device__ __forceinline__ void warp_argmin(float& av, int& ai) {
  const unsigned key = order_key(av);
  const unsigned kmin = __reduce_min_sync(kFull, key);
  const unsigned imin = __reduce_min_sync(
      kFull, key == kmin ? static_cast<unsigned>(ai) : 0xffffffffu);
  const unsigned who = __ballot_sync(
      kFull, key == kmin && static_cast<unsigned>(ai) == imin);
  av = __shfl_sync(kFull, av, __ffs(who) - 1);
  ai = static_cast<int>(imin);
}

// The warp's state loads: cp.async copies, all in flight at once, which
// the caller waits for (cp_async_wait_all) before a __syncwarp; rows x
// cols, row stride ld in shared memory, dense in src.  The row and column
// step along without a division (as segment.cuh's copies).
__device__ __noinline__ void warp_rows_async(float* dst, int ld,
                                             const float* src, int rows,
                                             int cols) {
  const int sr = 32 / cols, sc = 32 % cols;
  int r = warp_lane() / cols, c = warp_lane() % cols;
  for (int i = warp_lane(); i < rows * cols; i += 32) {
    cp_async4(dst + r * ld + c, src + i);
    r += sr;
    c += sc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

__device__ __forceinline__ void warp_vec_async(float* dst, const float* src,
                                               int len) {
  warp_rows_async(dst, len, src, 1, len);
}

__device__ __noinline__ void warp_rows_out(float* dst, const float* src,
                                           int ld, int rows, int cols) {
  const int sr = 32 / cols, sc = 32 % cols;
  int r = warp_lane() / cols, c = warp_lane() % cols;
  for (int i = warp_lane(); i < rows * cols; i += 32) {
    dst[i] = src[r * ld + c];
    r += sr;
    c += sc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// The used slots, in slot order, into L.list; their number.
__device__ __forceinline__ int warp_list(const Lane& L, int K) {
  const int l = warp_lane();
  const bool on = l < K && L.used[l] > 0.f;
  const unsigned bal = __ballot_sync(kFull, on);
  if (on) L.list[__popc(bal & ((1u << l) - 1u))] = l;
  return __popc(bal);
}

// slot_tsum8's sum of one item from its chains P[x] (the inputs j = x
// mod 8): the lane that ends with item r adds ((P_r + P_r^4) + (P_r^2 +
// P_r^6)) + ((P_r^1 + P_r^5) + (P_r^3 + P_r^7)), the same tree for every r
// as float addition commutes.
__device__ __forceinline__ float tree8(const float (&P)[kSG]) {
  return ((P[0] + P[4]) + (P[2] + P[6])) + ((P[1] + P[5]) + (P[3] + P[7]));
}

// slot_pair8 then slot_tsum8: the chains S[x] of the inputs cc = x mod 16
__device__ __forceinline__ float tree16(const float (&S)[2 * kSG]) {
  float Q[kSG];
#pragma unroll
  for (int x = 0; x < kSG; ++x) Q[x] = S[x] + S[x + kSG];
  return tree8(Q);
}

// f(i, x, on) for i < kWarpMaxK (list positions, or columns: n <= 32 in
// the warp body) in blocks of 8, each unrolled so that i and x = i mod C
// (C chains) are known when it compiles; on is i < len, and a block past
// len does not run.  A read past len stays in the lane's shared memory (a
// list position past the used count holds a slot below K) and is not
// summed.
template <int C, class F>
__device__ __forceinline__ void terms(int len, F f) {
#pragma unroll
  for (int b = 0; b < kWarpMaxK; b += kSG) {
    if (b < len) {
#pragma unroll
      for (int y = 0; y < kSG; ++y) f(b + y, (b + y) % C, b + y < len);
    }
  }
}

// The lane that holds list position cc's item: items 0-15 (the owners of
// the 128-thread step's warp 0) at their lanes there, items 16-31 (warp
// 1) at those lanes xor 8, so that a sum over the owners butterflies each
// warp's values in its lanes, +0 elsewhere (it swaps bits 3 and 4, and is
// its own inverse).
__host__ __device__ constexpr int pair_item(int l) {
  return 16 * ((l >> 3) & 1) + 8 * (l >> 4) + (l & 7);
}

// slot_steps on one warp (K, n <= 32), one lane an item: each item's sum
// keeps its chains and tree (tree8, tree16) in the lane's registers, so
// no product runs a shuffle or a branch a term; what a term needs of
// another item (its slot, v, g, e, w, d, keep) the item's lane stages in
// shared memory first (L.red, kPosArrays x kWarpMaxK).  The same phases,
// expressions and probe marks as slot_steps.
__device__ __forceinline__ void slot_warp_steps(const Lane& L, Ctl& c,
                                                const float* du,
                                                const float* dl, int m,
                                                int n, int K, int n_true,
                                                int steps, const Tol& tol) {
  if (c.stt != kRunning) return;
  const int l = warp_lane();
  const int pi = pair_item(l);          // this lane's list position
  const bool w1 = (l & kSG) != 0;       // pi is an item of virtual warp 1
  const int ldK = L.ldK, ldn = L.ldn;
  float* E = L.E;
  float* W = L.W;
  const float* M = L.M;
  const float* sc = L.sc;
  const float* im = L.im;
  float* au = L.au;
  float* al = L.al;
  float* lo_okv = L.lo_okv;
  float* dsl = L.dsl;
  float* used = L.used;
  float* sid = L.sid;
  float* slo = L.slo;
  const float* simm = L.simm;
  float* lam = L.lam;
  float* ls = L.ls;
  float* lstar = L.lstar;
  float* a_p = L.a_p;
  float* delta = L.delta;
  float* g_k = L.g_k;
  float* e = L.e;
  float* a = L.a;
  float* g_p = L.g_p;
  float* prow = L.prow;
  float* u = L.u;
  float* u_new = L.u_new;
  float* add_row = L.add_row;
  int* list = L.list;
  // per list position, what another item's term needs of it: R4 the
  // prefix's (d, g_p, slot) and the E update's (e, w, d, keep); R2 u's (v,
  // W row offset), the Schur vector's (g_k, slot) and a_p's (g_p, slot).
  // A term past the used count reads a stale record, whose index (a slot,
  // or a row offset below K ldn) keeps its read inside E and W; the
  // prefix zeroes them all first
  float4* R4 = reinterpret_cast<float4*>(L.red);
  float2* R2 = reinterpret_cast<float2*>(L.red + 4 * kWarpMaxK);
  float pd = c.pd, plm = c.plm, plo = c.plo, pid = c.pid, pdd = c.pdd;
  float fv = c.fv, bf = c.bf, cy = c.cy, it = c.it;
  const float rp = c.rp, fb = c.fb;
  int stt = c.stt;
  SLOT_PROBE_INIT
  __syncwarp();

  // round-start prefix from the stored E: the list (its every position,
  // and every record's, a slot); lam* = a_p = 0 off it; g_p = (W prow) o
  // used; lam* = -E (dsl o used), a_p = E g_p on the list
  list[l] = 0;
  R4[l] = make_float4(0.f, 0.f, 0.f, 0.f);
  R2[l] = make_float2(0.f, 0.f);
  __syncwarp();
  int k = warp_list(L, K);
  if (l < K) {
    if (!(used[l] > 0.f)) {
      lstar[l] = 0.f;
      a_p[l] = 0.f;
    }
    float sp = 0.f;
    if (pd > 0.f) {
      const float* Wl = W + l * ldn;
      float P[kSG] = {};
      terms<kSG>(n, [&](int j, int x, bool on) {
        const float wj = Wl[j], pj = prow[j];
        if (on) P[x] += wj * pj;
      });
      sp = tree8(P);
    }
    g_p[l] = sp * used[l];
  }
  __syncwarp();
  if (pi < k) {
    const int s = list[pi];
    R4[pi] = make_float4(dsl[s] * used[s], g_p[s], __int_as_float(s), 0.f);
  }
  __syncwarp();
  if (pi < k) {
    const int i = list[pi];
    const float* Ei = E + i * ldK;
    float s1[2 * kSG] = {}, s2[2 * kSG] = {};
    terms<2 * kSG>(k, [&](int cc, int x, bool on) {
      const float4 r = R4[cc];
      const float eij = Ei[__float_as_int(r.z)];
      const float dj = r.x, gj = r.y;
      if (on) {
        s1[x] += eij * dj;
        s2[x] += eij * gj;
      }
    });
    lstar[i] = -tree16(s1);
    a_p[i] = tree16(s2);
  }
  __syncwarp();
  int kU = k;                       // the update's list: used, + removed
  SLOT_PROBE_MARK(0)

  for (int step = 0; step < steps; ++step) {
    const float sgn_p = 1.f - 2.f * plo;

    // blocking min-ratio search over the slots (a lane a slot) and u =
    // -W'(lam* o used) over the update's list (a lane a column), in one
    // branch-free stretch: every lane computes both, for a slot or column
    // past the end on a valid one, and stores only its own; ||u||^2: the
    // 128-thread step's warp 2 holds the columns j < 32
    float r1[1] = {0.f};
    float av[2] = {INFINITY, INFINITY};
    int ai[2] = {INT_MAX, INT_MAX};
    if (pi < kU) {
      const int s = list[pi];
      R2[pi] = make_float2(lstar[s] * used[s], __int_as_float(s * ldn));
    }
    // the slot lane's values (none changes before the removal below)
    const int sl = min(l, K - 1);
    const float ap_l = a_p[sl], lstar_l = lstar[sl], lam_l = lam[sl];
    const float slo_l = slo[sl], used_l = used[sl], simm_l = simm[sl];
    const float dsl_l = dsl[sl], sid_l = sid[sl];
    float delta_l;
    __syncwarp();
    {
      const float* Wj = W + l;
      float P[kSG] = {};
      terms<kSG>(kU, [&](int cc, int x, bool on) {
        const float2 r = R2[cc];
        const float wsj = Wj[__float_as_int(r.y)], v = r.x;
        if (on) P[x] += wsj * v;
      });
      const float sdir = -ap_l * sgn_p;
      const float dk = pd * sdir + (1.f - pd) * (lstar_l - lam_l);
      delta_l = dk;
      const float signv = pd * sdir + (1.f - pd) * lstar_l;
      const float infeas =
          slo_l * (signv > tol.dtol ? 1.f : 0.f) +
          (1.f - slo_l) * (signv < -tol.dtol ? 1.f : 0.f);
      const float elig = infeas * used_l * (1.f - simm_l);
      float ratio = -lam_l / dk;
      ratio = isfinite(ratio) ? fmaxf(ratio, 0.f) : 0.f;
      const float cand = elig > 0.f ? ratio : kBig;
      if (l < K) {
        delta[l] = dk;
        if (better(cand, l, av[0], ai[0])) { av[0] = cand; ai[0] = l; }
      }
      const float sj = tree8(P);
      if (l < n) {
        u_new[l] = -sj;
        r1[0] += sj * sj;
      }
    }
    __syncwarp();
    SLOT_PROBE_MARK(1)

    // the list of this step's used slots; pricing on mu = M u (a lane a
    // row, two at once); the reduction of both searches and ||u||^2
    k = warp_list(L, K);
    // a row's pricing from its values, read before its product
    struct RowIn {
      float sc, du, dl, act, im;
    };
    auto row_in = [&](int i) {
      return RowIn{sc[i], du[i], dl[i], au[i] + al[i], im[i]};
    };
    auto price_row = [&](int i, const RowIn& r, float mu) {
      const float bound = -tol.ptol * r.sc;
      const float v_up = r.du - mu;
      const float v_lo = mu - r.dl;
      const float pblock = pd * (static_cast<float>(i) == pid ? 1.f : 0.f);
      const bool blocked = r.act > 0.f || r.im > 0.f || pblock > 0.f;
      const bool up_ok = v_up < bound && !blocked;
      const bool lo_ok = v_lo < bound && !blocked && !up_ok;
      float cand = up_ok ? v_up : (lo_ok ? v_lo : kBig);
      if (tol.bland)
        cand = (up_ok || lo_ok) ? static_cast<float>(i) - kBig : kBig;
      lo_okv[i] = lo_ok ? 1.f : 0.f;
      if (better(cand, i, av[1], ai[1])) { av[1] = cand; ai[1] = i; }
    };
#pragma unroll 1
    for (int i = l; i < m; i += 64) {
      const int i2 = i + 32 < m ? i + 32 : i;
      const float* Mi = M + i * ldn;
      const float* Mi2 = M + i2 * ldn;
      const RowIn in1 = row_in(i), in2 = row_in(i2);
      float P[kSG] = {}, Q[kSG] = {};
      terms<kSG>(n, [&](int j, int x, bool on) {
        const float uj = u_new[j], a1 = Mi[j], a2 = Mi2[j];
        if (on) {
          P[x] += a1 * uj;
          Q[x] += a2 * uj;
        }
      });
      price_row(i, in1, tree8(P));
      if (i + 32 < m) price_row(i2, in2, tree8(Q));
    }
    __syncwarp();
    float mx = -INFINITY;
    warp_reduce<1, false>(r1, mx);
    warp_argmin(av[0], ai[0]);
    warp_argmin(av[1], ai[1]);
    SLOT_PROBE_MARK(2)
    // slot_reduce's (w0 + w1) + (w2 + w3), the other warps' sums +0
    const float fv_new = (0.f + 0.f) + (r1[0] + 0.f);
    const float rmin = av[0], vmin = av[1];
    const int rm = ai[0], jr = ai[1];
    const float do_rm0 = rmin < kBig ? 1.f : 0.f;
    const float rm_id = sid[rm];
    const float rm_lo = slo[rm];
    const float found = vmin < 0.f ? 1.f : 0.f;
    const float j_lo = lo_okv[jr];
    const float d_j = j_lo * dl[jr] + (1.f - j_lo) * du[jr];

    // add candidate: pending retry after a removal, or the priced row
    const float retry = pd * do_rm0;
    const float price0 = (1.f - do_rm0) * (1.f - pd);
    const float padd0 = price0 * found;
    const float add_lo = retry * plo + padd0 * j_lo;
    const float add_lam = retry * plm + padd0 * (1.f - 2.f * j_lo);
    const float add_id = retry * pid + padd0 * static_cast<float>(jr);
    const float add_d = retry * pdd + padd0 * d_j;
    const float* mj = M + jr * ldn;
    auto xadd = [&](int j) { return retry * prow[j] + padd0 * mj[j]; };

    // the add's row and its ||.||^2; then the Gram column g_k over the
    // list (a lane an item, on the add's row as stored), the removed
    // column e, e.g_k and max|e|
    // r3: e.g_k of the items of warps 0 and 1, ||add row||^2 (warp 2)
    float r3[3] = {0.f, 0.f, 0.f};
    float emax = -INFINITY;
    // the item's own values, kept for the E update's columns
    int own_s = 0;
    float own_used = 0.f, own_e = 0.f, own_dsl = 0.f, own_a = 0.f;
    if (l < n) {
      const float x = xadd(l);
      add_row[l] = x;
      r3[2] += x * x;
    }
    __syncwarp();
    if (pi < k) {
      const int s = list[pi];
      const float* Ws = W + s * ldn;
      const float used_s = used[s], es = E[s * ldK + rm];
      own_s = s;
      own_used = used_s;
      own_e = es;
      own_dsl = dsl[s];
      float S[2 * kSG] = {};
      terms<2 * kSG>(n, [&](int j, int x, bool on) {
        const float wj = Ws[j], xj = add_row[j];
        if (on) S[x] += wj * xj;
      });
      const float sg = tree16(S);
      const float keep0 = 1.f - (s == rm ? 1.f : 0.f) * do_rm0;
      const float gs = sg * used_s * keep0;
      g_k[s] = gs;
      e[s] = es;
      R2[pi] = make_float2(gs, __int_as_float(s));
      float r = 0.f;
      r += es * gs;
      r3[0] = w1 ? 0.f : r;
      r3[1] = w1 ? r : 0.f;
      emax = max_nan(emax, fabsf(es));
    }
    __syncwarp();
    warp_reduce<3, true>(r3, emax);
    SLOT_PROBE_MARK(3)
    const float err = E[rm * ldK + rm];            // e[rm]
    const float dii = (0.f + 0.f) + (r3[2] + 0.f);
    const bool bad = do_rm0 > 0.f && err < tol.pivtol * emax;
    const float err_s = err != 0.f ? err : 1.f;
    const float ec = ((r3[0] + r3[1]) + (0.f + 0.f)) / err_s;
    if (bad) stt = kRefactor;
    const float do_rm = bad ? 0.f : do_rm0;
    const float alpha = do_rm * (rmin < kBig ? rmin : 0.f);
    plm = plm + alpha * sgn_p * pd;

    // exits
    if (stt == kRunning && pd > 0.f && do_rm == 0.f)
      stt = rp > 0.f ? kInfeasible : kCycle;
    if (price0 > 0.f && stt == kRunning && fv_new > fb) stt = kInfeasible;
    const float price = stt == kRunning ? price0 : 0.f;
    if (price > 0.f && found == 0.f) stt = kOptimal;
    const bool no_prog =
        fv_new - bf < tol.progtol * (1.f + fabsf(fv_new));
    if (price > 0.f) {
      cy = no_prog ? cy + 1.f : 0.f;
      if (!no_prog) bf = fv_new;
      if (cy > tol.cyctol && stt == kRunning) stt = kCycle;
      fv = fv_new;
    }
    const float padd = stt == kRunning ? padd0 : 0.f;

    // the Schur vector a_pre = E g_k over the list, a_post and g_k.a_post
    // (a lane an item); the dual step, the removal, lam <- lam* before a
    // priced add, the lam* record and the first free slot (a lane a slot)
    float r4[2] = {0.f, 0.f};       // g_k.a_post, warps 0 and 1
    float fv_free = INFINITY;
    int free_i = INT_MAX;
    if (pi < k) {
      const int s = list[pi];
      const float* Es = E + s * ldK;
      const float es = e[s], gs = g_k[s];
      float S[2 * kSG] = {};
      terms<2 * kSG>(k, [&](int cc, int x, bool on) {
        const float2 r = R2[cc];
        const float ej = Es[__float_as_int(r.y)], gj = r.x;
        if (on) S[x] += ej * gj;
      });
      const float sa = tree16(S);
      const float keep = 1.f - (s == rm ? 1.f : 0.f) * do_rm;
      const float ap = keep * (sa - do_rm * es * ec);
      a[s] = ap;
      own_a = ap;
      float r = 0.f;
      r += gs * ap;
      r4[0] = w1 ? 0.f : r;
      r4[1] = w1 ? r : 0.f;
    }
    if (l < K) {
      const int s = l;
      const float keep = 1.f - (s == rm ? 1.f : 0.f) * do_rm;
      const float used_n = used_l * keep;
      lam[s] = padd > 0.f ? lstar_l * used_n
                          : (lam_l + alpha * delta_l * used_l) * keep;
      used[s] = used_n;
      dsl[s] = dsl_l * keep;
      slo[s] = slo_l * keep;
      sid[s] = sid_l * keep - (1.f - keep);
      ls[s] = lstar_l;
      const float fc = static_cast<float>(s) + used_n * kBig;
      if (better(fc, s, fv_free, free_i)) {
        fv_free = fc;
        free_i = s;
      }
    }
    __syncwarp();
    warp_reduce<2, false>(r4, mx);
    warp_argmin(fv_free, free_i);
    SLOT_PROBE_MARK(4)
    const int free_k = free_i;
    const float kcnt = static_cast<float>(k) - do_rm;   // used after it

    // Schur complement and the relative singularity gate
    const float sval = dii - ((r4[0] + r4[1]) + (0.f + 0.f));
    const float gate = fmaxf(tol.singtol, 1e-4f * dii);
    const bool sing = sval < gate || kcnt >= static_cast<float>(n_true);
    const float do_add = retry * (bad ? 0.f : 1.f) + padd;
    const float ok = sing ? 0.f : do_add;
    const float mk_pend = sing ? do_add : 0.f;
    const float c_del = -do_rm / err_s;
    const float c_add = ok / (sval != 0.f ? sval : 1.f);
    pd = fminf((1.f - retry) * pd + mk_pend, 1.f);
    if (mk_pend > 0.f) {
      plm = add_lam;
      plo = add_lo;
      pid = add_id;
      pdd = add_d;
    }
    // the free slot joins the update's list unless it is the removed one
    const bool rm_free = do_rm > 0.f && free_k == rm;
    const int kN = k + (ok > 0.f && !rm_free ? 1 : 0);
    // the last step of the round computes no next lam*: ls is the record
    const bool last = stt != kRunning || step + 1 == steps;
    const bool has_pn = !last && pd > 0.f;
    auto slot_of = [&](int idx) { return idx < k ? list[idx] : free_k; };
    auto added = [&](int s) { return ok > 0.f && s == free_k; };

    // a pending entry's Gram column g_p = (W prow) o used on the new
    // table, over the update's list (a lane an item), and its record for
    // a_p = E g_p in the E update
    if (has_pn && l < kN) {
      const bool from_add = mk_pend > 0.f;
      const int s = slot_of(l);
      const float* Ws =
          added(s) || (do_rm > 0.f && s == rm) ? add_row : W + s * ldn;
      const float* xs = from_add ? add_row : prow;
      float P[kSG] = {};
      terms<kSG>(n, [&](int j, int x, bool on) {
        const float wj = Ws[j], xj = xs[j];
        if (on) P[x] += wj * xj;
      });
      const float sg = tree8(P) * (added(s) ? 1.f : used[s]);
      g_p[s] = sg;
      R2[l] = make_float2(sg, __int_as_float(s));
    }

    // the add's slot, m-space and pending bookkeeping (each value read
    // before any is written); the W update
    if (l == 0) {
      if (ok > 0.f) {
        const float used_f = used[free_k], sid_f = sid[free_k];
        const float slo_f = slo[free_k], dsl_f = dsl[free_k];
        const float lam_f = lam[free_k];
        used[free_k] = fminf(used_f + ok, 1.f);
        sid[free_k] = sid_f + ok * (add_id + 1.f);
        slo[free_k] = slo_f + ok * add_lo;
        dsl[free_k] = dsl_f + ok * add_d;
        lam[free_k] = lam_f + ok * add_lam;
      }
      if (kN > k) list[k] = free_k;
    }
    __syncwarp();
    if (l < n) {
      const int j = l;
      const float xj = add_row[j], uj = u_new[j];
      if (do_rm > 0.f) W[rm * ldn + j] = 0.f;
      if (ok > 0.f) W[free_k * ldn + j] = xj;
      if (price > 0.f) u[j] = uj;
      if (mk_pend > 0.f) prow[j] = xj;
    }
    {
      // two rows a lane at once, both read before either is written
      auto act = [&](int i, float up, float lo) {
        const float fi = static_cast<float>(i);
        const float oh_rm = (fi == rm_id ? 1.f : 0.f) * do_rm;
        up = up * (1.f - oh_rm * (1.f - rm_lo));
        lo = lo * (1.f - oh_rm * rm_lo);
        const float add_oh = retry * (fi == pid ? 1.f : 0.f) +
                             padd * (i == jr ? 1.f : 0.f);
        au[i] = fminf(up + ok * add_oh * (1.f - add_lo), 1.f);
        al[i] = fminf(lo + ok * add_oh * add_lo, 1.f);
      };
      for (int i = l; i < m; i += 64) {
        const int i2 = i + 32 < m ? i + 32 : i;
        const float up1 = au[i], lo1 = al[i], up2 = au[i2], lo2 = al[i2];
        act(i, up1, lo1);
        if (i + 32 < m) act(i2, up2, lo2);
      }
    }
    // each column's e, w, d and keep, staged by its item's lane from its
    // own values (used and dsl after the removal's keep); the added free
    // slot at position k has w = -1, d = add_d and e = 0
    if (pi < kN) {
      int j = free_k;
      float ej, wj, dj;
      if (pi < k) {
        j = own_s;
        const float keep = 1.f - (j == rm ? 1.f : 0.f) * do_rm;
        const float used_j = own_used * keep, dsl_j = own_dsl * keep;
        ej = added(j) && !rm_free ? 0.f : own_e;
        wj = j == free_k ? -1.f : (used_j > 0.f ? own_a * used_j : 0.f);
        dj = added(j) ? add_d : dsl_j * used_j;
      } else {
        ej = added(j) && !rm_free ? 0.f : e[j];
        wj = -1.f;
        dj = add_d;
      }
      R4[pi] = make_float4(ej, wj, dj, 1.f - (j == rm ? 1.f : 0.f) * do_rm);
    }
    __syncwarp();
    // E <- (E + c_del e e') o keep keep' + c_add w w' on the update's
    // list, a lane a row: each block of 8 terms reads its columns, records
    // and entries before it writes (a store would otherwise hold back the
    // next term's loads); from the new values the next lam* and, with an
    // entry pending, a_p = E g_p (the same values and order as a pass of
    // its own over the new E)
    if (pi < kN) {
      const int i = list[pi];
      float* Ei = E + i * ldK;
      const float4 ri = R4[pi];
      const float ce = c_del * ri.x, ca = c_add * ri.y;
      const float ki = i == rm ? 1.f - do_rm : 1.f;
      float S[2 * kSG] = {}, S2[2 * kSG] = {};
#pragma unroll
      for (int b = 0; b < kWarpMaxK; b += kSG) {
        if (b < kN) {
          int col[kSG];
          float4 rc[kSG];
          float gp[kSG], ev[kSG];
#pragma unroll
          for (int y = 0; y < kSG; ++y) {
            col[y] = list[b + y];
            rc[y] = R4[b + y];
            gp[y] = has_pn ? R2[b + y].x : 0.f;
          }
#pragma unroll
          for (int y = 0; y < kSG; ++y) ev[y] = Ei[col[y]];
#pragma unroll
          for (int y = 0; y < kSG; ++y) {
            const int x = (b + y) % (2 * kSG);
            const float ej = rc[y].x, wj = rc[y].y, dj = rc[y].z,
                        kj = rc[y].w;
            const float v = (ev[y] + ce * ej) * ki * kj + ca * wj;
            if (b + y < kN) {
              Ei[col[y]] = v;
              S[x] += v * dj;
              if (has_pn) S2[x] += v * gp[y];
            }
          }
        }
      }
      if (!last) {
        lstar[i] = -tree16(S);
        a_p[i] = has_pn ? tree16(S2) : 0.f;
      }
    }
    __syncwarp();
    SLOT_PROBE_MARK(5)
    SLOT_PROBE_STEP
    kU = kN;
    it += 1.f;
    if (stt != kRunning) break;
  }
  SLOT_PROBE_FLUSH
  c.pd = pd;
  c.plm = plm;
  c.plo = plo;
  c.pid = pid;
  c.pdd = pdd;
  c.fv = fv;
  c.bf = bf;
  c.cy = cy;
  c.it = it;
  c.stt = stt;
}

// slot_refresh_dsl on the warp; the caller syncs
__device__ __forceinline__ void warp_refresh_dsl(const Lane& L, int m,
                                                 int K) {
  const int k = warp_lane();
  if (k < K) {
    const int id = static_cast<int>(L.sid[k]);
    const bool hit = id >= 0 && id < m && static_cast<float>(id) == L.sid[k];
    const float du_sel = hit ? L.du[id] : 0.f;
    const float dl_sel = hit ? L.dl[id] : 0.f;
    L.dsl[k] = (L.slo[k] * dl_sel + (1.f - L.slo[k]) * du_sel) * L.used[k];
  }
}

// slot_solve_retry on the warp: slot_warp_steps, then, on CYCLE or
// REFACTOR, the in-kernel cold retry.
__device__ __forceinline__ void slot_warp_solve_retry(const Lane& L, Ctl& c,
                                                      int m, int n, int K,
                                                      int n_true, int steps,
                                                      const Tol& tol) {
  const int l = warp_lane();
  for (int attempt = 0; attempt < 2; ++attempt) {
    slot_warp_steps(L, c, L.du, L.dl, m, n, K, n_true, steps, tol);
    if (attempt == 1 || (c.stt != kCycle && c.stt != kRefactor)) break;
    SLOT_PROBE_RETRY
    __syncwarp();
    for (int i = l; i < K * L.ldK; i += 32) L.E[i] = 0.f;
    for (int i = l; i < K * L.ldn; i += 32) L.W[i] = 0.f;
    for (int i = l; i < m; i += 32) {
      L.au[i] = 0.f;
      L.al[i] = 0.f;
    }
    if (l < K) {
      L.used[l] = 0.f;
      L.dsl[l] = 0.f;
      L.slo[l] = 0.f;
      L.sid[l] = -1.f;
      L.lam[l] = 0.f;
      L.ls[l] = 0.f;
    }
    for (int j = l; j < n; j += 32) L.u[j] = 0.f;
    c.pd = 0.f;
    c.fv = 0.f;
    c.bf = -1.f;
    c.cy = 0.f;
    c.stt = kRunning;
  }
  __syncwarp();
}

// One launch of `kernel` at `smem` bytes a block, opting in above 48 KB.
template <class Kernel, class... Args>
int seg_launch(Kernel kernel, int blocks, int threads, size_t smem,
               void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();              // clear it: no launch follows
      return static_cast<int>(e);
    }
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
