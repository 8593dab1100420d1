// The SGM recurrence on 16-bit pairs and the cp.async helpers, shared by
// the v2 DPs (sgm_v2.cu) and the v1 aggregation (sgm_v1.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBig16 = 0x3fff;  // above every 16-bit path cost

// One DP step for a lane's disparities d0 = 4 lane .. d0 + 3, with the same
// integers as the plain version: delta = b - m with b = min(L(d),
// min(L(d -+ 1)) + P1, m + P2), m = min L, and L = C + delta. A = (L(d0),
// L(d0 + 1)), B = (L(d0 + 2), L(d0 + 3)), low half first; cA, cB the
// costs alike; p1p1, p2p2 the penalties in both halves. The minimum of the
// packed (m, m) over the warp is (min L, min L). The caller keeps every
// half of L, of m + P2 and of L(d -+ 1) + P1 in [0, 0x7fff] and every L
// below kBig16 (costs >= 0, so P1 >= 0, which SGMConfig and the DP
// functions of ops/sgm.py check for every backend), so that no half
// borrows from or carries into its neighbour in a 32-bit add or subtract:
// b - m and e + C are single IADDs. Returns the four deltas byte-packed
// (exact while they are <= 255) and leaves L in A, B. Hopper's DPX
// instructions (__vimin3_s16x2: a min of three; __viaddmin_s16x2: an add
// and a min) take a step to about 45 instructions, against about 55 for
// 32-bit lanes.
__device__ __forceinline__ unsigned dp_step16(unsigned& A, unsigned& B,
                                              unsigned cA, unsigned cB,
                                              unsigned p1p1, unsigned p2p2,
                                              int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned x = __vimin3_s16x2(A, B, B);
  const unsigned mine = __vimin3_s16x2(x, __byte_perm(x, 0, 0x1032),
                                       __byte_perm(x, 0, 0x1032));
  const unsigned mm = __reduce_min_sync(kAll, mine);
  unsigned sb = __shfl_up_sync(kAll, B, 1);    // (., L(d0 - 1))
  unsigned sa = __shfl_down_sync(kAll, A, 1);  // (L(d0 + 4), .)
  if (lane == 0) sb = kBig16 << 16;
  if (lane == 31) sa = kBig16;
  const unsigned y = __byte_perm(A, B, 0x5432);  // (L(d0 + 1), L(d0 + 2))
  const unsigned nA = __vimin3_s16x2(__byte_perm(sb, A, 0x5432), y, y);
  const unsigned nB = __vimin3_s16x2(y, __byte_perm(B, sa, 0x5432), y);
  const unsigned tA = __viaddmin_s16x2(nA, p1p1, A);
  const unsigned tB = __viaddmin_s16x2(nB, p1p1, B);
  const unsigned bA = __viaddmin_s16x2(mm, p2p2, tA);
  const unsigned bB = __viaddmin_s16x2(mm, p2p2, tB);
  const unsigned eA = bA - mm, eB = bB - mm;
  A = eA + cA;
  B = eB + cB;
  return __byte_perm(eA, eB, 0x6420);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
