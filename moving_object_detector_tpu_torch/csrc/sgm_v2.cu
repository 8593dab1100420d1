// SGM v2 for Hopper (sm_90a): census-input DP and winner-take-all kernels.
//
// Replaces the JAX package's Pallas TPU kernels in ops/sgm_pallas2.py:
//   sgm_vertical   <- vertical_deltas   / _v_kernel   (sgm_pallas2.py:265, :234)
//   sgm_horizontal <- horizontal_deltas / _h_kernel   (sgm_pallas2.py:159, :117)
//   sgm_wta        <- wta_from_parts    / _wta_kernel (sgm_pallas2.py:403, :302)
// and computes the same function, not the TPU block layout: no column-
// reversed census, no strided-roll shear, no systolic right view.
//
// Layout: every delta volume is (H, W, D) int8 with D = 128 contiguous, the
// layout of the plain versions in ops/sgm.py. Each DP direction stores
// delta = m(d) - min L in [0, P2] (L = C + delta), so the aggregated total
// is hf + hb + vf + vb + 4 C and the WTA recomputes C from the census.
//
// What bounds these kernels on an H100:
// - DP (sgm_vertical, sgm_horizontal): latency along the scan. Each step of
//   a scan line depends on the previous one, so the work (2 x H x W x 128
//   updates per direction pair) is spread over only H or W independent
//   lines, and a scan's time is its length times one step. Both keep one
//   warp per scan line, 4 disparities a lane, the Hamming cost
//   __popc(cl[y,x] ^ cr[y,x-d]) computed in the kernel (32 for x < d), and
//   one 4-byte store per lane per step (128 coalesced bytes per warp). On a
//   step's chain lies only the recurrence (dp_step): the census comes from
//   shared memory, the next step's costs are formed while this one runs,
//   the path minimum is one __reduce_min_sync. The horizontal DP stages a
//   row's census lines once; the vertical DP stages row blocks of a strip
//   of columns with cp.async, double-buffered (see vdp_kernel). The
//   vertical DP has 2 W warps (1,242 at the serving point, about 9 an SM),
//   so the instructions a step issues count beside its latency.
// - WTA (sgm_wta): the bytes it moves. It must read the four delta volumes
//   (4 x H x W x 128 bytes, 59.8 MB at 188 x 621) and two census images and
//   write one f32 plane, and that is all it reads: each volume once, 16
//   bytes a lane. One block per image row, the row's two census lines
//   staged in shared memory. A warp takes four pixels, eight lanes a pixel,
//   a lane the 16 disparities of its 16-byte load; a 4 x 4 byte transpose
//   (__byte_perm) brings the four volumes' deltas of one disparity into one
//   word and __dp4a adds them to 4 C. The left argmin is the minimum of
//   total * 128 + d (lowest d wins ties) over the lane's 16 and then over
//   the 8 lanes in three shuffles. The right view needs total(x + d, d) for
//   every right pixel: gathered, that is a one-byte read 129 bytes apart
//   from each volume (a 32-byte sector fetched for every byte used, on
//   volumes larger than L2). Instead each left cell pushes its packed value
//   into best_r[x - d] with atomicMin while it is in registers; min is
//   order-free, so the result is the same from run to run. The disparity
//   before the LR check waits in shared memory; after one barrier a second
//   phase, one thread a pixel, does the LR check and writes. The eight
//   lanes of a pixel touch right pixels 16 apart, so the shared rows carry
//   4 pad words every 16 (sw below): with four neighbouring pixels a warp's
//   32 accesses fall into 32 banks.
// Rows too wide for a block's shared memory (kSmemPerBlock) take a second
// instantiation of the horizontal DP and of the WTA that reads the census
// from global memory; the WTA's best_r then lives in a per-row scratch in
// global memory (global atomicMin, the same order-free minimum) and its
// pre-check disparity in the output row. No width is refused.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC -fmad=false. -fmad=false keeps the subpixel float math bitwise
// equal to the plain PyTorch version (IEEE division, no contraction).
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgm_dp16.cuh"

namespace {

constexpr int kD = 128;
constexpr int kMaxCost = 32;
constexpr int kBig = 1 << 20;
constexpr int kHuge = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemPerBlock = 232448;  // bytes a block may opt in to

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// One DP step for a lane's disparities d0 = 4 lane .. d0 + 3, with the same
// integers as the plain version: delta = b - m with b = min(L(d),
// min(L(d -+ 1)) + P1, m + P2), m = min L, and L = C + delta. The path
// minimum is one __reduce_min_sync, the neighbours L(d0 - 1) / L(d0 + 4)
// come by shuffles issued beside it, and t = min(L(d), min(L(d -+ 1)) +
// P1) is formed before m arrives; Hopper's DPX instructions (__vimin3_s32,
// __viaddmin_s32: a min of three, an add and a min in one) shorten both.
// Returns the four deltas, packed for one 4-byte store.
__device__ __forceinline__ char4 dp_step(int& l0, int& l1, int& l2, int& l3,
                                         int c0, int c1, int c2, int c3,
                                         int p1, int p2, int lane) {
  const int m = __reduce_min_sync(kFull, __vimin3_s32(l0, l1, min(l2, l3)));
  int left = __shfl_up_sync(kFull, l3, 1);     // L(d0 - 1)
  int right = __shfl_down_sync(kFull, l0, 1);  // L(d0 + 4)
  if (lane == 0) left = kBig;
  if (lane == 31) right = kBig;
  const int t0 = __viaddmin_s32(min(left, l1), p1, l0);
  const int t1 = __viaddmin_s32(min(l0, l2), p1, l1);
  const int t2 = __viaddmin_s32(min(l1, l3), p1, l2);
  const int t3 = __viaddmin_s32(min(l2, right), p1, l3);
  const int b0 = __viaddmin_s32(m, p2, t0), b1 = __viaddmin_s32(m, p2, t1),
            b2 = __viaddmin_s32(m, p2, t2), b3 = __viaddmin_s32(m, p2, t3);
  l0 = b0 + c0 - m;
  l1 = b1 + c1 - m;
  l2 = b2 + c2 - m;
  l3 = b3 + c3 - m;
  return make_char4(
      static_cast<signed char>(b0 - m), static_cast<signed char>(b1 - m),
      static_cast<signed char>(b2 - m), static_cast<signed char>(b3 - m));
}

// Vertical DP. A block owns a strip of S adjacent columns, one warp each,
// blockIdx.y the direction (0 top-down, 1 bottom-up); the wrapper sizes S
// so that the 2 ceil(W / S) blocks fill the card's SMs once. The census
// reaches shared memory in row blocks of kVRows rows by cp.async,
// double-buffered: while the warps scan one row block, the next one is in
// flight, so no load sits on a step's chain. A staged row holds the right
// census [x0 - 127, x0 + S), what the strip's candidates x - d read, then
// the strip's left census; a thread copies one of those words for every
// row of the block. A lane reads cr[x - d0 - k], k = 0..3, 4 words from
// its neighbours' (a stride of 4 across the warp); the right words' index
// is swizzled within each aligned group of 4 (vz) so that those 32 reads
// fall into 32 banks at every offset. A lane's four offsets into a staged
// row and its mask of candidates left of the image (x < d, cost kMaxCost)
// are the same on every step. The next step's five words are read before
// this step's recurrence and its costs formed after it. Stores: one 4-byte
// store a lane a step; the strip's warps write adjacent 128-byte lines.
constexpr int kVRows = 32;
constexpr int kVMaxStrip = 32;  // 1024 threads
// A staged row, for every strip: the right words [x0 - 127, x0 + strip)
// from word 0, the left words from kVCl. A fixed stride lets every read
// of the unrolled scan be a lane pointer plus a constant.
constexpr int kVCl = (kVMaxStrip + kD - 1 + 3) & ~3;
constexpr int kVRowWords = kVCl + kVMaxStrip;

__device__ __forceinline__ int vz(int j) { return j ^ ((j >> 5) & 3); }

template <bool BACKWARD>
__device__ __forceinline__ void v_scan(const int* __restrict__ cl,
                                       const int* __restrict__ cr,
                                       int8_t* __restrict__ out, int H,
                                       int W, int p1, int p2,
                                       int (*stage)[kVRows * kVRowWords]) {
  const int strip = blockDim.x >> 5;
  const int span = strip + kD - 1;  // right words a row needs
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * strip;
  const int x = x0 + warp;  // columns past the image scan and never store
  const int d0 = lane * 4;
  const int nblk = (H + kVRows - 1) / kVRows;
  // Row block b holds image rows [r0, r0 + kVRows), taken in scan order:
  // from the top forward, from the bottom backward (r0 < 0 for the last).
  auto first_row = [&](int b) {
    return BACKWARD ? H - (b + 1) * kVRows : b * kVRows;
  };
  // Cells outside the image are not copied: a stored step reads them only
  // for candidates left of the image, whose cost is kMaxCost whatever the
  // word (__popc <= 32).
  auto stage_rows = [&](int b, int* buf) {
    const int r0 = first_row(b);
    const int lo = max(0, -r0), hi = min(kVRows, H - r0);
    for (int j = threadIdx.x; j < span + strip; j += blockDim.x) {
      const bool right = j < span;
      const int gx = right ? x0 - (kD - 1) + j : x0 + j - span;
      if (gx < 0 || gx >= W) continue;
      int* dst = buf + lo * kVRowWords + (right ? vz(j) : kVCl + j - span);
      const int* src =
          (right ? cr : cl) + static_cast<size_t>(r0 + lo) * W + gx;
      for (int r = lo; r < hi; ++r, dst += kVRowWords, src += W)
        cp_async4(dst, src);
    }
  };
  const int j0 = warp + kD - 1 - d0;  // cr[x - d0], from x0 - 127
  const int o0 = vz(j0), o1 = vz(j0 - 1), o2 = vz(j0 - 2), o3 = vz(j0 - 3);
  const int m0 = x >= d0 ? 0 : kMaxCost, m1 = x >= d0 + 1 ? 0 : kMaxCost,
            m2 = x >= d0 + 2 ? 0 : kMaxCost, m3 = x >= d0 + 3 ? 0 : kMaxCost;
  const long long row_bytes = static_cast<long long>(W) * kD;
  constexpr int kStep = BACKWARD ? -kVRowWords : kVRowWords;
  const unsigned mA = __byte_perm(m0, m1, 0x5410),
                 mB = __byte_perm(m2, m3, 0x5410);
  // Costs are in [0, 159] (C <= 32, delta <= P2 <= 127), so with P1
  // clamped to 160 (the same t for every P1 >= 160) every half of
  // dp_step16 stays in 16 bits.
  const unsigned p1p1 = __byte_perm(min(p1, 160), min(p1, 160), 0x5410);
  const unsigned p2p2 = __byte_perm(p2, p2, 0x5410);
  unsigned A = 0, B = 0, cA, cB;
  auto costs = [&](int c, int w0, int w1, int w2, int w3) {
    cA = __vimax3_s16x2(__byte_perm(__popc(c ^ w0), __popc(c ^ w1), 0x5410),
                        mA, mA);
    cB = __vimax3_s16x2(__byte_perm(__popc(c ^ w2), __popc(c ^ w3), 0x5410),
                        mB, mB);
  };

  stage_rows(0, stage[0]);
  cp_async_commit();
  for (int b = 0; b < nblk; ++b) {
    if (b + 1 < nblk) {
      stage_rows(b + 1, stage[(b + 1) & 1]);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of row block b
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // everyone's copies of row block b
    const int r0 = first_row(b);
    // Steps stored in this block: the rest of the scan, once the image
    // ends, runs on stale words and stores nothing (only the last block in
    // scan order is partial, so nothing later reads its L).
    const int n = x < W ? (BACKWARD ? min(kVRows, kVRows + r0)
                                    : min(kVRows, H - r0))
                        : 0;
    const int* row = stage[b & 1] + (BACKWARD ? kVRows - 1 : 0) * kVRowWords;
    const int *pc = row + kVCl + warp, *p0 = row + o0, *p1w = row + o1,
              *p2w = row + o2, *p3w = row + o3;
    int8_t* dst = out + (static_cast<long long>(BACKWARD ? r0 + kVRows - 1
                                                         : r0) * W +
                         (x < W ? x : 0)) * kD + d0;
    costs(pc[0], p0[0], p1w[0], p2w[0], p3w[0]);
#pragma unroll
    for (int s = 0; s < kVRows; ++s) {
      // Step s + 1's words (the last step of a block rereads its own).
      const int o = (s + 1 < kVRows ? s + 1 : s) * kStep;
      const int nc = pc[o], w0 = p0[o], w1 = p1w[o], w2 = p2w[o],
                w3 = p3w[o];
      const unsigned e = dp_step16(A, B, cA, cB, p1p1, p2p2, lane);
      if (s < n) *reinterpret_cast<unsigned*>(dst) = e;
      costs(nc, w0, w1, w2, w3);
      dst += BACKWARD ? -row_bytes : row_bytes;
    }
    __syncthreads();  // row block b's buffer is refilled next iteration
  }
}

__global__ void __launch_bounds__(32 * kVMaxStrip)
    vdp_kernel(const int* __restrict__ cl, const int* __restrict__ cr,
               int8_t* __restrict__ out_f, int8_t* __restrict__ out_b, int H,
               int W, int p1, int p2) {
  __shared__ __align__(16) int stage[2][kVRows * kVRowWords];
  if (blockIdx.y == 0) {
    v_scan<false>(cl, cr, out_f, H, W, p1, p2, stage);
  } else {
    v_scan<true>(cl, cr, out_b, H, W, p1, p2, stage);
  }
}

// Horizontal DP. One block per image row, its two warps the two
// directions; a lane holds disparities d0 = 4 lane .. d0 + 3. The row's two
// census lines are staged in shared memory once, the right one padded (hw):
// a lane reads cr[x - d0 - k], 4 words from its neighbours', and one pad
// word every 32 spreads a warp's 32 reads over the banks. The next step's
// four costs are formed while dp_step runs, from words read an iteration
// earlier: the window slides by one pixel a step, so a lane keeps w_k =
// cr[x - d0 - k] in registers and reads one new word (and the left census
// word) two steps ahead. Reads left of the image are clamped to pixel 0
// and their cost is kMaxCost (x < d), as in the plain version. Rows whose
// two lines do not fit kSmemPerBlock (STAGED false) read the same words
// from global memory, unpadded.
constexpr int kHThreads = 64;

__host__ __device__ __forceinline__ int hw(int i) { return i + (i >> 5); }

template <bool BACKWARD, bool STAGED>
__device__ __forceinline__ void h_scan(const int* cl_s, const int* cr_s,
                                       int8_t* __restrict__ out, int W,
                                       int p1, int p2, int lane) {
  constexpr int kDir = BACKWARD ? -1 : 1;
  const int d0 = lane * 4;
  auto rd = [&](int i) {
    const int c = min(max(i, 0), W - 1);
    return cr_s[STAGED ? hw(c) : c];
  };
  auto rl = [&](int i) { return cl_s[min(max(i, 0), W - 1)]; };
  // The word that enters the window when it moves to x.
  auto entering = [&](int x) { return rd(BACKWARD ? x - d0 - 3 : x - d0); };
  auto cost = [&](int x, int c, int w, int k) {
    return x >= d0 + k ? __popc(c ^ w) : kMaxCost;
  };
  int x = BACKWARD ? W - 1 : 0;
  int w0 = rd(x - d0), w1 = rd(x - d0 - 1), w2 = rd(x - d0 - 2),
      w3 = rd(x - d0 - 3);
  int c = rl(x);
  int c0 = cost(x, c, w0, 0), c1 = cost(x, c, w1, 1), c2 = cost(x, c, w2, 2),
      c3 = cost(x, c, w3, 3);
  // Moves the window one pixel on, nw entering.
  auto slide = [&](int nw) {
    if (BACKWARD) {
      w0 = w1;
      w1 = w2;
      w2 = w3;
      w3 = nw;
    } else {
      w3 = w2;
      w2 = w1;
      w1 = w0;
      w0 = nw;
    }
  };
  slide(entering(x + kDir));  // the window and left word of step 1
  c = rl(x + kDir);
  int l0 = 0, l1 = 0, l2 = 0, l3 = 0;
  // Unrolled by 8: 0.0385 ms at 188 x 621 against 0.0410 by 4, 0.0460 by 2
  // and 0.0562 by 1 (NVIDIA H100 80GB HBM3, 700 W; 48 registers).
#pragma unroll 8
  for (int s = 0; s < W; ++s) {
    // Reads for step s + 2, used an iteration later (reads past the row
    // are clamped and their values never used).
    const int nw = entering(x + 2 * kDir);
    const int nc = rl(x + 2 * kDir);
    *reinterpret_cast<char4*>(out + static_cast<size_t>(x) * kD) =
        dp_step(l0, l1, l2, l3, c0, c1, c2, c3, p1, p2, lane);
    // Step s + 1's costs, from words read an iteration ago.
    x += kDir;
    c0 = cost(x, c, w0, 0);
    c1 = cost(x, c, w1, 1);
    c2 = cost(x, c, w2, 2);
    c3 = cost(x, c, w3, 3);
    slide(nw);
    c = nc;
  }
}

// STAGED: dynamic shared memory, in words: the left census line (W), then
// the padded right one (hw(W - 1) + 1).
template <bool STAGED>
__global__ void __launch_bounds__(kHThreads)
    hdp_kernel(const int* __restrict__ cl, const int* __restrict__ cr,
               int8_t* __restrict__ out_f, int8_t* __restrict__ out_b, int W,
               int p1, int p2) {
  extern __shared__ int hsm[];
  const size_t row = static_cast<size_t>(blockIdx.x) * W;
  const int* cl_s = cl + row;
  const int* cr_s = cr + row;
  if (STAGED) {
    for (int i = threadIdx.x; i < W; i += kHThreads) {
      hsm[i] = cl_s[i];
      hsm[W + hw(i)] = cr_s[i];
    }
    __syncthreads();
    cl_s = hsm;
    cr_s = hsm + W;
  }
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    h_scan<false, STAGED>(cl_s, cr_s, out_f + row * kD + lane * 4, W, p1, p2,
                          lane);
  } else {
    h_scan<true, STAGED>(cl_s, cr_s, out_b + row * kD + lane * 4, W, p1, p2,
                         lane);
  }
}

// Index of right pixel x in a padded shared row: 4 pad words every 16.
__host__ __device__ __forceinline__ int sw(int x) {
  return x + ((x >> 4) << 2);
}

// Minimum over the 8 lanes that share a pixel.
__device__ __forceinline__ int group_min(int v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

constexpr int kWtaThreads = 512;

// One block per image row. STAGED: dynamic shared memory, in words: the
// right census line and the right view's packed minimum (padded, sw(W - 1)
// + 1 each), the left census line and the disparity before the LR check (W
// each). Otherwise the census lines are read from global memory, the
// packed minimum lives in the row of `scratch` and the disparity before
// the LR check in the row of `out` (read back through L2 after the
// barrier, where the global atomics were done).
template <bool STAGED>
__global__ void __launch_bounds__(kWtaThreads)
    wta_kernel(const int8_t* __restrict__ hf, const int8_t* __restrict__ hb,
               const int8_t* __restrict__ vf, const int8_t* __restrict__ vb,
               const int* __restrict__ cl, const int* __restrict__ cr,
               float* out, int* scratch, int H, int W, int subpixel,
               int lr_check, float lr_max_diff, float uniqueness) {
  extern __shared__ int smem[];
  const int y = blockIdx.x;
  const size_t row = static_cast<size_t>(y) * W;
  auto at = [](int x) { return STAGED ? sw(x) : x; };
  const int* cr_s;
  const int* cl_s;
  int* best_r;
  float* sdisp;
  if (STAGED) {
    const int padded = sw(W - 1) + 1;
    int* cr_w = smem;
    best_r = cr_w + padded;
    int* cl_w = best_r + padded;
    sdisp = reinterpret_cast<float*>(cl_w + W);
    for (int x = threadIdx.x; x < W; x += kWtaThreads) {
      cr_w[sw(x)] = cr[row + x];
      best_r[sw(x)] = kHuge;
      cl_w[x] = cl[row + x];
    }
    cr_s = cr_w;
    cl_s = cl_w;
  } else {
    cr_s = cr + row;
    cl_s = cl + row;
    best_r = scratch + row;
    sdisp = out + row;
    for (int x = threadIdx.x; x < W; x += kWtaThreads) best_r[x] = kHuge;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane & 7;  // this lane holds disparities 16 l .. 16 l + 15
  for (int xg = warp * 4; xg < W; xg += (kWtaThreads >> 5) * 4) {
    // Past the row's end a lane repeats the last pixel: the same values
    // go into the same cells again, which neither a min nor a store of an
    // equal value notices, and the warp stays whole for the shuffles.
    const int x = min(xg + (lane >> 3), W - 1);
    const size_t o = (row + x) * kD + 16 * l;
    const int4 qa = __ldcs(reinterpret_cast<const int4*>(hf + o));
    const int4 qb = __ldcs(reinterpret_cast<const int4*>(hb + o));
    const int4 qc = __ldcs(reinterpret_cast<const int4*>(vf + o));
    const int4 qe = __ldcs(reinterpret_cast<const int4*>(vb + o));
    const int wa[4] = {qa.x, qa.y, qa.z, qa.w};
    const int wb[4] = {qb.x, qb.y, qb.z, qb.w};
    const int wc[4] = {qc.x, qc.y, qc.z, qc.w};
    const int we[4] = {qe.x, qe.y, qe.z, qe.w};
    const int clv = cl_s[x];
    int t[16];
    int packed = kHuge;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // Bytes j of the four volumes' words into word j.
      const unsigned ab_lo = __byte_perm(wa[k], wb[k], 0x5140);
      const unsigned ab_hi = __byte_perm(wa[k], wb[k], 0x7362);
      const unsigned ce_lo = __byte_perm(wc[k], we[k], 0x5140);
      const unsigned ce_hi = __byte_perm(wc[k], we[k], 0x7362);
      const int r[4] = {
          static_cast<int>(__byte_perm(ab_lo, ce_lo, 0x5410)),
          static_cast<int>(__byte_perm(ab_lo, ce_lo, 0x7632)),
          static_cast<int>(__byte_perm(ab_hi, ce_hi, 0x5410)),
          static_cast<int>(__byte_perm(ab_hi, ce_hi, 0x7632))};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 16 * l + 4 * k + j;
        const int xr = x - d;
        const int slot = at(max(xr, 0));
        const int cost = xr >= 0 ? __popc(clv ^ cr_s[slot]) : kMaxCost;
        const int tot = __dp4a(r[j], 0x01010101, 4 * cost);
        t[4 * k + j] = tot;
        const int pk = tot * kD + d;
        packed = min(packed, pk);
        // Right view: this cell is candidate d of right pixel x - d.
        if (lr_check && xr >= 0) atomicMin(&best_r[slot], pk);
      }
    }
    const int run = group_min(packed);
    const int best = run & (kD - 1);
    const int c0 = run >> 7;
    int cm = kHuge, cp = kHuge, um = kHuge;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = 16 * l + i;
      if (d == best - 1) cm = t[i];
      if (d == best + 1) cp = t[i];
    }
    if (subpixel) {
      cm = group_min(cm);
      cp = group_min(cp);
    }
    if (uniqueness > 0.0f) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (abs(16 * l + i - best) > 1) um = min(um, t[i]);
      }
      um = group_min(um);
    }
    if (l == 0) {
      float disp = static_cast<float>(best);
      if (subpixel && best > 0 && best < kD - 1) {
        const float fc0 = static_cast<float>(c0);
        const float fcm = static_cast<float>(cm);
        const float fcp = static_cast<float>(cp);
        const float denom = fcm - 2.0f * fc0 + fcp;
        const float off =
            denom > 1e-6f ? __fdiv_rn(0.5f * (fcm - fcp), fmaxf(denom, 1e-6f))
                          : 0.0f;
        disp = disp + off;
      }
      bool valid = x >= best;
      if (uniqueness > 0.0f)
        valid = valid && (static_cast<float>(um) * uniqueness >=
                          static_cast<float>(c0));
      sdisp[x] = valid ? disp : -1.0f;  // a valid disparity is >= 0
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += kWtaThreads) {
    const float disp = STAGED ? sdisp[x] : __ldcg(sdisp + x);
    bool valid = disp >= 0.0f;
    if (lr_check && valid) {
      const int xr = static_cast<int>(rintf(static_cast<float>(x) - disp));
      const int xc = min(max(xr, 0), W - 1);
      const int packed_r = STAGED ? best_r[at(xc)] : __ldcg(best_r + xc);
      const int d_r = packed_r & (kD - 1);
      valid = xr >= 0 && fabsf(disp - static_cast<float>(d_r)) <= lr_max_diff;
    }
    out[row + x] = valid ? disp : -1.0f;
  }
}

// Opts a kernel in to `smem` bytes of dynamic shared memory where that is
// above the 48 KB every kernel has.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// strip: the columns a block owns, 1 .. kVMaxStrip.
int sgm_vertical(const void* cl, const void* cr, void* vf, void* vb, int H,
                 int W, int p1, int p2, int strip, void* stream) {
  if (strip < 1 || strip > kVMaxStrip)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + strip - 1) / strip, 2);
  vdp_kernel<<<grid, 32 * strip, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<int8_t*>(vf), static_cast<int8_t*>(vb), H, W, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

int sgm_horizontal(const void* cl, const void* cr, void* hf, void* hb, int H,
                   int W, int p1, int p2, void* stream) {
  const size_t smem =
      (static_cast<size_t>(W) + static_cast<size_t>(hw(W - 1)) + 1) *
      sizeof(int);
  const bool staged = smem <= kSmemPerBlock;
  auto kernel = staged ? hdp_kernel<true> : hdp_kernel<false>;
  const size_t bytes = staged ? smem : 0;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<H, kHThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<int8_t*>(hf), static_cast<int8_t*>(hb), W, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

// scratch: null for rows whose lines fit a block's shared memory, else H x
// W int32 of global memory for the right view's packed minimum.
int sgm_wta(const void* hf, const void* hb, const void* vf, const void* vb,
            const void* cl, const void* cr, void* out, void* scratch, int H,
            int W, int subpixel, int lr_check, float lr_max_diff,
            float uniqueness, void* stream) {
  const bool staged = scratch == nullptr;
  const size_t smem =
      staged ? (2 * static_cast<size_t>(sw(W - 1) + 1) +
                2 * static_cast<size_t>(W)) *
                   sizeof(int)
             : 0;
  auto kernel = staged ? wta_kernel<true> : wta_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<H, kWtaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hf), static_cast<const int8_t*>(hb),
      static_cast<const int8_t*>(vf), static_cast<const int8_t*>(vb),
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<float*>(out), static_cast<int*>(scratch), H, W, subpixel,
      lr_check, lr_max_diff, uniqueness);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
