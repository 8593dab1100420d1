// SGM v1 for Hopper (sm_90a): census, Hamming cost volume, aggregation over
// the stored volume, and winner-take-all.
//
// Replaces the JAX package's Pallas TPU kernels in ops/sgm_pallas.py:
//   sgm1_census    <- _census_kernel    (sgm_pallas.py:161, called at :260)
//   sgm1_cost      <- _cost_kernel      (sgm_pallas.py:198, called at :271)
//   sgm1_aggregate <- _dual_scan_kernel (sgm_pallas.py:72, called at :121
//                     through aggregate_cost_volume_pallas :306)
//   sgm1_wta       <- _wta_kernel       (sgm_pallas.py:351, called at :462)
// and computes what they compute, not their block layout: no row-shifted
// copies of the image, no (W, H, D) transposed copy of the volume, no
// padding to tile multiples, no D-leading relayout before the WTA.
//
// Layout: the cost volume is (H, W, D) int8 and the aggregated total
// (H, W, D) int16, D = 128 contiguous, the layout of the plain versions in
// ops/sgm.py. What sets v1 apart from v2 (sgm_v2.cu) is that the cost is
// stored and read back, and that the four path costs L = C + delta are
// summed into one int16 volume by the aggregation itself.
//
// What bounds these kernels on an H100:
// - sgm1_census: the launch and its tail, not bytes (one f32 in, one i32
//   out per pixel: 0.56 us for both views at 188 x 621). One launch takes
//   both views of a pair (blockIdx.z the view). A block stages its tile of
//   kCensusTileH x kCensusTileW pixels and the window's halo in shared
//   memory, cells outside the image as +inf, as the plain version pads:
//   inf < c is false for every c, NaN included, so no bounds tests remain.
//   A lane takes 4 horizontally adjacent pixels and reads each window row
//   into registers with 16-byte loads, 4 + 2 rw values shared by its 4
//   pixels; the 5 x 5 serving window is a specialisation with every loop
//   unrolled. The lanes' results go through shared memory, so that the
//   stores are one coalesced word a lane. 0.0027 ms for a 188 x 621 pair
//   against 0.0094 for the former one launch a view, a thread a pixel
//   (NVIDIA H100 80GB HBM3, 700 W).
// - sgm1_cost: the popcounts (14.9 M at 188 x 621, 16 a clock an SM:
//   about 0.004 ms) beside the bytes of the volume it writes (0.0047 ms).
//   A block stages the census words of a 64-pixel segment of a row and
//   the 191 right words they meet once; a lane takes a pixel and 16
//   disparities, its right words consecutive across the warp (no bank
//   conflicts, no address arithmetic), and the segment's 8 KB leave
//   through a swizzled shared tile as one coalesced 16-byte store a lane.
//   0.0078 ms at 188 x 621 against 0.0137 for the former design, a warp
//   a pixel whose four gathers a lane touched 16 sectors for 128 useful
//   bytes (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
// - sgm1_aggregate: latency along the scan, as the v2 DP, and the bytes of
//   the int16 total. A scan's time is its length times one step, so only
//   the recurrence stays on a step's chain: the costs come from a
//   cp.async ring in shared memory filled ahead of the walk, the
//   recurrence runs on 16-bit pairs with Hopper's DPX instructions
//   (__vimin3_s16x2, __viaddmin_s16x2) and one __reduce_min_sync. Two
//   launches, one along the rows and one along the columns, each walking
//   its lines both ways at once; the two walks of a line meet in the
//   middle through shared memory, so that the row launch writes each total
//   cell once and the column launch reads and writes it once: 120 MB at
//   188 x 621, against about 240 MB for the former design, which stored,
//   re-read and rewrote each cell from both walks of both launches. The
//   column launch gives each block a strip of columns sized to the card
//   (sgm_v1_cuda.agg_plan). Lines longer than shared memory holds, and
//   P2 > 255, take a read-modify-write variant: no length is refused.
//   At 188 x 621 (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.041 ms
//   along the rows (621 steps, 66 ns a step: the chain) and 0.032 along
//   the columns (188 steps on 125 blocks of 10 warps: issue), 0.073 in
//   all against 0.43 for the former design, which walked each line with
//   one warp a direction, loads on the chain, and added into the total
//   from both walks of both launches.
// - sgm1_wta: instruction issue, beside the bytes of the int16 volume
//   (29.9 MB at 188 x 621: 0.0089 ms), read once, 16 bytes a lane. One
//   block of 512 threads per image row, 8 lanes a pixel, the next four
//   pixels' loads in flight while a warp reduces the current four. The
//   right view needs total(x + d, d) for every right pixel: instead of
//   gathering it (2-byte reads 258 bytes apart), each left pixel pushes
//   its packed values into a padded row of shared memory with atomicMin
//   (min(total * 128 + d) a right pixel; min is order-free, so the result
//   is deterministic), the pad of each cell known at compile time for 12
//   of a lane's 16. A second phase, one thread per pixel, does the LR
//   check. A row wider than a block's shared memory holds (25,828
//   pixels) keeps both rows in global memory instead: no width is
//   refused. 0.0156 ms at 188 x 621 against 0.0692 for the former design,
//   a warp a pixel with three full-warp reductions on each pixel's chain
//   (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC -fmad=false. -fmad=false keeps the subpixel float math bitwise
// equal to the plain PyTorch version (IEEE division, no contraction).
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgm_dp16.cuh"

#include <type_traits>

namespace {

constexpr int kD = 128;
constexpr int kMaxCost = 32;
constexpr int kHuge = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
// Steps a copied chunk of an aggregation ring holds, along the rows (a
// chunk is one straight-line block of code: longer is faster on the long
// row chain) and along the columns (whose staged ring also holds the total
// and shares shared memory with the strip's deltas); chunks a ring holds.
constexpr int kAggRowSteps = 32;
constexpr int kAggColSteps = 8;
constexpr int kAggRingBufs = 2;
constexpr int kAggMaxStrip = 8;   // lines a block, two warps each
constexpr int kDelta8MaxP2 = 255;  // a delta in [0, P2] fits a byte

// Bit i (row-major over the window, centre skipped) is set where neighbour
// i is darker than the centre; neighbours outside the image are staged as
// +inf and never are. RH < 0: the radii come at run time (rh_, rw_ <=
// kMaxRadius). Dynamic shared memory, in words: the staged tile,
// kCensusTileH + 2 rh rows of census_stride(rw) floats, then the output
// tile, kCensusTileH x kCensusTileW words.
constexpr int kCensusTileW = 128;  // 32 lanes x 4 pixels
constexpr int kCensusTileH = 8;    // a warp a row
constexpr int kCensusThreads = 32 * kCensusTileH;
constexpr int kMaxRadius = 16;     // a side of 33: 32 neighbours

__host__ __device__ __forceinline__ int census_stride(int rw) {
  return (kCensusTileW + 2 * rw + 3) & ~3;
}

template <int RH, int RW>
__global__ void __launch_bounds__(kCensusThreads)
    census_kernel(const float* __restrict__ left,
                  const float* __restrict__ right, int* __restrict__ out_l,
                  int* __restrict__ out_r, int H, int W, int rh_, int rw_) {
  extern __shared__ __align__(16) float tile[];
  const int rh = RH >= 0 ? RH : rh_;
  const int rw = RW >= 0 ? RW : rw_;
  const float* __restrict__ img = blockIdx.z ? right : left;
  int* __restrict__ out = blockIdx.z ? out_r : out_l;
  const int x0 = blockIdx.x * kCensusTileW;
  const int y0 = blockIdx.y * kCensusTileH;
  const int stride = census_stride(rw);
  const int rows = kCensusTileH + 2 * rh;
  for (int i = threadIdx.x; i < rows * stride; i += kCensusThreads) {
    const int r = i / stride;
    const int y = y0 - rh + r;
    const int x = x0 - rw + (i - r * stride);
    tile[i] = y >= 0 && y < H && x >= 0 && x < W
                  ? img[static_cast<size_t>(y) * W + x]
                  : __int_as_float(0x7f800000);  // +inf
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int ww = 2 * rw + 1;
  const int centre = rh * ww + rw;  // window index of the centre
  const float* ctr = tile + (ty + rh) * stride + 4 * lane + rw;
  const float c[4] = {ctr[0], ctr[1], ctr[2], ctr[3]};
  unsigned bits[4] = {0u, 0u, 0u, 0u};
  // Row r of the window holds, for the lane's pixels k = 0..3, the values
  // at staged columns 4 lane + p, p = 0 .. 3 + 2 rw: value p is neighbour
  // dx = p - k - rw of pixel k. Read 4 at a time (16-byte aligned).
  const int chunks = (2 * rw + 7) / 4;
#pragma unroll
  for (int r = 0; r < 2 * rh + 1; ++r) {
    const float* src = tile + (ty + r) * stride + 4 * lane;
#pragma unroll
    for (int q = 0; q < chunks; ++q) {
      const float4 v4 = *reinterpret_cast<const float4*>(src + 4 * q);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int dxi = 4 * q + j - k;  // dx + rw
          const int i = r * ww + dxi;
          if (dxi < 0 || dxi >= ww || i == centre) continue;
          if (v[j] < c[k]) bits[k] |= 1u << (i < centre ? i : i - 1);
        }
      }
    }
  }

  // Through shared memory to coalesced stores: the lane's 4 words at
  // 4 lane, then word lane + 32 k of the row.
  int* res = reinterpret_cast<int*>(tile + rows * stride) + ty * kCensusTileW;
  *reinterpret_cast<int4*>(res + 4 * lane) =
      make_int4(static_cast<int>(bits[0]), static_cast<int>(bits[1]),
                static_cast<int>(bits[2]), static_cast<int>(bits[3]));
  __syncwarp();
  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = x0 + lane + 32 * k;
    if (x < W) out[static_cast<size_t>(y) * W + x] = res[lane + 32 * k];
  }
}

// Index of word i of a padded shared line: 4 pad words every 16. In the
// WTA, eight lanes a pixel, lane l on disparities 16 l .. 16 l + 15, and
// four adjacent pixels p a warp push to right pixels a + p - 16 l - i for
// one i at a time: sw maps them to sw(a + p) - 20 l (mod 32), 32 distinct
// banks (p sets the bank mod 4, the eight l the multiples of 4).
__host__ __device__ constexpr int sw(int i) { return i + ((i >> 4) << 2); }

// Word sw(s - i) of a padded line, s - i >= 0: the 16 words s - 15 .. s
// lie in the 16-word run of s and the one before it.
__device__ __forceinline__ int* sw_back(int* line, int s, int i) {
  return line + sw(s) - i - ((s & 15) < i ? 4 : 0);
}

// Cost: a block takes kCostTX adjacent pixels of one row. It stages their
// left census words and the kCostTX + 127 right words they are compared
// with in shared memory, once. A warp then takes 32 adjacent pixels, a
// lane each, for one chunk q of 16 disparities: the lanes' right words
// x - d are consecutive words (no conflicts, no address arithmetic: each
// of the 16 reads is the lane's base minus a constant). Right pixels left
// of the image (x < d) are told by position and cost kMaxCost, as in the
// plain version: no census value stands for them. The lane's 16 bytes go
// into a (kCostTX, 8) tile of 16-byte units, unit q of pixel j at
// j * 8 + (q ^ (j & 7)), so that each 8 lanes of a store, and each 8
// lanes of the read-out, hit 32 banks. The tile is then the volume's
// kCostTX * 128 contiguous bytes from (y, x0): one 16-byte store a lane,
// coalesced, not evict-first (the aggregation reads the volume next and
// it fits L2).
constexpr int kCostTX = 64;
constexpr int kCostThreads = 128;

__global__ void __launch_bounds__(kCostThreads)
    cost_kernel(const int* __restrict__ cl, const int* __restrict__ cr,
                int8_t* __restrict__ cost, int W, int segs) {
  __shared__ int s_cr[kCostTX + kD - 1];
  __shared__ int s_cl[kCostTX];
  __shared__ uint4 tile[kCostTX * 8];
  const int y = blockIdx.x / segs;
  const int x0 = (blockIdx.x - y * segs) * kCostTX;
  const size_t row = static_cast<size_t>(y) * W;
  // Staged word k is right pixel x0 - 127 + k; those left of the image
  // are never read as costs, zero keeps them defined.
  for (int k = threadIdx.x; k < kCostTX + kD - 1; k += kCostThreads) {
    const int x = x0 - (kD - 1) + k;
    s_cr[k] = x >= 0 && x < W ? cr[row + x] : 0;
  }
  for (int k = threadIdx.x; k < kCostTX; k += kCostThreads) {
    s_cl[k] = x0 + k < W ? cl[row + x0 + k] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // Task t: chunk q = t / (kCostTX / 32) of pixel j, lane j % 32.
  for (int t = threadIdx.x >> 5; t < kCostTX / 4; t += kCostThreads / 32) {
    const int j = 32 * (t % (kCostTX / 32)) + lane;
    const int q = t / (kCostTX / 32);
    const int x = x0 + j;
    const int c = s_cl[j];
    const int* right = s_cr + j + kD - 1 - 16 * q;  // right pixel x - 16 q
    unsigned cv[16];
    if (x >= 16 * q + 15) {  // every candidate in the image
#pragma unroll
      for (int i = 0; i < 16; ++i) cv[i] = __popc(c ^ right[-i]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        cv[i] = x >= 16 * q + i ? __popc(c ^ right[-i]) : kMaxCost;
      }
    }
    unsigned words[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      words[k] = __byte_perm(__byte_perm(cv[4 * k], cv[4 * k + 1], 0x0040),
                             __byte_perm(cv[4 * k + 2], cv[4 * k + 3], 0x0040),
                             0x5410);
    }
    tile[j * 8 + (q ^ (j & 7))] =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
  __syncthreads();

  const int units = min(kCostTX, W - x0) * 8;
  uint4* dst = reinterpret_cast<uint4*>(cost + (row + x0) * kD);
  for (int u = threadIdx.x; u < units; u += kCostThreads) {
    const int j = u >> 3;
    dst[u] = tile[j * 8 + ((u & 7) ^ (j & 7))];
  }
}

// Aggregation. The four paths L = C + delta of the plain version, with
// delta = b - m, b = min(L(d), min(L(d -+ 1)) + P1, m + P2), m = min L, on
// 16-bit pairs (dp_step16): a lane holds disparities d0 = 4 lane .. d0 + 3
// as A = (L(d0), L(d0 + 1)), B = (L(d0 + 2), L(d0 + 3)), low half first.
// Costs are clipped to [0, 127] on read and delta <= P2 <= 8063 (the
// wrapper's int16 limit, 4 (127 + P2) < 32768), so L <= 8190 and m + P2 <=
// 16253 fit a signed half. P1 is clamped to P2: L(d -+ 1) >= m, so a P1
// above P2 gives L(d -+ 1) + P1 > m + P2 and never wins, as P2 does not
// either (the clamp is exact), and then L(d -+ 1) + P1 <= 0x3fff + 8063
// fits too. No sum below leaves its half either: every value is >= 0 and
// every sum of halves stays below 32768, so a 32-bit add adds both halves.
// Bytes 0, 1 (lo) and 2, 3 (hi) of w as zero-extended 16-bit pairs.
__device__ __forceinline__ unsigned lo16x2(unsigned w) {
  return __byte_perm(w, 0, 0x4140);
}
__device__ __forceinline__ unsigned hi16x2(unsigned w) {
  return __byte_perm(w, 0, 0x4342);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// One launch aggregates both directions of a set of lines: the rows
// (VERTICAL false, storing L_left + L_right into the total) or the columns
// (VERTICAL, adding L_up + L_down to what the row launch stored). A block
// owns `strip` adjacent lines, two warps a line: warp 2k walks line k
// forward, warp 2k + 1 backward. Each total cell is written once a launch:
// the two walks of a line meet in the middle.
// - Both walks take P = ceil(len / 2) steps, then all warps meet at one
//   barrier, then P more. Step i of the forward walk is at pos i, of the
//   backward walk at pos 2P - 1 - i (for an odd len its first step lies
//   past the line and its last forward step too: they do nothing). So in
//   the first half each walk covers its own half of the line, in the
//   second the other's.
// - STAGED: in its first half a walk stores its deltas, one byte a
//   disparity, in the block's shared memory (len x 128 bytes a line);
//   in its second half it reads the other walk's delta at the same cell
//   and writes total = L + C + delta_other (+ the row launch's total) once.
//   A byte holds a delta while P2 <= 255.
// - Otherwise (P2 > 255, or lines longer than shared memory holds) the
//   first half stores L (+ the row launch's total) into the total cell and
//   the second half reads it back and adds, as a read-modify-write in
//   global memory: correct for every length and P2, with twice the bytes.
// - Costs are off the chain: each warp copies its line's next steps into
//   its own ring of kAggRingBufs chunks of kAggRowSteps / kAggColSteps
//   steps with 16-byte cp.async, kAggRingBufs - 1 chunks ahead of the
//   walk; the column launch
//   (STAGED) copies the row launch's total for its second-half steps the
//   same way. A step reads its 4 cost bytes (and 8 total bytes) from
//   shared memory at consecutive lane addresses and stores 8 contiguous
//   bytes a lane, 256 a warp.
template <bool VERTICAL, bool STAGED>
__global__ void __launch_bounds__(64 * kAggMaxStrip)
    aggregate_kernel(const int8_t* __restrict__ cost,
                     int16_t* total, int H, int W, int p1,
                     int p2) {
  extern __shared__ __align__(16) unsigned char agg_smem[];
  constexpr int kStepBytes = VERTICAL && STAGED ? 3 * kD : kD;
  constexpr int kSteps = VERTICAL ? kAggColSteps : kAggRowSteps;
  constexpr int kChunkBytes = kSteps * kStepBytes;
  constexpr int kPieces = kStepBytes / 16;  // 16-byte copies a step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int strip = blockDim.x >> 6;
  const int k = warp >> 1;
  const bool backward = warp & 1;
  const int line = blockIdx.x * strip + k;
  const int len = VERTICAL ? H : W;
  const bool live = line < (VERTICAL ? W : H);
  const int P = (len + 1) / 2;
  unsigned char* ring = agg_smem + warp * kAggRingBufs * kChunkBytes;
  unsigned* delta = reinterpret_cast<unsigned*>(
                        agg_smem + 2 * strip * kAggRingBufs * kChunkBytes) +
                    static_cast<size_t>(k) * len * 32 + lane;
  const size_t first = VERTICAL ? line : static_cast<size_t>(line) * W;
  const size_t step_px = VERTICAL ? W : 1;
  auto pos_of = [&](int i) { return backward ? 2 * P - 1 - i : i; };
  auto pixel = [&](int pos) { return first + pos * step_px; };

  // Copies chunk c (steps [c R, c R + R)) into its buffer: a step's cost
  // is 8 pieces of 16 bytes (4 steps a pass of the warp), its total, for
  // second-half steps of the staged column launch, 16 (2 steps a pass).
  auto fetch = [&](int c) {
    unsigned char* buf = ring + (c % kAggRingBufs) * kChunkBytes;
#pragma unroll
    for (int j0 = 0; j0 < kSteps; j0 += 4) {
      const int j = j0 + (lane >> 3);
      const int i = c * kSteps + j;
      const int pos = pos_of(i);
      if (i < 2 * P && pos < len) {
        cp_async16(buf + j * kStepBytes + (lane & 7) * 16,
                   cost + pixel(pos) * kD + (lane & 7) * 16);
      }
    }
    if constexpr (VERTICAL && STAGED) {
#pragma unroll
      for (int j0 = 0; j0 < kSteps; j0 += 2) {
        const int j = j0 + (lane >> 4);
        const int i = c * kSteps + j;
        const int pos = pos_of(i);
        if (i >= P && i < 2 * P && pos < len) {
          cp_async16(buf + j * kStepBytes + kD + (lane & 15) * 16,
                     reinterpret_cast<const unsigned char*>(
                         total + pixel(pos) * kD) + (lane & 15) * 16);
        }
      }
    }
  };

  const int pc = min(p1, p2);
  const unsigned p1p1 = __byte_perm(pc, pc, 0x5410);
  const unsigned p2p2 = __byte_perm(p2, p2, 0x5410);
  unsigned A = 0u, B = 0u;
  // In the read-modify-write variant, what the cell holds before this
  // walk adds to it: the other walk's L (second half) or the row launch's
  // total (column launch).
  auto prior = [&](int pos) {
    return *(reinterpret_cast<const uint2*>(total + pixel(pos) * kD) + lane);
  };
  // One step at `pos`, its cost (and, staged, its prior total) at st.
  auto step = [&](const unsigned char* st, int pos, uint2 r, auto half) {
    constexpr bool kSecond = decltype(half)::value;
    const unsigned cw =
        __vmaxs4(*reinterpret_cast<const unsigned*>(st + 4 * lane), 0u);
    const unsigned cA = lo16x2(cw), cB = hi16x2(cw);
    const unsigned e = dp_step16(A, B, cA, cB, p1p1, p2p2, lane);
    uint2* out = reinterpret_cast<uint2*>(total + pixel(pos) * kD) + lane;
    if constexpr (STAGED) {
      unsigned* dc = delta + static_cast<size_t>(pos) * 32;
      if constexpr (!kSecond) {
        *dc = e;
      } else {
        const unsigned o = *dc;
        uint2 t = make_uint2(A + cA + lo16x2(o), B + cB + hi16x2(o));
        if constexpr (VERTICAL) {
          const uint2 v = *reinterpret_cast<const uint2*>(st + kD + 8 * lane);
          t.x += v.x;
          t.y += v.y;
        }
        *out = t;
      }
    } else if constexpr (kSecond || VERTICAL) {
      *out = make_uint2(r.x + A, r.y + B);
    } else {
      *out = make_uint2(A, B);
    }
  };
  constexpr bool kReads = !STAGED;  // the variant reads the cell first
  auto walk = [&](int i0, int i1, auto half) {
    constexpr bool kRmw =
        kReads && (decltype(half)::value || VERTICAL);
    for (int c = i0 / kSteps; c * kSteps < i1; ++c) {
      const int lo = c * kSteps, hi = lo + kSteps;
      if (lo >= i0) {  // chunk c begins: refill, wait
        __syncwarp();  // the buffer of chunk c - 1 is free
        fetch(c + kAggRingBufs - 1);
        cp_async_commit();
        cp_async_wait<kAggRingBufs - 1>();
        __syncwarp();
      }
      const unsigned char* buf = ring + (c % kAggRingBufs) * kChunkBytes;
      if (lo >= i0 && hi <= i1 && max(pos_of(lo), pos_of(hi - 1)) < len) {
        // The whole chunk on the line and in this half: one block of
        // straight-line code, so the compiler interleaves a step's stores
        // and address arithmetic with the next step's chain.
        uint2 r[kSteps];
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          r[j] = kRmw ? prior(pos_of(lo + j)) : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          step(buf + j * kStepBytes, pos_of(lo + j), r[j], half);
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < kSteps; ++j) {
          const int i = lo + j;
          const int pos = pos_of(i);
          if (i < i0 || i >= i1 || pos >= len) continue;
          step(buf + j * kStepBytes, pos,
               kRmw ? prior(pos) : make_uint2(0u, 0u), half);
        }
      }
    }
  };

  if (live) {
    for (int c = 0; c < kAggRingBufs - 1; ++c) {
      fetch(c);
      cp_async_commit();
    }
    walk(0, P, std::false_type{});
  }
  __syncthreads();  // every first half is stored
  if (live) walk(P, 2 * P, std::true_type{});
  cp_async_wait<0>();
}

// Minimum over the 8 lanes that share a pixel.
__device__ __forceinline__ int group_min(int v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Word k of a lane's eight for a k known at run time, without indexing
// the register array (which would put it in local memory): 7 selects.
__device__ __forceinline__ int pick8(const int (&w)[8], int k) {
  int a[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) a[m] = k & 1 ? w[2 * m + 1] : w[2 * m];
  const int b0 = k & 2 ? a[1] : a[0];
  const int b1 = k & 2 ? a[3] : a[2];
  return k & 4 ? b1 : b0;
}

// WTA: one block of kWtaThreads per image row, four pixels a warp, eight
// lanes a pixel: lane l reads disparities 16 l .. 16 l + 15 as two 16-byte
// evict-first loads (the total is read once), and a warp issues the next
// four pixels' loads before it reduces the current ones. The packed
// minimum total * 128 + d (signed: the lowest d wins a tie, totals may be
// negative) is taken over the lane's 16 values in registers, then over
// the 8 lanes in 3 shuffles; each subpixel neighbour total(best -+ 1)
// comes from the lane that holds it, one shuffle of the word that holds
// it. Right view: each cell is candidate d of right pixel x - d, pushed
// with atomicMin into a row of packed minima (min is order-free, so the
// result is deterministic). STAGED: dynamic shared memory, in words: that
// row, padded by sw (a warp's 32 atomics hit 32 banks), then the
// disparity before the LR check (W words, -1 where x < best: a valid
// disparity is >= 0). Otherwise both live in global memory, the packed
// minima in the row of `scratch` (global atomicMin, unpadded), the
// disparity in the row of `out` (read back through L2 after the barrier).
// A second phase, a thread a pixel, does the LR check.
//
// The kernel is bound by instruction issue, so the padded cell of right
// pixel s - i, sw(s) - i - (4 where i > s & 15), is not computed per
// candidate: a warp's groups start at pixels 4 warp + 64 n, so s & 15 =
// R0 + p with R0 = 4 warp & 15 fixed for the warp and p = lane >> 3. With
// R0 a template argument the pad term is known at compile time for 12 of
// the 16 candidates and a lane constant for the other 4. Groups with a
// candidate left of the image or a pixel past the row's end take the
// generic code.
constexpr int kWtaThreads = 512;
constexpr int kWtaWarps = kWtaThreads / 32;

template <bool STAGED, int R0>
__device__ __forceinline__ void wta_groups(const int16_t* __restrict__ total,
                                           size_t row, int W, int* best_r,
                                           float* sdisp, int subpixel,
                                           int lr_check) {
  const int lane = threadIdx.x & 31;
  const int p = lane >> 3;
  const int l = lane & 7;
  const int d0 = 16 * l;
  // Pixel xg + p; past the row's end a lane repeats the last pixel: the
  // same values go into the same cells again, which neither a min nor a
  // store of an equal value notices, and the warp stays whole for the
  // shuffles.
  const int4* vol = reinterpret_cast<const int4*>(total + row * kD) + 2 * l;
  auto pixel = [&](int xg) { return min(xg + p, W - 1); };
  int xg = 4 * (threadIdx.x >> 5);
  int4 qa = make_int4(0, 0, 0, 0), qb = qa;
  if (xg < W) {
    qa = __ldcs(vol + pixel(xg) * (kD / 8));
    qb = __ldcs(vol + pixel(xg) * (kD / 8) + 1);
  }
  // The pad terms of candidates R0 + 1 .. R0 + 3 (see above).
  const int off1 = p < 1 ? -4 : 0, off2 = p < 2 ? -4 : 0,
            off3 = p < 3 ? -4 : 0;
  for (; xg < W; xg += 4 * kWtaWarps) {
    const int x = pixel(xg);
    const int w[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    const int next = xg + 4 * kWtaWarps;
    if (next < W) {
      qa = __ldcs(vol + pixel(next) * (kD / 8));
      qb = __ldcs(vol + pixel(next) * (kD / 8) + 1);
    }
    // pk[i] = total(d) * 128 + d, d = d0 + i: the low half of word k is
    // candidate 2 k, the high half 2 k + 1.
    int pk[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pk[2 * k] = static_cast<int16_t>(w[k]) * kD + (d0 + 2 * k);
      pk[2 * k + 1] = (w[k] >> 16) * kD + (d0 + 2 * k + 1);
    }
    int m = pk[0];
#pragma unroll
    for (int i = 1; i < 16; ++i) m = min(m, pk[i]);
    if (lr_check) {
      // Candidate d0 + i of right pixel s - i.
      const int s = x - d0;
      if (STAGED && R0 >= 0 && xg >= kD - 1 && xg + 3 < W) {
        int* cell = best_r + sw(s);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int pad = i <= R0 ? 0
                          : i > R0 + 3 ? -4
                          : i == R0 + 1 ? off1
                          : i == R0 + 2 ? off2
                                        : off3;
          atomicMin(cell + pad - i, pk[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (s >= i) {
            atomicMin(STAGED ? sw_back(best_r, s, i) : best_r + s - i,
                      pk[i]);
          }
        }
      }
    }
    const int run = group_min(m);
    const int best = run & (kD - 1);
    int cm = 0, cp = 0;  // read only for 0 < best < 127
    if (subpixel) {
      // Disparity d is half d & 1 of word (d & 15) >> 1 of lane d >> 4.
      const int group = lane & ~7;
      const int jm = (best - 1) & 15, jp = (best + 1) & 15;
      const int wm = __shfl_sync(kFull, pick8(w, jm >> 1),
                                 group | (((best - 1) >> 4) & 7));
      const int wp = __shfl_sync(kFull, pick8(w, jp >> 1),
                                 group | (((best + 1) >> 4) & 7));
      cm = jm & 1 ? wm >> 16 : static_cast<int16_t>(wm);
      cp = jp & 1 ? wp >> 16 : static_cast<int16_t>(wp);
    }
    if (l == 0) {
      float disp = static_cast<float>(best);
      if (subpixel && best > 0 && best < kD - 1) {
        const float fc0 = static_cast<float>(run >> 7);
        const float fcm = static_cast<float>(cm);
        const float fcp = static_cast<float>(cp);
        const float denom = fcm - 2.0f * fc0 + fcp;
        const float off =
            denom > 1e-6f ? __fdiv_rn(0.5f * (fcm - fcp), fmaxf(denom, 1e-6f))
                          : 0.0f;
        disp = disp + off;
      }
      sdisp[x] = x >= best ? disp : -1.0f;
    }
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(kWtaThreads, 2)
    wta_kernel(const int16_t* __restrict__ total, float* out, int* scratch,
               int W, int subpixel, int lr_check, float lr_max_diff) {
  extern __shared__ int smem[];
  const size_t row = static_cast<size_t>(blockIdx.x) * W;
  int* best_r = STAGED ? smem : scratch + row;
  float* sdisp = STAGED ? reinterpret_cast<float*>(smem + sw(W - 1) + 1)
                        : out + row;
  if (lr_check) {
    for (int x = threadIdx.x; x < W; x += kWtaThreads) {
      best_r[STAGED ? sw(x) : x] = kHuge;
    }
  }
  __syncthreads();
  switch (STAGED ? 4 * (threadIdx.x >> 5) & 15 : -1) {  // R0 of this warp
    case 0:
      wta_groups<STAGED, 0>(total, row, W, best_r, sdisp, subpixel, lr_check);
      break;
    case 4:
      wta_groups<STAGED, 4>(total, row, W, best_r, sdisp, subpixel, lr_check);
      break;
    case 8:
      wta_groups<STAGED, 8>(total, row, W, best_r, sdisp, subpixel, lr_check);
      break;
    case 12:
      wta_groups<STAGED, 12>(total, row, W, best_r, sdisp, subpixel,
                             lr_check);
      break;
    default:
      wta_groups<STAGED, -1>(total, row, W, best_r, sdisp, subpixel,
                             lr_check);
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += kWtaThreads) {
    const float disp = STAGED ? sdisp[x] : __ldcg(sdisp + x);
    bool valid = disp >= 0.0f;
    if (lr_check && valid) {
      const int xr = static_cast<int>(rintf(static_cast<float>(x) - disp));
      const int xc = min(max(xr, 0), W - 1);
      const int best_r_xc = (STAGED ? best_r[sw(xc)] : __ldcg(best_r + xc)) &
                            (kD - 1);
      valid = xr >= 0 &&
              fabsf(disp - static_cast<float>(best_r_xc)) <= lr_max_diff;
    }
    out[row + x] = valid ? disp : -1.0f;
  }
}

constexpr int kSmemPerBlock = 232448;  // bytes a block may opt in to

// Opts a kernel in to `smem` bytes of dynamic shared memory where that is
// above the 48 KB every kernel has.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Shared memory of the aggregation: every warp's ring, then (STAGED) the
// strip's byte deltas, len x 128 a line.
size_t agg_smem_bytes(int len, int strip, bool vertical, bool staged) {
  const size_t step = vertical && staged ? 3 * kD : kD;
  const size_t steps = vertical ? kAggColSteps : kAggRowSteps;
  return 2 * static_cast<size_t>(strip) * kAggRingBufs * steps * step +
         (staged ? static_cast<size_t>(strip) * len * kD : 0);
}

}  // namespace

extern "C" {

// One launch for `views` images (1 or 2) of one size: left -> out_l and,
// with two, right -> out_r.
int sgm1_census(const void* left, const void* right, void* out_l,
                void* out_r, int views, int H, int W, int rh, int rw,
                void* stream) {
  if (rh < 0 || rw < 0 || rh > kMaxRadius || rw > kMaxRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + kCensusTileW - 1) / kCensusTileW,
            (H + kCensusTileH - 1) / kCensusTileH, views);
  const size_t smem = (static_cast<size_t>(kCensusTileH + 2 * rh) *
                           census_stride(rw) +
                       kCensusTileH * kCensusTileW) *
                      sizeof(float);
  auto kernel = rh == 2 && rw == 2 ? census_kernel<2, 2>
                                   : census_kernel<-1, -1>;
  kernel<<<grid, kCensusThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(left), static_cast<const float*>(right),
      static_cast<int*>(out_l), static_cast<int*>(out_r), H, W, rh, rw);
  return static_cast<int>(cudaGetLastError());
}

// The cost must be 16-byte aligned. One block per kCostTX pixels of a
// row, the segments of a row in turn: a 1-D grid takes any height.
int sgm1_cost(const void* cl, const void* cr, void* cost, int H, int W,
              void* stream) {
  if (reinterpret_cast<uintptr_t>(cost) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int segs = (W + kCostTX - 1) / kCostTX;
  cost_kernel<<<H * segs, kCostThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<int8_t*>(cost), W, segs);
  return static_cast<int>(cudaGetLastError());
}

// vertical: the column launch (adds to the total), else the row launch
// (stores it). strip: lines a block, 1 .. kAggMaxStrip. staged: byte
// deltas in shared memory (P2 <= kDelta8MaxP2 and agg_smem_bytes within
// kSmemPerBlock), else the read-modify-write variant. The cost and total
// must be 16-byte aligned.
int sgm1_aggregate(const void* cost, void* total, int H, int W, int p1,
                   int p2, int vertical, int strip, int staged,
                   void* stream) {
  const int len = vertical ? H : W;
  const size_t smem = agg_smem_bytes(len, strip, vertical, staged);
  if (strip < 1 || strip > kAggMaxStrip || p1 < 0 || p2 < 0 ||
      4 * (127 + p2) >= 32768 || (staged && p2 > kDelta8MaxP2) ||
      smem > kSmemPerBlock ||
      (reinterpret_cast<uintptr_t>(cost) |
       reinterpret_cast<uintptr_t>(total)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vertical ? (staged ? aggregate_kernel<true, true>
                                   : aggregate_kernel<true, false>)
                         : (staged ? aggregate_kernel<false, true>
                                   : aggregate_kernel<false, false>);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lines = vertical ? W : H;
  kernel<<<(lines + strip - 1) / strip, 64 * strip, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cost), static_cast<int16_t*>(total), H, W,
      p1, p2);
  return static_cast<int>(cudaGetLastError());
}

// scratch: null for rows whose padded right-view row and disparity fit a
// block's shared memory (sw(W - 1) + 1 + W words), else H x W int32 of
// global memory for the right view. The total must be 16-byte aligned.
int sgm1_wta(const void* total, void* out, void* scratch, int H, int W,
             int subpixel, int lr_check, float lr_max_diff, void* stream) {
  const bool staged = scratch == nullptr;
  const size_t smem =
      staged ? (static_cast<size_t>(sw(W - 1)) + 1 + W) * sizeof(int) : 0;
  if (smem > kSmemPerBlock || reinterpret_cast<uintptr_t>(total) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = staged ? wta_kernel<true> : wta_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<H, kWtaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(total), static_cast<float*>(out),
      static_cast<int*>(scratch), W, subpixel, lr_check, lr_max_diff);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
