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
// - sgm1_cost: the bytes of the volume it writes. One warp per pixel, lane
//   l holds disparities 4 l .. 4 l + 3 and stores them as one char4, so a
//   warp writes 128 contiguous bytes.
// - sgm1_aggregate: latency along the scan, as the v2 DP. One warp per scan
//   direction, 4 disparities a lane, the recurrence in registers, min Lp by
//   a __shfl_xor reduction and d -+ 1 by one __shfl_up / __shfl_down. A
//   block owns one line and runs its forward and backward walks at once,
//   each adding its L into the line's int16 cells; the two warps swap
//   halves at a barrier, so no cell is touched by both at a time and no
//   atomics are needed. The vertical launch adds into what the horizontal
//   one wrote. A vertical line's steps lie W * 128 bytes apart, so nothing
//   of the next step is in a cache line already fetched: the loads of
//   kUnroll steps are started together before the dependent updates, which
//   keeps that many requests in flight per warp.
// - sgm1_wta: the bytes of the int16 volume, read once and coalesced. One
//   block per image row, one warp per pixel, lane l holding disparities
//   l, l + 32, l + 64, l + 96. The right view needs total(x + d, d) for
//   every right pixel: instead of gathering it (2-byte reads 258 bytes
//   apart), each left pixel pushes its packed values into a row of shared
//   memory with atomicMin (rv[x - d] = min(total * 128 + d)); min is
//   order-free, so the result is deterministic. A second phase, one thread
//   per pixel, does the LR check from shared memory. A row wider than a
//   block's shared memory holds (two words a pixel, opted in above 48 KB)
//   keeps both rows in global memory instead: no width is refused.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC -fmad=false. -fmad=false keeps the subpixel float math bitwise
// equal to the plain PyTorch version (IEEE division, no contraction).
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kMaxCost = 32;
constexpr int kBig = 1 << 20;
constexpr int kHuge = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // scan steps whose loads are started together

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

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

// One warp per pixel: cost(y, x, d) = popcount(cl(x) ^ cr(x - d)), 32 for
// x < d.
__global__ void cost_kernel(const int* __restrict__ cl,
                            const int* __restrict__ cr,
                            int8_t* __restrict__ cost, int n, int W) {
  const int lane = threadIdx.x & 31;
  const int pix = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pix >= n) return;
  const int x = pix % W;
  const int c = cl[pix];
  const int d0 = lane * 4;
  const int c0 = x >= d0 ? __popc(c ^ cr[pix - d0]) : kMaxCost;
  const int c1 = x >= d0 + 1 ? __popc(c ^ cr[pix - d0 - 1]) : kMaxCost;
  const int c2 = x >= d0 + 2 ? __popc(c ^ cr[pix - d0 - 2]) : kMaxCost;
  const int c3 = x >= d0 + 3 ? __popc(c ^ cr[pix - d0 - 3]) : kMaxCost;
  *reinterpret_cast<char4*>(cost + static_cast<size_t>(pix) * kD + d0) =
      make_char4(static_cast<signed char>(c0), static_cast<signed char>(c1),
                 static_cast<signed char>(c2), static_cast<signed char>(c3));
}

// One block of two warps per scan line: warp 0 walks the line forward,
// warp 1 backward, each adding its L = C + delta into the line's int16
// cells. Both walk at once without atomics: in the first phase each warp
// covers its own half of the line (forward [0, len / 2), backward the
// rest), after the barrier each continues through the half the other has
// finished, so the two never touch the same cell at the same time. A cell
// is stored by its first visitor and added to by its second; with
// accumulate != 0 (the second launch on a volume) both add.
// VERTICAL scans y down column `line`; otherwise x along row `line`.
template <bool VERTICAL>
__global__ void aggregate_kernel(const int8_t* __restrict__ cost,
                                 int16_t* total, int H, int W, int p1, int p2,
                                 int accumulate) {
  const int lane = threadIdx.x & 31;
  const int dir = threadIdx.x >> 5;  // 0 forward, 1 backward
  const int line = blockIdx.x;
  const int len = VERTICAL ? H : W;
  const int half = len / 2;
  const size_t base = VERTICAL ? line : static_cast<size_t>(line) * W;
  const size_t step = VERTICAL ? W : 1;
  const int d0 = lane * 4;
  int l0 = 0, l1 = 0, l2 = 0, l3 = 0;
  for (int phase = 0; phase < 2; ++phase) {
    const bool add = phase == 1 || accumulate != 0;
    // Forward: [0, half) then [half, len). Backward: len - 1 down to half,
    // then half - 1 down to 0.
    const int start = dir == 0 ? (phase == 0 ? 0 : half)
                               : (phase == 0 ? len - 1 : half - 1);
    const int count = (dir == 0) == (phase == 0) ? half : len - half;
    const int sign = dir == 0 ? 1 : -1;
    for (int s0 = 0; s0 < count; s0 += kUnroll) {
      char4 c[kUnroll];
      short4 t[kUnroll];
      size_t off[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u < count) {
          const int pos = start + sign * (s0 + u);
          off[u] = (base + pos * step) * kD + d0;
          c[u] = *reinterpret_cast<const char4*>(cost + off[u]);
          if (add) t[u] = *reinterpret_cast<const short4*>(total + off[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u < count) {
          const int m = warp_min(min(min(l0, l1), min(l2, l3)));
          int left = __shfl_up_sync(kFull, l3, 1);  // L(d0 - 1)
          int right = __shfl_down_sync(kFull, l0, 1);  // L(d0 + 4)
          if (lane == 0) left = kBig;
          if (lane == 31) right = kBig;
          const int mp2 = m + p2;
          const int e0 = min(min(l0, mp2), min(left, l1) + p1) - m;
          const int e1 = min(min(l1, mp2), min(l0, l2) + p1) - m;
          const int e2 = min(min(l2, mp2), min(l1, l3) + p1) - m;
          const int e3 = min(min(l3, mp2), min(l2, right) + p1) - m;
          // Costs are clipped to [0, 127] on read (int8 tops out at 127).
          l0 = max(static_cast<int>(c[u].x), 0) + e0;
          l1 = max(static_cast<int>(c[u].y), 0) + e1;
          l2 = max(static_cast<int>(c[u].z), 0) + e2;
          l3 = max(static_cast<int>(c[u].w), 0) + e3;
          short4 o;
          if (add) {
            o = make_short4(static_cast<short>(t[u].x + l0),
                            static_cast<short>(t[u].y + l1),
                            static_cast<short>(t[u].z + l2),
                            static_cast<short>(t[u].w + l3));
          } else {
            o = make_short4(static_cast<short>(l0), static_cast<short>(l1),
                            static_cast<short>(l2), static_cast<short>(l3));
          }
          *reinterpret_cast<short4*>(total + off[u]) = o;
        }
      }
    }
    __syncthreads();  // the halves change hands
  }
}

// One block per image row. STAGED: dynamic shared memory, 2 W words (the
// right view's packed minimum, the disparity before the LR check, -1 where
// x < best: a valid disparity is >= 0). Otherwise both live in global
// memory, the packed minimum in the row of `scratch` (global atomicMin,
// the same order-free minimum), the disparity in the row of `out` (read
// back through L2 after the barrier).
template <bool STAGED>
__global__ void wta_kernel(const int16_t* __restrict__ total, float* out,
                           int* scratch, int H, int W, int subpixel,
                           int lr_check, float lr_max_diff) {
  extern __shared__ int smem[];
  const int y = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row = static_cast<size_t>(y) * W;
  int* rv = STAGED ? smem : scratch + row;
  float* sdisp = STAGED ? reinterpret_cast<float*>(smem + W) : out + row;

  for (int x = threadIdx.x; x < W; x += blockDim.x) rv[x] = kHuge;
  __syncthreads();

  for (int x = warp; x < W; x += nwarps) {
    const int16_t* p = total + (row + x) * kD;
    int t[4];
    int packed = kHuge;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = lane + 32 * k;
      t[k] = p[d];
      const int pk = t[k] * kD + d;
      packed = min(packed, pk);
      // Right view: this cell is candidate d of right pixel x - d.
      if (lr_check && x >= d) atomicMin(&rv[x - d], pk);
    }
    const int run = warp_min(packed);
    const int best = run & (kD - 1);
    const int c0 = run >> 7;
    int cm = kHuge, cp = kHuge;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = lane + 32 * k;
      if (d == best - 1) cm = t[k];
      if (d == best + 1) cp = t[k];
    }
    cm = warp_min(cm);
    cp = warp_min(cp);
    if (lane == 0) {
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
      sdisp[x] = x >= best ? disp : -1.0f;
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float disp = STAGED ? sdisp[x] : __ldcg(sdisp + x);
    bool valid = disp >= 0.0f;
    if (lr_check && valid) {
      const int xr = static_cast<int>(rintf(static_cast<float>(x) - disp));
      const int xc = min(max(xr, 0), W - 1);
      const int best_r = (STAGED ? rv[xc] : __ldcg(rv + xc)) & (kD - 1);
      valid = xr >= 0 &&
              fabsf(disp - static_cast<float>(best_r)) <= lr_max_diff;
    }
    out[row + x] = valid ? disp : -1.0f;
  }
}

constexpr int kCostThreads = 256;  // 8 pixels per block
constexpr int kAggThreads = 64;    // one scan line per block, two warps
constexpr int kWtaThreads = 256;

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

int sgm1_cost(const void* cl, const void* cr, void* cost, int H, int W,
              void* stream) {
  const int n = H * W;
  const int per_block = kCostThreads / 32;
  cost_kernel<<<(n + per_block - 1) / per_block, kCostThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<int8_t*>(cost), n, W);
  return static_cast<int>(cudaGetLastError());
}

int sgm1_aggregate(const void* cost, void* total, int H, int W, int p1,
                   int p2, int vertical, int accumulate, void* stream) {
  const int blocks = vertical ? W : H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vertical) {
    aggregate_kernel<true><<<blocks, kAggThreads, 0, s>>>(
        static_cast<const int8_t*>(cost), static_cast<int16_t*>(total), H, W,
        p1, p2, accumulate);
  } else {
    aggregate_kernel<false><<<blocks, kAggThreads, 0, s>>>(
        static_cast<const int8_t*>(cost), static_cast<int16_t*>(total), H, W,
        p1, p2, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: null for rows whose two words a pixel fit a block's shared
// memory, else H x W int32 of global memory for the right view.
int sgm1_wta(const void* total, void* out, void* scratch, int H, int W,
             int subpixel, int lr_check, float lr_max_diff, void* stream) {
  const bool staged = scratch == nullptr;
  const size_t smem = staged ? static_cast<size_t>(W) * 2 * sizeof(int) : 0;
  auto kernel = staged ? wta_kernel<true> : wta_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<H, kWtaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(total), static_cast<float*>(out),
      static_cast<int*>(scratch), H, W, subpixel, lr_check, lr_max_diff);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
