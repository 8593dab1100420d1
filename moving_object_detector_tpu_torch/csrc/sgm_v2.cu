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
//   lines. The design is the classic CUDA SGM one: one warp per scan line,
//   4 disparities per lane, the path minimum by a __shfl_xor reduction, the
//   neighbours d-1 / d+1 by one __shfl_up / __shfl_down, the Hamming cost
//   __popc(cl[y,x] ^ cr[y,x-d]) computed in the kernel (32 for x < d), and
//   one 4-byte store per lane per step (128 coalesced bytes per warp).
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
//   into best_r[x - d] in shared memory with atomicMin while it is in
//   registers; min is order-free, so the result is the same from run to
//   run. The disparity before the LR check waits in shared memory; after
//   one barrier a second phase, one thread a pixel, does the LR check and
//   writes. The eight lanes of a pixel touch right pixels 16 apart, so the
//   shared rows carry 4 pad words every 16 (sw below): with four
//   neighbouring pixels a warp's 32 accesses fall into 32 banks.
// Later work: several scan lines per warp in the DP, fusing the WTA into
// the last DP pass; wgmma has no role here.
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

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One warp per scan line, blockIdx.y = direction (0 forward, 1 backward).
// VERTICAL scans y down column `line`; otherwise scans x along row `line`.
template <bool VERTICAL>
__global__ void dp_kernel(const int* __restrict__ cl,
                          const int* __restrict__ cr,
                          int8_t* __restrict__ out_f,
                          int8_t* __restrict__ out_b, int H, int W, int p1,
                          int p2) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool backward = blockIdx.y == 1;
  const int nlines = VERTICAL ? W : H;
  const int len = VERTICAL ? H : W;
  if (line >= nlines) return;  // the whole warp leaves together
  int8_t* __restrict__ out = backward ? out_b : out_f;
  const int d0 = lane * 4;
  int l0 = 0, l1 = 0, l2 = 0, l3 = 0;
  for (int s = 0; s < len; ++s) {
    const int t = backward ? len - 1 - s : s;
    const int y = VERTICAL ? t : line;
    const int x = VERTICAL ? line : t;
    const int row = y * W;
    const int c = cl[row + x];
    const int c0 = x >= d0 ? __popc(c ^ cr[row + x - d0]) : kMaxCost;
    const int c1 = x >= d0 + 1 ? __popc(c ^ cr[row + x - d0 - 1]) : kMaxCost;
    const int c2 = x >= d0 + 2 ? __popc(c ^ cr[row + x - d0 - 2]) : kMaxCost;
    const int c3 = x >= d0 + 3 ? __popc(c ^ cr[row + x - d0 - 3]) : kMaxCost;
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
    l0 = c0 + e0;
    l1 = c1 + e1;
    l2 = c2 + e2;
    l3 = c3 + e3;
    *reinterpret_cast<char4*>(out + (static_cast<size_t>(row) + x) * kD +
                              d0) =
        make_char4(static_cast<signed char>(e0), static_cast<signed char>(e1),
                   static_cast<signed char>(e2), static_cast<signed char>(e3));
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

// One block per image row. Dynamic shared memory, in words: the right
// census line and the right view's packed minimum (padded, sw(W - 1) + 1
// each), the left census line and the disparity before the LR check (W
// each).
__global__ void __launch_bounds__(kWtaThreads)
    wta_kernel(const int8_t* __restrict__ hf, const int8_t* __restrict__ hb,
               const int8_t* __restrict__ vf, const int8_t* __restrict__ vb,
               const int* __restrict__ cl, const int* __restrict__ cr,
               float* __restrict__ out, int H, int W, int subpixel,
               int lr_check, float lr_max_diff, float uniqueness) {
  extern __shared__ int smem[];
  const int padded = sw(W - 1) + 1;
  int* cr_s = smem;
  int* best_r = cr_s + padded;
  int* cl_s = best_r + padded;
  float* sdisp = reinterpret_cast<float*>(cl_s + W);
  const int y = blockIdx.x;
  const size_t row = static_cast<size_t>(y) * W;

  for (int x = threadIdx.x; x < W; x += kWtaThreads) {
    cr_s[sw(x)] = cr[row + x];
    best_r[sw(x)] = kHuge;
    cl_s[x] = cl[row + x];
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
        const int slot = sw(max(xr, 0));
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
    const float disp = sdisp[x];
    bool valid = disp >= 0.0f;
    if (lr_check && valid) {
      const int xr = static_cast<int>(rintf(static_cast<float>(x) - disp));
      const int xc = min(max(xr, 0), W - 1);
      const int d_r = best_r[sw(xc)] & (kD - 1);
      valid = xr >= 0 && fabsf(disp - static_cast<float>(d_r)) <= lr_max_diff;
    }
    out[row + x] = valid ? disp : -1.0f;
  }
}

constexpr int kDpThreads = 128;  // 4 scan lines per block

}  // namespace

extern "C" {

int sgm_vertical(const void* cl, const void* cr, void* vf, void* vb, int H,
                 int W, int p1, int p2, void* stream) {
  const int lines_per_block = kDpThreads / 32;
  dim3 grid((W + lines_per_block - 1) / lines_per_block, 2);
  dp_kernel<true><<<grid, kDpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<int8_t*>(vf), static_cast<int8_t*>(vb), H, W, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

int sgm_horizontal(const void* cl, const void* cr, void* hf, void* hb, int H,
                   int W, int p1, int p2, void* stream) {
  const int lines_per_block = kDpThreads / 32;
  dim3 grid((H + lines_per_block - 1) / lines_per_block, 2);
  dp_kernel<false><<<grid, kDpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<int8_t*>(hf), static_cast<int8_t*>(hb), H, W, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

int sgm_wta(const void* hf, const void* hb, const void* vf, const void* vb,
            const void* cl, const void* cr, void* out, int H, int W,
            int subpixel, int lr_check, float lr_max_diff, float uniqueness,
            void* stream) {
  const size_t smem =
      (2 * static_cast<size_t>(sw(W - 1) + 1) + 2 * static_cast<size_t>(W)) *
      sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wta_kernel<<<H, kWtaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hf), static_cast<const int8_t*>(hb),
      static_cast<const int8_t*>(vf), static_cast<const int8_t*>(vb),
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<float*>(out), H, W, subpixel, lr_check, lr_max_diff,
      uniqueness);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
