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
// - WTA (sgm_wta): the bytes it moves (4 delta volumes in, one f32 plane
//   out). One block per image row: the right-view argmin of the whole row
//   goes to shared memory first, then each warp takes one pixel, finds the
//   packed (total * 128 + d) minimum (lowest d wins ties), the neighbour
//   costs for the parabola, the optional uniqueness minimum, and the LR
//   check against the shared right-view row.
// Later work: cp.async/TMA staging of the census rows, several scan lines
// per warp, fusing the WTA into the last DP pass; wgmma has no role here.
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

__device__ __forceinline__ int total_at(const int8_t* hf, const int8_t* hb,
                                        const int8_t* vf, const int8_t* vb,
                                        size_t o, int cost) {
  return static_cast<int>(hf[o]) + static_cast<int>(hb[o]) +
         static_cast<int>(vf[o]) + static_cast<int>(vb[o]) + 4 * cost;
}

// One block per image row. Dynamic shared memory: W ints (right view).
__global__ void wta_kernel(const int8_t* __restrict__ hf,
                           const int8_t* __restrict__ hb,
                           const int8_t* __restrict__ vf,
                           const int8_t* __restrict__ vb,
                           const int* __restrict__ cl,
                           const int* __restrict__ cr,
                           float* __restrict__ out, int H, int W,
                           int subpixel, int lr_check, float lr_max_diff,
                           float uniqueness) {
  extern __shared__ int best_r[];
  const int y = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int d0 = lane * 4;
  const size_t row = static_cast<size_t>(y) * W;

  if (lr_check) {
    // Right view: best_r(xr) = argmin_d total(y, xr + d, d), x < W only.
    for (int xr = warp; xr < W; xr += nwarps) {
      const int crv = cr[row + xr];
      int best = kHuge;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = d0 + k;
        const int x = xr + d;
        if (x < W) {
          const size_t o = (row + x) * kD + d;
          const int tot = total_at(hf, hb, vf, vb, o, __popc(cl[row + x] ^ crv));
          best = min(best, tot * kD + d);
        }
      }
      best = warp_min(best);
      if (lane == 0) best_r[xr] = best & (kD - 1);
    }
    __syncthreads();
  }

  for (int x = warp; x < W; x += nwarps) {
    const size_t o = (row + x) * kD + d0;
    const char4 a = *reinterpret_cast<const char4*>(hf + o);
    const char4 b = *reinterpret_cast<const char4*>(hb + o);
    const char4 c = *reinterpret_cast<const char4*>(vf + o);
    const char4 e = *reinterpret_cast<const char4*>(vb + o);
    const int clv = cl[row + x];
    int t[4];
    t[0] = a.x + b.x + c.x + e.x;
    t[1] = a.y + b.y + c.y + e.y;
    t[2] = a.z + b.z + c.z + e.z;
    t[3] = a.w + b.w + c.w + e.w;
    int packed = kHuge;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = d0 + k;
      const int cost = x >= d ? __popc(clv ^ cr[row + x - d]) : kMaxCost;
      t[k] += 4 * cost;
      packed = min(packed, t[k] * kD + d);
    }
    const int run = warp_min(packed);
    const int best = run & (kD - 1);
    const int c0 = run >> 7;
    int cm = kHuge, cp = kHuge, um = kHuge;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = d0 + k;
      if (d == best - 1) cm = t[k];
      if (d == best + 1) cp = t[k];
      if (abs(d - best) > 1) um = min(um, t[k]);
    }
    cm = warp_min(cm);
    cp = warp_min(cp);
    if (uniqueness > 0.0f) um = warp_min(um);
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
      bool valid = x >= best;
      if (uniqueness > 0.0f)
        valid = valid && (static_cast<float>(um) * uniqueness >=
                          static_cast<float>(c0));
      if (lr_check) {
        const int xr = static_cast<int>(rintf(static_cast<float>(x) - disp));
        const int xc = min(max(xr, 0), W - 1);
        valid = valid && xr >= 0 &&
                fabsf(disp - static_cast<float>(best_r[xc])) <= lr_max_diff;
      }
      out[row + x] = valid ? disp : -1.0f;
    }
  }
}

constexpr int kDpThreads = 128;  // 4 scan lines per block
constexpr int kWtaThreads = 256;

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
  const size_t smem = static_cast<size_t>(W) * sizeof(int);
  wta_kernel<<<H, kWtaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hf), static_cast<const int8_t*>(hb),
      static_cast<const int8_t*>(vf), static_cast<const int8_t*>(vb),
      static_cast<const int*>(cl), static_cast<const int*>(cr),
      static_cast<float*>(out), H, W, subpixel, lr_check, lr_max_diff,
      uniqueness);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
