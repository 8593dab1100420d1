// RAFT's correlation lookup for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no RAFT. It computes what
// the published CorrBlock.__call__ (princeton-vl/RAFT core/corr.py)
// computes with one grid_sample a pyramid level: for every pixel n of the
// (B, h, w) query grid and every level l of the all-pairs pyramid (level
// l a map of (H_l, W_l) for each n), the bilinear samples of n's map at
// (x / 2^l + dx, y / 2^l + dy), dx and dy in -r..r, zero outside the map:
//
//   out[b, l*K*K + (dx+r)*K + (dy+r), y, x],  K = 2r + 1,
//
// the published channel order (its meshgrid puts dy into the x
// coordinate's offset and lists it first, so the first offset index is
// the x offset). Each sample repeats bilinear_sampler's arithmetic: the
// coordinate normalised as 2 x / (W - 1) - 1 and unnormalised by
// grid_sample with align_corners as ((g + 1) / 2) (W - 1), its four taps
// weighted and summed in grid_sample's order, a tap outside the map
// skipped. Built with -fmad=false, so the products are not fused.
//
// What bounds it on an H100: latency and bytes. Per call it writes the
// (B, L K^2, h, w) f32 features (9.5 MB at RAFT's 47 x 156 KITTI grid)
// and reads 2 rows of about 10 floats of each level's map for each
// (pixel, level, dy): scattered 40-byte reads, one map per pixel, that L1
// and L2 serve after the first touch. The pyramid itself (286 MB there)
// is far larger than L2 but only a 10 x 10 patch of each map is read.
// Design: one launch for every level; a thread one (pixel, level, dy),
// its 2r + 1 outputs along dx, so the threads of a warp are neighbouring
// pixels and every store is coalesced; the grid's second dimension runs
// over (level, dy), which gives about 264 K threads at the KITTI grid,
// enough to keep every SM's load units busy.
//
// The entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;

struct Levels {
  const float* map[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

// grid_sample's unnormalised coordinate of the sample at pixel coordinate
// c of a side of ``size``, after bilinear_sampler's normalisation.
__device__ __forceinline__ float source_index(float c, int size) {
  const float s = static_cast<float>(size - 1);
  const float g = 2.0f * c / s - 1.0f;
  return ((g + 1.0f) / 2.0f) * s;
}

__global__ void raft_lookup_kernel(Levels lv, const float* __restrict__ coords,
                                   float* __restrict__ out, int n_pix, int hw,
                                   int levels, int r) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_pix) return;
  const int K = 2 * r + 1;
  const int l = blockIdx.y / K;
  const int iy = blockIdx.y - l * K;
  const int b = n / hw;
  const int p = n - b * hw;
  const float inv = 1.0f / static_cast<float>(1 << l);
  const float cx = coords[(static_cast<size_t>(b) * 2) * hw + p] * inv;
  const float cy = coords[(static_cast<size_t>(b) * 2 + 1) * hw + p] * inv;
  const int H = lv.H[l], W = lv.W[l];
  const float* __restrict__ map =
      lv.map[l] + static_cast<size_t>(n) * H * W;

  const float yi = source_index(cy + static_cast<float>(iy - r), H);
  const float y0f = floorf(yi);
  // Rows of the two taps, -1 where outside the map (and for coordinates
  // too far out to hold as an int).
  const bool in0 = y0f >= 0.0f && y0f <= static_cast<float>(H - 1);
  const bool in1 = y0f + 1.0f >= 0.0f && y0f + 1.0f <= static_cast<float>(H - 1);
  const int y0 = in0 ? static_cast<int>(y0f) : 0;
  const int y1 = in1 ? static_cast<int>(y0f) + 1 : 0;
  const float* row0 = map + static_cast<size_t>(y0) * W;
  const float* row1 = map + static_cast<size_t>(y1) * W;
  const float fy1 = yi - y0f;         // iy - iy_nw
  const float fy0 = (y0f + 1.0f) - yi;  // iy_se - iy

  const size_t plane = static_cast<size_t>(hw);
  float* o = out + (static_cast<size_t>(b) * levels * K * K +
                    static_cast<size_t>(l) * K * K + iy) * plane + p;
#pragma unroll
  for (int ix = 0; ix < 2 * kMaxRadius + 1; ++ix) {
    if (ix < K) {
      const float xi = source_index(cx + static_cast<float>(ix - r), W);
      const float x0f = floorf(xi);
      const bool ok0 = x0f >= 0.0f && x0f <= static_cast<float>(W - 1);
      const bool ok1 =
          x0f + 1.0f >= 0.0f && x0f + 1.0f <= static_cast<float>(W - 1);
      const int x0 = ok0 ? static_cast<int>(x0f) : 0;
      const int x1 = ok1 ? static_cast<int>(x0f) + 1 : 0;
      const float fx1 = xi - x0f;
      const float fx0 = (x0f + 1.0f) - xi;
      float acc = 0.0f;
      if (in0 && ok0) acc += row0[x0] * (fx0 * fy0);  // nw
      if (in0 && ok1) acc += row0[x1] * (fx1 * fy0);  // ne
      if (in1 && ok0) acc += row1[x0] * (fx0 * fy1);  // sw
      if (in1 && ok1) acc += row1[x1] * (fx1 * fy1);  // se
      o[static_cast<size_t>(ix) * K * plane] = acc;
    }
  }
}

}  // namespace

// ``maps``: ``levels`` device pointers, level l a contiguous (B h w, H_l,
// W_l) f32 pyramid level; ``heights`` / ``widths`` their H_l, W_l.
// ``coords``: contiguous (B, 2, h, w) f32, x then y. ``out``: contiguous
// (B, levels (2r+1)^2, h, w) f32.
extern "C" int raft_lookup(const float* const* maps, const int* heights,
                           const int* widths, int levels, const float* coords,
                           float* out, int B, int h, int w, int r,
                           cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || r < 1 || r > kMaxRadius ||
      B <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  for (int l = 0; l < levels; ++l) {
    if (heights[l] <= 0 || widths[l] <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.map[l] = maps[l];
    lv.H[l] = heights[l];
    lv.W[l] = widths[l];
  }
  const int n_pix = B * h * w;
  dim3 grid((n_pix + kThreads - 1) / kThreads, levels * (2 * r + 1));
  raft_lookup_kernel<<<grid, kThreads, 0, stream>>>(lv, coords, out, n_pix,
                                                    h * w, levels, r);
  return static_cast<int>(cudaGetLastError());
}
