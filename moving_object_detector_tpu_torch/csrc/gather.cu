// Windowed per-pixel 2D gather for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel window_gather_pallas /
// _window_gather_kernel (ops/gather_pallas.py:70, :43):
//   out[i, j] = src[v_idx[i, j], u_idx[i, j]]
// where the source pixel lies inside the image and inside the covered
// window of (i, j), NaN otherwise. The covered window is what the TPU
// kernel scans: source row groups (8 rows) within rg groups of the output
// pixel's group and column tiles (128 columns) within rt tiles of its
// tile, so the predicate is two integer shifts and needs no tiles here.
//
// What bounds it on an H100: the bytes it moves (two index planes and the
// source read, one plane written; no arithmetic to speak of). The TPU has
// no per-lane load from memory and brute-forces the window with in-tile
// shuffles; a GPU thread simply loads its source pixel. One thread per
// output pixel: indices and output are coalesced, the source loads are
// nearly so because flow is smooth, and the whole source plane (1.9 MB at
// 376 x 1242) stays in L2.
//
// The entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__global__ void window_gather_kernel(const float* __restrict__ src,
                                     const int* __restrict__ v_idx,
                                     const int* __restrict__ u_idx,
                                     float* __restrict__ out, int H, int W,
                                     int rg, int rt) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= W) return;
  const size_t p = static_cast<size_t>(i) * W + j;
  const int v = v_idx[p];
  const int u = u_idx[p];
  float r = CUDART_NAN_F;
  if (v >= 0 && v < H && u >= 0 && u < W && abs((v >> 3) - (i >> 3)) <= rg &&
      abs((u >> 7) - (j >> 7)) <= rt) {
    r = src[static_cast<size_t>(v) * W + u];
  }
  out[p] = r;
}

}  // namespace

extern "C" int window_gather(const float* src, const int* v_idx,
                             const int* u_idx, float* out, int H, int W,
                             int rg, int rt, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + kThreads - 1) / kThreads, H);
  window_gather_kernel<<<grid, kThreads, 0, stream>>>(src, v_idx, u_idx, out,
                                                      H, W, rg, rt);
  return static_cast<int>(cudaGetLastError());
}
