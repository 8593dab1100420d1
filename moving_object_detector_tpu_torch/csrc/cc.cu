// Depth-gated connected components for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel connected_components_pallas
// / _cc_kernel (ops/clustering_pallas.py:233, :50). Pixels p and q share an
// edge iff both are dynamic and inside the image, |z_p - z_q| <= depth_diff
// (a depth that is not finite counts as +inf, so such a pixel has no edge),
// q - p is a sign-consistent offset (dv * du >= 0) and max(|dv|, |du|) <=
// radius, with radius = clamp(*radius_ptr, 0, stencil). Every dynamic pixel
// gets the smallest flat index of its component, every other pixel H*W.
// That labelling is determined by the partition alone, so any algorithm
// that finds the components gives the TPU kernel's result.
//
// The TPU kernel keeps the whole image in VMEM on one core and iterates
// sweeps and log-step scans to a fixpoint. On 132 SMs that design would be
// a grid-wide barrier per round; instead this is a label-equivalence
// union-find in global memory (the int32 label image is 0.39 MB for the
// 192 x 512 crop and 1.87 MB for the frame, so it lives in L2):
//   cc_init   label[p] = p for a dynamic pixel, H*W otherwise;
//   cc_union  one thread per dynamic pixel tests the edge to each offset of
//             the forward half of the stencil (dv >= 0, du >= 0, not both
//             0; the offset set is symmetric, so the half covers every
//             edge) and unites the two roots, always hanging the larger
//             root under the smaller with an atomic compare-and-swap on
//             the root, in a retry loop;
//   cc_flatten every dynamic pixel takes the root of its tree.
// A parent is always smaller than its child, so a root is the minimum of
// its tree, and when all edges are united the root of a component is its
// smallest flat index. No host loop, no convergence flag, no fetch.
// What bounds it on an H100: latency of dependent loads and atomics in L2
// (the bytes, 9 a pixel, take under 2 microseconds).
//
// Races: a root is re-pointed only by the compare-and-swap and any other
// pixel only to an ancestor of its own tree (path halving with atomicMin),
// so label[] only ever decreases, trees merge and never split, and a stale
// read costs a retry and never a wrong union. Reads in the find loops are
// volatile so that a retry sees other SMs' writes.
//
// The entry returns the first cudaGetLastError() that is not success.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int load(const int* label, int x) {
  return *reinterpret_cast<const volatile int*>(label + x);
}

// Root of x, halving the path on the way: label[x] = min(label[x],
// grandparent) keeps every link inside the tree and only shortens it.
__device__ __forceinline__ int find_compress(int* label, int x) {
  int p = load(label, x);
  while (p != x) {
    const int g = load(label, p);
    if (g != p) atomicMin(&label[x], g);
    x = p;
    p = g;
  }
  return x;
}

__device__ __forceinline__ int find(const int* label, int x) {
  int p = load(label, x);
  while (p != x) {
    x = p;
    p = load(label, x);
  }
  return x;
}

__device__ __forceinline__ void unite(int* label, int a, int b) {
  while (true) {
    a = find_compress(label, a);
    b = find_compress(label, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // a > b: hang a under b, but only while a is still a root. A link is
    // written to a root alone, so trees merge and never split; if another
    // thread hung a first, find both roots again.
    if (atomicCAS(&label[a], a, b) == a) return;
  }
}

__global__ void cc_init_kernel(const unsigned char* __restrict__ dyn,
                               int* __restrict__ label, int H, int W,
                               int dyn_sr, int dyn_sc) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= W) return;
  const int p = i * W + j;
  label[p] = dyn[static_cast<size_t>(i) * dyn_sr +
                 static_cast<size_t>(j) * dyn_sc]
                 ? p
                 : H * W;
}

__global__ void cc_union_kernel(const unsigned char* __restrict__ dyn,
                                const float* __restrict__ depth,
                                const float* __restrict__ depth_diff,
                                const int* __restrict__ radius_ptr,
                                int* label, int H, int W, int dyn_sr,
                                int dyn_sc, int z_sr, int z_sc,
                                int stencil) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= W) return;
  if (!dyn[static_cast<size_t>(i) * dyn_sr + static_cast<size_t>(j) * dyn_sc])
    return;
  const float z = depth[static_cast<size_t>(i) * z_sr +
                        static_cast<size_t>(j) * z_sc];
  if (!isfinite(z)) return;  // inf - z' is never <= depth_diff
  const float dd = *depth_diff;
  const int radius = min(max(*radius_ptr, 0), stencil);
  const int p = i * W + j;
  const int v_end = min(i + radius, H - 1);
  const int u_end = min(j + radius, W - 1);
  for (int v = i; v <= v_end; ++v) {
    for (int u = (v == i ? j + 1 : j); u <= u_end; ++u) {
      if (!dyn[static_cast<size_t>(v) * dyn_sr +
               static_cast<size_t>(u) * dyn_sc])
        continue;
      const float zq = depth[static_cast<size_t>(v) * z_sr +
                             static_cast<size_t>(u) * z_sc];
      // A zq that is not finite gives inf or NaN here: no edge.
      if (!(fabsf(z - zq) <= dd)) continue;
      unite(label, p, v * W + u);
    }
  }
}

__global__ void cc_flatten_kernel(int* label, int H, int W) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int n = H * W;
  if (p >= n) return;
  if (load(label, p) >= n) return;
  // Other threads write roots into label[] meanwhile; any value they
  // store is an ancestor in the same tree, so the walk still ends at the
  // root.
  label[p] = find(label, p);
}

}  // namespace

extern "C" int cc_labels(const unsigned char* dyn, const float* depth,
                         const float* depth_diff, const int* radius,
                         int* label, int H, int W, int dyn_sr, int dyn_sc,
                         int z_sr, int z_sc, int stencil,
                         cudaStream_t stream) {
  if (H <= 0 || W <= 0 || stencil < 0 ||
      static_cast<long long>(H) * W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((W + kThreads - 1) / kThreads, H);
  cc_init_kernel<<<grid, kThreads, 0, stream>>>(dyn, label, H, W, dyn_sr,
                                                dyn_sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_union_kernel<<<grid, kThreads, 0, stream>>>(
      dyn, depth, depth_diff, radius, label, H, W, dyn_sr, dyn_sc, z_sr,
      z_sc, stencil);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * W;
  cc_flatten_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      label, H, W);
  return static_cast<int>(cudaGetLastError());
}
