// Depth-gated connected components for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel connected_components_pallas
// / _cc_kernel (ops/clustering_pallas.py:233, :50). Pixels p and q share an
// edge iff both are dynamic and inside the image, |z_p - z_q| <= depth_diff
// where a depth that is not finite counts as +inf (as in the plain version
// ops/clustering.py), q - p is a sign-consistent offset (dv * du >= 0) and
// max(|dv|, |du|) <= radius, with radius = clamp(*radius_ptr, 0, stencil).
// Every dynamic pixel gets the smallest flat index of its component, every
// other pixel H*W. That labelling is determined by the partition alone, so
// any algorithm that finds the components gives the TPU kernel's result.
//
// The TPU kernel keeps the whole image in VMEM on one core and iterates
// sweeps and log-step scans to a fixpoint. On 132 SMs that design would be
// a grid-wide barrier per round. This is a block-based union-find
// (after Allegretti, Bolelli and Grana, "Optimized Block-Based Algorithms
// to Label Connected Components on GPUs", IEEE TPDS 2020) on this stencil,
// with the forward half of it (dv >= 0, du >= 0, not both 0; the offset
// set is symmetric, so the half covers every edge):
//   cc_local   one block per kTileH x kTileW tile, a thread a pixel, labels
//              the tile's own graph in shared memory (see the kernel) and
//              writes each pixel the flat index of its local root (H*W for
//              background). Row-major order inside a tile is monotone in
//              the flat index, so a local root, the minimum of its tree, is
//              the smallest flat index of its local component.
//   cc_border  the edges that leave a tile are united in global memory,
//              always hanging the larger root under the smaller with a
//              compare-and-swap on the root, in a retry loop, once per
//              distinct pair of local components (see the kernel);
//   cc_flatten every dynamic pixel takes the root of its tree.
// A parent is always smaller than its child, so a root is the minimum of
// its tree, and when all edges are united the root of a component is its
// smallest flat index. No host loop, no convergence flag, no fetch.
// What bounds it on an H100: latency of dependent loads and atomics and,
// at full frame, the instructions of the edge tests (the bytes, 9 a pixel,
// take under 2 microseconds). Long chains and the contention of large
// components stay in shared memory; global atomics remain for the few
// pairs of local components that meet across a tile border.
//
// Races: a root is re-pointed only by an atomic that lowers it (the
// compare-and-swap in global memory, atomicMin in shared memory) and any
// other pixel only to an ancestor of its own tree (path halving with
// atomicMin, the passes that point a pixel at its root), so a label only
// ever decreases, trees merge and never split, and a stale read costs a
// retry or a round and never a wrong union. Reads in the find loops are
// volatile so that a retry sees other threads' writes.
//
// The entry returns the first cudaGetLastError() that is not success.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileH = 16;  // ops/clustering_cuda.py TILE_H
constexpr int kTileW = 32;  // ops/clustering_cuda.py TILE_W
constexpr int kTile = kTileH * kTileW;  // threads a block, a pixel each
constexpr int kThreads = 256;           // flatten
// The border phase stages (kTileH + stencil) x (kTileW + stencil) pixels,
// 8 bytes each: 24.6 KB at this limit (ops/clustering_cuda.py MAX_STENCIL).
constexpr int kMaxStencil = 32;
// The local phase unites the forward offsets up to this reach (a 32-bit
// mask, bit 5 dv + du); the border phase takes any beyond it.
constexpr int kLocalReach = 4;

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

// The depth an edge test compares, which also says whether the pixel is
// dynamic: NaN if it is not (no test passes), +inf if its depth is not
// finite (the plain version's z), else the depth.
__device__ __forceinline__ float gated_depth(const unsigned char* dyn,
                                             const float* depth, int i, int j,
                                             int dyn_sr, int dyn_sc, int z_sr,
                                             int z_sc) {
  if (!dyn[static_cast<size_t>(i) * dyn_sr + static_cast<size_t>(j) * dyn_sc])
    return CUDART_NAN_F;
  const float z =
      depth[static_cast<size_t>(i) * z_sr + static_cast<size_t>(j) * z_sc];
  return isfinite(z) ? z : CUDART_INF_F;
}

// Local phase. The forward edges inside the tile within kLocalReach are
// tested once into a bit mask (bit 5 dv + du). Each dynamic pixel first
// hangs under its smallest backward neighbour in the tile that shares an
// edge (parent < child, each link an edge: a forest of the local graph,
// built without atomics and shallow, since that neighbour lies up to
// `radius` rows and columns back), and a pass points every pixel at its
// root. Then rounds until no edge joins two trees: for each forward edge
// whose ends have different roots, the larger root is hung under the
// smaller with one atomicMin, and a pass points every pixel at its root
// again. A lost race (two roots offered to one) leaves an edge whose ends
// differ, which the next round sees; at the end each local component is
// one tree whose root, the minimum of the tree, is its smallest index. A
// round has no retry loop, so the lanes of a warp (a tile row) stay
// together; in a solid region the first round finds nothing to hang.
__global__ void __launch_bounds__(kTile)
    cc_local_kernel(const unsigned char* __restrict__ dyn,
                    const float* __restrict__ depth,
                    const float* __restrict__ depth_diff,
                    const int* __restrict__ radius_ptr, int* label, int H,
                    int W, int dyn_sr, int dyn_sc, int z_sr, int z_sc,
                    int stencil) {
  __shared__ int lab[kTile];
  __shared__ float zs[kTile];
  const int t = threadIdx.x;
  const int ty = t / kTileW, tx = t % kTileW;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const int i = i0 + ty, j = j0 + tx;
  const float z = (i < H && j < W)
                      ? gated_depth(dyn, depth, i, j, dyn_sr, dyn_sc, z_sr,
                                    z_sc)
                      : CUDART_NAN_F;
  const bool d = !isnan(z);
  zs[t] = z;
  __syncthreads();
  const float dd = *depth_diff;
  const int reach = min(min(max(*radius_ptr, 0), stencil), kLocalReach);
  unsigned mask = 0;
  int parent = t;
  if (d) {
    const int v_end = min(reach, kTileH - 1 - ty);
    const int u_end = min(reach, kTileW - 1 - tx);
#pragma unroll
    for (int dv = 0; dv <= kLocalReach; ++dv) {
#pragma unroll
      for (int du = 0; du <= kLocalReach; ++du) {
        // Outside the image zs is NaN: no edge.
        if ((dv | du) && dv <= v_end && du <= u_end &&
            fabsf(z - zs[t + dv * kTileW + du]) <= dd)
          mask |= 1u << (dv * 5 + du);
      }
    }
    for (int dv = min(reach, ty); dv >= 0 && parent == t; --dv) {
      for (int du = min(reach, tx); du >= (dv == 0 ? 1 : 0); --du) {
        const int q = t - dv * kTileW - du;
        if (fabsf(z - zs[q]) <= dd) {
          parent = q;
          break;
        }
      }
    }
  }
  lab[t] = parent;
  __syncthreads();
  // Any value read meanwhile is an ancestor: the walk ends at the root.
  if (d) lab[t] = find(lab, t);
  __syncthreads();
  while (true) {
    bool hung = false;
    if (mask) {
      const int r = lab[t];
      for (unsigned m = mask; m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        const int rq = lab[t + (b / 5) * kTileW + b % 5];
        if (rq != r) {
          atomicMin(&lab[max(r, rq)], min(r, rq));
          hung = true;
        }
      }
    }
    if (!__syncthreads_or(hung)) break;
    if (d) lab[t] = find(lab, t);
    __syncthreads();
  }
  if (i < H && j < W) {
    int root = H * W;
    if (d) {
      const int r = lab[t];
      root = (i0 + r / kTileW) * W + j0 + r % kTileW;
    }
    label[i * W + j] = root;
  }
}

// Border phase. The block stages its tile and the `stencil` rows and
// columns below and right of it (gated depths, and the labels the local
// phase wrote: each an ancestor of its pixel, whatever other blocks have
// united since), so the edge tests read shared memory. A pixel within
// `radius` of the tile's bottom or right edge tests the forward offsets
// that leave the tile (and any beyond kLocalReach); an edge becomes the
// pair (its local root, the neighbour's staged label). Most edges of a
// tile repeat a few pairs, so the pairs go into a hash set in shared
// memory (a 64-bit compare-and-swap a pair, no counter) and, after a
// barrier, the thread that owns a slot unites its pair, the finds starting
// from the staged ancestors. A pair that finds no free slot is united at
// once.
constexpr int kSlots = 1024;  // hash set of the border phase, a power of 2
constexpr unsigned long long kEmpty = ~0ull;

__global__ void __launch_bounds__(kTile)
    cc_border_kernel(const unsigned char* __restrict__ dyn,
                     const float* __restrict__ depth,
                     const float* __restrict__ depth_diff,
                     const int* __restrict__ radius_ptr, int* label, int H,
                     int W, int dyn_sr, int dyn_sc, int z_sr, int z_sc,
                     int stencil) {
  __shared__ unsigned long long keys[kSlots];
  extern __shared__ float hz[];
  const int hw = kTileW + stencil;
  const int hn = (kTileH + stencil) * hw;
  int* hl = reinterpret_cast<int*>(hz + hn);
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  for (int k = threadIdx.x; k < hn; k += kTile) {
    const int i = i0 + k / hw, j = j0 + k % hw;
    const bool in = i < H && j < W;
    hz[k] = in ? gated_depth(dyn, depth, i, j, dyn_sr, dyn_sc, z_sr, z_sc)
               : CUDART_NAN_F;
    hl[k] = in ? load(label, i * W + j) : 0;
  }
  for (int k = threadIdx.x; k < kSlots; k += kTile) keys[k] = kEmpty;
  __syncthreads();
  const int t = threadIdx.x;
  const int ty = t / kTileW, tx = t % kTileW;
  const int radius = min(max(*radius_ptr, 0), stencil);
  const int hp = ty * hw + tx;
  const float z = hz[hp];
  // A pixel has an offset the local phase did not take if it lies within
  // `radius` of the tile's bottom or right edge, or if the radius is beyond
  // the local reach; NaN: not dynamic, or outside the image.
  if ((radius > kLocalReach || ty + radius >= kTileH ||
       tx + radius >= kTileW) && !isnan(z)) {
    const float dd = *depth_diff;
    const int lp = hl[hp];
    int last = lp;
    for (int dv = 0; dv <= radius; ++dv) {
      for (int du = (dv == 0 ? 1 : 0); du <= radius; ++du) {
        if (ty + dv < kTileH && tx + du < kTileW &&
            max(dv, du) <= kLocalReach)
          continue;  // united by the local phase
        const int hq = hp + dv * hw + du;
        if (!(fabsf(z - hz[hq]) <= dd)) continue;  // outside: NaN
        const int lq = hl[hq];
        if (lq == last) continue;
        last = lq;
        const unsigned long long key =
            (static_cast<unsigned long long>(lp) << 32) |
            static_cast<unsigned>(lq);
        // One lane of those offering the same pair inserts it: identical
        // keys would serialize on one slot.
        const unsigned same = __match_any_sync(__activemask(), key);
        if ((threadIdx.x & 31) != __ffs(same) - 1) continue;
        unsigned slot = (static_cast<unsigned>(lp) * 0x9E3779B1u) ^
                        (static_cast<unsigned>(lq) * 0x85EBCA77u);
        bool placed = false;
        for (int probe = 0; probe < 8 && !placed; ++probe) {
          slot &= kSlots - 1;
          unsigned long long seen =
              *reinterpret_cast<volatile unsigned long long*>(&keys[slot]);
          if (seen == kEmpty) seen = atomicCAS(&keys[slot], kEmpty, key);
          placed = seen == kEmpty || seen == key;
          ++slot;
        }
        if (!placed) unite(label, lp, lq);
      }
    }
  }
  __syncthreads();
  for (int k = t; k < kSlots; k += kTile) {
    const unsigned long long key = keys[k];
    if (key != kEmpty)
      unite(label, static_cast<int>(key >> 32), static_cast<int>(key));
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
  if (H <= 0 || W <= 0 || stencil < 0 || stencil > kMaxStencil ||
      static_cast<long long>(H) * W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 tiles((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  cc_local_kernel<<<tiles, kTile, 0, stream>>>(dyn, depth, depth_diff,
                                               radius, label, H, W, dyn_sr,
                                               dyn_sc, z_sr, z_sc, stencil);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t halo =
      static_cast<size_t>(kTileH + stencil) * (kTileW + stencil) * 8;
  cc_border_kernel<<<tiles, kTile, halo, stream>>>(
      dyn, depth, depth_diff, radius, label, H, W, dyn_sr, dyn_sc, z_sr,
      z_sc, stencil);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * W;
  cc_flatten_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      label, H, W);
  return static_cast<int>(cudaGetLastError());
}
