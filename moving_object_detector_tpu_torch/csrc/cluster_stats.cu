// Per-cluster statistics after connected components, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel cluster_stats_pallas /
// _stats_kernel (ops/cluster_stats_pallas.py:66, :33). For cap <= 32
// selected root labels (h*w marks an unused slot):
//   cid[p]   = the slot c with roots[c] == labels[p] and roots[c] < h*w,
//              cap where there is none (the last such slot if roots
//              repeat, as the plain version's passes leave it);
//   mins[c], maxs[c] = AABB corners of the points of the pixels with
//              cid == c (+inf / -inf for an empty slot);
//   csize[c] = their count.
//
// What bounds it on an H100: the bytes it moves (labels and points read
// once, cid written once: 20 bytes a pixel). The TPU kernel holds the whole
// image in VMEM and loops over the slots, one full-image reduction each;
// here one pass over the pixels does all slots at once. A thread looks its
// label up in the roots (shared memory), writes cid, and folds its point
// into per-block partial min / max / count per slot with shared-memory
// atomics; then one global atomic per slot, value and block. Float min and
// max go through the order-preserving int encoding (enc below), so the
// integer atomicMin / atomicMax order them as floats. A NaN has no place in
// that order: a NaN coordinate of a member pixel sets a flag bit for its
// slot and axis instead, and the decode writes NaN for that slot's min and
// max on that axis, as the TPU kernel's and the plain version's reductions
// give it. Three launches in one entry: init of the accumulators, the pass,
// and the decode into the f32 outputs.
//
// The entry returns the first cudaGetLastError() that is not success.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCap = 32;

// Order-preserving float <-> int map (its own inverse).
__device__ __forceinline__ int enc(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// acc layout: [0, 3cap) encoded mins, [3cap, 6cap) encoded maxs,
// [6cap, 7cap) counts, [7cap, 8cap) NaN flags (bit a: axis a saw a NaN).
constexpr int kAccPerSlot = 8;

__device__ __forceinline__ int acc_init(int t, int cap) {
  return t < 3 * cap   ? enc(CUDART_INF_F)
         : t < 6 * cap ? enc(-CUDART_INF_F)
                       : 0;
}

__global__ void stats_init_kernel(int* __restrict__ acc, int cap) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < kAccPerSlot * cap) acc[t] = acc_init(t, cap);
}

__global__ void stats_kernel(const int* __restrict__ labels,
                             const float* __restrict__ points,
                             const int* __restrict__ roots,
                             int* __restrict__ cid, int* __restrict__ acc,
                             int H, int W, int stride_row, int stride_px,
                             int cap) {
  __shared__ int s_roots[kMaxCap];
  __shared__ int s_acc[kAccPerSlot * kMaxCap];
  const int n = H * W;
  const int tid = threadIdx.x;
  if (tid < cap) s_roots[tid] = roots[tid];
  for (int t = tid; t < kAccPerSlot * cap; t += kThreads) {
    s_acc[t] = acc_init(t, cap);
  }
  __syncthreads();

  for (int p = blockIdx.x * kThreads + tid; p < n;
       p += gridDim.x * kThreads) {
    const int lab = labels[p];
    int c = cap;
    if (lab < n) {
      for (int k = 0; k < cap; ++k) {
        if (s_roots[k] == lab) c = k;
      }
    }
    cid[p] = c;
    if (c < cap) {
      const int i = p / W;
      const int j = p - i * W;
      const float* pt = points + static_cast<size_t>(i) * stride_row +
                        static_cast<size_t>(j) * stride_px;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = pt[a];
        if (v == v) {
          const int e = enc(v);
          atomicMin(&s_acc[3 * c + a], e);
          atomicMax(&s_acc[3 * cap + 3 * c + a], e);
        } else {
          atomicOr(&s_acc[7 * cap + c], 1 << a);
        }
      }
      atomicAdd(&s_acc[6 * cap + c], 1);
    }
  }
  __syncthreads();

  // One global atomic per slot and value, only for slots this block saw.
  for (int t = tid; t < 6 * cap; t += kThreads) {
    const int c = (t % (3 * cap)) / 3;
    if (s_acc[6 * cap + c] == 0) continue;
    if (t < 3 * cap) {
      atomicMin(&acc[t], s_acc[t]);
    } else {
      atomicMax(&acc[t], s_acc[t]);
    }
  }
  if (tid < cap && s_acc[6 * cap + tid] != 0) {
    atomicAdd(&acc[6 * cap + tid], s_acc[6 * cap + tid]);
    if (s_acc[7 * cap + tid] != 0) {
      atomicOr(&acc[7 * cap + tid], s_acc[7 * cap + tid]);
    }
  }
}

__global__ void stats_decode_kernel(const int* __restrict__ acc,
                                    float* __restrict__ mins,
                                    float* __restrict__ maxs,
                                    int* __restrict__ csize, int cap) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < 6 * cap) {
    const int i = t % (3 * cap);  // slot i / 3, axis i % 3
    const bool nan = (acc[7 * cap + i / 3] >> (i % 3)) & 1;
    (t < 3 * cap ? mins : maxs)[i] = nan ? CUDART_NAN_F : dec(acc[t]);
  } else if (t < 7 * cap) {
    csize[t - 6 * cap] = acc[t];
  }
}

}  // namespace

extern "C" int cluster_stats(const int* labels, const float* points,
                             const int* roots, int* cid, float* mins,
                             float* maxs, int* csize, int* scratch, int H,
                             int W, int stride_row, int stride_px, int cap,
                             cudaStream_t stream) {
  if (H <= 0 || W <= 0 || cap < 1 || cap > kMaxCap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = H * W;
  const int small = (kAccPerSlot * cap + kThreads - 1) / kThreads;
  stats_init_kernel<<<small, kThreads, 0, stream>>>(scratch, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // At most a few blocks per SM: fewer blocks mean fewer global atomics.
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4 * 132) blocks = 4 * 132;
  stats_kernel<<<blocks, kThreads, 0, stream>>>(
      labels, points, roots, cid, scratch, H, W, stride_row, stride_px, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_decode_kernel<<<small, kThreads, 0, stream>>>(scratch, mins, maxs,
                                                      csize, cap);
  return static_cast<int>(cudaGetLastError());
}
