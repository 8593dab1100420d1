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
// What bounds it on an H100: latency, not bytes (labels and points read
// once, cid written once: 20 bytes a pixel, 0.0006 ms at the 192 x 512
// crop). The design is one launch a call:
// - A warp takes one segment of 32 adjacent pixels of a row, or 2 or 4
//   where the card cannot hold a block for every 8 segments at once
//   (the full frame takes 4), and issues the loads of all of them first,
//   beside the roots', so that one memory round trip precedes the work:
//   the labels, and the 96 floats of a segment's points as three
//   coalesced 4-byte loads (a crop's rows start only 4-byte aligned,
//   1,242 x 12 bytes apart, so 16-byte loads do not apply), regrouped
//   through shared memory, a pixel's x, y, z to its lane.
// - A lane looks its label up in a table of the valid roots sorted once
//   per block in shared memory (a branchless binary search over 32 keys:
//   5 probes, not a loop over the slots), and writes cid.
// - A member lane adds its point to the block's accumulator in shared
//   memory, one atomic a value. Folding a warp's members first measured
//   slower on an H100 (NVIDIA H100 80GB HBM3, 700 W; side-by-side builds
//   not kept here): grouping the lanes by slot with __match_any_sync and
//   reducing each group with __reduce_*_sync, full-warp reductions for
//   the segments that lie in one slot, or one pass of them for each slot
//   of a segment.
// - Each block adds its partials into a small accumulator in global memory
//   (one atomic per slot and value it saw) and takes a ticket; the last
//   block reads the accumulator and resets it in one atomicExch a value,
//   decodes it into the outputs, and the ticket wraps to 0 (atomicInc). So
//   the accumulator is all zeros between calls and needs no init launch.
//   It is state: the wrapper keeps one per stream, so that calls on two
//   streams never share it, and calls on one stream run in order.
// That tail is three dependent round trips to L2 (the partials' fence,
// the ticket, the read-back), about as long as the former design's init
// and decode launches: one launch and two fewer allocations, at about the
// same device time (chip_smoke.py: 0.0048 to 0.0050 ms at the crop
// against 0.0052 for the three launches, NVIDIA H100 80GB HBM3, 700 W). A
// single thread-block cluster reducing through distributed shared memory
// has no such tail, but its 16 SMs issue the per-pixel work too slowly:
// it measured slower still.
// Float min and max go through the order-preserving unsigned encoding
// (uenc below), in which 0 lies below every encoded non-NaN value, so 0 is
// the neutral element of every accumulator: the maximum of uenc(v) gives
// the max, the maximum of ~uenc(v) the min. A NaN has no place in that
// order: a NaN coordinate of a member pixel sets a flag bit for its slot
// and axis instead, and the decode writes NaN for that slot's min and max
// on that axis, as the TPU kernel's and the plain version's reductions
// give it.
//
// The entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCap = 32;
constexpr unsigned kFull = 0xffffffffu;
// Accumulator values a slot, kMaxCap apart: 0..2 max of ~uenc (the min of
// x, y, z), 3..5 max of uenc (the max), 6 the count, 7 the NaN bits (bit a:
// axis a). One more word after them: the ticket.
constexpr int kAcc = 8;

__device__ __forceinline__ unsigned uenc(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float udec(unsigned u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// Adds one segment's members to the block's accumulator in shared
// memory.
__device__ __forceinline__ void fold_segment(
    int c, int cap, const float (&pv)[3], float* sp, unsigned* acc,
    int lane) {
  const bool member = c < cap;
  const unsigned members = __ballot_sync(kFull, member);
  if (!members) return;
#pragma unroll
  for (int q = 0; q < 3; ++q) sp[lane + 32 * q] = pv[q];
  __syncwarp();
  const float v[3] = {sp[3 * lane], sp[3 * lane + 1], sp[3 * lane + 2]};
  __syncwarp();  // sp is refilled by the next segment
  unsigned lo[3], hi[3], nanb = 0u;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool ok = member && v[a] == v[a];
    const unsigned u = uenc(v[a]);
    lo[a] = ok ? ~u : 0u;
    hi[a] = ok ? u : 0u;
    nanb |= member && !ok ? 1u << a : 0u;
  }
  if (member) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (lo[a]) atomicMax(&acc[a * kMaxCap + c], lo[a]);
      if (hi[a]) atomicMax(&acc[(3 + a) * kMaxCap + c], hi[a]);
    }
    atomicAdd(&acc[6 * kMaxCap + c], 1u);
    if (nanb) atomicOr(&acc[7 * kMaxCap + c], nanb);
  }
  __syncwarp();
}

// SEGS: segments a warp takes at once, their loads issued together. The
// grid covers the image in rounds of gridDim.x * kWarps * SEGS segments.
template <int SEGS>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const int* __restrict__ labels,
                 const float* __restrict__ points,
                 const int* __restrict__ roots, int* __restrict__ cid,
                 float* __restrict__ mins, float* __restrict__ maxs,
                 int* __restrict__ csize, unsigned* __restrict__ acc, int H,
                 int W, int stride_row, int cap) {
  __shared__ int s_key[kMaxCap];
  __shared__ int s_slot[kMaxCap];
  __shared__ unsigned s_acc[kAcc * kMaxCap];
  __shared__ float s_pts[kWarps][3 * 32];
  __shared__ bool s_last;
  const int n = H * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int segs_row = (W + 31) / 32;
  const int nseg = H * segs_row;

  // A round's segments of 32 pixels of a row for this warp: their labels
  // and the 96 floats of their points (three coalesced loads a segment,
  // whether or not a pixel turns out a member).
  int lab[SEGS], y[SEGS], x0[SEGS], m[SEGS];
  float pv[SEGS][3];
  auto load = [&](int round) {
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      const int g =
          ((round * gridDim.x + blockIdx.x) * kWarps + wid) * SEGS + s;
      y[s] = g / segs_row;
      x0[s] = (g - y[s] * segs_row) * 32;
      m[s] = g < nseg ? min(32, W - x0[s]) : 0;
      lab[s] = lane < m[s] ? labels[static_cast<size_t>(y[s]) * W + x0[s] +
                                    lane]
                           : n;
      const float* row =
          points + static_cast<size_t>(y[s]) * stride_row + 3 * x0[s];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        pv[s][q] = lane + 32 * q < 3 * m[s] ? row[lane + 32 * q] : 0.0f;
      }
    }
  };
  load(0);  // in flight beside the roots

  // The lookup table: the valid roots (< n) sorted ascending, each with its
  // slot; a root that a later slot repeats is left out, so the last slot
  // wins. INT_MAX pads it: no label (< n) reaches it.
  if (tid < 32) {
    const int r = tid < cap ? roots[tid] : INT_MAX;
    bool keep = tid < cap && r < n;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int rj = __shfl_sync(kFull, r, j);
      if (j > tid && j < cap && rj == r) keep = false;
    }
    const int key = keep ? r : INT_MAX;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kj = __shfl_sync(kFull, key, j);
      rank += kj < key || (kj == key && j < tid);
    }
    s_key[rank] = key;
    s_slot[rank] = keep ? tid : cap;
  }
  for (int t = tid; t < kAcc * kMaxCap; t += kThreads) s_acc[t] = 0u;
  __syncthreads();

  const int per_round = gridDim.x * kWarps * SEGS;
  for (int round = 0; round * per_round < nseg; ++round) {
    if (round > 0) load(round);
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      int c = cap;
      if (lab[s] < n) {
        int pos = 0;  // keys below the label, at most 31
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          if (s_key[pos + step - 1] < lab[s]) pos += step;
        }
        if (s_key[pos] == lab[s]) c = s_slot[pos];
      }
      if (lane < m[s]) {
        cid[static_cast<size_t>(y[s]) * W + x0[s] + lane] = c;
      }
      fold_segment(c, cap, pv[s], s_pts[wid], s_acc, lane);
    }
  }
  __syncthreads();

  // This block's partials into the global accumulator: 0 is neutral for
  // all.
  for (int t = tid; t < kAcc * cap; t += kThreads) {
    const int a = t / cap;
    const int i = a * kMaxCap + t - a * cap;
    const unsigned v = s_acc[i];
    if (v == 0u) continue;
    if (a == 6) {
      atomicAdd(&acc[i], v);
    } else if (a == 7) {
      atomicOr(&acc[i], v);
    } else {
      atomicMax(&acc[i], v);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicInc(&acc[kAcc * kMaxCap], gridDim.x - 1) ==
             gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // The last block: read and reset the accumulator, decode.
  __threadfence();
  for (int t = tid; t < kAcc * cap; t += kThreads) {
    const int a = t / cap;
    const int i = a * kMaxCap + t - a * cap;
    s_acc[i] = atomicExch(&acc[i], 0u);
  }
  __syncthreads();
  for (int t = tid; t < 7 * cap; t += kThreads) {
    if (t >= 6 * cap) {
      csize[t - 6 * cap] = static_cast<int>(s_acc[6 * kMaxCap + t - 6 * cap]);
      continue;
    }
    const bool is_min = t < 3 * cap;
    const int i = is_min ? t : t - 3 * cap;  // slot i / 3, axis i % 3
    const int c = i / 3, a = i - 3 * c;
    float val;
    if (s_acc[6 * kMaxCap + c] == 0u) {
      val = is_min ? CUDART_INF_F : -CUDART_INF_F;
    } else if ((s_acc[7 * kMaxCap + c] >> a) & 1u) {
      val = CUDART_NAN_F;
    } else if (is_min) {
      val = udec(~s_acc[a * kMaxCap + c]);
    } else {
      val = udec(s_acc[(3 + a) * kMaxCap + c]);
    }
    (is_min ? mins : maxs)[i] = val;
  }
}

}  // namespace

// acc: kAcc * kMaxCap + 1 words, all zero between calls (the kernel leaves
// them so), owned by one stream. points: (H, W, 3) f32 with pixels 3
// floats apart, rows stride_row floats apart.
extern "C" int cluster_stats(const int* labels, const float* points,
                             const int* roots, int* cid, float* mins,
                             float* maxs, int* csize, unsigned* acc, int H,
                             int W, int stride_row, int cap,
                             cudaStream_t stream) {
  if (H <= 0 || W <= 0 || cap < 1 || cap > kMaxCap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The fewest segments a warp (1, 2 or 4, loaded together) that cover
  // the image in one wave of blocks; beyond that, rounds of 4.
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stats_kernel<4>, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * per_sm;
  }
  const long long nseg = static_cast<long long>(H) * ((W + 31) / 32);
  const long long wave = static_cast<long long>(resident) * kWarps;
  const int segs = nseg <= wave ? 1 : nseg <= 2 * wave ? 2 : 4;
  const long long blocks = std::min<long long>(
      (nseg + kWarps * segs - 1) / (kWarps * segs), resident);
  auto kernel = segs == 1   ? stats_kernel<1>
                : segs == 2 ? stats_kernel<2>
                            : stats_kernel<4>;
  kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      labels, points, roots, cid, mins, maxs, csize, acc, H, W, stride_row,
      cap);
  return static_cast<int>(cudaGetLastError());
}
