// PWC-Net local correlation for Hopper (sm_90a), forward only.
//
// Replaces the JAX package's Pallas TPU kernel correlation_pallas /
// _corr_kernel (ops/flow_corr_pallas.py:88, :37):
//   out[b, k, y, x] = (1/C) sum_c f1[b, c, y, x] * f2[b, c, y + dy, x + dx]
// for the (2r+1)^2 offsets k = (dy + r) * (2r + 1) + (dx + r), dy-major,
// with f2 reads outside the image taken as zero. Inputs are f32 NCHW, the
// layout of the port's PWC-Net; the output is (B, (2r+1)^2, H, W) f32.
//
// What bounds it on an H100: latency and occupancy, not bytes. The four
// pyramid levels of the serving point hold 30 to 1,920 pixels and 47 KB to
// 983 KB of features, all of it in L2; the bytes would take a fraction of a
// microsecond. A kernel that gives a thread one pixel and lets it walk all C
// channels puts one to eighteen blocks on 132 SMs and chains C dependent
// load-and-accumulate rounds. So the parallelism here comes from the
// offsets and the channels as well as the pixels:
// - a block owns TX pixels of one image row; a thread owns one pixel, one
//   dy row of 2r+1 sums and one of G channel slices (channels g, g + G,
//   ...), so a block has TX * (2r+1) * G threads. TX and G are picked per
//   call from the shape, for about 32 K threads over the grid: narrow
//   tiles and many slices while the image has too few pixels to fill the
//   card (the 3 x 10 level runs 9 blocks of 900 threads, 8 channels a
//   thread), wide tiles and long slices once it has (24 x 80: 120 blocks
//   of 288 threads, 32 channels a thread);
// - the channels arrive in chunks of G * U through a ring of three
//   cp.async stages in shared memory (16-byte copies where W is a multiple
//   of 4 and the planes are 16-byte aligned, 4-byte copies otherwise; f2
//   reads outside the image and channels beyond C are zero-filled by the
//   copy itself). Each thread works out its source and destination offsets
//   once, before the loop: a copy costs a multiply-add of the channel
//   stride, no division. One barrier a chunk;
// - the G partial sums of an output meet in shared memory and are added in
//   slice order by one thread, so the result is the same from run to run:
//   no float atomics.
// One launch a call, no scratch beyond the output.
//
// The entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a search range it was not compiled for or a
// grid the card does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 4;       // f2 columns staged each side: >= r, 16 bytes
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kMaxThreads = 1024;
constexpr int kMinBlocks = 100;            // of 132 SMs
constexpr long long kTargetThreads = 32768;  // about 256 an SM

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool take) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = take ? 4 : 0;  // 0 bytes read: the 4 are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool take) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = take ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory, per stage: G * U channel slabs, each (2R+1) rows of
// TX + 2 kHalo f2 values followed by TX f1 values. After the channel loop
// the same memory holds the partial sums [G][(2R+1)^2][TX].
template <int R, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                float* __restrict__ out, int C, int H, int W, int TX, int G,
                int U) {
  constexpr int kS = 2 * R + 1;
  constexpr int kV = VEC ? 4 : 1;  // floats a copy
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // TX * kS * G
  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int rowf = TX + 2 * kHalo;
  const int slab = kS * rowf + TX;
  const int chunk_channels = G * U;
  const int stage_floats = chunk_channels * slab;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* __restrict__ g1 = f1 + blockIdx.z * C * plane;
  const float* __restrict__ g2 = f2 + blockIdx.z * C * plane;

  // This thread's copy: item `li` of a channel slab, for every `lanes`-th
  // channel of a chunk starting at `lc`.
  const int copies_row = rowf / kV;
  const int copies_f2 = kS * copies_row;
  const int items = copies_f2 + TX / kV;
  const int lanes = nthreads / items;  // >= 1, the launch sees to it
  const int li = tid % items;
  const int lc = tid / items;
  const float* src;
  int s_off;
  bool inside;
  if (li < copies_f2) {
    const int rr = li / copies_row;
    const int v = li - rr * copies_row;
    const int gy = y - R + rr;
    const int gx = x0 - kHalo + v * kV;
    inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    src = g2 + static_cast<ptrdiff_t>(gy) * W + gx;
    s_off = rr * rowf + v * kV;
  } else {
    const int gx = x0 + (li - copies_f2) * kV;
    inside = gx < W;
    src = g1 + static_cast<size_t>(y) * W + gx;
    s_off = kS * rowf + (li - copies_f2) * kV;
  }

  const int nchunks = (C + chunk_channels - 1) / chunk_channels;
  auto fetch = [&](int chunk) {
    if (chunk < nchunks && lc < lanes) {
      const int c0 = chunk * chunk_channels;
      float* dst = smem + (chunk % kStages) * stage_floats + s_off;
      for (int cc = lc; cc < chunk_channels; cc += lanes) {
        const bool take = inside && c0 + cc < C;
        const float* s = take ? src + (c0 + cc) * plane : g1;
        if (VEC) {
          cp_async16(dst + cc * slab, s, take);
        } else {
          cp_async4(dst + cc * slab, s, take);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count in step
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  const int px = tid % TX;
  const int dy = (tid / TX) % kS;
  const int g = tid / (TX * kS);
  float acc[kS];
#pragma unroll
  for (int dx = 0; dx < kS; ++dx) acc[dx] = 0.0f;

  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk k
    __syncthreads();  // everyone's; and chunk k - 1 has been consumed
    fetch(k + kStages - 1);  // into the stage chunk k - 1 held
    const float* st = smem + (k % kStages) * stage_floats;
    for (int u = 0; u < U; ++u) {
      const float* ch = st + (g + u * G) * slab;
      const float a = ch[kS * rowf + px];
      const float* row = ch + dy * rowf + px + (kHalo - R);
#pragma unroll
      for (int dx = 0; dx < kS; ++dx) acc[dx] = fmaf(a, row[dx], acc[dx]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the stages are free: they take the partial sums
  constexpr int kK = kS * kS;
#pragma unroll
  for (int dx = 0; dx < kS; ++dx) {
    smem[(g * kK + dy * kS + dx) * TX + px] = acc[dx];
  }
  __syncthreads();
  const float fc = static_cast<float>(C);
  float* __restrict__ o = out + blockIdx.z * kK * plane +
                          static_cast<size_t>(y) * W + x0;
  for (int i = tid; i < kK * TX; i += nthreads) {
    float s = smem[i];
    for (int gg = 1; gg < G; ++gg) s += smem[gg * kK * TX + i];  // in order
    const int k = i / TX;
    const int p = i - k * TX;
    if (x0 + p < W) o[k * plane + p] = s / fc;
  }
}

template <int R, bool VEC>
int launch_as(const float* f1, const float* f2, float* out, int B, int C,
              int H, int W, cudaStream_t stream) {
  constexpr int kS = 2 * R + 1;
  constexpr int kV = VEC ? 4 : 1;
  // The widest tile that still makes about a block an SM; the narrowest
  // where no width does.
  int tx = 4;
  for (int cand = 32; cand > 4; cand /= 2) {
    const long long blocks =
        static_cast<long long>(H) * B * ((W + cand - 1) / cand);
    if (blocks >= kMinBlocks) {
      tx = cand;
      break;
    }
  }
  // Channel slices: enough for kTargetThreads over the whole grid, at
  // least 8 channels a thread, at most what a block can hold.
  const long long per_slice =
      static_cast<long long>(H) * B * ((W + tx - 1) / tx) * tx * kS;
  const int gmax = kMaxThreads / (tx * kS);
  const int most = (C + 7) / 8;
  long long want = (kTargetThreads + per_slice / 2) / per_slice;
  want = want > most ? most : want;
  int groups = want < 1 ? 1 : (want > gmax ? gmax : static_cast<int>(want));
  // One thread for each copy of a channel slab: at most 392 copies, and
  // gmax slices make more than 700 threads.
  const int items = (kS * (tx + 2 * kHalo) + tx) / kV;
  while (tx * kS * groups < items) ++groups;
  const int unroll = (C + groups - 1) / groups > 8 ? 4 : 2;
  const int slab = kS * (tx + 2 * kHalo) + tx;
  const size_t ring = static_cast<size_t>(kStages) * groups * unroll * slab;
  const size_t sums = static_cast<size_t>(groups) * kS * kS * tx;
  const size_t smem = (ring > sums ? ring : sums) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_kernel<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((W + tx - 1) / tx, H, B);
  corr_kernel<R, VEC><<<grid, tx * kS * groups, smem, stream>>>(
      f1, f2, out, C, H, W, tx, groups, unroll);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch(const float* f1, const float* f2, float* out, int B, int C, int H,
           int W, cudaStream_t stream) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  return vec ? launch_as<R, true>(f1, f2, out, B, C, H, W, stream)
             : launch_as<R, false>(f1, f2, out, B, C, H, W, stream);
}

}  // namespace

extern "C" int corr_forward(const void* f1, const void* f2, void* out, int B,
                            int C, int H, int W, int search_range,
                            void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (search_range) {
    case 1: return launch<1>(a, b, o, B, C, H, W, s);
    case 2: return launch<2>(a, b, o, B, C, H, W, s);
    case 3: return launch<3>(a, b, o, B, C, H, W, s);
    case 4: return launch<4>(a, b, o, B, C, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
