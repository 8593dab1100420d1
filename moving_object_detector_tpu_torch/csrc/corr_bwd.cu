// Backward of the PWC-Net local correlation for Hopper (sm_90a).
//
// Replaces the backward of the JAX package's Pallas kernel
// correlation_pallas, the custom_vjp rule _corr_bwd
// (ops/flow_corr_pallas.py:151), which differentiates the XLA
// shift-and-reduce form. Given the forward
//   out[b, k, y, x] = (1/C) sum_c f1[b, c, y, x] * f2[b, c, y + dy, x + dx]
// (k = (dy + r) * (2r + 1) + (dx + r), dy-major, f2 outside the image zero)
// and the output's gradient g (B, (2r+1)^2, H, W), it writes
//   g1[b, c, y, x] = (1/C) sum_k g[b, k, y, x] * f2[b, c, y + dy, x + dx]
//   g2[b, c, y, x] = (1/C) sum_k g[b, k, y - dy, x - dx]
//                                * f1[b, c, y - dy, x - dx]
// with terms whose pixel falls outside the image zero. All tensors are f32
// NCHW. Both gradients are gathers: each output element is summed by one
// thread in a fixed order, so no float atomics are needed and two runs give
// the same bits.
//
// What bounds it on an H100: bytes, at the training point. Its largest
// level (B = 8, C = 64, 24 x 56 at 192 x 448) moves f1, f2, g1, g2 (2.75 MB
// each) and g (3.5 MB), 0.0043 ms at 3.35 TB/s, against 0.22 GFLOP (0.0033
// ms at 67 TFLOP/s); the smaller levels have 21 to 336 pixels an image and
// sit at the launch floor. The design keeps every input read from device
// memory about once:
// - a block owns TX pixels of one image row (TX = 8, 16 or 32, the
//   narrowest that covers min(W, 32)) and all C channels; a thread owns one
//   pixel and one of G channel slices (channels s, s + G, ...), G =
//   min(256 / TX, C);
// - the (2r+1)^2 values of g that the row's g1 needs (at the pixel itself)
//   and those its g2 needs (at the pixel minus each offset) are staged in
//   shared memory once, before the channel loop: 2 * K * TX floats;
// - each round of the channel loop stages, for G channels, the (2r+1) x
//   (TX + 2r) windows of f1 and f2 around the row (zero outside the image)
//   and then each thread sums its 2 K products from shared memory.
// One launch a call for both gradients, no scratch beyond the outputs.
// A simple kernel first: no cp.async ring, one barrier pair a round.
//
// The entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a search range it was not compiled for or a
// grid the card does not take.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int R>
__global__ void __launch_bounds__(kThreads)
    corr_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                    const float* __restrict__ g, float* __restrict__ g1,
                    float* __restrict__ g2, int C, int H, int W, int TX,
                    int G) {
  constexpr int kS = 2 * R + 1;
  constexpr int kK = kS * kS;
  extern __shared__ float smem[];
  const int win_w = TX + 2 * R;
  const int win = kS * win_w;  // floats of one channel's window
  float* s_g1 = smem;              // [kK][TX]: g[k, y, x]
  float* s_g2 = s_g1 + kK * TX;    // [kK][TX]: g[k, y - dy, x - dx]
  float* s_f1 = s_g2 + kK * TX;    // [G][kS][win_w]
  float* s_f2 = s_f1 + G * win;    // [G][kS][win_w]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // TX * G
  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* __restrict__ gb = g + blockIdx.z * kK * plane;
  const float* __restrict__ f1b = f1 + blockIdx.z * C * plane;
  const float* __restrict__ f2b = f2 + blockIdx.z * C * plane;

  for (int i = tid; i < kK * TX; i += nthreads) {
    const int k = i / TX;
    const int p = i - k * TX;
    const int dy = k / kS - R;
    const int dx = k % kS - R;
    const int x = x0 + p;
    s_g1[i] = x < W ? gb[k * plane + static_cast<size_t>(y) * W + x] : 0.0f;
    const int ys = y - dy;
    const int xs = x - dx;
    const bool in = ys >= 0 && ys < H && xs >= 0 && xs < W && x < W;
    s_g2[i] = in ? gb[k * plane + static_cast<size_t>(ys) * W + xs] : 0.0f;
  }

  const int px = tid % TX;
  const int slice = tid / TX;
  const int x = x0 + px;
  const float fc = static_cast<float>(C);
  for (int c0 = 0; c0 < C; c0 += G) {
    __syncthreads();  // the g stage is written; the last round was read
    for (int i = tid; i < 2 * G * win; i += nthreads) {
      const int which = i / (G * win);  // 0: f1, 1: f2
      const int j = i - which * G * win;
      const int s = j / win;
      const int e = j - s * win;
      const int rr = e / win_w;
      const int cc = e - rr * win_w;
      const int c = c0 + s;
      const int gy = y - R + rr;
      const int gx = x0 - R + cc;
      const bool in = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = which ? f2b : f1b;
      (which ? s_f2 : s_f1)[j] =
          in ? src[c * plane + static_cast<size_t>(gy) * W + gx] : 0.0f;
    }
    __syncthreads();
    const int c = c0 + slice;
    if (c < C && x < W) {
      const float* w1 = s_f1 + slice * win;
      const float* w2 = s_f2 + slice * win;
      float a1 = 0.0f;
      float a2 = 0.0f;
#pragma unroll
      for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
        for (int dx = -R; dx <= R; ++dx) {
          const int k = (dy + R) * kS + (dx + R);
          a1 = fmaf(s_g1[k * TX + px], w2[(R + dy) * win_w + px + R + dx],
                    a1);
          a2 = fmaf(s_g2[k * TX + px], w1[(R - dy) * win_w + px + R - dx],
                    a2);
        }
      }
      const size_t o = c * plane + static_cast<size_t>(y) * W + x;
      g1[blockIdx.z * C * plane + o] = a1 / fc;
      g2[blockIdx.z * C * plane + o] = a2 / fc;
    }
  }
}

template <int R>
int launch(const float* f1, const float* f2, const float* g, float* g1,
           float* g2, int B, int C, int H, int W, cudaStream_t stream) {
  constexpr int kS = 2 * R + 1;
  const int span = W < 32 ? W : 32;
  const int tx = span <= 8 ? 8 : (span <= 16 ? 16 : 32);
  const int groups = kThreads / tx < C ? kThreads / tx : C;
  const size_t floats = 2 * static_cast<size_t>(kS) * kS * tx +
                        2 * static_cast<size_t>(groups) * kS * (tx + 2 * R);
  const size_t smem = floats * sizeof(float);  // at most 42 KB
  dim3 grid((W + tx - 1) / tx, H, B);
  corr_bwd_kernel<R><<<grid, tx * groups, smem, stream>>>(
      f1, f2, g, g1, g2, C, H, W, tx, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int corr_backward(const void* f1, const void* f2, const void* g,
                             void* g1, void* g2, int B, int C, int H, int W,
                             int search_range, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  const float* d = static_cast<const float*>(g);
  float* o1 = static_cast<float*>(g1);
  float* o2 = static_cast<float*>(g2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (search_range) {
    case 1: return launch<1>(a, b, d, o1, o2, B, C, H, W, s);
    case 2: return launch<2>(a, b, d, o1, o2, B, C, H, W, s);
    case 3: return launch<3>(a, b, d, o1, o2, B, C, H, W, s);
    case 4: return launch<4>(a, b, d, o1, o2, B, C, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
