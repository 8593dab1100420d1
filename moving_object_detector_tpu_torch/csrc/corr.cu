// PWC-Net local correlation for Hopper (sm_90a), forward only.
//
// Replaces the JAX package's Pallas TPU kernel correlation_pallas /
// _corr_kernel (ops/flow_corr_pallas.py:88, :37):
//   out[b, k, y, x] = (1/C) sum_c f1[b, c, y, x] * f2[b, c, y + dy, x + dx]
// for the (2r+1)^2 offsets k = (dy + r) * (2r + 1) + (dx + r), dy-major,
// with f2 reads outside the image taken as zero. Inputs are f32 NCHW, the
// layout of the port's PWC-Net; the output is (B, (2r+1)^2, H, W) f32.
//
// What bounds it on an H100: the bytes it moves. It reads f1 and f2 once
// and writes 81 planes; the 81 x C multiply-adds per pixel are far below
// the f32 rate. The simple design keeps every re-read of f2 on chip: one
// block per (32-column x 4-row) tile stages, per chunk of 8 channels, the
// f1 tile and the f2 tile with its r-pixel halo in shared memory; each
// thread owns one output pixel and keeps its 81 sums in registers, then
// divides by the real C and writes its 81 outputs.
// Later work: TMA/cp.async double buffering of the channel chunks, bf16
// inputs, and a wgmma formulation of the channel contraction.
//
// Each entry returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for a search range it was not compiled for).

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 4;
constexpr int kCC = 8;

template <int R>
__global__ void corr_kernel(const float* __restrict__ f1,
                            const float* __restrict__ f2,
                            float* __restrict__ out, int C, int H, int W) {
  constexpr int kS = 2 * R + 1;
  constexpr int kK = kS * kS;
  constexpr int kSW = kTX + 2 * R;
  constexpr int kSH = kTY + 2 * R;
  __shared__ float s1[kCC][kTY][kTX];
  __shared__ float s2[kCC][kSH][kSW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* __restrict__ g1 = f1 + blockIdx.z * C * plane;
  const float* __restrict__ g2 = f2 + blockIdx.z * C * plane;

  float acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    for (int i = tid; i < kCC * kTY * kTX; i += kTX * kTY) {
      const int cc = i / (kTY * kTX);
      const int rem = i - cc * (kTY * kTX);
      const int yy = rem / kTX;
      const int xx = rem - yy * kTX;
      const int c = c0 + cc;
      const int gy = y0 + yy;
      const int gx = x0 + xx;
      s1[cc][yy][xx] = (c < C && gy < H && gx < W)
                           ? g1[c * plane + static_cast<size_t>(gy) * W + gx]
                           : 0.0f;
    }
    for (int i = tid; i < kCC * kSH * kSW; i += kTX * kTY) {
      const int cc = i / (kSH * kSW);
      const int rem = i - cc * (kSH * kSW);
      const int yy = rem / kSW;
      const int xx = rem - yy * kSW;
      const int c = c0 + cc;
      const int gy = y0 - R + yy;
      const int gx = x0 - R + xx;
      s2[cc][yy][xx] =
          (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
              ? g2[c * plane + static_cast<size_t>(gy) * W + gx]
              : 0.0f;
    }
    __syncthreads();
    const int cn = min(kCC, C - c0);
    for (int cc = 0; cc < cn; ++cc) {
      const float a = s1[cc][ty][tx];
#pragma unroll
      for (int dy = 0; dy < kS; ++dy) {
#pragma unroll
        for (int dx = 0; dx < kS; ++dx) {
          acc[dy * kS + dx] += a * s2[cc][ty + dy][tx + dx];
        }
      }
    }
    __syncthreads();
  }

  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x < W && y < H) {
    float* __restrict__ o = out + blockIdx.z * kK * plane +
                            static_cast<size_t>(y) * W + x;
    const float fc = static_cast<float>(C);
#pragma unroll
    for (int k = 0; k < kK; ++k) o[k * plane] = acc[k] / fc;
  }
}

template <int R>
int launch(const float* f1, const float* f2, float* out, int B, int C, int H,
           int W, cudaStream_t stream) {
  dim3 block(kTX, kTY);
  dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B);
  corr_kernel<R><<<grid, block, 0, stream>>>(f1, f2, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int corr_forward(const void* f1, const void* f2, void* out, int B,
                            int C, int H, int W, int search_range,
                            void* stream) {
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
