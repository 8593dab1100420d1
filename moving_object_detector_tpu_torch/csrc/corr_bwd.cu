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
// NCHW. With i = dy + r, j = dx + r for g1 and i = r - dy, j = r - dx for
// g2, both are one sum over a (2r+1) x (2r+1) window of a feature map,
//   out[c, y, x] = (1/C) sum_{i, j} w[i, j, y, x] * f[c, y + i - r, x + j - r]
// where f is f2 (g1) or f1 (g2) and the weights w do not depend on the
// channel: w[i, j, y, x] = g[k, y, x] for g1 and g[K - 1 - k, y + i - r,
// x + j - r] for g2 (k = i (2r+1) + j, K = (2r+1)^2). Each output element is
// summed by one thread in a fixed order (i, then j), so no float atomics are
// needed and two runs give the same bits.
//
// What bounds it on an H100: at the training point (192 x 448, batch 8,
// r = 4) bytes, 0.0043 ms at 3.35 TB/s for the largest level (8 x 64 x 24 x
// 56: f1, f2, g1, g2 2.75 MB each, g 3.5 MB) against 0.0033 ms of f32
// multiply-adds at 67 TFLOP/s; in practice the latency of the shared-memory
// reads that feed the multiply-adds, and at the small levels the launch.
// The design:
// - a block owns one gradient, TY output rows of TX pixels of one image and
//   a chunk of the channels; blockIdx.x walks (tile, row group, channel
//   chunk, gradient), blockIdx.y the image. TX (balanced tiles of at most
//   32), TY (2, or up to 4 on images of under 8 rows), the channel slots G
//   and the chunk are picked per call from the shape: the most slots whose
//   block fits two an SM, fewer while the grid would have under a block an
//   SM, and chunks until it has about two blocks an SM. The training levels
//   run 384, 288, 256 and 208 blocks, each level in one wave;
// - a thread owns 4 pixels of one output row (one float4) and a channel
//   slot: kCh channels a round, slots G apart. The weights stay in shared
//   memory, staged once a block ([TY][K][TX], zero outside the image, one
//   pointer step a copy); per window row i a thread loads its 2 x 12 window
//   values (three float4s a channel), then for each j one float4 of
//   weights that the slots of a warp share, and does 8 multiply-adds into 8
//   independent sums; its results leave as float4s where W allows;
// - the channels arrive in rounds of G * kCh through a ring of two cp.async
//   stages ((TY + 2r) window rows of TX + 8 columns a channel, 16-byte copies
//   where W is a multiple of 4 and the planes are 16-byte aligned, 4-byte
//   copies otherwise; rows outside the image and channels beyond C are
//   zero-filled by the copy itself). A thread's column and first (channel,
//   row) item are worked out once, before the loop, with no division in it.
//   The copy of round k + 1 overlaps the math of round k; one barrier a
//   round. A channel's window is padded so that the slots of a quarter warp
//   read distinct banks;
// - about 100 registers a thread at r = 4 (__launch_bounds__ for one
//   block: held to 64, the compiler spilled and the kernel ran slower on
//   an H100); shared memory, not registers, sets the blocks an SM (three
//   of 112 threads at the largest level).
// One launch a call for both gradients, no scratch beyond the outputs.
//
// The entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a search range it was not compiled for or a
// grid the card does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 4;            // pixels a thread: one float4 of a row
constexpr int kCh = 2;           // channels a thread a round
constexpr int kHalo = 4;         // window columns each side: >= r, 16 bytes
constexpr int kStages = 2;       // cp.async ring depth
constexpr int kMaxTX = 32;       // widest tile
constexpr int kRows = 2;         // output rows a block,
constexpr int kMaxTY = 4;        // or up to 4 on an image
constexpr int kShortH = 8;       // of fewer rows than this
constexpr int kMaxSlots = 16;    // channel slots a block, at most
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 132;     // a block an SM
constexpr int kTargetBlocks = 264;  // two blocks an SM
constexpr int kSmemTarget = 114688;  // bytes: two blocks an SM (227 KB)

struct Plan {
  int tx, ty, slots, tiles, groups, chunks, rounds, chs;
};

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory: the weights [TY][K][TX], then kStages stages of G * kCh
// channel windows, each (TY + 2R) rows of TX + 2 kHalo floats, padded to
// chs floats.
template <int R, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    corr_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                    const float* __restrict__ g, float* __restrict__ g1,
                    float* __restrict__ g2, int C, int H, int W, Plan pl) {
  constexpr int kS = 2 * R + 1;
  constexpr int kK = kS * kS;
  constexpr int kV = VEC ? 4 : 1;  // floats a copy
  extern __shared__ __align__(16) float smem[];

  const int TX = pl.tx;
  const int TY = pl.ty;
  const int G = pl.slots;
  const int rs = TX + 2 * kHalo;  // floats of a window row
  const int wrows = TY + 2 * R;   // rows of a window
  const int cc = G * kCh;         // channels a round
  const int stage_floats = cc * pl.chs;
  float* s_w = smem;
  float* s_win = smem + TY * kK * TX;

  int bx = blockIdx.x;
  const int tile = bx % pl.tiles;
  bx /= pl.tiles;
  const int grp = bx % pl.groups;
  bx /= pl.groups;
  const int chunk = bx % pl.chunks;
  const int grad = bx / pl.chunks;  // 0: g1 from f2, 1: g2 from f1
  const int x0 = tile * TX;
  const int y0 = grp * TY;
  const int cb0 = chunk * pl.rounds * cc;
  const int cb1 = min(C, cb0 + pl.rounds * cc);
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t b = blockIdx.y;
  const float* __restrict__ gb = g + b * kK * plane;
  const float* __restrict__ fb = (grad ? f1 : f2) + b * C * plane;
  float* __restrict__ ob = (grad ? g2 : g1) + b * C * plane;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // G * (TX / kP) * TY >= TX, >= rs / kV

  // The weights, once: thread (px, r0) copies the kS weights of rows r =
  // r0, r0 + rstep, ... of (output row ty, window row i) at its pixel; k =
  // i kS + j, g1's weight g[k, y, x] and g2's g[K - 1 - k, y + i - R,
  // x + j - R], one pointer step a j.
  {
    const int px = tid % TX;
    const int rstep = nthreads / TX;
    const int x = x0 + px;
    if (tid < rstep * TX) {
      for (int r = tid / TX; r < TY * kS; r += rstep) {
        const int ty = r / kS;
        const int i = r - ty * kS;
        const int y = y0 + ty;
        const int yy = grad ? y + i - R : y;
        const bool row_in = x < W && y < H && yy >= 0 && yy < H;
        const long long lplane = static_cast<long long>(plane);
        const long long first =
            (grad ? kK - 1 - i * kS : i * kS) * lplane +
            static_cast<long long>(row_in ? yy : 0) * W + (grad ? x - R : x);
        const long long step = grad ? 1 - lplane : lplane;
        float* dst = s_w + (ty * kK + i * kS) * TX + px;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const int xx = grad ? x + j - R : x;
          const bool take = row_in && xx >= 0 && xx < W;
          cp_async4(dst + j * TX, take ? gb + (first + j * step) : g, take);
        }
      }
    }
  }

  // This thread's copies: column vector li of every lanes-th (channel, row)
  // item of a round, from item lr on.
  const int vpr = rs / kV;
  const int li = tid % vpr;
  const int lanes = nthreads / vpr;
  const int lr = tid / vpr;
  const int gx = x0 - kHalo + li * kV;
  const bool col_in = gx >= 0 && gx < W;
  const int ch_first = lr / wrows;
  const int row_first = lr - ch_first * wrows;
  const int ch_step = lanes / wrows;
  const int row_step = lanes - ch_step * wrows;
  const int items = cc * wrows;
  const int nrounds = (cb1 - cb0 + cc - 1) / cc;
  auto fetch = [&](int round) {
    if (round < nrounds && lr < lanes) {
      const int c0 = cb0 + round * cc;
      float* dst = s_win + (round % kStages) * stage_floats + li * kV;
      int ch = ch_first;
      int row = row_first;
      for (int q = lr; q < items; q += lanes) {
        const int c = c0 + ch;
        const int gy = y0 - R + row;
        const bool take = col_in && c < C && gy >= 0 && gy < H;
        const float* src =
            take ? fb + c * plane + static_cast<size_t>(gy) * W + gx : fb;
        float* d = dst + ch * pl.chs + row * rs;
        if (VEC) {
          cp_async16(d, src, take);
        } else {
          cp_async4(d, src, take);
        }
        ch += ch_step;
        row += row_step;
        if (row >= wrows) {
          row -= wrows;
          ++ch;
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count in step
  };

  fetch(0);  // one group with the weights

  const int npg = TX / kP;
  const int slot = tid % G;
  const int pg = (tid / G) % npg;
  const int ty = tid / (G * npg);
  const int y = y0 + ty;
  const float fc = static_cast<float>(C);
  const float* wrow = s_w + ty * kK * TX + pg * kP;

  for (int round = 0; round < nrounds; ++round) {
    cp_async_wait_all();  // this thread's copies of this round
    __syncthreads();      // everyone's; and the last round has been read
    fetch(round + 1);     // into the stage the last round held
    const float* st = s_win + (round % kStages) * stage_floats +
                      slot * pl.chs + ty * rs + pg * kP;
    float acc[kCh][kP];
#pragma unroll
    for (int m = 0; m < kCh; ++m) {
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[m][p] = 0.0f;
    }
#pragma unroll 1
    for (int i = 0; i < kS; ++i) {
      float v[kCh][kP + 2 * kHalo];
#pragma unroll
      for (int m = 0; m < kCh; ++m) {
        const float4* src =
            reinterpret_cast<const float4*>(st + m * G * pl.chs + i * rs);
#pragma unroll
        for (int q = 0; q < (kP + 2 * kHalo) / 4; ++q) {
          const float4 a = src[q];
          v[m][4 * q] = a.x;
          v[m][4 * q + 1] = a.y;
          v[m][4 * q + 2] = a.z;
          v[m][4 * q + 3] = a.w;
        }
      }
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(wrow + (i * kS + j) * TX);
        const float w[kP] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int m = 0; m < kCh; ++m) {
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            acc[m][p] = fmaf(w[p], v[m][p + j + kHalo - R], acc[m][p]);
          }
        }
      }
    }
    const int xg = x0 + pg * kP;
    if (y < H) {
#pragma unroll
      for (int m = 0; m < kCh; ++m) {
        const int c = cb0 + round * cc + slot + m * G;
        if (c >= cb1) continue;
        float* o = ob + c * plane + static_cast<size_t>(y) * W + xg;
        if (VEC && xg + kP <= W) {  // one 16-byte store
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[m][0] / fc, acc[m][1] / fc, acc[m][2] / fc,
                          acc[m][3] / fc);
        } else {
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            if (xg + p < W) o[p] = acc[m][p] / fc;
          }
        }
      }
    }
  }
  cp_async_wait_all();  // the last, empty group
}

// Floats of a channel's window: wrows * rs, padded so that its size in
// 16-byte words is odd (8 or more slots: the 8 slots of a quarter warp
// read 8 banks apart) or 8 / G modulo 8 (fewer slots: they and the pixel
// groups beside them do).
int window_floats(int wrows, int rs, int slots) {
  const int want = slots >= 8 ? 1 : 8 / slots % 8;
  int words = wrows * rs / 4;
  while (words % 8 != want) ++words;
  return 4 * words;
}

size_t smem_bytes(int tx, int ty, int slots, int chs, int kk) {
  return sizeof(float) * (static_cast<size_t>(ty) * kk * tx +
                          static_cast<size_t>(kStages) * slots * kCh * chs);
}

// The tile, the row group, the slots and the channel chunk of a call.
Plan plan(int B, int C, int H, int W, int R, int kv) {
  const int kk = (2 * R + 1) * (2 * R + 1);
  Plan p;
  p.tiles = (W + kMaxTX - 1) / kMaxTX;  // balanced tiles of whole groups
  p.tx = ((W + p.tiles - 1) / p.tiles + kP - 1) / kP * kP;
  const int rows = H < kShortH ? kMaxTY : kRows;
  p.groups = (H + rows - 1) / rows;  // balanced row groups
  p.ty = (H + p.groups - 1) / p.groups;
  const int npg = p.tx / kP;
  const int rs = p.tx + 2 * kHalo;
  const int wrows = p.ty + 2 * R;
  const long long per_chunk = 2LL * p.tiles * p.groups * B;
  int slots = kMaxSlots;
  while (slots > 1 &&
         (slots * npg * p.ty > kMaxThreads ||
          smem_bytes(p.tx, p.ty, slots,
                     window_floats(wrows, rs, slots), kk) > kSmemTarget)) {
    slots /= 2;
  }
  while (slots > 1 &&
         per_chunk * ((C + kCh * slots - 1) / (kCh * slots)) < kMinBlocks) {
    slots /= 2;
  }
  // Enough threads for a weight row and a window row of copies.
  const int need = p.tx > rs / kv ? p.tx : rs / kv;
  while (slots * npg * p.ty < need) slots *= 2;
  p.slots = slots;
  const int cc = kCh * slots;
  const int total = (C + cc - 1) / cc;
  const long long want = (kTargetBlocks + per_chunk - 1) / per_chunk;
  const int chunks = want < total ? static_cast<int>(want) : total;
  p.rounds = (total + chunks - 1) / chunks;
  p.chunks = (total + p.rounds - 1) / p.rounds;
  p.chs = window_floats(wrows, rs, slots);
  return p;
}

template <int R, bool VEC>
int launch_as(const float* f1, const float* f2, const float* g, float* g1,
              float* g2, int B, int C, int H, int W, cudaStream_t stream) {
  constexpr int kK = (2 * R + 1) * (2 * R + 1);
  const Plan p = plan(B, C, H, W, R, VEC ? 4 : 1);
  const long long gx = 2LL * p.tiles * p.groups * p.chunks;
  if (gx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(p.tx, p.ty, p.slots, p.chs, kK);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_bwd_kernel<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = p.slots * (p.tx / kP) * p.ty;
  corr_bwd_kernel<R, VEC>
      <<<dim3(static_cast<unsigned>(gx), B), threads, smem, stream>>>(
          f1, f2, g, g1, g2, C, H, W, p);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch(const float* f1, const float* f2, const float* g, float* g1,
           float* g2, int B, int C, int H, int W, cudaStream_t stream) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g2) % 16 == 0;
  return vec ? launch_as<R, true>(f1, f2, g, g1, g2, B, C, H, W, stream)
             : launch_as<R, false>(f1, f2, g, g1, g2, B, C, H, W, stream);
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
