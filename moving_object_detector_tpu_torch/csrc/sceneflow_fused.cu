// The whole scene-flow construct in one pass, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel scene_flow_fused_pallas /
// _fused_kernel (ops/sceneflow_pallas.py:187, :49). Per pixel (u, v):
//   * back-project the current disparity: z = f t / d, x = (u - cx)/fx z,
//     y = (v - cy)/fy z, NaN where d is invalid or zero;
//   * back-project the previous disparity at the own pixel, move it by
//     T_prev2now and project it: the static flow (NaN for z <= 0);
//   * previous pixel = round(now - flow) (half to even), previous
//     disparity there through the windowed gather (the covered-window
//     predicate of gather.cu), NaN for a miss;
//   * the validity chain, the dynamic test (flow against static flow, or
//     the disparity-rate test) and velocity = (P_now - T P_prev) / dt,
//     zero where static, NaN where the chain fails.
// Inputs: d_now, d_prev (H, W) f32, flow (H, W, 2) f32, params (27,) f32
// in the layout of ops/sceneflow_cuda.py. Outputs: points, velocity
// (H, W, 3) and static flow (H, W, 2), eight values a pixel written once,
// straight into the interleaved layouts the pipeline uses.
//
// What bounds it on an H100: the bytes it moves, 48 a pixel, would allow
// 0.0067 ms at 376 x 1242, but the arithmetic is heavier than it looks:
// 14 IEEE divisions and a square root a pixel (-prec-div, needed for the
// plain version's results) make over 500 instructions a pixel, and
// instruction issue takes longer than the bytes. The TPU kernel works
// on (8, 128) tiles and emulates the gather with in-tile shuffles over the
// whole window; here a thread loads its matched disparities directly
// (d_prev stays in L2). A thread owns four consecutive pixels of the flat
// index: 116,748 threads at 376 x 1242, one wave of the card, in 1,825
// blocks of 64 (13 or 14 an SM; blocks of 256 leave 3 or 4 an SM and
// measured slower on an H100). Its loads are 16 bytes wide (one each of d_now
// and d_prev, two of the flow), its four gathers of d_prev are issued
// together, after the flow they depend on and before any is used. Its
// outputs go through shared memory, so that a warp writes its 128 pixels
// as eight coalesced 512-byte stores: a lane's own 16-byte stores, 48
// bytes apart, measured slower on an H100. The parameters come through the
// read-only path into registers, with no barrier. A pixel's (i, j) comes
// from its flat index, so the covered-window predicate is the one of
// gather.cu. The last, partial warp goes a pixel at a time.
//
// The arithmetic follows the plain version operation by operation (built
// with -fmad=false, IEEE division and square root), so both agree to the
// last bit or within an ulp, and their NaN masks agree exactly.
//
// The entry returns cudaGetLastError() after its launch; the wrapper
// hands it 16-byte aligned inputs.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 64;  // blocks spread evenly over the SMs
constexpr int kPix = 4;  // consecutive pixels (flat index) a thread
constexpr int kWarpPix = 32 * kPix;  // consecutive pixels a warp

struct Point {
  float x, y, z;
};

struct Params {
  float cfx, cfy, ccx, ccy;
  float now_f, now_t, now_min, now_max;
  float prv_f, prv_t, prv_min, prv_max;
  float r[12];  // rows of T_prev2now
  float dt, dyn, rate;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ p) {
  Params q;
  q.cfx = __ldg(p + 0);
  q.cfy = __ldg(p + 1);
  q.ccx = __ldg(p + 2);
  q.ccy = __ldg(p + 3);
  q.now_f = __ldg(p + 4);
  q.now_t = __ldg(p + 5);
  q.now_min = __ldg(p + 6);
  q.now_max = __ldg(p + 7);
  q.prv_f = __ldg(p + 8);
  q.prv_t = __ldg(p + 9);
  q.prv_min = __ldg(p + 10);
  q.prv_max = __ldg(p + 11);
#pragma unroll
  for (int k = 0; k < 12; ++k) q.r[k] = __ldg(p + 12 + k);
  q.dt = __ldg(p + 24);
  q.dyn = __ldg(p + 25);
  q.rate = __ldg(p + 26);
  return q;
}

// xu = (u - cx) / fx and yv = (v - cy) / fy of the pixel, computed once
// for both disparities.
__device__ __forceinline__ Point backproject(float d, float f, float t,
                                             float dmin, float dmax,
                                             float xu, float yv) {
  const bool valid = isfinite(d) && d >= dmin && d <= dmax && d != 0.0f;
  Point p;
  p.z = valid ? f * t / d : CUDART_NAN_F;
  p.x = xu * p.z;
  p.y = yv * p.z;
  return p;
}

__device__ __forceinline__ Point transform(const float* r, Point a) {
  Point q;
  q.x = r[0] * a.x + r[1] * a.y + r[2] * a.z + r[3];
  q.y = r[4] * a.x + r[5] * a.y + r[6] * a.z + r[7];
  q.z = r[8] * a.x + r[9] * a.y + r[10] * a.z + r[11];
  return q;
}

// The backward-flow match of pixel (i, j): the previous pixel (up, vp)
// and whether it lies inside the image and the covered window.
struct Match {
  int up, vp;
  bool hit;
};

__device__ __forceinline__ Match match(float fxv, float fyv, int i, int j,
                                       int H, int W, int rg, int rt) {
  const bool flow_finite = isfinite(fxv) && isfinite(fyv);
  const float sfx = flow_finite ? fxv : 0.0f;
  const float sfy = flow_finite ? fyv : 0.0f;
  Match m;
  m.up = static_cast<int>(rintf(static_cast<float>(j) - sfx));
  m.vp = static_cast<int>(rintf(static_cast<float>(i) - sfy));
  m.hit = m.vp >= 0 && m.vp < H && m.up >= 0 && m.up < W &&
          abs((m.vp >> 3) - (i >> 3)) <= rg &&
          abs((m.up >> 7) - (j >> 7)) <= rt;
  return m;
}

// One pixel's eight outputs: points xyz, velocity xyz, static flow xy,
// from its disparities, its flow, its match and the gathered disparity
// dm there (NaN for a miss).
__device__ __forceinline__ void pixel(const Params& P, float dn, float dpo,
                                      float fxv, float fyv, Match m,
                                      float dm, int i, int j, float* o) {
  const float u = static_cast<float>(j);
  const float v = static_cast<float>(i);

  const float xu = (u - P.ccx) / P.cfx;
  const float yv = (v - P.ccy) / P.cfy;

  // Current cloud, own pixel.
  const Point pn = backproject(dn, P.now_f, P.now_t, P.now_min, P.now_max,
                               xu, yv);
  const bool valid_now = isfinite(pn.x);

  // Static flow: previous disparity at the own pixel, moved and projected.
  const Point po = backproject(dpo, P.prv_f, P.prv_t, P.prv_min, P.prv_max,
                               xu, yv);
  const Point pt = transform(P.r, po);
  const float safe_z = pt.z <= 0.0f ? CUDART_NAN_F : pt.z;
  const float static_x = (P.cfx * pt.x / safe_z + P.ccx) - u;
  const float static_y = (P.cfy * pt.y / safe_z + P.ccy) - v;
  const bool static_ok = isfinite(static_x);

  // Match-chain gates.
  const bool flow_finite = isfinite(fxv) && isfinite(fyv);
  const bool right_now_ok =
      isfinite(dn) && dn >= P.now_min && dn <= P.now_max && dn >= 0.0f;
  const bool right_prev_ok =
      isfinite(dm) && dm >= P.prv_min && dm <= P.prv_max && dm >= 0.0f;
  const bool match_ok = flow_finite && right_now_ok && right_prev_ok;
  const bool prev_point_ok = right_prev_ok && dm != 0.0f;
  const float safe_d = prev_point_ok ? dm : 1.0f;
  Point pp;
  pp.z = P.prv_f * P.prv_t / safe_d;
  pp.x = (static_cast<float>(m.up) - P.ccx) / P.cfx * pp.z;
  pp.y = (static_cast<float>(m.vp) - P.ccy) / P.cfy * pp.z;
  const Point q = transform(P.r, pp);
  const bool have_velocity =
      valid_now && match_ok && prev_point_ok && static_ok;

  const float fdx = fxv - static_x;
  const float fdy = fyv - static_y;
  const float diff_norm = sqrtf(fdx * fdx + fdy * fdy);
  bool is_dynamic = diff_norm >= P.dyn;  // NaN compares false: static
  const float d_pred =
      q.z > 0.0f ? P.now_f * P.now_t / fmaxf(q.z, 1e-6f) : CUDART_NAN_F;
  const float ddot = fabsf(dn - d_pred) / P.dt;
  is_dynamic = is_dynamic || (P.rate > 0.0f && ddot >= P.rate);

  const float nan = CUDART_NAN_F;
  o[0] = pn.x;
  o[1] = pn.y;
  o[2] = pn.z;
  o[3] = have_velocity ? (is_dynamic ? (pn.x - q.x) / P.dt : 0.0f) : nan;
  o[4] = have_velocity ? (is_dynamic ? (pn.y - q.y) / P.dt : 0.0f) : nan;
  o[5] = have_velocity ? (is_dynamic ? (pn.z - q.z) / P.dt : 0.0f) : nan;
  o[6] = static_x;
  o[7] = static_y;
}

__global__ void scene_flow_fused_kernel(
    const float* __restrict__ d_now, const float* __restrict__ d_prev,
    const float* __restrict__ flow, const float* __restrict__ params,
    float* __restrict__ points, float* __restrict__ velocity,
    float* __restrict__ static_flow, int H, int W, int rg, int rt) {
  // A warp's 128 pixels' eight outputs: points, velocity, static flow.
  __shared__ __align__(16) float4 stage[kThreads / 32][8 * kWarpPix / 4];
  const int n = H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = (blockIdx.x * (kThreads / 32) + warp) * kWarpPix;
  if (base >= n) return;
  const Params P = load_params(params);
  const int p0 = base + lane * kPix;
  int i = p0 / W;
  int j = p0 - i * W;

  if (base + kWarpPix > n) {  // the last, partial warp: a pixel at a time
    for (int p = p0; p < n && p < p0 + kPix; ++p) {
      const float fxv = __ldg(flow + 2 * static_cast<size_t>(p));
      const float fyv = __ldg(flow + 2 * static_cast<size_t>(p) + 1);
      const Match m = match(fxv, fyv, i, j, H, W, rg, rt);
      const float dm =
          m.hit ? __ldg(d_prev + static_cast<size_t>(m.vp) * W + m.up)
                : CUDART_NAN_F;
      float o[8];
      pixel(P, __ldg(d_now + p), __ldg(d_prev + p), fxv, fyv, m, dm, i, j,
            o);
      const size_t q = static_cast<size_t>(p);
      points[3 * q] = o[0];
      points[3 * q + 1] = o[1];
      points[3 * q + 2] = o[2];
      velocity[3 * q] = o[3];
      velocity[3 * q + 1] = o[4];
      velocity[3 * q + 2] = o[5];
      static_flow[2 * q] = o[6];
      static_flow[2 * q + 1] = o[7];
      if (++j == W) {
        j = 0;
        ++i;
      }
    }
    return;
  }

  const float4 dn4 = __ldg(reinterpret_cast<const float4*>(d_now + p0));
  const float4 dp4 = __ldg(reinterpret_cast<const float4*>(d_prev + p0));
  const float4* f4 =
      reinterpret_cast<const float4*>(flow + 2 * static_cast<size_t>(p0));
  const float4 f01 = __ldg(f4);
  const float4 f23 = __ldg(f4 + 1);
  const float dn[kPix] = {dn4.x, dn4.y, dn4.z, dn4.w};
  const float dpo[kPix] = {dp4.x, dp4.y, dp4.z, dp4.w};
  const float fx[kPix] = {f01.x, f01.z, f23.x, f23.z};
  const float fy[kPix] = {f01.y, f01.w, f23.y, f23.w};
  int ii[kPix], jj[kPix];
  Match m[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    ii[k] = i;
    jj[k] = j;
    m[k] = match(fx[k], fy[k], i, j, H, W, rg, rt);
    if (++j == W) {
      j = 0;
      ++i;
    }
  }
  float dm[kPix];  // all four gathers in flight before any is used
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    dm[k] = m[k].hit
                ? __ldg(d_prev + static_cast<size_t>(m[k].vp) * W + m[k].up)
                : CUDART_NAN_F;
  }
  float o[kPix][8];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    pixel(P, dn[k], dpo[k], fx[k], fy[k], m[k], dm[k], ii[k], jj[k], o[k]);
  }

  // Through shared memory, so that each of the warp's eight stores writes
  // 512 contiguous bytes (a lane's own 16-byte stores would sit 48 bytes
  // apart, three times the transactions). Writing the stage is free of
  // bank conflicts: eight lanes' 16 bytes at a 48-byte stride hit 32
  // different banks.
  float4* st = stage[warp];
  st[3 * lane] = make_float4(o[0][0], o[0][1], o[0][2], o[1][0]);
  st[3 * lane + 1] = make_float4(o[1][1], o[1][2], o[2][0], o[2][1]);
  st[3 * lane + 2] = make_float4(o[2][2], o[3][0], o[3][1], o[3][2]);
  st[96 + 3 * lane] = make_float4(o[0][3], o[0][4], o[0][5], o[1][3]);
  st[96 + 3 * lane + 1] = make_float4(o[1][4], o[1][5], o[2][3], o[2][4]);
  st[96 + 3 * lane + 2] = make_float4(o[2][5], o[3][3], o[3][4], o[3][5]);
  st[192 + 2 * lane] = make_float4(o[0][6], o[0][7], o[1][6], o[1][7]);
  st[192 + 2 * lane + 1] = make_float4(o[2][6], o[2][7], o[3][6], o[3][7]);
  __syncwarp();
  const size_t b = static_cast<size_t>(base);
  float4* gp = reinterpret_cast<float4*>(points + 3 * b);
  float4* gv = reinterpret_cast<float4*>(velocity + 3 * b);
  float4* gs = reinterpret_cast<float4*>(static_flow + 2 * b);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    gp[32 * r + lane] = st[32 * r + lane];
    gv[32 * r + lane] = st[96 + 32 * r + lane];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) gs[32 * r + lane] = st[192 + 32 * r + lane];
}

}  // namespace

extern "C" int scene_flow_fused(const float* d_now, const float* d_prev,
                                const float* flow, const float* params,
                                float* points, float* velocity,
                                float* static_flow, int H, int W, int rg,
                                int rt, cudaStream_t stream) {
  // Pixel indices are ints: H W and a warp's reach past it must fit.
  if (H <= 0 || W <= 0 ||
      static_cast<long long>(H) * W > INT_MAX - kThreads * kPix) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (H * W + kThreads * kPix - 1) / (kThreads * kPix);
  scene_flow_fused_kernel<<<blocks, kThreads, 0, stream>>>(
      d_now, d_prev, flow, params, points, velocity, static_flow, H, W, rg,
      rt);
  return static_cast<int>(cudaGetLastError());
}
