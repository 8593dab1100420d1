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
// What bounds it on an H100: the bytes it moves, 48 a pixel; about 60
// f32 operations and 10 divisions a pixel are below the f32 rate. The TPU
// kernel works on (8, 128) tiles and emulates the gather with in-tile
// shuffles over the whole window; here one thread owns one pixel and
// loads its matched disparity directly (d_prev stays in L2).
//
// The arithmetic follows the plain version operation by operation (built
// with -fmad=false, IEEE division and square root), so both agree to the
// last bit or within an ulp, and their NaN masks agree exactly.
//
// The entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNPar = 27;

struct Point {
  float x, y, z;
};

__device__ __forceinline__ Point backproject(float d, float f, float t,
                                             float dmin, float dmax,
                                             float uu, float vv, float cx,
                                             float cy, float fx, float fy) {
  const bool valid = isfinite(d) && d >= dmin && d <= dmax && d != 0.0f;
  Point p;
  p.z = valid ? f * t / d : CUDART_NAN_F;
  p.x = (uu - cx) / fx * p.z;
  p.y = (vv - cy) / fy * p.z;
  return p;
}

__device__ __forceinline__ Point transform(const float* r, Point a) {
  Point q;
  q.x = r[0] * a.x + r[1] * a.y + r[2] * a.z + r[3];
  q.y = r[4] * a.x + r[5] * a.y + r[6] * a.z + r[7];
  q.z = r[8] * a.x + r[9] * a.y + r[10] * a.z + r[11];
  return q;
}

__global__ void scene_flow_fused_kernel(
    const float* __restrict__ d_now, const float* __restrict__ d_prev,
    const float* __restrict__ flow, const float* __restrict__ params,
    float* __restrict__ points, float* __restrict__ velocity,
    float* __restrict__ static_flow, int H, int W, int rg, int rt) {
  __shared__ float par[kNPar];
  if (threadIdx.x < kNPar) par[threadIdx.x] = params[threadIdx.x];
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= W) return;
  const size_t pix = static_cast<size_t>(i) * W + j;

  const float cfx = par[0], cfy = par[1], ccx = par[2], ccy = par[3];
  const float now_f = par[4], now_t = par[5];
  const float now_min = par[6], now_max = par[7];
  const float prv_f = par[8], prv_t = par[9];
  const float prv_min = par[10], prv_max = par[11];
  const float* r = par + 12;
  const float dt = par[24], dyn = par[25], rate = par[26];
  const float u = static_cast<float>(j);
  const float v = static_cast<float>(i);

  // Current cloud, own pixel.
  const float dn = d_now[pix];
  const Point pn = backproject(dn, now_f, now_t, now_min, now_max, u, v,
                               ccx, ccy, cfx, cfy);
  const bool valid_now = isfinite(pn.x);

  // Static flow: previous disparity at the own pixel, moved and projected.
  const Point po = backproject(d_prev[pix], prv_f, prv_t, prv_min, prv_max,
                               u, v, ccx, ccy, cfx, cfy);
  const Point pt = transform(r, po);
  const float safe_z = pt.z <= 0.0f ? CUDART_NAN_F : pt.z;
  const float static_x = (cfx * pt.x / safe_z + ccx) - u;
  const float static_y = (cfy * pt.y / safe_z + ccy) - v;
  const bool static_ok = isfinite(static_x);

  // Backward-flow match and the windowed gather of d_prev.
  const float fxv = flow[2 * pix];
  const float fyv = flow[2 * pix + 1];
  const bool flow_finite = isfinite(fxv) && isfinite(fyv);
  const float sfx = flow_finite ? fxv : 0.0f;
  const float sfy = flow_finite ? fyv : 0.0f;
  const int up = static_cast<int>(rintf(u - sfx));
  const int vp = static_cast<int>(rintf(v - sfy));
  float dm = CUDART_NAN_F;
  if (vp >= 0 && vp < H && up >= 0 && up < W &&
      abs((vp >> 3) - (i >> 3)) <= rg && abs((up >> 7) - (j >> 7)) <= rt) {
    dm = d_prev[static_cast<size_t>(vp) * W + up];
  }

  // Match-chain gates.
  const bool right_now_ok =
      isfinite(dn) && dn >= now_min && dn <= now_max && dn >= 0.0f;
  const bool right_prev_ok =
      isfinite(dm) && dm >= prv_min && dm <= prv_max && dm >= 0.0f;
  const bool match_ok = flow_finite && right_now_ok && right_prev_ok;
  const bool prev_point_ok = right_prev_ok && dm != 0.0f;
  const float safe_d = prev_point_ok ? dm : 1.0f;
  Point pp;
  pp.z = prv_f * prv_t / safe_d;
  pp.x = (static_cast<float>(up) - ccx) / cfx * pp.z;
  pp.y = (static_cast<float>(vp) - ccy) / cfy * pp.z;
  const Point q = transform(r, pp);
  const bool have_velocity =
      valid_now && match_ok && prev_point_ok && static_ok;

  const float fdx = fxv - static_x;
  const float fdy = fyv - static_y;
  const float diff_norm = sqrtf(fdx * fdx + fdy * fdy);
  bool is_dynamic = diff_norm >= dyn;  // NaN compares false: static
  const float d_pred =
      q.z > 0.0f ? now_f * now_t / fmaxf(q.z, 1e-6f) : CUDART_NAN_F;
  const float ddot = fabsf(dn - d_pred) / dt;
  is_dynamic = is_dynamic || (rate > 0.0f && ddot >= rate);

  const float nan = CUDART_NAN_F;
  float* po3 = points + 3 * pix;
  po3[0] = pn.x;
  po3[1] = pn.y;
  po3[2] = pn.z;
  float* ve3 = velocity + 3 * pix;
  ve3[0] = have_velocity ? (is_dynamic ? (pn.x - q.x) / dt : 0.0f) : nan;
  ve3[1] = have_velocity ? (is_dynamic ? (pn.y - q.y) / dt : 0.0f) : nan;
  ve3[2] = have_velocity ? (is_dynamic ? (pn.z - q.z) / dt : 0.0f) : nan;
  static_flow[2 * pix] = static_x;
  static_flow[2 * pix + 1] = static_y;
}

}  // namespace

extern "C" int scene_flow_fused(const float* d_now, const float* d_prev,
                                const float* flow, const float* params,
                                float* points, float* velocity,
                                float* static_flow, int H, int W, int rg,
                                int rt, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + kThreads - 1) / kThreads, H);
  scene_flow_fused_kernel<<<grid, kThreads, 0, stream>>>(
      d_now, d_prev, flow, params, points, velocity, static_flow, H, W, rg,
      rt);
  return static_cast<int>(cudaGetLastError());
}
