"""Stereo visual odometry (the JAX package's ``egomotion.py``): Harris
corners with NMS and bucketed top-K selection, correspondences from the
dense flow (or pyramidal LK), RANSAC over batched 3-point Gauss-Newton
hypotheses scored by MSAC, and a two-pass refinement of the best few:
the whole RANSAC is one call of ``ops/gauss_newton_cuda.ransac_solve``,
one kernel launch on the card.

Returns the camera motion M with p_now = M @ p_prev. All math is f32.
Hypotheses are drawn as ``torch.multinomial`` draws them from an
explicit ``torch.Generator``; JAX's ``random.choice`` stream cannot be
reproduced, so ``_ransac_gn_solve`` also takes the sample indices.

On the card the stage replays CUDA graphs (``utils/cuda_graphs.py``), one
a signature: ``_dense_half`` on every pair that has a dense flow, and
``_lk_half`` on the pairs whose fallback flag the host reads as set (or
``_lk_only`` without a dense flow); each RANSAC launches between the
graphs, and both halves draw from one generator a device.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .config import EgoMotionConfig
from .ops import gauss_newton_cuda, geometry
from .types import CameraModel, DisparityImage
from .utils import cuda_graphs, profiling


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Same-padded box-window sum via a summed-area table."""
    pad = size // 2
    xp = F.pad(x, (pad, pad, pad, pad))
    c = torch.cumsum(torch.cumsum(xp, dim=0), dim=1)
    c = F.pad(c, (1, 0, 1, 0))
    h, w = x.shape
    return (c[size: size + h, size: size + w] - c[:h, size: size + w]
            - c[size: size + h, :w] + c[:h, :w])


def harris_response(img: torch.Tensor, window: int = 5, k: float = 0.04):
    """Harris response from central differences, zero at the border."""
    ix = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) * 0.5
    iy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) * 0.5
    ix[:, 0] = 0.0
    ix[:, -1] = 0.0
    iy[0, :] = 0.0
    iy[-1, :] = 0.0
    sxx = _box_sum(ix * ix, window)
    syy = _box_sum(iy * iy, window)
    sxy = _box_sum(ix * iy, window)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep only local maxima within a (2r+1)^2 window."""
    size = 2 * radius + 1
    maxed = F.max_pool2d(scores[None, None], size, stride=1,
                         padding=radius)[0, 0]
    return scores == maxed


def _top_k(values: torch.Tensor, k: int):
    """lax.top_k: the k largest along the last axis, ties by lower index."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_features(img, valid, cfg: EgoMotionConfig, border=None):
    """Bucketed top-K Harris corners with NMS: ((K, 2) f32 (u, v),
    (K,) bool validity)."""
    h, w = img.shape
    scores = harris_response(img)
    keep = _nms(scores, cfg.nms_radius) & valid & (scores > 0)
    if border is None:
        border = cfg.lk_window * (2 ** (cfg.lk_pyramid_levels - 1)) + 2
    u, v = geometry.pixel_grid(h, w, img.device)
    keep = keep & (u >= border) & (u < w - border) & (v >= border) & (
        v < h - border)
    masked = torch.where(keep, scores,
                         torch.full_like(scores, float("-inf")))
    nb = cfg.bucket_h * cfg.bucket_w
    per_bucket = max(1, cfg.max_features // nb)
    ph = (-h) % cfg.bucket_h
    pw = (-w) % cfg.bucket_w
    padded = F.pad(masked, (0, pw, 0, ph), value=float("-inf"))
    hp, wp = padded.shape
    bh, bw = hp // cfg.bucket_h, wp // cfg.bucket_w
    flat_idx = torch.arange(hp * wp, dtype=torch.int64,
                            device=img.device).reshape(hp, wp)
    grouped = padded.reshape(cfg.bucket_h, bh, cfg.bucket_w, bw)
    grouped = grouped.permute(0, 2, 1, 3).reshape(nb, bh * bw)
    gidx = flat_idx.reshape(cfg.bucket_h, bh, cfg.bucket_w, bw)
    gidx = gidx.permute(0, 2, 1, 3).reshape(nb, bh * bw)
    bvals, bpos = _top_k(grouped, per_bucket)
    bidx = gidx.gather(1, bpos)
    cand_vals = bvals.reshape(-1)
    cand_idx = bidx.reshape(-1)
    k = min(cfg.max_features, cand_vals.shape[0])
    vals, pos = _top_k(cand_vals, k)
    idx = cand_idx[pos]
    if k < cfg.max_features:
        pad_n = cfg.max_features - k
        vals = torch.cat([vals, vals.new_full((pad_n,), float("-inf"))])
        idx = torch.cat([idx, idx.new_zeros((pad_n,))])
    fu = (idx % wp).float()
    fv = (idx // wp).float()
    return torch.stack([fu, fv], dim=1), torch.isfinite(vals)


def build_pyramid(img: torch.Tensor, levels: int):
    """Average-pooled image pyramid, finest first."""
    pyr = [img]
    for _ in range(levels - 1):
        cur = pyr[-1]
        h2, w2 = cur.shape[0] // 2 * 2, cur.shape[1] // 2 * 2
        pyr.append(cur[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2)
                   .mean(dim=(1, 3)))
    return pyr


def _lk_patch_track(prev_img, now_img, pts_prev, guess, half: int,
                    iters: int):
    """Single-level LK for K features at once: refine the (K, 2)
    displacement ``guess`` of each (2h+1)^2 patch."""
    dev = prev_img.device
    r = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([dx, dy], dim=-1).reshape(-1, 2)
    coords0 = pts_prev[:, None, :] + offs[None]  # (K, P, 2)
    ex, ey = torch.eye(2, dtype=torch.float32, device=dev)  # no host copy
    template = geometry.bilinear_sample(prev_img, coords0)
    gx = (geometry.bilinear_sample(prev_img, coords0 + ex)
          - geometry.bilinear_sample(prev_img, coords0 - ex)) * 0.5
    gy = (geometry.bilinear_sample(prev_img, coords0 + ey)
          - geometry.bilinear_sample(prev_img, coords0 - ey)) * 0.5
    gxx = (gx * gx).sum(-1)
    gxy = (gx * gy).sum(-1)
    gyy = (gy * gy).sum(-1)
    det = gxx * gyy - gxy * gxy
    inv_ok = det.abs() > 1e-6
    safe_det = torch.where(inv_ok, det, torch.ones_like(det))
    h_inv = torch.stack([torch.stack([gyy, -gxy], -1),
                         torch.stack([-gxy, gxx], -1)], -2) / safe_det[
        :, None, None]
    d = guess
    for _ in range(iters):
        cur = geometry.bilinear_sample(now_img, coords0 + d[:, None, :])
        err = cur - template
        b = torch.stack([(err * gx).sum(-1), (err * gy).sum(-1)], -1)
        d = d - (h_inv @ b[..., None])[..., 0]
    return torch.where(inv_ok[:, None], d, guess)


def lk_track(prev_img, now_img, pts, cfg: EgoMotionConfig):
    """Pyramidal LK of (K, 2) points prev -> now: (tracked, in-bounds)."""
    levels = cfg.lk_pyramid_levels
    pyr_prev = build_pyramid(prev_img, levels)
    pyr_now = build_pyramid(now_img, levels)
    disp = torch.zeros_like(pts)
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0 ** lvl
        disp = _lk_patch_track(pyr_prev[lvl], pyr_now[lvl], pts / scale,
                               disp, cfg.lk_window, cfg.lk_iters)
        disp = disp * (2.0 if lvl > 0 else 1.0)
    tracked = pts + disp
    h, w = prev_img.shape
    ok = ((tracked[:, 0] >= 0) & (tracked[:, 0] <= w - 1)
          & (tracked[:, 1] >= 0) & (tracked[:, 1] <= h - 1))
    return tracked, ok


_chol_solve6 = gauss_newton_cuda.chol_solve6


def _solve_pose(pts3d, obs_uv, weights, cam: CameraModel, iters: int):
    """Gauss-Newton from the identity (``gauss_newton_cuda.solve_pose``:
    one kernel launch on the card); batch = the rows of ``weights``."""
    return gauss_newton_cuda.solve_pose(
        pts3d, obs_uv, weights, gauss_newton_cuda.camera_vector(cam), iters)


def _draw(p, sample: int, generator):
    """``torch.multinomial(p, sample, replacement=False, generator=
    generator)`` without its checks of ``p`` (host reads in some torch
    versions, device asserts and their launches in others; ``p`` is
    floored above 0, so they cannot fail): ATen's draw after them, the
    ``sample`` largest of p / q for q ~ Exp(1), the same indices for the
    same generator state."""
    q = torch.empty_like(p).exponential_(1, generator=generator)
    return torch.topk(p / q, sample).indices


def _ransac_gn_solve(pts3d, tracked, feat_valid, cam, generator,
                     cfg: EgoMotionConfig, sample_idx=None):
    """RANSAC over 3-point Gauss-Newton hypotheses plus the two-pass
    refinement of the ``refine_candidates`` best by MSAC score
    (``gauss_newton_cuda.ransac_solve``: one kernel launch on the card).
    Returns (motion 4x4, success bool, inlier count int32), as 0-d
    tensors.

    ``sample_idx`` (hypotheses, sample) overrides the draw, so a test can
    inject the JAX package's indices."""
    if sample_idx is None:
        # Weighted sampling without replacement over the valid features.
        # The floor keeps the draw defined when fewer than `sample`
        # features are valid (such a frame fails min_inliers anyway).
        p = torch.clamp(feat_valid.float(), min=1e-20)
        sample_idx = _draw(p.expand(cfg.ransac_hypotheses, pts3d.shape[0]),
                           cfg.ransac_sample, generator)
    return gauss_newton_cuda.ransac_solve(
        pts3d, tracked, feat_valid, gauss_newton_cuda.camera_vector(cam),
        sample_idx.to(pts3d.device).long(), cfg)


def _features(prev_left, disparity_prev: DisparityImage, cam: CameraModel,
              cfg: EgoMotionConfig, border):
    """The features of ``prev_left`` with a depth: (K, 2) pixels, (K, 3)
    points, (K,) validity."""
    depth_prev = geometry.disparity_to_depth(disparity_prev)
    pts, feat_valid = select_features(
        prev_left, torch.isfinite(depth_prev), cfg, border=border)
    ui = torch.round(pts[:, 0]).to(torch.int64)
    vi = torch.round(pts[:, 1]).to(torch.int64)
    z, zin = geometry.gather_pixels(depth_prev, ui, vi)
    feat_valid = feat_valid & zin & torch.isfinite(z)
    z = torch.where(torch.isfinite(z), z, torch.ones_like(z))
    x3 = (pts[:, 0] - cam.cx) / cam.fx * z
    y3 = (pts[:, 1] - cam.cy) / cam.fy * z
    return pts, torch.stack([x3, y3, z], dim=1), feat_valid


def _dense_half(cfg: EgoMotionConfig, generator, sample_idx, prev_left,
                disparity_prev, cam, dense_flow):
    """The motion from the dense flow's correspondences: ((motion, success,
    count), the LK fallback's 0-d bool flag, (pixels, points, validity) of
    the features for ``_lk_half``)."""
    pts, pts3d, feat_valid_pre_track = _features(prev_left, disparity_prev,
                                                 cam, cfg, border=2)
    h, w = prev_left.shape
    f = geometry.bilinear_sample(dense_flow, pts)
    tracked = pts + f
    track_ok = (torch.isfinite(f).all(dim=-1)
                & (tracked[:, 0] >= 0) & (tracked[:, 0] <= w - 1)
                & (tracked[:, 1] >= 0) & (tracked[:, 1] <= h - 1))
    feat_valid = feat_valid_pre_track & track_ok
    result = _ransac_gn_solve(pts3d, tracked, feat_valid, cam, generator,
                              cfg, sample_idx)
    n_valid = torch.clamp(feat_valid.sum(), min=1)
    fall_back = result[2] < cfg.lk_fallback_frac * n_valid
    return result, fall_back, (pts, pts3d, feat_valid_pre_track)


def _lk_half(cfg: EgoMotionConfig, generator, sample_idx, prev_left,
             now_left, cam, pts, pts3d, feat_valid):
    """The motion from pyramidal-LK tracks of the features the LK window
    reaches: (motion, success, count)."""
    h, w = prev_left.shape
    reach = cfg.lk_window * (2 ** (cfg.lk_pyramid_levels - 1)) + 2
    in_reach = ((pts[:, 0] >= reach) & (pts[:, 0] < w - reach)
                & (pts[:, 1] >= reach) & (pts[:, 1] < h - reach))
    tracked, ok = lk_track(prev_left, now_left, pts, cfg)
    return _ransac_gn_solve(pts3d, tracked, feat_valid & in_reach & ok, cam,
                            generator, cfg, sample_idx)


def _lk_only(cfg: EgoMotionConfig, generator, sample_idx, prev_left,
             now_left, disparity_prev, cam):
    """The motion from LK tracks alone (features inside the LK window's
    reach, so ``_lk_half``'s mask keeps them all)."""
    feats = _features(prev_left, disparity_prev, cam, cfg, border=None)
    return _lk_half(cfg, generator, sample_idx, prev_left, now_left, cam,
                    *feats)


_dense_cache = cuda_graphs.GraphCache("egomotion")
_lk_cache = cuda_graphs.GraphCache("egomotion_lk")
_generators: dict = {}  # device -> the generator the graphs draw from


def _graph_generator(device) -> torch.Generator:
    g = _generators.get(device)
    if g is None:
        g = _generators[device] = torch.Generator(device=device)
    return g


def estimate_motion(prev_left, now_left, disparity_prev: DisparityImage,
                    cam: CameraModel, generator, cfg=EgoMotionConfig(),
                    dense_flow=None, sample_idx=None):
    """Camera motion M (p_now = M @ p_prev) between two frames: returns
    (motion 4x4 f32, success bool, inlier count int32).

    With ``dense_flow`` (H, W, 2, prev-frame indexed) correspondences are
    one bilinear sample of the field per feature; if the RANSAC then keeps
    fewer than ``lk_fallback_frac`` of the valid features, the motion is
    re-derived from pyramidal-LK tracks (a Python branch on the fetched
    flag: one host sync per frame; counter ``egomotion_lk_fallbacks`` of
    the frame, 0 or 1, while a span recorder is active).

    CUDA inputs that autograd does not track, drawn from a CUDA
    ``generator``, replay the process's CUDA graphs of this signature
    (the device, the images' and the flow's shapes and dtypes, ``cfg``):
    ``_dense_cache``'s of ``_dense_half``, then on a fallback
    ``_lk_cache``'s of ``_lk_half`` (of ``_lk_only`` without a dense flow).
    They draw from the device's own generator, given ``generator``'s state
    before and handing its own back after, so the draws are the eager
    stage's. Other inputs, and an injected ``sample_idx``, run the same
    functions eagerly and count 0 captures and replays."""
    images = [prev_left, now_left, disparity_prev.disparity]
    if dense_flow is not None:
        images.append(dense_flow)
    key, gen, graph_gens = None, generator, ()
    if (sample_idx is None and isinstance(generator, torch.Generator)
            and generator.device.type == prev_left.device.type
            and cuda_graphs.graphable(*images)):
        key = (prev_left.device, cfg) + tuple(
            (tuple(x.shape), x.dtype) for x in images)
        gen = _graph_generator(prev_left.device)
        gen.set_state(generator.get_state())
        graph_gens = (gen,)

    def run(cache, fn, *args):
        return cache(key, functools.partial(fn, cfg, gen, sample_idx), args,
                     generators=graph_gens)

    if dense_flow is None:
        result = run(_lk_cache, _lk_only, prev_left, now_left,
                     disparity_prev, cam)
    else:
        result, fall_back, feats = run(_dense_cache, _dense_half, prev_left,
                                       disparity_prev, cam, dense_flow)
        if cfg.lk_fallback:
            with profiling.sync_point("egomotion_lk_fallback"):
                fall_back = bool(fall_back)
            profiling.count("egomotion_lk_fallbacks", int(fall_back))
            if fall_back:
                result = run(_lk_cache, _lk_half, prev_left, now_left, cam,
                             *feats)
    if key is not None:
        generator.set_state(gen.get_state())
    return result
