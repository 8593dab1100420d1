"""Smoke test and kernel report of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``moving_object_detector_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints the build seconds.
2. Holds each of the sixteen kernels against its plain PyTorch version on
   the card, at the serving shapes and at an odd shape: the census pair,
   SGM deltas and disparity bitwise (v2, also at the spatial path's
   252 x 1242 stripe; the WTA for every combination of ``subpixel``,
   ``lr_check`` and ``uniqueness_ratio``, also at a width below 128, at
   widths that are and are not a multiple of 4, on a constant pair and on
   random int8 volumes), the v1 census pair, cost volume, aggregated total
   and disparity bitwise, the correlation within 1e-5 for r = 1..4 and
   B = 1, 2 with two runs bit-identical, the correlation's backward
   (``corr_backward``) at the four levels of a train step (192 x 448,
   batch 8), the odd shapes and the plan's switch points of
   ``tests/corr_grad_cases.py`` within 1e-5 of the gradients' scale, on
   inputs 16-byte aligned and 4 bytes off, with two runs bit-identical,
   each training level timed against its bound beside its launch plan,
   its registers a thread read by ``cuobjdump``, the windowed gather equal with
   NaN positions equal, the connected components exactly on six kinds of
   input (three runs each), the cluster stats exactly (min / max by
   value; a NaN member coordinate gives NaN), the fused scene-flow
   construct with exact NaN masks and values within 1e-5 (also on the
   edge cases of ``tests/sceneflow_cases.py``: every residue of W mod 4,
   odd pixel counts, 1 x 1, 1 x 5, 3 x 7, matches on the window's edges,
   NaN and +-inf flow, an unaligned input), ego-motion's Gauss-Newton
   solve on correspondences of a known motion at the RANSAC's two shapes
   (4 x 512 points within 1e-5, 64 x 3 within 1e-4 on the sound triples
   of ``tests/gauss_newton_cases.py``), timed at every block size, and
   the whole RANSAC in one launch (``ransac_gn``) on the RANSAC cases of
   that file (the serving shape with 1, 4 and 16 candidates, an odd 37 x
   50) at every block size: the same success and inlier count, the motion
   within 1e-4, no valid feature and too few inliers failing to the
   identity, two runs bit-identical; its device time a call beside the
   same RANSAC as three Gauss-Newton launches and the torch scoring
   between them, and the registers of its kernels; the kernels'
   branch-free IEEE division and square root bit for bit the card's own
   on 2^26 inputs. Prints each
   kernel's time and its plain version's time (CUDA events, median after
   warm-up), the correlation's per pyramid level and at its smallest
   case (the launch floor). Both SGM DPs are also held at the edge shapes
   of ``tests/dp_cc_cases.py`` for five (P1, P2) pairs, the census pair on
   its edge cases (images smaller than the halo, partial tiles, ties, NaN
   and +-inf, four other windows), the SGM kernels past their old width
   ceilings (the v2 WTA at 8,193, 9,000 and past its shared-memory limit,
   the v1 WTA at 4,097, 19,000 and past its limit, the horizontal DP past
   its limit), the CC on its tile-border cases (contiguous and strided),
   and the CC's device time is printed on the full-frame inputs (blobs,
   one component, serpentine, dense). The v1 aggregation is held on its
   edge cases (lengths around its ring's chunks, lines on both sides of
   its shared-memory limits, P2 on both sides of its byte deltas' limit,
   negative costs) and at the serving shape and the full frame for five
   (P1, P2) pairs; the v1 cost volume and WTA at the full frame and on
   their edge cases (widths 1, below D and around the cost kernel's
   segment, census words with all 32 bits different; ties over d and in
   the right view, minima at d = 0, 1, 126, 127, an offset of +0.5, x <
   best, negative and extreme totals, for every flag combination); the
   cluster stats on their edge cases (cap 1 and 32, repeated roots, no
   slot used, one cluster over the image, signed zeros and NaN members, a
   strided crop), three times in a row, on two streams at once and at the
   full frame, and must be one kernel a call. RAFT's lookup
   (``raft_lookup``) within 1e-4 of its plain version and of the
   published ``grid_sample`` lookup (both of the samples' scale), two runs
   bit-identical, at RAFT's KITTI grid (47 x 156, 4 levels, r = 4, matches
   near and far outside the maps) and at edge shapes (a batch of 2 and 3,
   1 to 4 levels, r = 1 to 4, maps down to 2 x 2), timed at the KITTI grid
   beside its bound and the ``grid_sample`` lookup.
3. Runs ``pipeline.detect_step`` at the KITTI serving point (376 x 1242,
   pwc_v7 weights, flow and SGM at half resolution, two-window clusterer
   crop, default backends: windowed gather, CC and cluster-stats kernels)
   on frames made from ``tests/fixtures/real_textures.npz``: a textured
   background in depth strips and a pasted patch moving 12 px a frame.
   Checks shapes, finiteness, the known strip disparities and the patch's
   flow, and that every kernel of this path launched on it: a frame, the
   census kernel once (both views), each SGM v2 kernel once, the
   correlation four times, the RANSAC kernel once (twice on a frame that
   takes the LK fallback), the Gauss-Newton kernel and the plain census
   never (a replayed flow graph launches its correlations between its
   segments). The flow stage's CUDA graphs must give the eager flow bit
   for bit on two pairs, and the profiler must see four correlation
   kernels a replay (``check_flow_graph``). Prints
   ms/frame, pairs/s and per-stage ms.
4. Runs the same frames with the gather, CC and stats in their plain
   forms and requires identical detections, label images and overflow;
   then with every kernel in its plain form and requires the same
   disparity and nearly the same flow. No kernel may launch in a plain
   run.
5. Runs 4 frames with a second moving patch near the right border, so
   that the clusterer takes its two-window branch (CC and stats launch
   twice a frame), and 6 frames with ``gather_backend="fused"``, which must
   launch the fused kernel once a frame, the gather never, and give the
   default path's detections. Repeats every RANSAC of the serving frames
   on the RANSAC kernel and on its plain version with one draw of
   hypotheses (the same success, the motion within 1e-4), then forces
   the LK fallback on 4 frames (``lk_fallback_frac=1.01``: two RANSAC
   launches a frame, the motion within 1e-4 of the same frames with the
   plain RANSAC). Then the clusterer's other branches:
   the full frame with no crop window configured (detections and label
   images equal to the crop window's), three moving patches spread wider
   than two windows (the full-frame branch under the serving crop) and
   a patch that stops (the quiet early-out after busy frames), both
   identical to the plain gather, CC and stats.
6. Profiles three serving frames with torch.profiler: device busy time
   per frame, kernel launches per frame, ego-motion's host ms, launches
   and device ms a frame alone, the kernels with the most device time.
7. Runs the same 12 frames through ``io.runner.PipelineRunner`` (feeder
   thread, frame ring, pinned upload, harvest a frame behind) with
   ``sgm.backend="pallas_v1"``: each of the four v1 kernels must launch
   every frame (the census once, the aggregation twice), no v2 SGM kernel
   at all, every disparity must equal the v2 path's bitwise and the
   detections the default path's. Prints ms/frame through the runner beside the
   hand-driven loop's, and the runner's report.
8. Runs the CLI in process (``run.main``) on the same frames written to a
   temporary ``.npz``: one JSON line per frame, the moving patch among the
   detections, the export files present; then 6 frames with
   ``--save-state`` and 6 more with ``--resume-state``, which must equal
   the unbroken 12-frame run; ``--crop`` (to 352 x 1216) and ``--source
   kitti`` (PNG pairs in the KITTI raw layout), each equal to the npz run
   of the same pixels. Runs 6 frames with ``association="gnn"`` and
   compares the tracks with the greedy run's.
9. Quality: the held-out-texture sequence of
   ``tests/test_real_sequence.py`` (two objects, a translating and yawing
   camera, 7 frames) through ``eval.evaluate_planar_sequence`` with the
   default weights (pwc_v7, which must be scale-2 gated) at 384 x 896, fx
   600, flow and SGM at scale 2 (the serving setting) and at 192 x 448,
   fx 300, scale 1. Each run must pass every gate of that test (D1 <
   0.04, density > 0.85, rotation < 0.35 deg, translation < 0.13 m, no
   ego failure, at most one phantom and none persistent, the lateral
   object hit in all frames but one, the approaching one in 2 of the
   last 3, median velocity error < 0.85 m/s, median centre error < 0.25
   m, flow EPE < 2.6 / 1.8 and Fl < 0.19 / 0.13), and every default-path
   kernel must launch on every frame (CC and stats from the second frame
   on). Prints one JSON line per run, each metric beside the JAX
   package's recorded quality value, and the serving run's oracle budget:
   the median velocity error with the flow, the disparity, both or
   neither replaced by the renderer's truth. Then the scene matrix of
   ``scripts/validate_scene_matrix.py``: the six ``validation_scenes``
   (lateral, multi_object, occlusion, approach, rotating_cam, sloped_bg)
   at 192 x 448, fx 300, scale 1, ``dynamic_disparity_rate`` 3.0, every
   default-path kernel on every frame, each scene held to that script's
   gates (``tests/scene_gates.py``: no phantom, no ego failure, D1 <
   0.05, each object hit in 0.8 of its scoreable frames (0.5 in
   occlusion), 2 of the last 3 approach frames hit, median velocity
   error < 0.6 m/s, median centre error < 0.3 m; in approach and
   rotating_cam, where the JAX package fails the velocity and the phantom
   gate, the port must fail the same gates and no other), one JSON line a scene
   with the JAX package's recorded velocity error beside the three scenes
   it names; the same at 384 x 896 scale 2, logged and not gated.
10. Dashboard: ``PipelineRunner`` with ``io.dashboard.LiveDashboard`` over
   ``run.py``'s interactive scene at 376 x 1242 (8 frames, not paced):
   the page, ``/status.json`` and every product PNG served; a retune
   POSTed to ``/tunables`` during frame 3's harvest is applied from frame
   5 and shows in ``/tunables.json``; a ``/sim`` command moves the object
   in the rendered frames; the dashboard's update runs with synchronizing
   CUDA calls made errors. Each harvest, profiled alone, must launch no
   kernel with or without the dashboard (it adds copies only); with the
   object moving from the first frame, the runner's detections equal the
   hand-driven loop's and the camera product draws them; prints
   the launches a frame of whole runs with and without it and the
   runner's ``harvest`` and ``dashboard`` stage ms in turns. Then
   ``run.main`` with ``--source interactive --serve-port 0`` in process:
   its JSON lines, and its dashboard closed on return.
11. Streams: ``parallel.streams.detect_step_streams_scan`` over 4 camera
   streams at the serving point, each with its own 12 frames (the
   background rolled, the patch cut and started elsewhere, from a seed).
   Every stream's disparity, flow, label image, detections, motion and
   pose must equal a single-stream ``detect_step`` run of its frames bit
   for bit, and each frame's launches the sum of the single-stream
   runs' (4 x each default-path kernel); ``detect_step_batched`` must
   refuse CUDA tensors. Prints ms per 4-stream step and pairs/s.
12. Spatial: two processes (``torch.multiprocessing``), both on the one
   card, join a gloo world as a (data 1, model 2) mesh and run
   ``parallel.spatial.detect_step_streams_spatial`` on 12 moving-patch
   frames with bench.py's halos (SGM 32, flow 64); the halo and gather
   buffers go through host memory (gloo has no CUDA transport). Both
   ranks' outputs must be equal bit for bit; the gathered disparity bit
   for bit the plain SGM of each rank's 252 x 1242 stripe, and the
   gathered flow the net's on each 316 x 1242 stripe, both cropped and
   stacked in this process; the disparity agree with the unsharded
   full-resolution ``compute_disparity`` within
   ``tests/test_spatial.py``'s thresholds, the flow with the unsharded
   scale-2 flow (median |diff| < 0.25 px from frame 1: pwc_v7's own
   striping error, ``TOL_SPATIAL_FLOW``), the patch be
   detected, and the census, SGM v2 and correlation kernels launch on
   each rank; the flow graphs of the stripe's shape give the eager flow
   bit for bit with four correlation kernels a replay. A rank's failure fails the script.
13. The same step over a world of one NCCL rank (this process; device
   tensors through the all-gather) with no halo, bit for bit the
   unsharded step fed the full-resolution SGM and the scale-2 flow.
14. alg: the 13-channel ICF bank on a 376 x 1242 RGB frame, a kNN store
   of capacity 4096 and 1,000 online-boosting updates on the card,
   against the same calls on the CPU within stated tolerances.
15. Training (``train/*``): pwc_v7 from the bundled weights at
   ``train_flow.py``'s defaults (192 x 448, batch 8, scenes made on the
   card by ``train.data_synth.generate_batch``). One ``train_step`` with
   the correlation kernels against the same step with
   ``corr_backend="xla"`` (loss within 1e-4 and the gradient's norm within
   1e-2, relative; the kernel step launches 4 forward and 4 backward
   correlations, the plain one neither); then the main path, the chunked
   trainer (``make_chunked_train_step``, 2 chunks of 25 steps, ``pool=1``,
   constant lr 1e-4; the second chunk with synchronizing CUDA calls made
   errors): every step launches the 4 + 4 correlation kernels and nothing
   else, and the second chunk's mean loss must be below the first's.
   Prints the median step ms (10 steps synchronized one by one), samples/s,
   kernel launches and device busy share of a profiled step, the peak
   memory allocated. Then ``train_flow.main`` in process for 20 steps from
   pwc_v7 into an ``.npz``, whose weights serve 2 frames through
   ``detect_step`` with finite flow; and pwc_v7 scored on the port's
   seeded scenes as ``tests/test_flow_quality.py`` scores it (4 pairs at
   192 x 448 scale 1 and 384 x 896 scale 2: mean EPE < 4.5 px and < half
   the zero-flow EPE).
16. Prints the card's name and power limit, a ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, before printing any result, without CUDA or without the
package beside it. Uses one card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))  # dp_cc_cases: numpy only

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM non-tensor-core f32 rate
# Scalar operations per SGM DP update (cost: xor, popc, select; recurrence:
# 4 min, 2 add, 1 sub; share of the warp min and neighbour shuffles).
OPS_PER_DP_UPDATE = 12
OPS_PER_WTA_CANDIDATE = 8  # 4 adds, cost, pack, 2 min (left + right view)
OPS_PER_CENSUS_NEIGHBOUR = 2  # compare, or
OPS_PER_COST = 3  # xor, popc, select
FX, BASELINE = 721.5, 0.54

H, W = 376, 1242
N_FRAMES = 12
SHIFT = 12  # patch motion, px per frame
STRIPS = ((0, 300, 24), (300, 640, 14), (640, 950, 30), (950, W, 18))
PATCH_Y, PATCH_H, PATCH_W, PATCH_D = 140, 120, 200, 44
TOL_FLOW_MEAN = 0.05  # px, kernel vs plain correlation through the bf16 net
PATCH2_X, PATCH2_D = 990, 36  # the second patch of the two-window frames
PATCH3_X, PATCH3_D = 40, 40  # the third, left of the first: no two windows
CLI_CROP = (352, 1216)  # --crop's --height / --width
TOL_FULL_FRAME = 1e-4  # m, m/s: the stats' sums over a window or the frame
TOL_CLI = 1e-4  # m, m/s: two CLI runs of the same pixels
CROP_H, CROP_W = 192, 512  # ClustererConfig.cc_crop_h / cc_crop_w
ODD_H, ODD_W = 125, 350
SGM_HALO, FLOW_HALO = 32, 64  # bench.py's --spatial halos
# A rank's full-resolution SGM stripe on the spatial path, two ranks.
SPATIAL_SGM_STRIPE = (H // 2 + 2 * SGM_HALO, W)
PLAIN_CC_ITERS = 1 << 14  # rounds enough for the plain fixpoint to converge
OPS_PER_EDGE_TEST = 6  # 2 loads, subtract, abs, 2 compares (CC)
OPS_PER_FUSED_PIXEL = 100  # about 60 f32 operations and 10 divisions
# Gauss-Newton, per point and iteration: transform 18, projection and
# residual 12, Jacobian 76, J^T W J and J^T W r 108, selects 10; per
# problem and iteration: the 6 x 6 Cholesky and substitutions, the
# exponential and the 4 x 4 product, about 400.
OPS_PER_GN_POINT = 224
OPS_PER_GN_SOLVE = 400
# The RANSAC, per point and hypothesis or candidate: transform 18,
# projection 6, residual and its norm 6, the MSAC term and the inlier test
# 4; per pair of hypotheses ranked, 4.
OPS_PER_GN_RESIDUAL = 34
OPS_PER_RANK = 4
TOL_GN_MOTION = 1e-4  # ego-motion on the GN kernel against the plain solve


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_profile(fn, reps: int = 20):
    """Device ms and kernel launches of one call of ``fn``: the kernels'
    own time from torch.profiler over ``reps`` calls, without the host's
    launch path that ``median_ms`` includes. The profiler may drop a
    record: each kernel name's mean time is counted ceil(records / reps)
    times a call, and a shortfall is logged. A profiler run that comes
    back without a kernel record is repeated, at most twice; after that
    the time is reported as not measured (NaN), since it is an extra
    beside ``ms``."""
    import math

    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name].append(e.device_time / 1e3)
        if by_name:
            ms = launches = 0
            for name, times in by_name.items():
                per_call = math.ceil(len(times) / reps)
                if len(times) != per_call * reps:
                    log(f"device_profile: {per_call * reps - len(times)} of "
                        f"{per_call * reps} records of {name[:60]} dropped")
                ms += statistics.fmean(times) * per_call
                launches += per_call
            return ms, launches
        log(f"device_profile: no kernel record in profiler run {attempt}")
    return float("nan"), 0


def device_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn`` (``device_profile``)."""
    return device_profile(fn, reps)[0]


def timed(kernel, plain) -> dict:
    """The three measured times of a kernel record."""
    return dict(ms=median_ms(kernel), device_ms=device_ms(kernel),
                plain_ms=median_ms(plain, reps=5, warmup=1))


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def make_frames(n_frames=N_FRAMES, second_patch=False, seed=None,
                third_patch=False, stop_at=None):
    """(left, right, x) f32 pairs: strips of known disparity, a moving patch
    at column x; with ``second_patch`` another one near the right border,
    with ``third_patch`` one more near the left border. With a ``seed``
    (one camera stream of several), the background is rolled, the patch
    cut from another place and started at another column, all drawn from
    the seed. With ``stop_at``, every patch stands still from that frame
    on."""
    tex = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "real_textures.npz"))
    bg = np.concatenate([tex["china"][:H], tex["flower"][:H]], axis=1)
    bg = bg[:, :W].astype(np.float32) / 255.0
    src_y, src_x, start = 100, 100, 360
    if seed is not None:
        rng = np.random.default_rng(seed)
        bg = np.roll(bg, int(rng.integers(0, W)), axis=1)
        src_y, src_x = (int(v) for v in rng.integers(0, 300, 2))
        start = int(rng.integers(W // 4, W // 3))
    patch = tex["hopper"][src_y:src_y + PATCH_H,
                          src_x:src_x + PATCH_W].astype(np.float32) / 255.0
    right_bg = np.empty_like(bg)
    for x0, x1, d in STRIPS:
        right_bg[:, x0:x1] = np.roll(bg, -d, axis=1)[:, x0:x1]
    frames = []
    patch2 = tex["hopper"][240:240 + PATCH_H,
                           300:300 + PATCH_W].astype(np.float32) / 255.0
    patch3 = tex["hopper"][0:PATCH_H, 0:PATCH_W].astype(np.float32) / 255.0
    for k in range(n_frames):
        moved = SHIFT * (k if stop_at is None else min(k, stop_at))
        x = start + moved
        left = bg.copy()
        right = right_bg.copy()
        pasted = [(patch, x, PATCH_D)]
        if second_patch:
            pasted.append((patch2, PATCH2_X + moved, PATCH2_D))
        if third_patch:
            pasted.append((patch3, PATCH3_X + moved, PATCH3_D))
        for img, px, pd in pasted:
            left[PATCH_Y:PATCH_Y + PATCH_H, px:px + PATCH_W] = img
            right[PATCH_Y:PATCH_Y + PATCH_H,
                  px - pd:px - pd + PATCH_W] = img
        frames.append((left, right, x))
    return frames


WTA_FLAGS = [(sub, lr, uniq) for sub in (True, False)
             for lr in (True, False) for uniq in (0.0, 0.95)]
# Widths below D = 128, not a multiple of the 4 pixels a warp takes, and
# one that is.
WTA_EDGE_SHAPES = ((20, 37), (9, 351), (9, 350))


def check_wta(sgm, sgm_cuda, vols, cl, cr, what: str) -> None:
    """sgm_wta against its plain version, bitwise, for every flag
    combination."""
    total = sgm.total_from_deltas(*vols, cl, cr)
    for sub, lr, uniq in WTA_FLAGS:
        kw = dict(subpixel=sub, lr_check=lr, lr_max_diff=1.0,
                  uniqueness_ratio=uniq)
        d = sgm_cuda.wta(*vols, cl, cr, **kw)
        ref = sgm.wta_from_total(total, **kw)
        if not torch.equal(d.view(torch.int32), ref.view(torch.int32)):
            bad = int((d.view(torch.int32) != ref.view(torch.int32)).sum())
            raise AssertionError(f"sgm_wta differs on {what} with {kw}: "
                                 f"{bad} pixels")


def check_sgm_kernels(dev, report):
    from moving_object_detector_tpu_torch.ops import sgm, sgm_cuda, sgm_v1_cuda

    rng = np.random.default_rng(0)
    serving = None
    for h, w in ((H // 2, W // 2), (ODD_H, ODD_W),
                 SPATIAL_SGM_STRIPE) + WTA_EDGE_SHAPES:
        left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                            device=dev)
        right = torch.roll(left, -9, 1) + 0.02 * torch.randn(
            h, w, device=dev)
        cl, cr = sgm.census_transform(left), sgm.census_transform(right)
        kl, kr = sgm_v1_cuda.census_pair(left, right)
        if not (torch.equal(kl, cl) and torch.equal(kr, cr)):
            raise AssertionError(f"sgm1_census differs at {h}x{w}")
        vf, vb = sgm_cuda.vertical_deltas(cl, cr, 10, 120)
        hf, hb = sgm_cuda.horizontal_deltas(cl, cr, 10, 120)
        pvf, pvb = sgm.vertical_deltas(cl, cr, 10, 120)
        phf, phb = sgm.horizontal_deltas(cl, cr, 10, 120)
        for name, a, b in (("sgm_vertical", vf, pvf), ("sgm_vertical", vb, pvb),
                           ("sgm_horizontal", hf, phf),
                           ("sgm_horizontal", hb, phb)):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} deltas differ at {h}x{w}")
        check_wta(sgm, sgm_cuda, (hf, hb, vf, vb), cl, cr, f"{h}x{w}")
        log(f"census and sgm v2 kernels bitwise equal to plain at {h}x{w} "
            f"({len(WTA_FLAGS)} WTA flag combinations)")
        if serving is None:
            serving = (h, w, cl, cr, vf, vb, hf, hb)
    # Ties over d everywhere: a constant pair has census 0 and cost 0. And
    # volumes of arbitrary int8 values, negative ones too.
    h, w = WTA_EDGE_SHAPES[0]
    flat = torch.zeros((h, w), dtype=torch.int32, device=dev)
    zeros = [torch.zeros((h, w, sgm_cuda.D), dtype=torch.int8, device=dev)
             for _ in range(4)]
    check_wta(sgm, sgm_cuda, zeros, flat, flat, "a constant pair")
    noise = [torch.randint(-128, 128, (ODD_H, ODD_W, sgm_cuda.D),
                           dtype=torch.int8, device=dev) for _ in range(4)]
    cn = torch.randint(0, 1 << 24, (2, ODD_H, ODD_W), dtype=torch.int32,
                       device=dev)
    check_wta(sgm, sgm_cuda, noise, cn[0], cn[1], "random int8 volumes")
    log("sgm_wta bitwise equal to plain on a constant pair (ties over d) "
        "and on random int8 volumes")
    check_dp_edges(dev, sgm, sgm_cuda)
    check_wide_rows(dev)

    h, w, cl, cr, vf, vb, hf, hb = serving
    n = h * w
    updates = 2 * n * sgm_cuda.D
    dp_bytes = 2 * n * 4 + 2 * n * sgm_cuda.D
    timings = {
        "sgm_vertical": (
            lambda: sgm_cuda.vertical_deltas(cl, cr, 10, 120),
            lambda: sgm.vertical_deltas(cl, cr, 10, 120),
            bound_ms(dp_bytes, updates * OPS_PER_DP_UPDATE),
            "ops/sgm_pallas2.py:265 vertical_deltas (_v_kernel :234)"),
        "sgm_horizontal": (
            lambda: sgm_cuda.horizontal_deltas(cl, cr, 10, 120),
            lambda: sgm.horizontal_deltas(cl, cr, 10, 120),
            bound_ms(dp_bytes, updates * OPS_PER_DP_UPDATE),
            "ops/sgm_pallas2.py:159 horizontal_deltas (_h_kernel :117)"),
        "sgm_wta": (
            lambda: sgm_cuda.wta(hf, hb, vf, vb, cl, cr),
            lambda: sgm.wta_from_total(
                sgm.total_from_deltas(hf, hb, vf, vb, cl, cr)),
            bound_ms(4 * n * sgm_cuda.D + 2 * n * 4 + n * 4,
                     2 * n * sgm_cuda.D * OPS_PER_WTA_CANDIDATE),
            "ops/sgm_pallas2.py:403 wta_from_parts (_wta_kernel :302)"),
    }
    for name, (kern, plain, (bms, by), replaces) in timings.items():
        report[name] = dict(
            name=name, route="cuda",
            source="moving_object_detector_tpu_torch/csrc/sgm_v2.cu",
            replaces=replaces, max_abs_err=0.0, **timed(kern, plain),
            bound_ms=bms, bound_by=by, library_ms=None)
    time_vertical_strips(dev, sgm, sgm_cuda, cl, cr)


def time_vertical_strips(dev, sgm, sgm_cuda, cl, cr) -> None:
    """The vertical DP's device ms at the serving shape with strips of 4,
    8 and 16 columns a block and the card's own (``sgm_cuda.v_strip``),
    each first held bitwise against the plain version, in two rounds of
    opposite order."""
    w = cl.shape[1]
    card = sgm_cuda.v_strip(
        w, torch.cuda.get_device_properties(dev).multi_processor_count)
    strips = sorted({4, 8, 16, card})
    runs = {s: (lambda s=s: sgm_cuda._dp("sgm_vertical", cl, cr, 10, 120,
                                         strip=s)) for s in strips}
    ref = sgm.vertical_deltas(cl, cr, 10, 120)
    for s, run in runs.items():
        if not all(torch.equal(a, b) for a, b in zip(run(), ref)):
            raise AssertionError(f"sgm_vertical differs with strip {s}")
    times = {s: [] for s in strips}
    for order in (strips, strips[::-1]):
        for s in order:
            times[s].append(device_ms(runs[s]))
    log(f"sgm_vertical device ms by strip (card strip {card}), two rounds: "
        + json.dumps(times))


# (p1, p2): the serving pair, P1 = P2 = 0, P2 = 127 (the int8 limit),
# P1 > P2, P1 above the 160 at which the vertical DP clamps it.
DP_PENALTIES = ((10, 120), (0, 0), (10, 127), (40, 7), (500, 127))


def check_dp_edges(dev, sgm, sgm_cuda) -> None:
    """sgm_horizontal and sgm_vertical against their plain versions,
    bitwise, at the serving and odd shapes and the edge shapes of
    tests/dp_cc_cases.py (widths below D, not a multiple of 32, 4 or the
    vertical strip; heights at and around the vertical row block), for
    each penalty pair."""
    from dp_cc_cases import DP_CASES, VDP_CASES

    shapes = [(H // 2, W // 2), (ODD_H, ODD_W)]
    shapes += sorted({(h, w) for h, w, _, _ in DP_CASES + VDP_CASES})
    rng = np.random.default_rng(6)
    for h, w in shapes:
        left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                            device=dev)
        right = torch.roll(left, -9, 1) + 0.02 * torch.randn(
            h, w, device=dev)
        cl, cr = sgm.census_transform(left), sgm.census_transform(right)
        for p1, p2 in DP_PENALTIES:
            for name in ("horizontal", "vertical"):
                out = getattr(sgm_cuda, f"{name}_deltas")(cl, cr, p1, p2)
                ref = getattr(sgm, f"{name}_deltas")(cl, cr, p1, p2)
                if not (torch.equal(out[0], ref[0])
                        and torch.equal(out[1], ref[1])):
                    raise AssertionError(f"sgm_{name} differs at {h}x{w} "
                                         f"p1={p1} p2={p2}")
    log(f"sgm_horizontal and sgm_vertical bitwise equal to plain at "
        f"{shapes} for (p1, p2) in {list(DP_PENALTIES)}")


def check_wide_rows(dev) -> None:
    """The SGM kernels past their old width ceilings, against the plain
    versions: the v2 WTA at 8,193, 9,000 and its widest staged row
    (shared memory, opted in) and past its shared-memory limit (global
    memory), the v1 WTA at 4,097, 19,000, its widest staged row and past
    its limit, the horizontal DP past its limit (on the slices whose
    deltas depend on the slice alone)."""
    from moving_object_detector_tpu_torch.ops import sgm, sgm_cuda, \
        sgm_v1_cuda

    g = torch.Generator(device=dev).manual_seed(7)
    wta_widths = (8193, 9000, sgm_cuda.WTA_SMEM_WIDTH,
                  sgm_cuda.WTA_SMEM_WIDTH + 1)
    v1_widths = (4097, 19000, sgm_v1_cuda.WTA_SMEM_WIDTH,
                 sgm_v1_cuda.WTA_SMEM_WIDTH + 1)
    for w in wta_widths:
        vols = [torch.randint(-128, 128, (2, w, sgm_cuda.D), device=dev,
                              generator=g, dtype=torch.int8)
                for _ in range(4)]
        cl, cr = torch.randint(0, 1 << 24, (2, 2, w), device=dev,
                               generator=g, dtype=torch.int32)
        check_wta(sgm, sgm_cuda, vols, cl, cr, f"2x{w} random int8")
    for w in v1_widths:
        total = torch.randint(0, 600, (2, w, sgm_v1_cuda.D), device=dev,
                              generator=g, dtype=torch.int16)
        check_v1_wta(sgm, sgm_v1_cuda, total, f"2x{w}")
    w = sgm_cuda.DP_SMEM_WIDTH + 1
    cl, cr = torch.randint(0, 1 << 24, (2, 2, w), device=dev, generator=g,
                           dtype=torch.int32)
    hf, hb = sgm_cuda.horizontal_deltas(cl, cr, 10, 120)
    pf, _ = sgm.horizontal_deltas(cl[:, :300], cr[:, :300], 10, 120)
    _, pb = sgm.horizontal_deltas(cl[:, -300:], cr[:, -300:], 10, 120)
    if not (torch.equal(hf[:, :300], pf) and torch.equal(hb[:, -173:],
                                                          pb[:, 127:])):
        raise AssertionError(f"sgm_horizontal differs at width {w}")
    log(f"wide rows bitwise equal to plain: sgm_wta at {wta_widths} "
        f"({len(WTA_FLAGS)} flag combinations), sgm1_wta at {v1_widths}, "
        f"sgm_horizontal at {w} (slices)")


def check_sgm_v1_kernels(dev, report):
    """The four v1 kernels against their plain versions, bitwise."""
    from moving_object_detector_tpu_torch.ops import sgm, sgm_v1_cuda

    rng = np.random.default_rng(5)
    d = sgm_v1_cuda.D
    serving = None
    for h, w in ((H // 2, W // 2), (ODD_H, ODD_W)):
        left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                            device=dev)
        right = torch.roll(left, -9, 1) + 0.02 * torch.randn(
            h, w, device=dev)
        cl, cr = sgm_v1_cuda.census_pair(left, right)
        if not (torch.equal(cl, sgm.census_transform(left))
                and torch.equal(cr, sgm.census_transform(right))):
            raise AssertionError(f"sgm1_census differs at {h}x{w}")
        cost = sgm_v1_cuda.cost_volume(cl, cr)
        if not (cost.dtype == torch.int8 and torch.equal(
                cost.to(torch.int32), sgm.hamming_cost(cl, cr, d))):
            raise AssertionError(f"sgm1_cost differs at {h}x{w}")
        total = sgm_v1_cuda.aggregate(cost, 10, 120)
        if not torch.equal(total, sgm.aggregate_cost_volume(cost, 10, 120)):
            raise AssertionError(f"sgm1_aggregate differs at {h}x{w}")
        check_v1_wta(sgm, sgm_v1_cuda, total, f"{h}x{w}")
        n_valid = int((sgm_v1_cuda.wta(total) >= 0).sum())
        if not 0.5 * h * w < n_valid < h * w:
            raise AssertionError(f"sgm v1 check is vacuous: {n_valid} valid")
        log(f"sgm v1 kernels bitwise equal to plain at {h}x{w} "
            f"({n_valid} of {h * w} pixels valid)")
        if serving is None:
            serving = (h, w, left, right, cl, cr, cost, total)
    check_census_cases(dev, sgm, sgm_v1_cuda)
    check_aggregate_cases(dev, sgm, sgm_v1_cuda)
    check_cost_wta_cases(dev, sgm, sgm_v1_cuda)

    h, w, left, right, cl, cr, cost, total = serving
    n = h * w
    scratch = torch.empty_like(total)
    for vertical in (False, True):  # each launch alone
        one = lambda: sgm_v1_cuda._aggregate_pass(
            cost, scratch, 10, 120, vertical=vertical)
        log(f"sgm1_aggregate launch along the "
            f"{'columns' if vertical else 'rows'} alone at {h}x{w}: "
            f"{median_ms(one):.4f} ms, on the device {device_ms(one):.4f} ms")
    full = torch.randint(0, 33, (2 * h, 2 * w, d), dtype=torch.int8,
                         device=dev)
    one = lambda: sgm_v1_cuda.aggregate(full, 10, 120)
    log(f"sgm1_aggregate at {2 * h}x{2 * w} (column strip "
        f"{sgm_v1_cuda.agg_plan(2 * h, 2 * w, 120, sms(dev))[1]}): "
        f"{median_ms(one):.4f} ms, on the device {device_ms(one):.4f} ms")
    timings = {
        "sgm1_census": (  # both views of the pair, one launch
            lambda: sgm_v1_cuda.census_pair(left, right),
            lambda: (sgm.census_transform(left),
                     sgm.census_transform(right)),
            bound_ms(2 * 2 * n * 4, 2 * n * 24 * OPS_PER_CENSUS_NEIGHBOUR),
            "ops/sgm_pallas.py:260 in census_cost_volume_pallas :226 "
            "(_census_kernel :161)"),
        "sgm1_cost": (
            lambda: sgm_v1_cuda.cost_volume(cl, cr),
            lambda: sgm.hamming_cost(cl, cr, d),
            bound_ms(2 * n * 4 + n * d, n * d * OPS_PER_COST),
            "ops/sgm_pallas.py:271 in census_cost_volume_pallas :226 "
            "(_cost_kernel :198)"),
        "sgm1_aggregate": (  # both launches: along the rows, the columns
            lambda: sgm_v1_cuda.aggregate(cost, 10, 120),
            lambda: sgm.aggregate_cost_volume(cost, 10, 120),
            bound_ms(n * d + n * d * 2, 4 * n * d * OPS_PER_DP_UPDATE),
            "ops/sgm_pallas.py:121 in _dual_scan :111, via "
            "aggregate_cost_volume_pallas :306 (_dual_scan_kernel :72)"),
        "sgm1_wta": (
            lambda: sgm_v1_cuda.wta(total),
            lambda: sgm.wta_from_total(total),
            bound_ms(n * d * 2 + n * 4, n * d * OPS_PER_WTA_CANDIDATE),
            "ops/sgm_pallas.py:462 in wta_disparity_pallas :432 "
            "(_wta_kernel :351)"),
    }
    for name, (kern, plain, (bms, by), replaces) in timings.items():
        report[name] = dict(
            name=name, route="cuda",
            source="moving_object_detector_tpu_torch/csrc/sgm_v1.cu",
            replaces=replaces, max_abs_err=0.0, **timed(kern, plain),
            bound_ms=bms, bound_by=by, library_ms=None)


V1_WTA_FLAGS = ((True, True), (False, True), (True, False), (False, False))


def check_v1_wta(sgm, sgm_v1_cuda, total, what: str) -> None:
    """sgm1_wta against its plain version, bitwise, for all four
    (subpixel, lr_check) pairs."""
    for subpixel, lr in V1_WTA_FLAGS:
        disp = sgm_v1_cuda.wta(total, subpixel, lr, 1.0)
        ref = sgm.wta_from_total(total, subpixel, lr, 1.0)
        if not torch.equal(disp.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"sgm1_wta differs at {what} "
                                 f"subpixel={subpixel} lr={lr}")


def check_cost_wta_cases(dev, sgm, sgm_v1_cuda) -> None:
    """sgm1_cost and sgm1_wta against their plain versions at the full
    frame and on the cases of tests/dp_cc_cases.py: the cost at widths 1,
    below D and around its segment of COST_TX pixels, a height of 1,
    census words with all 32 bits different beside x < d; the WTA on ties
    over d and in the right view, minima at d = 0, 1, 126, 127, an offset
    of exactly +0.5, x < best, negative totals and the int16 extremes, for
    all four (subpixel, lr_check) pairs with lr_max_diff 0 and 1."""
    from dp_cc_cases import (COST_CASES, WTA_V1_CASES, WTA_V1_FLAGS,
                             cost_pair, wta_total)

    rng = np.random.default_rng(9)
    left = torch.tensor(rng.uniform(0, 1, (H, W)), dtype=torch.float32,
                        device=dev)
    right = torch.roll(left, -9, 1) + 0.02 * torch.randn(H, W, device=dev)
    cl, cr = sgm_v1_cuda.census_pair(left, right)
    cost = sgm_v1_cuda.cost_volume(cl, cr)
    if not torch.equal(cost.to(torch.int32), sgm.hamming_cost(cl, cr, 128)):
        raise AssertionError(f"sgm1_cost differs at {H}x{W}")
    check_v1_wta(sgm, sgm_v1_cuda, sgm_v1_cuda.aggregate(cost, 10, 120),
                 f"{H}x{W}")
    for case, (_, _, window, _) in sorted(COST_CASES.items()):
        left, right = (torch.from_numpy(x).to(dev) for x in cost_pair(case))
        cl, cr = sgm_v1_cuda.census_pair(left, right, window)
        if not torch.equal(sgm_v1_cuda.cost_volume(cl, cr).to(torch.int32),
                           sgm.hamming_cost(cl, cr, 128)):
            raise AssertionError(f"sgm1_cost differs on {case}")
    for case in sorted(WTA_V1_CASES):
        total = torch.from_numpy(wta_total(case)).to(dev)
        for subpixel, lr, md in WTA_V1_FLAGS:
            disp = sgm_v1_cuda.wta(total, subpixel, lr, md)
            ref = sgm.wta_from_total(total, subpixel, lr, md)
            if not torch.equal(disp.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"sgm1_wta differs on {case} subpixel="
                                     f"{subpixel} lr={lr} lr_max_diff={md}")
    log(f"sgm1_cost and sgm1_wta bitwise equal to plain at {H}x{W}, on "
        f"{len(COST_CASES)} cost and {len(WTA_V1_CASES)} WTA edge cases "
        f"({len(WTA_V1_FLAGS)} flag combinations)")


def sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def check_aggregate_cases(dev, sgm, sgm_v1_cuda) -> None:
    """sgm1_aggregate against its plain version, bitwise, on the cases of
    tests/dp_cc_cases.py (lengths 1, 2, odd and around the ring's chunks,
    lines on both sides of the shared-memory limits, P2 on both sides of
    the byte deltas' limit, negative int8 costs), at the serving shape and
    the full frame for five (P1, P2) pairs, and with blocks of more lines
    than the image has, staged and not."""
    from dp_cc_cases import (AGG_CASES, AGG_FULL, AGG_PENALTIES, AGG_SERVING,
                             agg_cost)

    def same(cost, p1, p2):
        return torch.equal(sgm_v1_cuda.aggregate(cost, p1, p2),
                           sgm.aggregate_cost_volume(cost, p1, p2))

    for h, w, p1, p2, kind in AGG_CASES:
        cost = torch.from_numpy(agg_cost(h, w, kind)).to(dev)
        if not same(cost, p1, p2):
            raise AssertionError(f"sgm1_aggregate differs at {h}x{w} "
                                 f"p1={p1} p2={p2} ({kind})")
    for shape in (AGG_SERVING, AGG_FULL):
        cost = torch.from_numpy(agg_cost(*shape, "int8")).to(dev)
        for p1, p2 in AGG_PENALTIES:
            if not same(cost, p1, p2):
                raise AssertionError(f"sgm1_aggregate differs at {shape} "
                                     f"p1={p1} p2={p2}")
    cost = torch.from_numpy(agg_cost(11, 5, "int8")).to(dev)
    ref = sgm.aggregate_cost_volume(cost, 10, 120)
    for staged in (True, False):
        total = torch.empty_like(ref)
        plan = (sgm_v1_cuda.AGG_MAX_STRIP, staged)
        sgm_v1_cuda._aggregate_pass(cost, total, 10, 120, False, plan)
        sgm_v1_cuda._aggregate_pass(cost, total, 10, 120, True, plan)
        if not torch.equal(total, ref):
            raise AssertionError(f"sgm1_aggregate differs with blocks of "
                                 f"{plan[0]} lines over 5 (staged {staged})")
    plans = [sgm_v1_cuda.agg_plan(*shape, 120, sms(dev))
             for shape in (AGG_SERVING, AGG_FULL)]
    log(f"sgm1_aggregate bitwise equal to plain on {len(AGG_CASES)} edge "
        f"cases, at {AGG_SERVING} and {AGG_FULL} for (p1, p2) in "
        f"{list(AGG_PENALTIES)} (plans {plans}), and with blocks wider "
        f"than the image")


def check_census_cases(dev, sgm, sgm_v1_cuda) -> None:
    """census_pair against the plain transform and against the kernel on
    each view alone, bitwise, on the cases of tests/dp_cc_cases.py (images
    smaller than the halo, partial tiles, ties, NaN and +-inf pixels,
    windows 3 x 3, 3 x 9, 11 x 3, 1 x 33)."""
    from dp_cc_cases import CENSUS_CASES, census_pair

    for case, (_, _, window, _) in sorted(CENSUS_CASES.items()):
        left, right = (torch.from_numpy(x).to(dev)
                       for x in census_pair(case))
        cl, cr = sgm_v1_cuda.census_pair(left, right, window)
        for out, img in ((cl, left), (cr, right)):
            if not (torch.equal(out, sgm.census_transform(img, window))
                    and torch.equal(out, sgm_v1_cuda.census(img, window))):
                raise AssertionError(f"sgm1_census differs on {case}")
    log(f"census_pair bitwise equal to plain and to one view at a time on "
        f"{len(CENSUS_CASES)} edge cases")


CORR_LEVELS = ((196, 3, 10), (128, 6, 20), (96, 12, 40), (64, 24, 80))


def check_corr_kernel(dev, report):
    from moving_object_detector_tpu_torch.ops import flow_corr_cuda, flow_ops

    g = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    ms = dev_ms = plain_ms = t_bytes = t_ops = 0.0
    shapes = [(1, *lvl) for lvl in CORR_LEVELS]
    shapes += [(1, 64, ODD_H, ODD_W), (1, 7, 13, 37), (2, 96, 12, 40),
               (2, 7, 5, 3)]
    for b, c, h, w in shapes:
        for r in (4, 3, 2, 1):
            f1 = torch.randn(b, c, h, w, device=dev, generator=g)
            f2 = torch.randn(b, c, h, w, device=dev, generator=g)
            out = flow_corr_cuda.correlation(f1, f2, r)
            ref = flow_ops.correlation(f1, f2, r)
            e = (out - ref).abs().max().item()
            if not e <= 1e-5:
                raise AssertionError(
                    f"corr differs at {b}x{c}x{h}x{w} r={r}: {e}")
            # The channel slices are added in a fixed order: same bits.
            if not torch.equal(out, flow_corr_cuda.correlation(f1, f2, r)):
                raise AssertionError(
                    f"corr differs between two runs at {b}x{c}x{h}x{w} r={r}")
            err = max(err, e)
        if (c, h, w) not in CORR_LEVELS + ((7, 13, 37),) or b != 1:
            continue
        f1 = torch.randn(b, c, h, w, device=dev, generator=g)
        f2 = torch.randn(b, c, h, w, device=dev, generator=g)
        t = timed(lambda: flow_corr_cuda.correlation(f1, f2, 4),
                  lambda: flow_ops.correlation(f1, f2, 4))
        if (c, h, w) in CORR_LEVELS:  # the main path's four calls
            log(f"corr kernel at {c}x{h}x{w} r=4: {t['ms']:.4f} ms, on the "
                f"device {t['device_ms']:.4f} ms, plain {t['plain_ms']:.4f}")
            ms += t["ms"]
            dev_ms += t["device_ms"]
            plain_ms += t["plain_ms"]
            t_bytes += (2 * c + 81) * h * w * 4
            t_ops += 2 * 81 * c * h * w
        else:
            log(f"corr launch floor, the smallest case {c}x{h}x{w} r=4: "
                f"{t['ms']:.4f} ms, on the device {t['device_ms']:.4f} ms")
    log(f"corr kernel within {err:.3g} of plain (tolerance 1e-5), two runs "
        f"bit-identical, at {len(shapes)} shapes, r = 1..4")
    bms, by = bound_ms(t_bytes, t_ops)
    report["corr"] = dict(
        name="corr", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/corr.cu",
        replaces="ops/flow_corr_pallas.py:88 correlation_pallas "
                 "(_corr_kernel :37)",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)


def raft_lookup_bytes_ops(n, levels, r):
    """RAFT's lookup over n pixels: the coordinates read once, the
    features written once, the (2r+2)^2 patch of each level a pixel's
    samples need; four multiply-adds a sample."""
    k = 2 * r + 1
    return (4 * (2 * n + n * levels * k * k + n * levels * (k + 1) ** 2),
            8 * n * levels * k * k)


def raft_pyramid(dev, g, b, h, w, levels):
    """An all-pairs pyramid of random (b, 256, h, w) features, as RAFT
    builds it."""
    from moving_object_detector_tpu_torch.models.raft import \
        correlation_pyramid

    f1 = torch.randn(b, 256, h, w, device=dev, generator=g)
    f2 = torch.randn(b, 256, h, w, device=dev, generator=g)
    return correlation_pyramid(f1, f2, levels)


def raft_coords(dev, g, b, h, w, amp):
    """Each pixel's own place plus a random shift of up to ``amp``
    pixels, so that samples fall on and off every level's map."""
    from moving_object_detector_tpu_torch.models.raft import coords_grid

    return coords_grid(b, h, w, dev) + amp * (
        2 * torch.rand(b, 2, h, w, device=dev, generator=g) - 1)


def check_raft_lookup(dev, report):
    """RAFT's lookup kernel against its plain version and against the
    published grid_sample lookup (``portbench/reference/raft.py``) at the
    KITTI grid and at edge shapes (radii 1..4, 1..4 levels, a batch of 2,
    maps down to 2 x 2, matches far outside); its times at the KITTI
    grid."""
    from moving_object_detector_tpu_torch.ops import raft_lookup_cuda as rl
    from portbench.reference import raft as ref

    g = torch.Generator(device=dev).manual_seed(0)
    err = err_pub = 0.0
    cases = [(1, 47, 156, 4, 4, 12.0), (1, 47, 156, 4, 4, 400.0),
             (2, 16, 24, 4, 4, 8.0), (1, 16, 16, 3, 3, 30.0),
             (1, 9, 13, 2, 2, 5.0), (3, 8, 8, 1, 1, 3.0)]
    for b, h, w, levels, r, amp in cases:
        pyr = raft_pyramid(dev, g, b, h, w, levels)
        coords = raft_coords(dev, g, b, h, w, amp)
        out = rl.raft_lookup(pyr, coords, r)
        plain = rl.raft_lookup_plain(pyr, coords, r)
        pub = ref.lookup([p[:, None] for p in pyr], coords, r)
        e = (out - plain).abs().max().item()
        e_pub = (out - pub).abs().max().item()
        scale = pub.abs().max().item()
        # Both tolerances are the coordinates' rounding: the kernel
        # normalises them with IEEE division, PyTorch on the card multiplies
        # by the divisor's reciprocal.
        if not e <= 1e-4 * max(scale, 1.0):
            raise AssertionError(f"raft_lookup differs from plain at "
                                 f"{b}x{h}x{w} L={levels} r={r}: {e}")
        if not e_pub <= 1e-4 * max(scale, 1.0):
            raise AssertionError(f"raft_lookup differs from grid_sample at "
                                 f"{b}x{h}x{w} L={levels} r={r}: {e_pub}")
        if not torch.equal(out, rl.raft_lookup(pyr, coords, r)):
            raise AssertionError("raft_lookup differs between two runs")
        err, err_pub = max(err, e), max(err_pub, e_pub)
    log(f"raft_lookup within {err:.3g} of plain and {err_pub:.3g} of "
        f"grid_sample, two runs bit-identical, at {len(cases)} shapes")
    b, h, w = 1, 47, 156
    pyr = raft_pyramid(dev, g, b, h, w, 4)
    coords = raft_coords(dev, g, b, h, w, 12.0)
    pub_pyr = [p[:, None] for p in pyr]
    t = timed(lambda: rl.raft_lookup(pyr, coords, 4),
              lambda: rl.raft_lookup_plain(pyr, coords, 4))
    library = median_ms(lambda: ref.lookup(pub_pyr, coords, 4))
    nbytes, ops = raft_lookup_bytes_ops(b * h * w, 4, 4)
    bms, by = bound_ms(nbytes, ops)
    log(f"raft_lookup at the KITTI grid 47x156, 4 levels, r=4: "
        f"{t['ms']:.4f} ms, on the device {t['device_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f}, grid_sample {library:.4f}, bound {bms:.4f} "
        f"({by}: {nbytes} bytes, {ops} operations); "
        f"{kernel_registers('raft_lookup')}")
    report["raft_lookup"] = dict(
        name="raft_lookup", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/raft_lookup.cu",
        replaces="none: RAFT's CorrBlock.__call__ (the JAX package has no "
                 "RAFT)",
        max_abs_err=max(err, err_pub), ms=t["ms"], device_ms=t["device_ms"],
        plain_ms=t["plain_ms"], bound_ms=bms, bound_by=by,
        library_ms=library)


def corr_grad_bytes_ops(b, c, h, w):
    """Bytes and operations of one correlation backward at r = 4: f1, f2
    and g read once, g1 and g2 written once; a multiply-add for each of
    the 81 offsets, channels and pixels, for both gradients."""
    return (4 * b * c * h * w + 81 * b * h * w) * 4, 2 * 2 * 81 * b * c * h * w


def check_corr_backward_kernel(dev, report):
    """``corr_backward`` against the plain ``correlation_backward`` at the
    train step's four levels, the odd shapes and the plan's switch points
    of ``tests/corr_grad_cases.py``: within TOL_CORR_GRAD of the
    gradients' scale, two runs bit-identical, and inputs 4 bytes into
    their storage (the 4-byte copies) too; each training level timed
    beside its launch plan, and the kernels' registers a thread."""
    from corr_grad_cases import (
        ODD_CASES,
        PLAN_CASES,
        TOL_CORR_GRAD,
        TRAIN_LEVELS,
        grad_case,
        grad_error,
    )
    from moving_object_detector_tpu_torch.ops import flow_corr_cuda, flow_ops

    err = 0.0
    ms = dev_ms = plain_ms = t_bytes = t_ops = 0.0
    levels = []
    cases = [lvl + (4,) for lvl in TRAIN_LEVELS] + ODD_CASES + PLAN_CASES
    for b, c, h, w, r in cases:
        f1, f2, g = (torch.from_numpy(x).to(dev)
                     for x in grad_case(b, c, h, w, r))
        out = flow_corr_cuda.corr_backward(f1, f2, g, r)
        ref = flow_ops.correlation_backward(f1, f2, g, r)
        e = grad_error([o.cpu() for o in out], [x.cpu() for x in ref])
        v1, v2 = (torch.cat([x.new_zeros(1), x.flatten()])[1:].view_as(x)
                  for x in (f1, f2))
        e = max(e, grad_error([o.cpu() for o in flow_corr_cuda.corr_backward(
            v1, v2, g, r)], [x.cpu() for x in ref]))
        if not e <= TOL_CORR_GRAD:
            raise AssertionError(
                f"corr_backward differs at {b}x{c}x{h}x{w} r={r}: {e}")
        again = flow_corr_cuda.corr_backward(f1, f2, g, r)
        if not all(torch.equal(x, y) for x, y in zip(out, again)):
            raise AssertionError(f"corr_backward differs between two runs "
                                 f"at {b}x{c}x{h}x{w} r={r}")
        err = max(err, e)
        if (b, c, h, w) not in TRAIN_LEVELS or r != 4:
            continue
        t = timed(lambda: flow_corr_cuda.corr_backward(f1, f2, g, 4),
                  lambda: flow_ops.correlation_backward(f1, f2, g, 4))
        nbytes, ops = corr_grad_bytes_ops(b, c, h, w)
        lvl_bound, lvl_by = bound_ms(nbytes, ops)
        plan = flow_corr_cuda.backward_plan(b, c, h, w, 4, w % 4 == 0)
        levels.append(dict(shape=[b, c, h, w], ms=t["ms"],
                           device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                           bound_ms=lvl_bound, bound_by=lvl_by, plan=plan))
        log(f"corr_backward at {b}x{c}x{h}x{w} r=4: {t['ms']:.4f} ms, on the "
            f"device {t['device_ms']:.4f} ms, bound {lvl_bound:.4f} "
            f"({lvl_by}), plain {t['plain_ms']:.4f}; plan {plan}")
        ms += t["ms"]
        dev_ms += t["device_ms"]
        plain_ms += t["plain_ms"]
        t_bytes += nbytes
        t_ops += ops
    log(f"corr_backward within {err:.3g} of plain (tolerance {TOL_CORR_GRAD}"
        f" of the gradients' scale), two runs bit-identical, at the "
        f"{len(TRAIN_LEVELS)} training levels, {len(ODD_CASES)} odd shapes "
        f"and {len(PLAN_CASES)} plan cases, aligned and 4 bytes off; per "
        f"level: " + json.dumps(levels))
    log("corr_backward registers a thread (cuobjdump): "
        + kernel_registers("corr_bwd"))
    bms, by = bound_ms(t_bytes, t_ops)
    report["corr_backward"] = dict(
        name="corr_backward", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/corr_bwd.cu",
        replaces="ops/flow_corr_pallas.py:151 _corr_bwd (custom_vjp of "
                 "correlation_pallas :88)",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)


def kernel_registers(name: str) -> str:
    """Each kernel of ``csrc/<name>.cu``'s built library with its registers
    a thread and its spill bytes, as ``cuobjdump -res-usage`` prints them;
    "not measured" where the toolkit has no ``cuobjdump``."""
    import re

    from moving_object_detector_tpu_torch import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return "not measured (no cuobjdump)"
    lib = _build._target(name)[1]
    text = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                          text=True, timeout=60).stdout
    found = re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) "
                       r"SHARED:\d+ LOCAL:(\d+)", text)
    return json.dumps({fn: dict(registers=int(reg), stack=int(stack),
                                local=int(local))
                       for fn, reg, stack, local in found})


def equal_with_nans(a, b) -> bool:
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def smooth_flow(rng, h, w, amp=12.0):
    """(h, w, 2) flow that varies smoothly, as between two video frames."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = amp * np.sin(xx / 90.0 + yy / 140.0) + rng.normal(0, 0.3, (h, w))
    fy = 0.4 * amp * np.cos(xx / 120.0 - yy / 60.0) + rng.normal(0, 0.3,
                                                                 (h, w))
    return np.stack([fx, fy], axis=-1).astype(np.float32)


def check_gather_kernel(dev, report):
    from moving_object_detector_tpu_torch.ops import gather_cuda, geometry

    rng = np.random.default_rng(1)
    serving = None
    for h, w in ((H, W), (ODD_H, ODD_W)):
        src = rng.uniform(1.0, 100.0, (h, w)).astype(np.float32)
        src[rng.random((h, w)) < 0.05] = np.nan  # holes
        flow = smooth_flow(rng, h, w)
        beyond = rng.random((h, w)) < 0.01  # outliers beyond the window
        flow[beyond] = rng.choice([-1.0, 1.0], (int(beyond.sum()), 2)) * \
            rng.uniform(30, 400, (int(beyond.sum()), 2))
        vv, uu = np.mgrid[0:h, 0:w]
        up = np.rint(uu - flow[..., 0]).astype(np.int32)
        vp = np.rint(vv - flow[..., 1]).astype(np.int32)
        outside = rng.random((h, w)) < 0.01  # and outside the image
        up[outside] = rng.choice([-5, -1, w, w + 300], int(outside.sum()))
        args = [torch.from_numpy(x).to(dev) for x in (src, vp, up)]
        out = gather_cuda.window_gather(*args, 16, 128)
        ref = geometry.window_gather(*args, 16, 128)
        if not equal_with_nans(out, ref):
            raise AssertionError(f"gather differs from plain at {h}x{w}")
        n_nan = int(torch.isnan(out).sum())
        if not 0 < n_nan < h * w // 2:
            raise AssertionError(f"gather check is vacuous: {n_nan} NaN")
        log(f"gather kernel equal to plain at {h}x{w} (NaN positions "
            f"equal, {n_nan} NaN of {h * w})")
        if serving is None:
            serving = args
    src, vp, up = serving
    n = H * W
    vc, uc = vp.clamp(0, H - 1).long(), up.clamp(0, W - 1).long()
    index_ms = median_ms(lambda: src[vc, uc])
    log(f"plain advanced indexing src[v, u] alone (no window, no bounds): "
        f"{index_ms:.4f} ms")
    bms, by = bound_ms(16 * n, 12 * n)
    report["gather"] = dict(
        name="gather", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/gather.cu",
        replaces="ops/gather_pallas.py:70 window_gather_pallas "
                 "(_window_gather_kernel :43)",
        max_abs_err=0.0,
        **timed(lambda: gather_cuda.window_gather(src, vp, up, 16, 128),
                lambda: geometry.window_gather(src, vp, up, 16, 128)),
        bound_ms=bms, bound_by=by, library_ms=None)


def cc_case(name, h, w, rng):
    """(dynamic, depth) numpy pair of one kind of CC input."""
    depth = (np.round(rng.random((h, w)) * 3) * 0.4 + 4.0).astype(np.float32)
    depth += rng.uniform(-0.05, 0.05, (h, w)).astype(np.float32)
    if name == "blobs":
        dyn = np.zeros((h, w), bool)
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(12):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            ry, rx = rng.integers(8, 50), rng.integers(8, 90)
            dyn |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        dyn &= rng.random((h, w)) < 0.9
        depth[rng.random((h, w)) < 0.02] = np.nan
    elif name == "one_component":
        dyn = np.ones((h, w), bool)
        depth[:] = 5.0
    elif name == "serpentine":  # one pixel wide, winding down the frame
        dyn = np.zeros((h, w), bool)
        dyn[::6, :] = True
        for k, r in enumerate(range(0, h - 6, 6)):
            dyn[r:r + 6, w - 1 if k % 2 == 0 else 0] = True
        depth[:] = 5.0
    elif name == "dense":
        dyn = rng.random((h, w)) < 0.5
    elif name == "empty":
        dyn = np.zeros((h, w), bool)
    else:
        raise ValueError(name)
    return dyn, depth


def check_cc_kernel(dev, report):
    from moving_object_detector_tpu_torch.ops import clustering, \
        clustering_cuda

    rng = np.random.default_rng(2)
    cases = [("blobs", CROP_H, CROP_W, 4), ("blobs", H, W, 4),
             ("one_component", H, W, 4), ("serpentine", H, W, 4),
             ("dense", H, W, 4), ("blobs", H, W, 2), ("empty", H, W, 4),
             ("blobs", ODD_H, ODD_W, 4), ("dense", ODD_H, ODD_W, 3)]
    serving = None
    for name, h, w, radius in cases:
        dyn_np, z_np = cc_case(name, h, w, rng)
        dyn = torch.from_numpy(dyn_np).to(dev)
        z = torch.from_numpy(z_np).to(dev)
        nd = torch.tensor(radius, dtype=torch.int32, device=dev)
        dd = torch.tensor(0.15, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        ref, iters = clustering.connected_components(
            dyn, z, dd, neighbor_distance=nd, max_iters=PLAIN_CC_ITERS,
            stencil_radius=4, return_iters=True)
        sync(dev)
        plain_s = time.perf_counter() - t0
        if iters >= PLAIN_CC_ITERS:
            raise AssertionError(f"plain CC did not converge on {name}")
        for run in range(3):  # a racy union would differ between runs
            out = clustering_cuda.connected_components(
                dyn, z, dd, neighbor_distance=nd, stencil_radius=4,
                max_iters=PLAIN_CC_ITERS)  # read by the plain form alone
            if not torch.equal(out, ref):
                bad = int((out != ref).sum())
                raise AssertionError(
                    f"cc differs from plain on {name} {h}x{w} radius "
                    f"{radius}, run {run}: {bad} pixels")
        n_comp = int(torch.unique(ref).numel()) - int(not dyn_np.all())
        log(f"cc kernel equal to plain on {name} {h}x{w} radius {radius}: "
            f"{int(dyn_np.sum())} dynamic pixels, {n_comp} components, "
            f"plain fixpoint {iters} rounds in {plain_s:.2f} s, 3 kernel "
            f"runs identical")
        if serving is None:
            serving = (dyn, z, dd, nd, dyn_np, z_np)
        if h == H and radius == 4 and name != "empty":
            run = lambda: clustering_cuda.connected_components(
                dyn, z, dd, neighbor_distance=nd, stencil_radius=4)
            log(f"cc kernel at {h}x{w} ({name}): {median_ms(run):.4f} ms, "
                f"on the device {device_ms(run):.4f} ms")
    check_cc_tile_borders(dev, clustering, clustering_cuda)
    dyn, z, dd, nd, dyn_np, z_np = serving
    n = CROP_H * CROP_W
    # Edge tests this input needs: 24 forward offsets per dynamic pixel
    # with a finite depth.
    tests = 24 * int((dyn_np & np.isfinite(z_np)).sum())
    bms, by = bound_ms(9 * n, OPS_PER_EDGE_TEST * tests)
    report["cc"] = dict(
        name="cc", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/cc.cu",
        replaces="ops/clustering_pallas.py:233 connected_components_pallas "
                 "(_cc_kernel :50)",
        max_abs_err=0.0,
        **timed(lambda: clustering_cuda.connected_components(
            dyn, z, dd, neighbor_distance=nd, stencil_radius=4),
            lambda: clustering.connected_components(
                dyn, z, dd, neighbor_distance=nd, max_iters=PLAIN_CC_ITERS,
                stencil_radius=4)),
        bound_ms=bms, bound_by=by, library_ms=None)
    return serving


def check_cc_tile_borders(dev, clustering, clustering_cuda) -> None:
    """The CC kernel against the converged plain version on the tile-border
    cases of tests/dp_cc_cases.py, contiguous and as strided views into a
    larger frame, three runs each."""
    from dp_cc_cases import CC_CASES

    for name, (make, radius, stencil, _) in sorted(CC_CASES.items()):
        dyn_np, z_np = make()
        h, w = dyn_np.shape
        dyn = torch.from_numpy(dyn_np).to(dev)
        z = torch.from_numpy(z_np).to(dev)
        nd = torch.tensor(radius, dtype=torch.int32, device=dev)
        ref, iters = clustering.connected_components(
            dyn, z, 0.15, neighbor_distance=nd, max_iters=PLAIN_CC_ITERS,
            stencil_radius=stencil, return_iters=True)
        if iters >= PLAIN_CC_ITERS:
            raise AssertionError(f"plain CC did not converge on {name}")
        big_dyn = torch.zeros((h + 7, w + 11), dtype=torch.bool, device=dev)
        big_z = torch.zeros((h + 7, w + 11, 3), device=dev)
        big_dyn[5:5 + h, 3:3 + w] = dyn
        big_z[5:5 + h, 3:3 + w, 2] = z
        for d, zz in ((dyn, z), (big_dyn[5:5 + h, 3:3 + w],
                                 big_z[5:5 + h, 3:3 + w, 2])):
            for run in range(3):
                out = clustering_cuda.connected_components(
                    d, zz, 0.15, neighbor_distance=nd,
                    stencil_radius=stencil)
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"cc differs from plain on tile case {name}, "
                        f"strided {not d.is_contiguous()}, run {run}")
    log(f"cc kernel equal to plain on {len(CC_CASES)} tile-border cases, "
        f"contiguous and strided, 3 runs each")


def check_stats_kernel(dev, report, cc_serving):
    from moving_object_detector_tpu_torch.ops import cluster_stats, \
        cluster_stats_cuda, clustering_cuda

    rng = np.random.default_rng(3)
    serving = None
    for h, w, cap in ((CROP_H, CROP_W, 16), (ODD_H, ODD_W, 32)):
        if (h, w) == (CROP_H, CROP_W):
            dyn, z, dd, nd = cc_serving[:4]
        else:
            dyn_np, z_np = cc_case("blobs", h, w, rng)
            dyn = torch.from_numpy(dyn_np).to(dev)
            z = torch.from_numpy(z_np).to(dev)
            dd, nd = 0.15, 4
        labels = clustering_cuda.connected_components(
            dyn, z, dd, neighbor_distance=nd, stencil_radius=4)
        n = h * w
        found, sizes = torch.unique(labels[labels < n], return_counts=True)
        found = found[torch.argsort(sizes, descending=True)]
        k = min(cap - cap // 4, found.numel())  # the last slots stay unused
        roots = torch.full((cap,), n, dtype=torch.int32, device=dev)
        roots[:k] = torch.sort(found[:k]).values.to(torch.int32)
        # The cloud of a larger frame, cropped: a strided view, as on the
        # main path; NaN outside the selected clusters.
        frame = torch.randn(h + 9, w + 14, 3, device=dev) * 5.0
        points = frame[4:4 + h, 7:7 + w]
        points[~torch.isin(labels, roots[:k])] = float("nan")
        out = cluster_stats_cuda.cluster_stats(labels, points, roots)
        ref = cluster_stats.cluster_stats(labels, points, roots)
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])):
            raise AssertionError(f"cluster_stats cid/csize differ at {h}x{w}")
        # By value: a zero may carry either sign.
        if not (bool((out[1] == ref[1]).all())
                and bool((out[2] == ref[2]).all())):
            raise AssertionError(f"cluster_stats min/max differ at {h}x{w}")
        if k == 0 or int(out[3].sum()) == 0:
            raise AssertionError("cluster_stats check is vacuous")
        log(f"cluster_stats kernel equal to plain at {h}x{w}: {k} of {cap} "
            f"slots used, {int(out[3].sum())} member pixels")
        if serving is None:
            serving = (labels, points, roots)
    labels, points, roots = serving
    # A NaN coordinate on a member pixel makes that slot's min and max on
    # that axis NaN, in the kernel as in the plain version.
    member = (labels == roots[0]).nonzero()[0]
    holed = points.clone()
    holed[member[0], member[1], 1] = float("nan")
    out = cluster_stats_cuda.cluster_stats(labels, holed, roots)
    ref = cluster_stats.cluster_stats(labels, holed, roots)
    if not (bool(torch.isnan(ref[1][0, 1])) and bool(torch.isnan(ref[2][0, 1]))
            and int(torch.isnan(ref[1]).sum()) == 1
            and equal_with_nans(out[1], ref[1])
            and equal_with_nans(out[2], ref[2])
            and torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])):
        raise AssertionError("cluster_stats with a NaN member coordinate "
                             "differs from plain")
    log("cluster_stats kernel equal to plain with a NaN coordinate on a "
        "member pixel (NaN min and max for that slot and axis alone)")
    check_stats_cases(dev, cluster_stats, cluster_stats_cuda)
    run = lambda: cluster_stats_cuda.cluster_stats(labels, points, roots)
    kernels = device_kernels(run)
    if len(kernels) != 1 or not 0 < sum(kernels.values()) <= 10:
        raise AssertionError(f"cluster_stats ran {kernels} in 10 calls, "
                             "expected one kernel a call")
    # The full-frame branch: 376 x 1242 blobs, 32 slots.
    dyn_np, z_np = cc_case("blobs", H, W, rng)
    full_labels = clustering_cuda.connected_components(
        torch.from_numpy(dyn_np).to(dev), torch.from_numpy(z_np).to(dev),
        0.15, neighbor_distance=4, stencil_radius=4)
    found, sizes = torch.unique(full_labels[full_labels < H * W],
                                return_counts=True)
    full_roots = torch.full((32,), H * W, dtype=torch.int32, device=dev)
    k = min(28, found.numel())
    full_roots[:k] = torch.sort(found[torch.argsort(
        sizes, descending=True)][:k]).values.to(torch.int32)
    full_points = torch.randn(H, W, 3, device=dev) * 5.0
    full = lambda: cluster_stats_cuda.cluster_stats(full_labels, full_points,
                                                    full_roots)
    if not stats_equal(full(), cluster_stats.cluster_stats(
            full_labels, full_points, full_roots)):
        raise AssertionError("cluster_stats differs at the full frame")
    log(f"cluster_stats: one kernel a call; equal to plain at {H}x{W} "
        f"({k} of 32 slots used): {median_ms(full):.4f} ms, on the device "
        f"{device_ms(full):.4f} ms (bound "
        f"{bound_ms(20 * H * W, 16 * H * W)[0]:.4f} ms)")
    n = CROP_H * CROP_W
    bms, by = bound_ms(20 * n, 16 * n)
    report["cluster_stats"] = dict(
        name="cluster_stats", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/cluster_stats.cu",
        replaces="ops/cluster_stats_pallas.py:66 cluster_stats_pallas "
                 "(_stats_kernel :33)",
        max_abs_err=0.0,
        **timed(lambda: cluster_stats_cuda.cluster_stats(labels, points,
                                                         roots),
                lambda: cluster_stats.cluster_stats(labels, points, roots)),
        bound_ms=bms, bound_by=by, library_ms=None)


def stats_equal(out, ref) -> bool:
    """cid and csize equal, mins and maxs equal by value (a zero may carry
    either sign) with NaN in the same places."""
    return (torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])
            and equal_with_nans(out[1], ref[1])
            and equal_with_nans(out[2], ref[2]))


def device_kernels(fn, reps: int = 10) -> dict:
    """Kernel records of the profiler by name over ``reps`` calls of
    ``fn``, after a warm-up call. The profiler may drop a record, never
    add one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return names


def check_stats_cases(dev, cluster_stats, cluster_stats_cuda) -> None:
    """cluster_stats against its plain version on the cases of
    tests/dp_cc_cases.py (cap 1 and 32, repeated roots, no slot used, one
    cluster over the image, signed zeros and NaN members, a strided crop,
    an image not a multiple of the block), then all of them three times in
    a row and on two streams at once: the accumulator the kernel leaves
    zeroed is per stream."""
    from dp_cc_cases import STATS_CASES, on_device, stats_case

    cases = []
    for name in sorted(STATS_CASES):
        labels, points, roots = stats_case(name)
        cases.append((torch.from_numpy(labels).to(dev),
                      on_device(points, dev), torch.from_numpy(roots).to(dev)))
    refs = [cluster_stats.cluster_stats(*c) for c in cases]
    for _ in range(3):
        for name, c, ref in zip(sorted(STATS_CASES), cases, refs):
            if not stats_equal(cluster_stats_cuda.cluster_stats(*c), ref):
                raise AssertionError(f"cluster_stats differs on {name}")
    streams = [torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(4):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                for c in cases[k::2]:
                    outs[k].append(cluster_stats_cuda.cluster_stats(*c))
    torch.cuda.synchronize()
    for k in range(2):
        if not all(stats_equal(o, r)
                   for o, r in zip(outs[k], refs[k::2] * 4)):
            raise AssertionError(f"cluster_stats differs on stream {k}")
    log(f"cluster_stats kernel equal to plain on {len(STATS_CASES)} edge "
        f"cases, three times in a row and on two streams at once")


def check_fused_kernel(dev, report):
    from moving_object_detector_tpu_torch.ops import sceneflow_cuda

    rng = np.random.default_rng(4)
    serving = None
    err = 0.0
    for h, w in ((H, W), (ODD_H, ODD_W)):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 30.0 + 18.0 * np.sin(xx / 150.0) * np.cos(yy / 80.0)
        d_now = (base + rng.normal(0, 0.2, (h, w))).astype(np.float32)
        d_prev = (base + rng.normal(0, 0.3, (h, w))).astype(np.float32)
        d_now[rng.random((h, w)) < 0.1] = -1.0  # invalid pixels
        d_prev[rng.random((h, w)) < 0.1] = -1.0
        d_prev[rng.random((h, w)) < 0.02] = np.nan
        d_prev[5:9] = 0.0
        flow = smooth_flow(rng, h, w)
        far = rng.random((h, w)) < 0.02  # outliers
        flow[far] = rng.uniform(-500, 500, (int(far.sum()), 2))
        flow[rng.random((h, w)) < 0.01] = np.nan
        params = torch.tensor(
            [721.5, 720.0, w / 2 - 3, h / 2 + 2,
             721.5, 0.54, 0.5, 127.0, 721.5, 0.54, 0.5, 127.0,
             0.99999, -0.001, 0.004, 0.05, 0.001, 0.99999, -0.002, -0.02,
             -0.004, 0.002, 0.99999, 0.3, 0.1, 5.0, 30.0],
            dtype=torch.float32, device=dev)  # a non-identity transform
        args = [torch.from_numpy(x).to(dev) for x in (d_now, d_prev, flow)]
        out = sceneflow_cuda.scene_flow_fused_cuda(*args, params)
        ref = sceneflow_cuda.scene_flow_fused(*args, params)
        err = max(err, check_fused_close(out, ref, f"{h}x{w}"))
        vel = out[1]
        n_vel = int(torch.isfinite(vel[..., 0]).sum())
        n_dyn = int((torch.nan_to_num(vel).abs().sum(-1) > 0).sum())
        some_static = n_dyn < n_vel or (h, w) != (H, W)
        if not (0 < n_dyn <= n_vel < h * w and some_static):
            raise AssertionError("fused check is vacuous")
        log(f"fused scene-flow kernel matches plain at {h}x{w}: NaN masks "
            f"equal, {n_vel} pixels with velocity, {n_dyn} dynamic")
        if serving is None:
            serving = (args, params)
    check_fused_cases(dev, sceneflow_cuda)
    args, params = serving
    n = H * W
    bms, by = bound_ms(48 * n, OPS_PER_FUSED_PIXEL * n)
    report["sceneflow_fused"] = dict(
        name="sceneflow_fused", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/sceneflow_fused.cu",
        replaces="ops/sceneflow_pallas.py:187 scene_flow_fused_pallas "
                 "(_fused_kernel :49)",
        max_abs_err=err,
        **timed(lambda: sceneflow_cuda.scene_flow_fused_cuda(*args, params),
                lambda: sceneflow_cuda.scene_flow_fused(*args, params)),
        bound_ms=bms, bound_by=by, library_ms=None)


def check_fused_close(out, ref, what: str) -> float:
    """Raise unless the fused construct's three outputs have the plain
    version's NaN masks and values within 1e-5 relative; the static flow
    is a difference of pixel coordinates, so its 1e-5 is relative to the
    frame's extent. Returns the largest difference."""
    err = 0.0
    scale = float(max(out[0].shape[:2]))
    for name, a, b, sc in zip(("points", "velocity", "static_flow"), out,
                              ref, (0.0, 0.0, scale)):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"fused {name} NaN masks differ on {what}")
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        diff = (a - b).abs()
        if not bool((diff <= 1e-5 * (b.abs() + sc) + 1e-30).all()):
            raise AssertionError(
                f"fused {name} differs on {what}: max {diff.max()}")
        err = max(err, float(diff.max()))
    return err


def check_fused_cases(dev, sceneflow_cuda) -> None:
    """The fused construct against its plain version on the cases of
    tests/sceneflow_cases.py (every residue of W mod 4, odd pixel counts,
    1 x 1, 1 x 5, 3 x 7, matches on the window's edges, NaN and +-inf
    flow), and once from an input that is not 16-byte aligned."""
    from sceneflow_cases import FUSED_CASES, fused_case

    for name in sorted(FUSED_CASES):
        d_now, d_prev, flow, par, vr, hr = fused_case(name)
        args = [torch.from_numpy(x).to(dev) for x in (d_now, d_prev, flow)]
        params = torch.from_numpy(par).to(dev)
        ref = sceneflow_cuda.scene_flow_fused(*args, params, vr, hr)
        shifted = torch.empty(d_now.size + 1, device=dev)[1:]
        shifted = shifted.view(d_now.shape).copy_(args[0])
        for now in (args[0], shifted):
            check_fused_close(sceneflow_cuda.scene_flow_fused_cuda(
                now, *args[1:], params, vr, hr), ref, name)
    log(f"fused scene-flow kernel matches plain on {len(FUSED_CASES)} edge "
        f"cases, NaN masks equal, aligned and unaligned input")


def gn_bytes_ops(pts3d, obs_uv, weights, iters):
    """Bytes one Gauss-Newton call must move and the operations it does."""
    b, n = weights.shape
    nbytes = 4 * (pts3d.numel() + obs_uv.numel() + weights.numel() + 4
                  + 16 * b)
    return nbytes, iters * (OPS_PER_GN_POINT * b * n + OPS_PER_GN_SOLVE * b)


def check_gauss_newton_kernel(dev, report):
    """The Gauss-Newton kernel against its plain version on synthetic
    correspondences of a known motion (tests/gauss_newton_cases.py) at the
    RANSAC's two shapes: the refinement (4 problems over 512 shared
    points, 8 iterations) within 1e-5, the hypotheses (64 problems of 3
    points, 5 iterations) within 1e-4 on the sound triples. Times one
    frame's three calls, and each call at the block sizes that fit it."""
    from gauss_newton_cases import (
        CAM,
        TRANS,
        problem,
        sound,
    )
    from moving_object_detector_tpu_torch.ops import gauss_newton_cuda as gn

    cam = torch.tensor(CAM, device=dev)
    calls, err = {}, 0.0
    for shape in ("hypothesis", "refine"):
        pts, uv, weights, iters = problem(shape)
        args = [torch.from_numpy(x).to(dev) for x in (pts, uv, weights)]
        args += [cam, iters]
        out = gn.solve_pose(*args)
        ref = gn.solve_pose_plain(*args)
        diff = (out - ref).abs().amax((1, 2)).cpu().numpy()
        if shape == "hypothesis":
            keep = sound(ref.cpu().numpy(), pts, uv, weights)
            tol = 1e-4
        else:
            keep = np.ones(len(diff), bool)
            tol = 1e-5
            t_err = float((out[:, :3, 3] - torch.tensor(
                TRANS, device=dev)).abs().max())
            if not t_err <= 0.02:
                raise AssertionError(f"gauss_newton: the known translation "
                                     f"missed by {t_err} m")
        if keep.sum() < min(16, len(diff)) or not diff[keep].max() <= tol:
            raise AssertionError(
                f"gauss_newton differs from plain at the {shape} shape: "
                f"{diff[keep].max()} (tolerance {tol}) on {keep.sum()} "
                f"sound problems")
        err = max(err, float(diff[keep].max()))
        calls[shape] = args
        log(f"gauss_newton kernel matches plain at the {shape} shape "
            f"{tuple(weights.shape)} x {iters} iterations: max |diff| "
            f"{diff[keep].max():.3g} on {keep.sum()} of {len(diff)} "
            f"sound problems (all: {diff.max():.3g})")
    hyp, refine = calls["hypothesis"], calls["refine"]
    for threads in gn.THREADS:
        log(f"gauss_newton refine call at {threads} threads a block: "
            f"{device_ms(lambda: gn.solve_pose(*refine, threads=threads)):.4f}"
            f" device ms")
    for threads in gn.THREADS[:2]:
        log(f"gauss_newton hypothesis call at {threads} threads a block: "
            f"{device_ms(lambda: gn.solve_pose(*hyp, threads=threads)):.4f}"
            f" device ms")

    def frame(solve):  # a frame's three calls, as _ransac_gn_solve makes
        solve(*hyp)
        solve(*refine)
        solve(*refine)

    sizes = [gn_bytes_ops(*a[:3], a[4]) for a in (hyp, refine, refine)]
    bms, by = bound_ms(sum(b for b, _ in sizes), sum(o for _, o in sizes))
    report["gauss_newton"] = dict(
        name="gauss_newton", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/gauss_newton.cu",
        replaces="egomotion.py:318 _solve_pose (an XLA fori_loop, "
                 "no Pallas kernel); timed as the 3 calls a RANSAC made "
                 "before ransac_gn took them over; off the serving path",
        max_abs_err=err,
        **timed(lambda: frame(gn.solve_pose),
                lambda: frame(gn.solve_pose_plain)),
        bound_ms=bms, bound_by=by, library_ms=None)


def ransac_bytes_ops(n, h, s, k, cfg):
    """Bytes one RANSAC must move (each input once, the outputs once) and
    the operations it does: the hypotheses' solves, their scores, the
    ranking, each candidate's two refinements and three passes of
    residuals (its inliers, the tight mask, the final count and score)."""
    nbytes = 12 * n + 8 * n + n + 8 * h * s + 16 + 64 + 1 + 4
    ops = (cfg.gn_iters_hypothesis * (OPS_PER_GN_POINT * h * s
                                      + OPS_PER_GN_SOLVE * h)
           + OPS_PER_GN_RESIDUAL * h * n + OPS_PER_RANK * h * h
           + k * (2 * cfg.gn_iters_refine * (OPS_PER_GN_POINT * n
                                             + OPS_PER_GN_SOLVE)
                  + 3 * OPS_PER_GN_RESIDUAL * n))
    return nbytes, ops


def ransac_case_args(dev, name, **kw):
    """(args, cfg) of a RANSAC case of tests/gauss_newton_cases.py."""
    from gauss_newton_cases import CAM, RANSAC_CASES, ransac_case
    from moving_object_detector_tpu_torch.config import EgoMotionConfig

    pts, uv, valid, idx = ransac_case(name)
    _, h, k = RANSAC_CASES[name]
    args = [torch.from_numpy(x).to(dev) for x in (pts, uv, valid)]
    args += [torch.tensor(CAM, device=dev), torch.from_numpy(idx).to(dev)]
    return args, EgoMotionConfig(ransac_hypotheses=h, refine_candidates=k,
                                 **kw)


def check_ransac_kernel(dev, report):
    """The RANSAC kernel (``ransac_gn``) against its plain version on the
    cases of tests/gauss_newton_cases.py (the serving shape, 512 features
    with outliers and invalid ones, 64 hypotheses, 1, 4 and 16 candidates,
    and an odd 37 x 50), at every block size: one launch and no
    ``gauss_newton`` launch a call, the same success and inlier count, the
    motion within TOL_GN_MOTION; no valid feature and too few inliers give
    the identity; two runs bit-identical. First holds the kernels'
    branch-free division and square root against the card's own on 2^26
    inputs. Times the serving case at every block size, beside the same
    RANSAC as three ``gauss_newton`` launches and the torch scoring
    between them, and logs the kernels' registers."""
    from gauss_newton_cases import RANSAC_CASES
    from moving_object_detector_tpu_torch.ops import gauss_newton_cuda as gn

    counts = gn.ieee_ops_check(1 << 26, seed=1, device=dev)
    if counts["div_mismatches"] or counts["sqrt_mismatches"]:
        raise AssertionError(f"FastOps differ from the card's IEEE "
                             f"division or square root: {counts}")
    log(f"FastOps equal the card's IEEE division and square root bit for "
        f"bit: {json.dumps(counts)}")
    err = 0.0
    for name in RANSAC_CASES:
        args, cfg = ransac_case_args(dev, name)
        ref = gn.ransac_solve_plain(*args, cfg)
        for threads in gn.RANSAC_THREADS:
            before = dict(gn.LAUNCHES)
            out = gn.ransac_solve(*args, cfg, threads=threads)
            sync(dev)
            if gn.LAUNCHES != dict(before, ransac_gn=before["ransac_gn"] + 1):
                raise AssertionError(f"ransac_gn {name}: launches "
                                     f"{before} -> {gn.LAUNCHES}")
            diff = float((out[0] - ref[0]).abs().max())
            if (bool(out[1]) != bool(ref[1]) or not bool(out[1])
                    or int(out[2]) != int(ref[2])
                    or not diff <= TOL_GN_MOTION):
                raise AssertionError(
                    f"ransac_gn differs from plain on {name} at {threads} "
                    f"threads: success {bool(out[1])} / {bool(ref[1])}, "
                    f"count {int(out[2])} / {int(ref[2])}, motion {diff}")
            err = max(err, diff)
        log(f"ransac_gn matches plain on {name} {RANSAC_CASES[name]} at "
            f"{gn.RANSAC_THREADS} threads: count {int(ref[2])}, motion max "
            f"|diff| {diff:.3g} (tolerance {TOL_GN_MOTION})")
    for what in ("no valid feature", "too few inliers"):
        if what == "no valid feature":
            args, cfg = ransac_case_args(dev, "odd")
            args[2] = torch.zeros_like(args[2])
        else:
            args, cfg = ransac_case_args(dev, "serving", min_inliers=10_000)
        out = gn.ransac_solve(*args, cfg)
        ref = gn.ransac_solve_plain(*args, cfg)
        if not (torch.equal(out[0], torch.eye(4, device=dev))
                and not bool(out[1]) and int(out[2]) == int(ref[2])):
            raise AssertionError(f"ransac_gn with {what}: {out}, plain {ref}")
    args, cfg = ransac_case_args(dev, "serving")
    first = gn.ransac_solve(*args, cfg)
    if not all(torch.equal(a, b) for a, b in
               zip(first, gn.ransac_solve(*args, cfg))):
        raise AssertionError("ransac_gn: two runs differ")
    log("ransac_gn: the identity and no success with no valid feature and "
        "with too few inliers; two runs bit-identical")
    for threads in gn.RANSAC_THREADS:
        ms = device_ms(lambda: gn.ransac_solve(*args, cfg, threads=threads))
        log(f"ransac_gn serving call at {threads} threads a block: "
            f"{ms:.4f} device ms")

    def three_calls():  # the same RANSAC on the gauss_newton kernel
        real = gn.solve_pose_plain
        gn.solve_pose_plain = gn.solve_pose
        try:
            return gn.ransac_solve_plain(*args, cfg)
        finally:
            gn.solve_pose_plain = real

    for what, fn in (("one ransac_gn launch", lambda: gn.ransac_solve(
            *args, cfg)), ("three gauss_newton launches and the torch "
                           "scoring between them", three_calls)):
        ms, launches = device_profile(fn)
        log(f"the serving RANSAC as {what}: {ms:.4f} device ms in "
            f"{launches} kernel launches a call")
    log("registers of csrc/gauss_newton.cu's kernels: "
        + kernel_registers("gauss_newton"))
    (n, _), (h, s) = args[0].shape, args[4].shape
    k = gn.ransac_candidates(cfg, h)
    bms, by = bound_ms(*ransac_bytes_ops(n, h, s, k, cfg))
    report["ransac_gn"] = dict(
        name="ransac_gn", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/gauss_newton.cu",
        replaces="egomotion.py:441 _ransac_gn_solve (XLA, no Pallas "
                 "kernel): hypotheses, MSAC scores, stable top-k, two-pass "
                 "refinement, argmin in one launch a RANSAC; latency-bound "
                 "(a chain of 5 + 8 + 8 dependent Gauss-Newton iterations, "
                 "each a reduction and a serial 6 x 6 solve)",
        max_abs_err=err,
        **timed(lambda: gn.ransac_solve(*args, cfg),
                lambda: gn.ransac_solve_plain(*args, cfg)),
        bound_ms=bms, bound_by=by, library_ms=None)
    log(f"ransac_gn serving shape (N, H, K) = {(n, h, k)}: bound "
        f"{bms:.6f} ms ({by})")


def synchronized_stage_ms(rec) -> dict:
    """Total ms of each of ``detect_step``'s stages in a recorder that
    synchronized the card around them."""
    from moving_object_detector_tpu_torch.utils.profiling import SYNC_PREFIX

    return {k: v for k, v in rec.totals_ms().items()
            if not k.startswith(SYNC_PREFIX)}


@contextlib.contextmanager
def synchronized_stages(dev):
    """Record ``detect_step``'s stage spans with the card synchronized
    around each: yields the recorder."""
    from moving_object_detector_tpu_torch.utils import profiling

    with profiling.recording(
            profiling.SpanRecorder(synchronize=dev)) as rec:
        yield rec


def run_frames(model, config, stereo, frames, dev, per_frame=None):
    """Drive ``detect_step`` over the frames from a fresh state: (outputs,
    ms per step). ``per_frame`` maps counter names (a kernel's, or
    "lk_track" for the LK fallback's tracking calls) to lists that receive
    each frame's count."""
    from moving_object_detector_tpu_torch.pipeline import (
        PipelineState,
        detect_step,
    )

    state = PipelineState.create(config, device=dev)
    outs, step_ms = [], []
    for k, (left, right, _) in enumerate(frames):
        lt = torch.from_numpy(left).to(dev)
        rt = torch.from_numpy(right).to(dev)
        before = dict(read_counts(), lk_track=LK_CALLS[0])
        sync(dev)
        t0 = time.perf_counter()
        state, out = detect_step(model, state, lt, rt, 0.1 * k, stereo,
                                 config)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        after = dict(read_counts(), lk_track=LK_CALLS[0])
        for name, counts in (per_frame or {}).items():
            counts.append(after[name] - before[name])
    return outs, step_ms


def check_outputs(outs, frames, cap):
    for k, (out, (_, _, x)) in enumerate(zip(outs, frames)):
        d = out.disparity.disparity
        assert tuple(d.shape) == (H, W) and bool(torch.isfinite(d).all())
        assert tuple(out.flow.shape) == (H, W, 2)
        assert bool(torch.isfinite(out.flow).all())
        assert tuple(out.scene_flow.points.shape) == (H, W, 3)
        assert tuple(out.label_image.shape) == (H, W)
        for o in (out.detections, out.tracked.objects):
            assert tuple(o.center.shape) == (cap(o), 3)
            assert bool(torch.isfinite(o.center).all())
            assert bool(torch.isfinite(o.velocity).all())
        assert bool(torch.isfinite(out.motion).all())
        # The strips' known disparities, away from the patch.
        dn = d.cpu().numpy()
        for x0, x1, dd in STRIPS:
            region = dn[20:120, x0 + 40:x1 - 20]
            v = region[region >= 0]
            assert v.size > 0.5 * region.size, (k, x0, v.size)
            med = float(np.median(v))
            assert abs(med - dd) <= 1.0, (k, x0, med, dd)
        if k:  # the patch moved SHIFT px to the right since frame k - 1
            f = out.flow[PATCH_Y + 20:PATCH_Y + PATCH_H - 20,
                         x + 20:x + PATCH_W - 20, 0]
            med = float(f.median())
            # pwc_v7 at half resolution underestimates this pasted patch's
            # motion (the JAX package gives the same on the CPU), so the
            # check is a band, not an equality.
            assert 0.5 * SHIFT <= med <= 1.5 * SHIFT, (k, med)
            bg = float(out.flow[20:120, 40:260].abs().median())
            assert bg <= 0.5, (k, bg)
    assert any(int(o.detections.valid.sum()) for o in outs[1:]), \
        "the moving patch was never detected"


def profile_frames(model, config, stereo, frames, dev, step_ms: float,
                   what: str, ego: bool = False):
    """torch.profiler over the serving frames: device busy ms per frame
    (and its share of the unprofiled median ``step_ms``; the profiler
    itself slows the host), kernel launches per frame, with ``ego`` the
    ego-motion stage's alone, then the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync(dev)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run_frames(model, config, stereo, frames, dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    n = len(frames)
    log(f"profile of {what} over {n} frames: device busy {busy_ms / n:.2f} ms/frame "
        f"= {100 * busy_ms / n / step_ms:.1f}% of the unprofiled median "
        f"{step_ms:.2f} ms/frame; {len(kernels) / n:.0f} kernel "
        f"launches/frame; profiled wall {wall_ms / n:.0f} ms/frame")
    if ego:
        ego_ms, ego_launches, ego_busy = profile_ego_motion(
            model, config, stereo, frames, dev)
        log(f"  ego-motion alone on these frames' inputs, frame by frame "
            f"(frame 0 takes the LK fallback): host ms (synchronized) "
            f"{[round(t, 3) for t in ego_ms]}, kernel launches "
            f"{ego_launches}, device busy ms "
            f"{[round(t, 3) for t in ego_busy]}")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, c) in top:
        log(f"  {t / n:8.3f} ms/frame {c / n:7.1f} calls/frame  {name[:90]}")


V1_KERNELS = ("sgm1_census", "sgm1_cost", "sgm1_aggregate", "sgm1_wta")
V1_ONLY_KERNELS = V1_KERNELS[1:]  # the census kernel serves both paths
V2_SGM_KERNELS = ("sgm_vertical", "sgm_horizontal", "sgm_wta")


def check_flow_graph(model, config, prev, now, what: str) -> None:
    """The flow stage's CUDA graphs at one shape: ``_flow_forward`` on two
    pairs (the capture's eager run or a replay, then a replay), each
    bitwise ``_flow_eager`` and a correlation launch a level; then three
    replays under the profiler, which must hold a correlation kernel a
    level and a replay."""
    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.ops import flow_corr_cuda

    scale, backend = config.flow_input_scale, config.flownet.corr_backend

    def flow(a, b):
        return pipeline._flow_forward(model, a, b, input_scale=scale,
                                      corr_backend=backend)

    for a, b in ((prev, now), (now, prev)):
        before = flow_corr_cuda.LAUNCHES["corr"]
        got = flow(a, b)
        n = flow_corr_cuda.LAUNCHES["corr"] - before
        want = pipeline._flow_eager(model, a, b, scale, backend)
        if not torch.equal(got, want) or n != len(CORR_LEVELS):
            raise AssertionError(
                f"flow graph at {what}: max |diff| against the eager flow "
                f"{float((got - want).abs().max())}, {n} corr launches")
    if pipeline._flow_key(model, prev, now, scale,
                          backend) not in pipeline._flow_cache.graphs:
        raise AssertionError(f"flow graph at {what}: no graph captured")
    reps = 3
    on_card = sum(n for name, n in device_kernels(
        lambda: flow(prev, now), reps).items() if "corr_kernel" in name)
    if on_card != reps * len(CORR_LEVELS):
        raise AssertionError(f"flow graph at {what}: the profiler saw "
                             f"{on_card} corr kernels in {reps} replays")
    log(f"flow graph at {what} ({tuple(prev.shape)}, scale {scale}): "
        f"bitwise the eager flow on two pairs, {len(CORR_LEVELS)} corr "
        f"launches a call, {on_card} corr kernels on the card in {reps} "
        f"replays; {len(pipeline._flow_cache.graphs)} graphs held in the "
        "process")


def check_gauss_newton_per_frame(per_frame, what: str) -> None:
    """One RANSAC kernel launch on a frame that keeps the dense flow, two
    on a frame that takes the LK fallback (the RANSAC runs again on the LK
    tracks), and no Gauss-Newton launch: ``ransac_gn`` runs its solves."""
    for k, (n_ransac, n_gn, n_lk) in enumerate(zip(
            per_frame["ransac_gn"], per_frame["gauss_newton"],
            per_frame["lk_track"])):
        if n_ransac != (2 if n_lk else 1) or n_gn:
            raise AssertionError(
                f"{what}: frame {k} launched ransac_gn {n_ransac} and "
                f"gauss_newton {n_gn} times with {n_lk} LK fallbacks, "
                f"expected {2 if n_lk else 1} and 0")
    if all(per_frame["lk_track"]):
        raise AssertionError(f"{what}: no frame kept the dense flow")


def kernel_counters():
    """Every wrapper's launch counter, by kernel name."""
    from moving_object_detector_tpu_torch.ops import (
        cluster_stats_cuda,
        clustering_cuda,
        flow_corr_cuda,
        gather_cuda,
        gauss_newton_cuda,
        sceneflow_cuda,
        sgm_cuda,
        sgm_v1_cuda,
    )

    return (sgm_cuda.LAUNCHES, sgm_v1_cuda.LAUNCHES, flow_corr_cuda.LAUNCHES,
            gather_cuda.LAUNCHES, clustering_cuda.LAUNCHES,
            cluster_stats_cuda.LAUNCHES, sceneflow_cuda.LAUNCHES,
            gauss_newton_cuda.LAUNCHES)


def reset_counts() -> None:
    for c in kernel_counters():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in kernel_counters() for k, v in c.items()}


LK_CALLS = [0]  # egomotion.lk_track calls, counted by count_lk_calls


def count_lk_calls() -> None:
    """Count the LK fallback's tracking calls (``estimate_motion`` looks
    ``lk_track`` up in its module at each call)."""
    from moving_object_detector_tpu_torch import egomotion

    real = egomotion.lk_track

    def counted(*args, **kwargs):
        LK_CALLS[0] += 1
        return real(*args, **kwargs)

    egomotion.lk_track = counted


@contextlib.contextmanager
def plain_gauss_newton():
    """Ego-motion's RANSAC and Gauss-Newton solves in their plain forms, on
    the card too: the yardstick the kernels' path is held against."""
    from moving_object_detector_tpu_torch.ops import gauss_newton_cuda as gn

    real, real_ransac = gn.solve_pose, gn.ransac_solve
    gn.solve_pose = lambda *a, **k: gn.solve_pose_plain(*a, **k)
    gn.ransac_solve = lambda *a, **k: gn.ransac_solve_plain(*a, **k)
    try:
        yield
    finally:
        gn.solve_pose, gn.ransac_solve = real, real_ransac


def matches_outside_window(outs, sf_config) -> int:
    """Pixels of these frames whose flow-matched previous pixel lies inside
    the image but outside the covered window: there the windowed and the
    plain gather differ by design."""
    from moving_object_detector_tpu_torch.ops import geometry

    total = 0
    for out in outs:
        flow = out.flow
        h, w = flow.shape[:2]
        u, v = geometry.pixel_grid(h, w, flow.device)
        finite = torch.isfinite(flow).all(-1)
        safe = torch.where(finite[..., None], flow, torch.zeros_like(flow))
        up = torch.round(u - safe[..., 0]).to(torch.int32)
        vp = torch.round(v - safe[..., 1]).to(torch.int32)
        inside = (up >= 0) & (up < w) & (vp >= 0) & (vp < h)
        hit = torch.isfinite(geometry.window_gather(
            torch.ones((h, w), device=flow.device), vp, up,
            sf_config.match_v_radius, sf_config.match_h_radius))
        total += int((finite & inside & ~hit).sum())
    return total


def compare_detections(outs_a, outs_b, what: str, atol: float) -> None:
    """Validity, ids, label images and overflow identical; centers, boxes
    and velocities within ``atol`` (0 = identical)."""
    for k, (a, b) in enumerate(zip(outs_a, outs_b)):
        da, db = a.detections, b.detections
        same = (torch.equal(da.valid, db.valid) and torch.equal(da.id, db.id)
                and torch.equal(a.label_image, b.label_image)
                and int(a.cluster_overflow) == int(b.cluster_overflow))
        if not same:
            bad = int((a.label_image != b.label_image).sum())
            raise AssertionError(
                f"{what}: frame {k} detections differ ({bad} label pixels, "
                f"valid {da.valid.tolist()} / {db.valid.tolist()})")
        for f in ("center", "bounding_box", "velocity"):
            diff = float((getattr(da, f) - getattr(db, f)).abs().max())
            if not diff <= atol:
                raise AssertionError(f"{what}: frame {k} {f} differs by "
                                     f"{diff} (tolerance {atol})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from moving_object_detector_tpu_torch import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
        + json.dumps({k: round(v, 2) for k, v in per_source.items()}))

    report = {}
    run_checks_and_paths(dev, report)

    log(card())
    for r in report.values():  # NaN is not JSON: not measured is null
        if r["device_ms"] != r["device_ms"]:
            r["device_ms"] = None
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serving_setup(dev):
    """(flow net, config, stereo rig) of the serving point: 376 x 1242,
    pwc_v7, flow and SGM at scale 2, the two-window crop, "auto"
    backends."""
    from moving_object_detector_tpu_torch import config as cfgmod
    from moving_object_detector_tpu_torch.types import StereoModel
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    config = cfgmod.PipelineConfig(
        height=H, width=W, flow_input_scale=2, sgm_input_scale=2,
        clusterer=cfgmod.ClustererConfig(cc_crop_h=CROP_H, cc_crop_w=CROP_W))
    if config.clusterer != cfgmod.ClustererConfig():
        raise AssertionError("CROP_H / CROP_W are not the serving defaults")
    model, fcfg = load_flow_checkpoint(
        os.path.join(ROOT, "weights", "pwc_v7.fp16.npz"),
        cfgmod.FlowNetConfig(), device=dev)
    config = config.replace(flownet=fcfg)
    # The serving backends: "auto" is the kernels on the card.
    assert config.scene_flow.gather_backend == "auto"
    assert config.clusterer.cc_backend == "auto"
    stereo = StereoModel.create(fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0,
                                baseline=BASELINE, device=dev)
    return model, config, stereo


def run_checks_and_paths(dev, report) -> None:
    """Phases 2 to 15 of the module docstring; raises on the first
    failure."""
    count_lk_calls()

    check_sgm_kernels(dev, report)
    check_sgm_v1_kernels(dev, report)
    check_corr_kernel(dev, report)
    check_corr_backward_kernel(dev, report)
    check_gather_kernel(dev, report)
    cc_serving = check_cc_kernel(dev, report)
    check_stats_kernel(dev, report, cc_serving)
    check_fused_kernel(dev, report)
    check_gauss_newton_kernel(dev, report)
    check_ransac_kernel(dev, report)
    check_raft_lookup(dev, report)
    for r in report.values():
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
            f"ms {r['ms']:.4f} (on the device {r['device_ms']:.4f}) "
            f"plain_ms {r['plain_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")

    model, config, stereo = serving_setup(dev)
    fcfg = config.flownet
    frames = make_frames()
    run_frames(model, config, stereo, frames[:2], dev)  # warm-up

    # The main path: default backends, every kernel but the fused construct.
    from moving_object_detector_tpu_torch.ops import sgm

    plain_census, plain_census_calls = sgm.census_transform, []
    sgm.census_transform = lambda *a, **k: (plain_census_calls.append(1)
                                            or plain_census(*a, **k))
    reset_counts()
    main_per_frame = {"cc": [], "ransac_gn": [], "gauss_newton": [],
                      "lk_track": []}
    try:
        outs, step_ms = run_frames(model, config, stereo, frames, dev,
                                   per_frame=main_per_frame)
    finally:
        sgm.census_transform = plain_census
    launches = read_counts()
    log("launches on the main path: " + json.dumps(launches)
        + "; per frame " + json.dumps(main_per_frame))
    check_gauss_newton_per_frame(main_per_frame, "the default path")
    if launches.pop("sceneflow_fused") != 0:
        raise AssertionError("the default path launched the fused construct")
    if launches.pop("corr_backward") != 0:
        raise AssertionError("serving launched the correlation backward")
    if launches.pop("gauss_newton") != 0:
        raise AssertionError("the default path launched gauss_newton: "
                             "ransac_gn runs the RANSAC's solves")
    report["gauss_newton"]["launches"] = 0  # off the serving path
    for name in V1_ONLY_KERNELS:
        if launches.pop(name) != 0:
            raise AssertionError(f"the default path launched {name}")
    per_frame = {"sgm1_census": 1, "sgm_vertical": 1, "sgm_horizontal": 1,
                 "sgm_wta": 1, "corr": len(CORR_LEVELS)}
    for name, k in per_frame.items():
        if launches[name] != k * len(frames):
            raise AssertionError(
                f"the default path launched {name} {launches[name]} times "
                f"over {len(frames)} frames, expected {k} a frame")
    if plain_census_calls:
        raise AssertionError(
            f"the default path called the plain census_transform "
            f"{len(plain_census_calls)} times")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
        report[name]["launches"] = n
    busy = sum(int(o.detections.valid.any()) for o in outs)
    for name in ("gather", "cc", "cluster_stats"):
        floor = len(frames) if name == "gather" else busy
        if launches[name] < floor:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"under once a frame ({floor})")
    check_outputs(outs, frames, lambda o: o.capacity)
    check_flow_graph(model, config, *(torch.from_numpy(f[0]).to(dev)
                                      for f in frames[:2]), "serving")
    dets = [int(o.detections.valid.sum()) for o in outs]
    tracks = [int(o.tracked.objects.valid.sum()) for o in outs]
    med = statistics.median(step_ms[1:])
    log(f"detect_step {H}x{W} pwc_v7 flow/2 sgm/2, windowed gather, CC and "
        f"stats kernels: median {med:.2f} ms/frame"
        f" = {1e3 / med:.2f} pairs/s over {len(step_ms) - 1} frames; "
        f"all ms {[round(t, 2) for t in step_ms]}")
    log(f"detections per frame {dets}; published tracks {tracks}")
    log(f"matched pixels outside the gather window over {len(outs)} frames: "
        f"{matches_outside_window(outs, config.scene_flow)}")

    with synchronized_stages(dev) as rec:
        run_frames(model, config, stereo, frames, dev)
    log("per-stage ms/frame (synchronized): " + json.dumps(
        {k: round(v / len(frames), 3)
         for k, v in synchronized_stage_ms(rec).items()}))

    # The same frames with the plain gather, CC and stats: identical
    # detections (SGM and correlation keep their kernels, so disparity and
    # flow are the same in both runs).
    plain_scene = config.replace(
        scene_flow=dataclasses.replace(config.scene_flow,
                                       gather_backend="xla"),
        clusterer=dataclasses.replace(config.clusterer, cc_backend="xla"))
    reset_counts()
    scene_outs, scene_ms = run_frames(model, plain_scene, stereo, frames, dev)
    counts = read_counts()
    for name in ("gather", "cc", "cluster_stats", "sceneflow_fused"):
        if counts[name] != 0:
            raise AssertionError(f"the plain scene run launched {name}")
    same_flow = all(torch.equal(a.flow, b.flow)
                    for a, b in zip(outs, scene_outs))
    log(f"flow bit-identical between the two runs: {same_flow}")
    compare_detections(outs, scene_outs, "kernel vs plain gather/CC/stats",
                       atol=0.0)
    log(f"plain gather/CC/stats: detections, label images and overflow "
        f"identical on {len(frames)} frames; median "
        f"{statistics.median(scene_ms[1:]):.2f} ms/frame")

    # Every kernel in its plain form, 6 frames (the plain SGM is slow).
    plain = plain_scene.replace(
        sgm=dataclasses.replace(config.sgm, backend="xla"),
        flownet=dataclasses.replace(fcfg, corr_backend="xla"))
    n_plain = len(frames[:6])
    reset_counts()
    with plain_gauss_newton():
        plain_outs, plain_ms = run_frames(model, plain, stereo,
                                          frames[:n_plain], dev)
    if any(read_counts().values()):
        raise AssertionError(f"the plain path launched kernels: "
                             f"{read_counts()}")
    flow_err = []
    for a, b in zip(outs, plain_outs):
        if not torch.equal(a.disparity.disparity, b.disparity.disparity):
            raise AssertionError("kernel and plain disparity differ")
        flow_err.append((a.flow - b.flow).abs())
    mean_err = max(float(e.mean()) for e in flow_err)
    max_err = max(float(e.max()) for e in flow_err)
    plain_dets = [int(o.detections.valid.sum()) for o in plain_outs]
    log(f"plain path ({n_plain} frames): disparity identical; flow mean "
        f"|diff| {mean_err:.3g} px (tolerance {TOL_FLOW_MEAN}), max "
        f"{max_err:.3g} px; detections per frame {plain_dets}; plain "
        f"median {statistics.median(plain_ms[1:]):.2f} ms/frame")
    if not mean_err <= TOL_FLOW_MEAN:
        raise AssertionError(f"flow kernel vs plain mean diff {mean_err}")
    if plain_dets != dets[:n_plain]:
        raise AssertionError(f"plain path detections {plain_dets} != "
                             f"{dets[:n_plain]}")

    # Two moving patches too far apart for one crop window.
    frames2 = make_frames(4, second_patch=True)
    reset_counts()
    cc_per_frame2 = []
    outs2, _ = run_frames(model, config, stereo, frames2, dev,
                          per_frame={"cc": cc_per_frame2})
    counts = read_counts()
    dets2 = [int(o.detections.valid.sum()) for o in outs2]
    log(f"two-window frames: launches {json.dumps(counts)}; cc launches "
        f"per frame {cc_per_frame2}; detections per frame {dets2}")
    for o in outs2[1:]:  # the first frame has no previous one
        xs = o.detections.center[o.detections.valid][:, 0]
        if not (bool((xs < 0).any()) and bool((xs > 0).any())):
            raise AssertionError("two-window frames: both patches were not "
                                 f"detected ({dets2})")
    if not (cc_per_frame2[1:] == [2] * (len(frames2) - 1)
            and counts["cluster_stats"] == counts["cc"]):
        raise AssertionError(
            f"two-window frames: cc launches per frame {cc_per_frame2}, "
            f"cluster_stats {counts['cluster_stats']}: expected two windows "
            "a frame after the first")
    scene2, _ = run_frames(model, plain_scene, stereo, frames2, dev)
    compare_detections(outs2, scene2, "two-window kernel vs plain", atol=0.0)

    # The fused construct in place of the composite scene flow.
    fused = config.replace(scene_flow=dataclasses.replace(
        config.scene_flow, gather_backend="fused"))
    n_fused = len(frames[:6])
    reset_counts()
    fused_outs, fused_ms = run_frames(model, fused, stereo, frames[:n_fused],
                                      dev)
    counts = read_counts()
    log("launches on the fused path: " + json.dumps(counts))
    if counts["sceneflow_fused"] != n_fused or counts["gather"] != 0:
        raise AssertionError(
            f"fused path: sceneflow_fused {counts['sceneflow_fused']} "
            f"launches (expected {n_fused}), gather {counts['gather']} "
            "(expected 0)")
    report["sceneflow_fused"]["launches"] = counts["sceneflow_fused"]
    check_outputs(fused_outs, frames[:n_fused], lambda o: o.capacity)
    compare_detections(outs[:n_fused], fused_outs, "default vs fused path",
                       atol=1e-4)
    log(f"fused path: detections, label images and overflow equal to the "
        f"default path on {n_fused} frames (velocities within 1e-4); median "
        f"{statistics.median(fused_ms[1:]):.2f} ms/frame")

    run_clusterer_branches(model, config, stereo, frames, outs, plain_scene,
                           dev)
    check_serving_gauss_newton(model, config, stereo, frames, dev)
    run_lk_fallback(model, config, stereo, frames[:4], dev)
    profile_frames(model, config, stereo, frames[:3], dev, med,
                   "the serving backends", ego=True)
    profile_frames(model, plain_scene, stereo, frames[:3], dev,
                   statistics.median(scene_ms[1:]),
                   "the plain gather, CC and stats")

    run_v1_runner_path(model, config, stereo, frames, outs, med, dev, report)
    run_cli(frames)
    run_cli_sources(frames)
    run_gnn(model, config, stereo, frames[:6], outs[:6], dev)
    run_quality(model, dev)
    run_scene_matrix(model, dev)
    run_dashboard(model, config, stereo, dev)
    run_streams(model, config, stereo, dev)
    run_spatial(model, config, stereo, dev)
    run_spatial_nccl(model, config, stereo, dev)
    run_alg(dev)
    run_training(model, config, stereo, frames, dev, report)


def run_clusterer_branches(model, config, stereo, frames, outs, plain_scene,
                           dev) -> None:
    """The clusterer's full-frame branch and its quiet early-out at the
    serving point. With no crop window configured (``cc_crop_h`` /
    ``cc_crop_w`` 0) every busy frame takes the full frame: the same
    detections and label images as the crop window's run (the JAX
    package's crop is exact). Three moving patches spread wider than two
    windows take it under the serving crop too (one CC launch a frame,
    labels more than a window apart), and the quiet early-out follows
    busy frames once the patch stands still (no CC launch, no detection);
    both held to the plain gather, CC and stats on the same frames."""
    nocrop = config.replace(clusterer=dataclasses.replace(
        config.clusterer, cc_crop_h=0, cc_crop_w=0))
    reset_counts()
    full_outs, _ = run_frames(model, nocrop, stereo, frames, dev)
    counts = read_counts()
    compare_detections(outs, full_outs, "full frame (no crop) vs the crop "
                       "window", atol=TOL_FULL_FRAME)
    log(f"full-frame clusterer (cc_crop_h = cc_crop_w = 0), {len(frames)} "
        f"frames: detections and label images equal to the crop window's "
        f"(centres within {TOL_FULL_FRAME}); cc {counts['cc']}, "
        f"cluster_stats {counts['cluster_stats']} launches")

    wide = make_frames(4, second_patch=True, third_patch=True)
    cc_wide = []
    wide_outs, _ = run_frames(model, config, stereo, wide, dev,
                              per_frame={"cc": cc_wide})
    spans = []
    for o in wide_outs[1:]:
        cols = torch.nonzero((o.label_image >= 0).any(dim=0)).flatten()
        spans.append(int(cols.max() - cols.min()) + 1 if len(cols) else 0)
    dets = [int(o.detections.valid.sum()) for o in wide_outs]
    if cc_wide[1:] != [1] * (len(wide) - 1) or min(spans) <= CROP_W:
        raise AssertionError(f"three patches: cc launches {cc_wide}, "
                             f"labelled column spans {spans}: not the "
                             "full-frame branch")
    if min(dets[1:]) < 1:
        raise AssertionError(f"three patches: detections per frame {dets}")
    compare_detections(wide_outs, run_frames(model, plain_scene, stereo,
                                             wide, dev)[0],
                       "three patches kernel vs plain", atol=0.0)
    log(f"three patches, no two crop windows: the full-frame branch (cc "
        f"launches {cc_wide}, labelled columns spanning {spans} > "
        f"{CROP_W}), detections per frame {dets}, identical to the plain "
        "gather/CC/stats")

    still = make_frames(8, stop_at=3)
    cc_still = []
    still_outs, _ = run_frames(model, config, stereo, still, dev,
                               per_frame={"cc": cc_still})
    dets = [int(o.detections.valid.sum()) for o in still_outs]
    quiet = [k for k in range(4, len(still))
             if cc_still[k] == 0 and dets[k] == 0
             and not bool((still_outs[k].label_image >= 0).any())]
    if min(cc_still[1:4]) < 1 or not quiet:
        raise AssertionError(f"patch stopping at frame 3: cc launches "
                             f"{cc_still}, detections {dets}: no quiet "
                             "frame after the busy ones")
    compare_detections(still_outs, run_frames(model, plain_scene, stereo,
                                              still, dev)[0],
                       "quiet frames kernel vs plain", atol=0.0)
    log(f"patch standing still from frame 3: cc launches {cc_still}, "
        f"detections {dets}; quiet early-out on frames {quiet}; identical "
        "to the plain gather/CC/stats")


def check_serving_gauss_newton(model, config, stereo, frames, dev) -> None:
    """The RANSAC and Gauss-Newton kernels on the serving frames'
    correspondences: every ``_ransac_gn_solve`` call of a run over the
    frames is recorded and repeated with one draw of hypotheses, on the
    RANSAC kernel and on its plain version: the same success, the motion
    within TOL_GN_MOTION; and the hypotheses alone on the Gauss-Newton
    kernel within 1e-4 of the plain solve on the sound triples."""
    from gauss_newton_cases import sound
    from moving_object_detector_tpu_torch import egomotion
    from moving_object_detector_tpu_torch.ops import gauss_newton_cuda as gn

    recorded = []
    real = egomotion._ransac_gn_solve

    def record(pts3d, tracked, feat_valid, cam, generator, cfg,
               sample_idx=None):
        recorded.append((pts3d, tracked, feat_valid, cam, cfg))
        return real(pts3d, tracked, feat_valid, cam, generator, cfg,
                    sample_idx)

    egomotion._ransac_gn_solve = record
    try:
        run_frames(model, config, stereo, frames, dev)
    finally:
        egomotion._ransac_gn_solve = real
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    worst = worst_hyp = 0.0
    counts, n_sound = [], 0
    for pts3d, tracked, feat_valid, cam, cfg in recorded:
        n = pts3d.shape[0]
        idx = torch.multinomial(
            torch.clamp(feat_valid.float(), min=1e-20).expand(
                cfg.ransac_hypotheses, n), cfg.ransac_sample,
            replacement=False, generator=gen)
        kernel = real(pts3d, tracked, feat_valid, cam, None, cfg, idx)
        with plain_gauss_newton():
            plain = real(pts3d, tracked, feat_valid, cam, None, cfg, idx)
        if bool(kernel[1]) != bool(plain[1]):
            raise AssertionError(f"serving RANSAC: success {bool(kernel[1])}"
                                 f" on the kernel, {bool(plain[1])} plain")
        worst = max(worst, float((kernel[0] - plain[0]).abs().max()))
        counts.append((int(kernel[2]), int(plain[2])))
        args = (pts3d[idx], tracked[idx], torch.ones(idx.shape, device=dev),
                gn.camera_vector(cam), cfg.gn_iters_hypothesis)
        hk, hp = gn.solve_pose(*args), gn.solve_pose_plain(*args)
        keep = sound(*(x.cpu().numpy() for x in (hp,) + args[:3]),
                     cam=args[3].tolist())
        n_sound += int(keep.sum())
        if keep.any():
            diff = (hk - hp).abs().amax((1, 2)).cpu().numpy()
            worst_hyp = max(worst_hyp, float(diff[keep].max()))
    if not (worst <= TOL_GN_MOTION and worst_hyp <= 1e-4 and n_sound):
        raise AssertionError(f"serving RANSAC on the kernels: motion "
                             f"{worst}, {n_sound} sound hypotheses "
                             f"{worst_hyp} from plain")
    log(f"RANSAC kernel on the serving frames' {len(recorded)} calls: "
        f"success equal, motion max |diff| {worst:.3g} (tolerance "
        f"{TOL_GN_MOTION}), inlier counts kernel/plain {counts}; "
        f"the GN kernel on their {n_sound} sound hypotheses within "
        f"{worst_hyp:.3g}")


def run_lk_fallback(model, config, stereo, frames, dev) -> None:
    """The LK fallback at serving size, forced on every frame by a
    fallback fraction above 1: two RANSAC launches, no Gauss-Newton launch
    and one LK tracking call a frame, the motion within TOL_GN_MOTION of
    the same frames with the plain RANSAC."""
    forced = config.replace(egomotion=dataclasses.replace(
        config.egomotion, lk_fallback_frac=1.01))
    reset_counts()
    per_frame = {"ransac_gn": [], "gauss_newton": [], "lk_track": []}
    with synchronized_stages(dev) as rec:
        outs, _ = run_frames(model, forced, stereo, frames, dev,
                             per_frame=per_frame)
    stage_ms = synchronized_stage_ms(rec)
    n = len(frames)
    if per_frame != {"ransac_gn": [2] * n, "gauss_newton": [0] * n,
                     "lk_track": [1] * n}:
        raise AssertionError(f"forced LK fallback: per frame "
                             f"{json.dumps(per_frame)}, expected 1 LK call, "
                             f"2 ransac_gn and no gauss_newton launch")
    with plain_gauss_newton():
        plain, _ = run_frames(model, forced, stereo, frames, dev)
    worst = 0.0
    for k, (a, b) in enumerate(zip(outs, plain)):
        if bool(a.ego_success) != bool(b.ego_success):
            raise AssertionError(f"forced LK fallback: frame {k} ego "
                                 f"success differs from the plain RANSAC")
        worst = max(worst, float((a.motion - b.motion).abs().max()))
    if not worst <= TOL_GN_MOTION:
        raise AssertionError(f"forced LK fallback: motion {worst} from the "
                             f"plain RANSAC")
    log(f"forced LK fallback over {len(frames)} frames: 2 ransac_gn "
        f"launches and 1 LK call a frame, ego success "
        f"{[bool(o.ego_success) for o in outs]}, motion max |diff| from the "
        f"plain RANSAC {worst:.3g} (tolerance {TOL_GN_MOTION}); ego-motion "
        f"{stage_ms['egomotion'] / len(frames):.3f} ms/frame")


def profile_ego_motion(model, config, stereo, frames, dev):
    """Ego-motion alone on the serving frames' inputs (recorded from a run
    over the frames from a fresh state, then replayed one frame at a
    time): per frame, host ms (synchronized), kernel launches and device
    ms (profiler). Frame 0 has no previous frame and takes the LK
    fallback."""
    from torch.profiler import ProfilerActivity, profile

    from moving_object_detector_tpu_torch import pipeline

    calls = []
    real = pipeline.estimate_motion
    pipeline.estimate_motion = lambda *a, **k: (calls.append((a, k))
                                                or real(*a, **k))
    try:
        run_frames(model, config, stereo, frames, dev)
    finally:
        pipeline.estimate_motion = real
    ms, launches, busy = [], [], []
    for a, k in calls:
        sync(dev)
        t0 = time.perf_counter()
        real(*a, **k)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            real(*a, **k)
            sync(dev)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        launches.append(len(kernels))
        busy.append(sum(e.device_time for e in kernels) / 1e3)
    return ms, launches, busy


def run_v1_runner_path(model, config, stereo, frames, outs, loop_ms, dev,
                       report) -> None:
    """This slice's path: the port's ``PipelineRunner`` at full width with
    the v1 SGM kernels, over the frames fed as a sequence."""
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner

    class KeepOutputs(PipelineRunner):
        """A runner that also keeps each frame's FrameOutput."""

        def _harvest(self, index, t, out, *rest):
            self.outs.append(out)
            return super()._harvest(index, t, out, *rest)

    v1 = config.replace(sgm=dataclasses.replace(config.sgm,
                                                backend="pallas_v1"))
    sequence = [(left, right, 0.1 * k)
                for k, (left, right, _) in enumerate(frames)]
    n = len(frames)

    def through_runner():
        runner = KeepOutputs(v1, stereo, model, device=dev)
        runner.outs = []
        sync(dev)
        t0 = time.perf_counter()
        results = runner.run(sequence)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        t = runner.timer.samples
        per_frame = [1e3 * (a + b + c) for a, b, c in zip(
            t["ring_pop"], t["dispatch"], t["harvest"])]
        return runner, results, wall_ms, statistics.median(per_frame[1:])

    # In turns within this run, since the host's speed drifts: the
    # hand-driven loop, the runner twice, the loop again, all on v1.
    with synchronized_stages(dev) as rec:
        run_frames(model, v1, stereo, frames, dev)  # warm-up
    stage_ms = synchronized_stage_ms(rec)
    _, loop_a = run_frames(model, v1, stereo, frames, dev)
    reset_counts()
    runner, results, wall_ms, runner_a = through_runner()
    counts = read_counts()
    _, _, wall_b, runner_b = through_runner()
    _, loop_b = run_frames(model, v1, stereo, frames, dev)

    log("launches on the v1 runner path: " + json.dumps(counts))
    expected = {"sgm1_census": n, "sgm1_cost": n, "sgm1_aggregate": 2 * n,
                "sgm1_wta": n}
    for name, want in expected.items():
        if counts[name] != want:
            raise AssertionError(f"v1 runner path: {name} launched "
                                 f"{counts[name]} times, expected {want}")
        if name != "sgm1_census":  # its count is the default path's
            report[name]["launches"] = counts[name]
    for name in V2_SGM_KERNELS:
        if counts[name] != 0:
            raise AssertionError(f"v1 runner path launched {name}")
    if len(results) != n or len(runner.outs) != n:
        raise AssertionError(f"v1 runner path: {len(results)} results for "
                             f"{n} frames")
    for k, (a, b) in enumerate(zip(outs, runner.outs)):
        da, db = a.disparity.disparity, b.disparity.disparity
        if not torch.equal(da.view(torch.int32), db.view(torch.int32)):
            raise AssertionError(
                f"v1 and v2 disparity differ on frame {k}: "
                f"{int((da != db).sum())} pixels")
    check_outputs(runner.outs, frames, lambda o: o.capacity)
    compare_detections(outs, runner.outs, "default path vs v1 runner path",
                       atol=0.0)
    for r, o in zip(results, outs):
        if r.n_detections != int(o.detections.valid.sum()):
            raise AssertionError(f"runner result {r.index}: "
                                 f"{r.n_detections} detections")
    log(f"PipelineRunner {H}x{W} pwc_v7 flow/2 sgm/2 pallas_v1 over {n} "
        f"frames from the feeder thread and the ring: disparities bitwise "
        f"equal to the v2 path's and detections identical on all {n} "
        f"frames. Median ms/frame after the first, in turns: hand-driven "
        f"detect_step loop {statistics.median(loop_a[1:]):.2f}, runner "
        f"(ring pop + upload + detect_step + harvest) {runner_a:.2f}, "
        f"runner {runner_b:.2f}, loop {statistics.median(loop_b[1:]):.2f}; "
        f"the runner's whole runs {wall_ms / n:.2f} and {wall_b / n:.2f} "
        f"ms/frame wall; the loop on the v2 kernels read {loop_ms:.2f} "
        f"earlier in this run")
    log("runner report:\n" + runner.report())
    log("v1 per-stage ms/frame (synchronized): " + json.dumps(
        {k: round(v / n, 3) for k, v in stage_ms.items()}))


def run_main(argv, err=None) -> list:
    """``run.main(argv)`` in process: its parsed JSON lines; ``err``, a
    StringIO, receives its standard error."""
    from moving_object_detector_tpu_torch import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err or sys.stderr):
        rc = run.main(argv)
    if rc != 0:
        raise AssertionError(f"run.main({argv}) returned {rc}")
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


def run_cli(frames) -> None:
    """The CLI on the frames as a recorded sequence; save and resume."""
    n = len(frames)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "frames.npz")
        np.savez(npz, left=np.stack([f[0] for f in frames]),
                 right=np.stack([f[1] for f in frames]),
                 time=0.1 * np.arange(n))
        export = os.path.join(tmp, "export")
        base = ["--source", "npz", "--npz", npz, "--height", str(H),
                "--width", str(W), "--fx", str(FX), "--baseline",
                str(BASELINE), "--flow-input-scale", "2",
                "--sgm-input-scale", "2"]
        t0 = time.perf_counter()
        whole = run_main(base + ["--frames", str(n), "--export-dir", export,
                                 "--report"])
        wall = time.perf_counter() - t0
        if [r["frame"] for r in whole] != list(range(n)):
            raise AssertionError(f"CLI printed frames "
                                 f"{[r['frame'] for r in whole]}")
        hits = patch_hits(whole, frames)
        if hits < n // 2:
            raise AssertionError(f"CLI: the moving patch was detected on "
                                 f"{hits} of {n} frames")
        names = sorted(os.listdir(export))
        for index in range(0, n, 5):  # --export-every defaults to 5
            for kind in ("clusters.ppm", "flow.ppm", "static_flow.ppm",
                         "depth.ppm", "velocity.ppm", "markers.json"):
                if f"{index:06d}_{kind}" not in names:
                    raise AssertionError(f"CLI export lacks "
                                         f"{index:06d}_{kind}: {names}")
        log(f"CLI run.main --source npz: {n} JSON lines in {wall:.1f} s "
            f"(weights loaded, exports written), the patch detected on "
            f"{hits} frames, {len(names)} export files; detections per "
            f"frame {[len(r['detections']) for r in whole]}, tracks "
            f"{[len(r['tracks']) for r in whole]}")

        snap = os.path.join(tmp, "state.npz")
        first = run_main(base + ["--frames", str(n // 2), "--save-state",
                                 snap])
        second = run_main(base + ["--frames", str(n - n // 2),
                                  "--resume-state", snap])
        worst = compare_cli_runs(whole, first + second,
                                 "save + resume against the unbroken run")
        log(f"CLI save after {n // 2} frames + resume: ids, flags and times "
            f"equal to the unbroken {n}-frame run, centres and velocities "
            f"max |diff| {worst:.3g} (tolerance {TOL_CLI})")


def compare_cli_runs(runs_a, runs_b, what: str) -> float:
    """The JSON lines of two CLI runs: the same frames, flags, times and
    detection and track ids, centres and velocities within TOL_CLI; the
    largest difference."""
    worst = 0.0
    if len(runs_a) != len(runs_b):
        raise AssertionError(f"{what}: {len(runs_a)} and {len(runs_b)} "
                             "frames")
    for a, b in zip(runs_a, runs_b):
        same = (a["frame"] == b["frame"] and a["valid"] == b["valid"]
                and a["ego"] == b["ego"] and a["time"] == b["time"])
        for key in ("detections", "tracks"):
            same = same and ([o["id"] for o in a[key]]
                             == [o["id"] for o in b[key]])
            if same:
                for oa, ob in zip(a[key], b[key]):
                    for f in ("center", "velocity"):
                        worst = max(worst, max(
                            abs(p - q) for p, q in zip(oa[f], ob[f])))
        if not same:
            raise AssertionError(f"{what}: frame {a['frame']} differs")
    if not worst <= TOL_CLI:
        raise AssertionError(f"{what}: max |diff| {worst}")
    return worst


def patch_hits(runs, frames) -> int:
    """Frames of a CLI run whose detections hold the moving patch (its
    disparity PATCH_D, its centre column x + PATCH_W / 2; a crop about the
    centre keeps the camera-frame position)."""
    z_true = FX * BASELINE / PATCH_D
    hits = 0
    for r, (_, _, x) in zip(runs, frames):
        x_true = (x + PATCH_W / 2 - W / 2) * z_true / FX
        hits += any(abs(d["center"][2] - z_true) < 1.0
                    and abs(d["center"][0] - x_true) < 1.0
                    for d in r["detections"])
    return hits


def run_cli_sources(frames) -> None:
    """``--crop`` and ``--source kitti`` in process, each against the npz
    run of the same pixels: ``--crop`` of the full frames against frames
    cropped here about the centre, and a KITTI-layout directory of PNG
    pairs (``image_02/data``, ``image_03/data``) against its images read
    back into an npz. Both find the moving patch."""
    from moving_object_detector_tpu_torch.io import readers, viz
    from moving_object_detector_tpu_torch.ops.image import center_crop_offsets

    n = 6
    frames = frames[:n]
    ch, cw = CLI_CROP
    y0, x0 = center_crop_offsets(H, W, ch, cw)
    times = np.arange(n) / 10.0  # the KITTI reader's fixed rate, --fps 10
    with tempfile.TemporaryDirectory() as tmp:
        def npz(name, lefts, rights):
            path = os.path.join(tmp, name)
            np.savez(path, left=np.stack(lefts), right=np.stack(rights),
                     time=times)
            return path

        def args(h, w):
            return ["--height", str(h), "--width", str(w), "--fx", str(FX),
                    "--baseline", str(BASELINE), "--flow-input-scale", "2",
                    "--sgm-input-scale", "2", "--frames", str(n)]

        full = npz("full.npz", [f[0] for f in frames], [f[1] for f in frames])
        cut = npz("cut.npz", [f[0][y0:y0 + ch, x0:x0 + cw] for f in frames],
                  [f[1][y0:y0 + ch, x0:x0 + cw] for f in frames])
        crop = run_main(["--source", "npz", "--npz", full, "--crop"]
                        + args(ch, cw))
        ref = run_main(["--source", "npz", "--npz", cut] + args(ch, cw))
        worst = compare_cli_runs(crop, ref, "--crop against frames cropped "
                                 "before the CLI")
        crop_hits = patch_hits(crop, frames)

        dirs = [os.path.join(tmp, "kitti", cam, "data")
                for cam in ("image_02", "image_03")]
        for d in dirs:
            os.makedirs(d)
        for k, (left, right, _) in enumerate(frames):
            for d, img in zip(dirs, (left, right)):
                viz.write_png(os.path.join(d, f"{k:010d}.png"), img)
        back = [[readers.read_image(os.path.join(d, f"{k:010d}.png"))
                 for k in range(n)] for d in dirs]
        kitti = run_main(["--source", "kitti", "--left-dir", dirs[0],
                          "--right-dir", dirs[1], "--fps", "10"]
                         + args(H, W))
        ref = run_main(["--source", "npz", "--npz", npz("png.npz", *back)]
                       + args(H, W))
        worst = max(worst, compare_cli_runs(kitti, ref, "--source kitti "
                                            "against its PNGs as an npz"))
        kitti_hits = patch_hits(kitti, frames)
    if min(crop_hits, kitti_hits) < n // 2:
        raise AssertionError(f"the moving patch was detected on {crop_hits} "
                             f"(--crop) and {kitti_hits} (--source kitti) "
                             f"of {n} frames")
    log(f"CLI --crop to {ch}x{cw} and --source kitti (PNG pairs in the "
        f"KITTI raw layout), {n} frames each: equal to the npz runs of the "
        f"same pixels (max |diff| {worst:.3g}, tolerance {TOL_CLI}); the "
        f"patch detected on {crop_hits} and {kitti_hits} frames")


def run_gnn(model, config, stereo, frames, greedy_outs, dev) -> None:
    """The tracker's optimal assignment against the greedy one."""
    gnn = config.replace(tracker=dataclasses.replace(config.tracker,
                                                     association="gnn"))
    outs, ms = run_frames(model, gnn, stereo, frames, dev)
    worst = 0.0
    for k, (a, b) in enumerate(zip(greedy_outs, outs)):
        ta, tb = a.tracked.objects, b.tracked.objects
        if not (torch.equal(ta.valid, tb.valid) and torch.equal(ta.id, tb.id)):
            raise AssertionError(
                f"gnn: frame {k} published tracks {tb.id.tolist()} differ "
                f"from greedy {ta.id.tolist()}")
        worst = max(worst, float((ta.center - tb.center).abs().max()))
    if not worst <= 1e-4:
        raise AssertionError(f"gnn: track centres differ by {worst}")
    log(f"association='gnn' over {len(frames)} frames: the same track ids "
        f"as greedy, centres max |diff| {worst:.3g}; published tracks "
        f"{[int(o.tracked.objects.valid.sum()) for o in outs]}; median "
        f"{statistics.median(ms[1:]):.2f} ms/frame")



# The held-out-texture sequence of tests/test_real_sequence.py at its two
# settings: (name, height, width, fx, flow and SGM input scale).
QUALITY_RUNS = (("384x896 scale 2", 384, 896, 600.0, 2),
                ("192x448 scale 1", 192, 448, 300.0, 1))
# The JAX package's recorded quality values on this sequence, from the
# comments of tests/test_real_sequence.py (quality, not speed), by scale.
VEL_RECORDED = "0.593-0.606 (TPU), 0.706 (CPU), pwc_v6m3"
JAX_RECORDED = {
    2: {"d1": 0.016, "flow_epe": 1.78, "flow_fl": 0.130,
        "ego_rot_err_deg": "<= 0.17", "ego_trans_err_m": "<= 0.063",
        "vel_err_median": VEL_RECORDED},
    1: {"d1": 0.013, "flow_epe": 1.05, "flow_fl": 0.070,
        "ego_rot_err_deg": "<= 0.17", "ego_trans_err_m": "<= 0.063",
        "vel_err_median": VEL_RECORDED},
}
# Kernels of the default path and their launches a frame.
DEFAULT_PATH_KERNELS = {"sgm1_census": 1, "sgm_vertical": 1,
                        "sgm_horizontal": 1, "sgm_wta": 1,
                        "corr": len(CORR_LEVELS), "gather": 1}


def heldout_sequence(h, w, fx):
    """tests/test_real_sequence.py's sequence (two objects, a translating
    and yawing camera, 7 frames), its frames rendered once."""
    import functools

    from moving_object_detector_tpu_torch.io.scenes import (
        PlanarSceneSequence,
        PlaneObject,
    )

    data = np.load(os.path.join(ROOT, "tests", "fixtures",
                                "real_textures.npz"))
    tex = {k: data[k].astype(np.float32) / 255.0
           for k in data.files if k.startswith("heldout_")}
    seq = PlanarSceneSequence(
        h, w, fx=fx, bg_depth=12.0, bg_texture=tex["heldout_camera"],
        objects=[
            PlaneObject(center0=(-1.2, -0.75, 6.0), size=(2.0, 1.28),
                        velocity=(2.0, 0.0, 0.0),
                        texture=tex["heldout_blade"]),
            PlaneObject(center0=(0.55, 0.5, 6.5), size=(1.7, 1.1),
                        velocity=(0.2, 0.0, -4.0),
                        texture=tex["heldout_freedom"]),
        ],
        cam_velocity=(0.5, 0.0, 0.3), yaw_rate=np.deg2rad(1.5),
        fps=10.0, n_frames=7)
    seq.frame = functools.lru_cache(maxsize=None)(seq.frame)
    return seq


def quality_gates(m, scale) -> list:
    """(gate, value, limit, passed) for every gate of
    tests/test_real_sequence.py: ``_common_gates`` and the flow gates of
    the run at this scale."""
    frames = m["detail_frames"]
    persistent, prev_px = 0, []
    for df in frames:  # a phantom within 60 px (L1) of the last frame's
        cur_px = [ph["px"] for ph in df["phantoms"] if ph["px"]]
        persistent += sum(any(abs(p[0] - q[0]) + abs(p[1] - q[1]) <= 60.0
                              for q in prev_px) for p in cur_px)
        prev_px = cur_px
    lateral = [df["matched"][0] for df in frames]
    approach = [df["matched"][1] for df in frames if len(df["matched"]) > 1]
    epe_max, fl_max = (2.6, 0.19) if scale == 2 else (1.8, 0.13)
    gates = [
        ("d1", m["d1"], "< 0.04", m["d1"] < 0.04),
        ("d1_density", m["d1_density"], "> 0.85", m["d1_density"] > 0.85),
        ("ego_rot_err_deg", m["ego_rot_err_deg"], "< 0.35",
         m["ego_rot_err_deg"] < 0.35),
        ("ego_trans_err_m", m["ego_trans_err_m"], "< 0.13",
         m["ego_trans_err_m"] < 0.13),
        ("ego_failures", m["ego_failures"], "== 0", m["ego_failures"] == 0),
        ("phantoms", m["phantoms"], "<= 1", m["phantoms"] <= 1),
        ("persistent_phantoms", persistent, "== 0", persistent == 0),
        ("lateral_hits", sum(lateral), f">= {len(lateral) - 1}",
         sum(lateral) >= len(lateral) - 1),
        ("approach_hits_of_last_3", sum(approach[-3:]), ">= 2",
         sum(approach[-3:]) >= 2),
        ("vel_err_median", m["vel_err_median"], "< 0.85",
         m["vel_err_median"] < 0.85),
        ("center_err_median", m["center_err_median"], "< 0.25",
         m["center_err_median"] < 0.25),
        ("flow_epe", m["flow_epe"], f"< {epe_max}", m["flow_epe"] < epe_max),
        ("flow_fl", m["flow_fl"], f"< {fl_max}", m["flow_fl"] < fl_max),
    ]
    return gates


@contextlib.contextmanager
def counts_per_step(record: list):
    """Append each ``detect_step`` call's kernel launches (and LK tracking
    calls) to ``record``; callers that import ``detect_step`` at call time
    (``eval``, the runner) get the counting one."""
    from moving_object_detector_tpu_torch import pipeline

    real = pipeline.detect_step

    def counted(*args, **kwargs):
        before = dict(read_counts(), lk_track=LK_CALLS[0])
        result = real(*args, **kwargs)
        after = dict(read_counts(), lk_track=LK_CALLS[0])
        record.append({k: after[k] - before[k] for k in after})
        return result

    pipeline.detect_step = counted
    try:
        yield
    finally:
        pipeline.detect_step = real


def check_default_path_per_frame(per_frame, what: str,
                                 every_frame_busy: bool = True) -> None:
    """Every default-path kernel on every frame: the census pair, the
    three SGM v2 kernels, the correlation's levels and the gather at their
    counts, the RANSAC kernel once (twice with the LK fallback) and the
    Gauss-Newton kernel never, CC and stats at least once on every frame
    that has a previous one (the first frame has no velocities, so nothing
    to cluster; without ``every_frame_busy``, on some frame: a frame with
    no dynamic pixel takes the quiet early-out); no v1-only kernel and no
    fused construct."""
    for k, c in enumerate(per_frame):
        want = dict(DEFAULT_PATH_KERNELS, gauss_newton=0,
                    ransac_gn=2 if c["lk_track"] else 1)
        bad = {n: c[n] for n, v in want.items() if c[n] != v}
        bad.update({n: c[n] for n in V1_ONLY_KERNELS + ("sceneflow_fused",)
                    if c[n]})
        if k and every_frame_busy:
            bad.update({n: c[n] for n in ("cc", "cluster_stats")
                        if c[n] < 1})
        if bad:
            raise AssertionError(f"{what}: frame {k} launched {bad}")
    for n in ("cc", "cluster_stats"):
        if not sum(c[n] for c in per_frame):
            raise AssertionError(f"{what}: {n} never launched")


def run_quality(model, dev) -> None:
    """The quality gates of tests/test_real_sequence.py on the card: the
    held-out-texture sequence through ``eval.evaluate_planar_sequence`` at
    the serving setting and at scale 1 (pwc_v7, the default weights, which
    must be scale-2 gated), every default-path kernel launched on every
    frame of the serving run; then the serving run's oracle budget."""
    from moving_object_detector_tpu_torch.eval import (
        evaluate_planar_sequence,
    )
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        default_flow_checkpoint,
        flow_checkpoint_scale2_gated,
    )

    ckpt = default_flow_checkpoint()
    if os.path.basename(ckpt) != "pwc_v7.fp16.npz":
        raise AssertionError(f"the default weights are {ckpt}, not pwc_v7")
    if not flow_checkpoint_scale2_gated(ckpt):
        raise AssertionError(f"{ckpt} is not scale-2 gated")
    failed = []
    for name, h, w, fx, scale in QUALITY_RUNS:
        seq = heldout_sequence(h, w, fx)
        for k in range(seq.n_frames):
            seq.frame(k)  # render outside the timed run
        per_frame = []
        reset_counts()
        t0 = time.perf_counter()
        with counts_per_step(per_frame):
            m = evaluate_planar_sequence(
                seq, model, flow_input_scale=scale, sgm_input_scale=scale,
                details=True, device=dev)
        wall = time.perf_counter() - t0
        if len(per_frame) != seq.n_frames:
            raise AssertionError(f"quality {name}: {len(per_frame)} steps")
        check_default_path_per_frame(per_frame, f"quality {name}")
        gates = quality_gates(m, scale)
        metrics = {k: {"port": v, "jax_recorded": JAX_RECORDED[scale].get(k)}
                   for k, v in m.items() if k != "detail_frames"}
        print(json.dumps({
            "quality": name, "device": torch.cuda.get_device_name(dev),
            "weights": os.path.basename(ckpt), "metrics": metrics,
            "gates": {g: {"value": v, "limit": lim, "pass": ok}
                      for g, v, lim, ok in gates},
            "launches_per_frame": {
                n: [c[n] for c in per_frame]
                for n in list(DEFAULT_PATH_KERNELS)
                + ["cc", "cluster_stats", "ransac_gn", "gauss_newton",
                   "lk_track"]},
            "wall_s": round(wall, 3)}), flush=True)
        failed += [f"{name}: {g} = {v} (limit {lim})"
                   for g, v, lim, ok in gates if not ok]
        if scale == 2:
            budget = {"flow net + SGM": m["vel_err_median"]}
            for fo, do, label in ((True, False, "flow oracle"),
                                  (False, True, "disparity oracle"),
                                  (True, True, "both oracles")):
                budget[label] = evaluate_planar_sequence(
                    seq, model, flow_input_scale=scale,
                    sgm_input_scale=scale, flow_oracle=fo,
                    disparity_oracle=do, device=dev)["vel_err_median"]
            print(json.dumps({"oracle_budget": name,
                              "vel_err_median": budget}), flush=True)
    if failed:
        raise AssertionError("quality gates failed: " + "; ".join(failed))
    log("quality: every gate of tests/test_real_sequence.py passed at "
        + " and ".join(r[0] for r in QUALITY_RUNS))


# The scene matrix of scripts/validate_scene_matrix.py: (run, height,
# width, fx, flow and SGM input scale, gated). The JAX record is at scale
# 1; scale 2, the serving setting, is logged beside it.
SCENE_RUNS = (("192x448 scale 1", 192, 448, 300.0, 1, True),
              ("384x896 scale 2", 384, 896, 600.0, 2, False))


def run_scene_matrix(model, dev) -> None:
    """The six ``validation_scenes`` through ``eval.evaluate_planar_sequence``
    with pwc_v7 and the default backends at ``dynamic_disparity_rate`` 3.0,
    every default-path kernel launched on every frame, each scene held to
    ``scripts/validate_scene_matrix.py``'s gates (``tests/scene_gates.py``)
    at scale 1, or where the JAX package itself fails some of them
    (``scene_gates.JAX_FAILS``: approach, rotating_cam) to failing those
    and no other; scale 2 logged. One JSON line a scene."""
    from moving_object_detector_tpu_torch.eval import (
        evaluate_planar_sequence,
    )
    from moving_object_detector_tpu_torch.io.scenes import validation_scenes
    from scene_gates import (
        DISPARITY_RATE,
        JAX_FAILS,
        JAX_RECORD_VEL,
        SCENES,
        hit_fractions,
        matrix_verdict,
        scene_gates,
    )

    failed = []
    name_limit = card()
    for run, h, w, fx, scale, gated in SCENE_RUNS:
        scenes = validation_scenes(h=h, w=w, fx=fx)
        if tuple(scenes) != SCENES:
            raise AssertionError(f"validation_scenes: {tuple(scenes)}")
        for name, seq in scenes.items():
            for k in range(seq.n_frames):
                seq.frame(k)  # render outside the timed run
            per_frame = []
            reset_counts()
            t0 = time.perf_counter()
            with counts_per_step(per_frame):
                m = evaluate_planar_sequence(
                    seq, model, flow_input_scale=scale,
                    sgm_input_scale=scale,
                    dynamic_disparity_rate=DISPARITY_RATE, details=True,
                    device=dev)
            wall = time.perf_counter() - t0
            if len(per_frame) != seq.n_frames:
                raise AssertionError(f"scene {name} {run}: "
                                     f"{len(per_frame)} steps")
            check_default_path_per_frame(per_frame, f"scene {name} {run}",
                                         every_frame_busy=False)
            gates = scene_gates(name, m, len(seq.objects))
            print(json.dumps({
                "scene": name, "run": run, "gated": gated,
                "card": name_limit, "d1": m["d1"],
                "flow_epe": m["flow_epe"],
                "ego_rot_err_deg": m["ego_rot_err_deg"],
                "hits": hit_fractions(m, len(seq.objects)),
                "phantoms": m["phantoms"],
                "ego_failures": m["ego_failures"],
                "vel_err_median": m["vel_err_median"],
                "center_err_median": m["center_err_median"],
                "jax_record_vel_err_median": (JAX_RECORD_VEL.get(name)
                                              if scale == 1 else None),
                "jax_fails": sorted(JAX_FAILS.get(name, ())),
                "verdict": (matrix_verdict(name, gates) or "pass")
                if gated else "not gated",
                "gates": {g: {"value": v, "limit": lim, "pass": ok}
                          for g, v, lim, ok in gates},
                "wall_s": round(wall, 3)}), flush=True)
            if gated:
                failed += [f"{name} {run}: {v}"
                           for v in matrix_verdict(name, gates)]
    if failed:
        raise AssertionError("scene matrix gates failed: "
                             + "; ".join(failed))
    log("scene matrix at 192x448 scale 1 (vel < 0.6 m/s, disparity rate "
        f"{DISPARITY_RATE}): every gate of scripts/validate_scene_matrix.py "
        "passed, and where the JAX package fails some "
        f"({ {k: sorted(v) for k, v in JAX_FAILS.items()} }) the port fails "
        "those and no other")


def interactive_scene(h, w, fx, n_frames):
    """``run.py --source interactive``'s scene (one object, 110 x 70 px at
    6 m), not paced; ``columns`` receives each rendered left view's mean
    object column."""
    from moving_object_detector_tpu_torch.io.scenes import (
        InteractiveSceneSequence,
        PlaneObject,
        _procedural_texture,
    )

    class Recorded(InteractiveSceneSequence):
        def _cast(self, k, right):
            out = super()._cast(k, right)
            if not right:
                self.columns.append(float(np.nonzero(out[2] == 0)[1].mean()))
            return out

    seq = Recorded(
        h, w, fx=fx, baseline=BASELINE, bg_depth=12.0,
        objects=[PlaneObject(
            center0=(0.0, 0.0, 6.0), size=(110 * 6.0 / fx, 70 * 6.0 / fx),
            velocity=(0.0, 0.0, 0.0),
            texture=_procedural_texture(np.random.default_rng(5), 96, 128))],
        n_frames=n_frames, realtime=False)
    seq.columns = []
    return seq


def http(base, path, body=None):
    """GET (or POST ``body``) ``base + path``: the response's bytes."""
    import urllib.request

    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST")
    return urllib.request.urlopen(req, timeout=10).read()


def run_dashboard(model, config, stereo, dev) -> None:
    """``LiveDashboard`` on ``PipelineRunner`` over an interactive scene at
    the serving point: products served, a retune POSTed during frame 3's
    harvest applied from frame 5, a /sim command moving the object; the
    kernels each harvest launches (none: the dashboard reads the
    harvest's host copy, and its update runs with synchronizing CUDA
    calls made errors) and the launches a frame of whole runs, with and
    without the dashboard; then ``run.main`` with ``--source interactive
    --serve-port 0``."""
    from urllib.error import URLError

    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.io.dashboard import LiveDashboard
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner
    from torch.profiler import ProfilerActivity, profile

    n = 8
    speed = 0.5  # the retuned dynamic_speed, m/s

    class Probe(LiveDashboard):
        """POSTs a retune and a steering command from frame 3's harvest;
        its update may make no synchronizing CUDA call."""

        post_at = None

        def update(self, index, t, out, left, config, stereo):
            if index == self.post_at:
                base = f"http://127.0.0.1:{self.port}"
                http(base, "/tunables",
                     json.dumps({"dynamic_speed": speed}).encode())
                http(base, "/sim",
                     json.dumps({"obj_velocity": [[2.0, 0.0, 0.0]]}).encode())
            torch.cuda.set_sync_debug_mode("error")
            try:
                super().update(index, t, out, left, config, stereo)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    # Functional run: products, retune, steering.
    dash = Probe(0, host="127.0.0.1")
    dash.post_at = 3
    base = f"http://127.0.0.1:{dash.port}"
    try:
        seq = interactive_scene(H, W, FX, n)
        dash.set_sim_handler(seq.command)
        # A ring of one, blocking: the feeder renders at most two frames
        # ahead, so the object moves in the frames after the command.
        runner = PipelineRunner(config, stereo, model, dashboard=dash,
                                ring_capacity=1, device=dev)
        used = []
        real = pipeline.detect_step

        def spy(*args, tunables=None, **kwargs):
            used.append(tunables)
            return real(*args, tunables=tunables, **kwargs)

        pipeline.detect_step = spy
        try:
            results = runner.run(seq)
        finally:
            pipeline.detect_step = real
        page = http(base, "/")
        status = json.loads(http(base, "/status.json"))
        pngs = {p: http(base, f"/view/{p}.png") for p in dash.PRODUCTS}
        view = json.loads(http(base, "/tunables.json"))
    finally:
        dash.close()
    speeds = [float(t.dynamic_speed) for t in used]
    want = [config.clusterer.dynamic_speed] * 5 + [speed] * (n - 5)
    cols = seq.columns
    if not (len(results) == n and status["frame"] == n - 1
            and b"moving_object_detector_tpu_torch" in page
            and all(b.startswith(b"\x89PNG") for b in pngs.values())):
        raise AssertionError(f"dashboard: {len(results)} results, status "
                             f"{status}, products "
                             f"{ {p: b[:4] for p, b in pngs.items()} }")
    if not np.allclose(speeds, want) or view["dynamic_speed"] != float(
            np.float32(speed)):
        raise AssertionError(f"dashboard retune: dynamic_speed per frame "
                             f"{speeds}, /tunables.json {view}")
    step = 2.0 / seq.fps * FX / 6.0  # px a frame at 2 m/s, 6 m away
    if not (len(set(cols[:5])) == 1 and cols[-1] > cols[4] + 0.5 * step
            and seq.state()["obj_pos"][0][0] > 0.3):
        raise AssertionError(f"dashboard /sim: object columns {cols}, "
                             f"state {seq.state()}")
    log(f"dashboard over the interactive scene at {H}x{W}: status frame "
        f"{status['frame']}, products "
        f"{ {p: len(b) for p, b in pngs.items()} } bytes, dynamic_speed per "
        f"frame {speeds}, object column per frame "
        f"{[round(c, 1) for c in cols]}")
    check_dashboard_overlays(model, config, stereo, dev, n)

    # Launches with and without the dashboard (every product wanted), on
    # the same frames: profiled whole runs, then each harvest profiled
    # alone (the device drained before it), then the stages' host ms
    # unprofiled, in turns.
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_events(prof):
        names = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        copies = collections.Counter(
            {k: v for k, v in names.items()
             if k.startswith(("Memcpy", "Memset"))})
        return names - copies, copies

    class HarvestProfiled(PipelineRunner):
        """Profiles each harvest (results, exports, dashboard) alone."""

        def _harvest(self, *args):
            sync(dev)
            with profile(activities=acts) as prof:
                result = super()._harvest(*args)
                sync(dev)
            self.windows.append(device_events(prof))
            return result

    def through_runner(with_dash: bool, mode=None):
        dash = Probe(0, host="127.0.0.1") if with_dash else None
        try:
            if dash is not None:
                for p in dash.PRODUCTS:  # a browser asks for every product
                    try:
                        http(f"http://127.0.0.1:{dash.port}", f"/view/{p}.png")
                    except URLError:
                        pass  # 404: not rendered yet
            cls = HarvestProfiled if mode == "harvest" else PipelineRunner
            runner = cls(config, stereo, model, dashboard=dash, device=dev)
            runner.windows = []
            frames = list(interactive_scene(H, W, FX, n))
            with (profile(activities=acts) if mode == "run"
                  else contextlib.nullcontext()) as prof:
                results = runner.run(frames)
        finally:
            if dash is not None:
                dash.close()
        seen = [(r.n_detections, r.n_tracks) for r in results]
        if mode == "run":
            kernels, copies = device_events(prof)
            return (sum(kernels.values()) / n, sum(copies.values()) / n,
                    seen)
        if mode == "harvest":
            return ([sum(k.values()) for k, _ in runner.windows],
                    [sum(c.values()) for _, c in runner.windows], seen)
        t = runner.timer.samples
        return (statistics.median(t["harvest"][1:]) * 1e3,
                statistics.median(t["dashboard"][1:]) * 1e3
                if with_dash else None)

    order = (False, True, True, False)
    whole = [through_runner(d, "run") for d in order]
    harvests = [through_runner(d, "harvest") for d in (False, True)]
    turns = [through_runner(d) for d in order]
    log("runner over the interactive scene, in turns without / with / with "
        "/ without the dashboard (every product wanted), whole runs "
        f"profiled: kernel launches a frame {[x[0] for x in whole]}, "
        f"copies a frame {[x[1] for x in whole]}, (detections, tracks) a "
        f"frame {[x[2] for x in whole]}")
    log("each harvest profiled alone, without / with the dashboard: kernel "
        f"launches {[x[0] for x in harvests]}, copies "
        f"{[x[1] for x in harvests]}")
    log("unprofiled, in turns: harvest median ms "
        f"{[round(x[0], 3) for x in turns]}, dashboard stage median ms "
        f"{[x[1] and round(x[1], 3) for x in turns]}")
    if any(any(x[0]) for x in harvests) or (
            dev.type == "cuda" and not all(x[0] for x in whole)):
        raise AssertionError(
            "a harvest launched kernels (or a profiled run saw none): "
            f"{harvests}, {whole}")

    # The CLI: an interactive scene with the dashboard, in process.
    err = io.StringIO()
    lines = run_main(["--source", "interactive", "--frames", "6",
                      "--serve-port", "0", "--serve-host", "127.0.0.1",
                      "--height", str(H), "--width", str(W), "--fx", str(FX),
                      "--flow-input-scale", "2", "--sgm-input-scale", "2"],
                     err=err)
    frames = [r["frame"] for r in lines]
    port = [line.rsplit(":", 1)[1].strip("/") for line in
            err.getvalue().splitlines() if "live dashboard" in line]
    if not (1 <= len(lines) <= 6 and frames == sorted(frames)
            and frames[0] == 0 and len(port) == 1):
        raise AssertionError(f"CLI --source interactive: frames {frames}, "
                             f"stderr {err.getvalue()[-500:]}")
    try:
        http(f"http://127.0.0.1:{port[0]}", "/status.json")
        raise AssertionError("CLI: the dashboard was left serving")
    except URLError:
        pass  # closed when run.main returned
    log(f"CLI run.main --source interactive --serve-port 0: frames "
        f"{frames} (a live ring drops stale frames), detections "
        f"{[len(r['detections']) for r in lines]}, dashboard on port "
        f"{port[0]} closed on return")


def check_dashboard_overlays(model, config, stereo, dev, n) -> None:
    """The interactive scene with its object moving at 2 m/s from the
    first frame through ``PipelineRunner`` with the dashboard (the camera
    product wanted throughout): its detections per frame equal the
    hand-driven loop's on the same frames, and ``_overlay_objects`` draws
    them into the camera product."""
    from moving_object_detector_tpu_torch.io import dashboard as dashmod
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner

    seq = interactive_scene(H, W, FX, n)
    seq.command(obj_velocity=[[2.0, 0.0, 0.0]])
    frames = list(seq)
    hand, _ = run_frames(model, config, stereo, frames, dev)
    drawn = []  # (color, objects valid, pixels changed) a call
    real = dashmod._overlay_objects

    def counted(img, objects, cam, color, **kwargs):
        before = img.copy()
        real(img, objects, cam, color, **kwargs)
        drawn.append((color, int(np.asarray(objects.valid).sum()),
                      int((img != before).any(axis=-1).sum())))

    dash = dashmod.LiveDashboard(0, host="127.0.0.1", demand_window=1e9)
    dashmod._overlay_objects = counted
    try:
        try:
            http(f"http://127.0.0.1:{dash.port}", "/view/camera.png")
        except OSError:
            pass  # 404 before the first frame: the product is wanted
        results = PipelineRunner(config, stereo, model, dashboard=dash,
                                 device=dev).run(frames)
        png = http(f"http://127.0.0.1:{dash.port}", "/view/camera.png")
    finally:
        dashmod._overlay_objects = real
        dash.close()
    runner_dets = [r.n_detections for r in results]
    hand_dets = [int(o.detections.valid.sum()) for o in hand]
    boxes = sum(px for color, _, px in drawn if color == (1.0, 0.2, 0.2))
    if runner_dets != hand_dets or not sum(hand_dets) or not boxes \
            or not png.startswith(b"\x89PNG"):
        raise AssertionError(f"dashboard overlays: runner detections "
                             f"{runner_dets}, hand-driven {hand_dets}, "
                             f"overlay calls {drawn}")
    log(f"dashboard overlays, the object moving at 2 m/s: detections per "
        f"frame {runner_dets} (the hand-driven loop's), {boxes} camera "
        f"pixels drawn for detections over {len(drawn)} overlay calls "
        f"(color, objects, pixels) {drawn}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def tree_equal(a, b) -> bool:
    """Bit for bit through dataclasses, NaN where NaN."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b) or (
            a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))
    if dataclasses.is_dataclass(a):
        return all(tree_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


# The step's products a stream must reproduce bit for bit.
STEP_FIELDS = ("disparity", "flow", "label_image", "detections",
               "odom_pose", "motion")
STREAMS = 4  # camera streams of the streams phase
SPATIAL_FRAMES = 12
# Striped against unsharded flow, median |diff| in px. With pwc_v7 the
# striping error is the reference's own (the coarsest level sees 64 net
# pixels, the halo 32, and a stripe pads to the pyramid stride otherwise
# than the image): tests/test_torch_spatial.py holds the port's equal to
# the JAX package's, and the spatial phase holds the ranks' flow bit for
# bit to the net run here on the same stripes. The 0.1 px of
# tests/test_spatial.py is for its three-level net; the serving point
# reads 0.17 to 0.19 px on an NVIDIA H100 80GB HBM3 at 700.00 W.
TOL_SPATIAL_FLOW = 0.25


def differing_fields(a, b) -> list:
    return [f for f in STEP_FIELDS
            if not tree_equal(getattr(a, f), getattr(b, f))]


def run_streams(model, config, stereo, dev) -> None:
    """``detect_step_streams_scan`` over STREAMS camera streams at the
    serving point, each with its own frames: every stream bit for bit
    equal to a single-stream run of its frames, each frame's launches
    the sum of the single-stream runs' (N x each default-path kernel);
    ms per N-stream step and pairs/s; ``detect_step_batched`` refused on
    CUDA tensors."""
    from moving_object_detector_tpu_torch.parallel import streams

    if torch.backends.cudnn.benchmark:
        raise AssertionError("cudnn.benchmark would autotune between runs")
    frames = [make_frames(seed=100 + i) for i in range(STREAMS)]
    singles, single_counts, single_ms = [], [], []
    for i, f in enumerate(frames):
        record = []
        with counts_per_step(record):
            outs, ms = run_frames(model, config, stereo, f, dev)
        check_default_path_per_frame(record, f"stream {i} alone")
        if not any(int(o.detections.valid.sum()) for o in outs[1:]):
            raise AssertionError(f"stream {i} alone: the patch was never "
                                 "detected")
        singles.append(outs)
        single_counts.append(record)
        single_ms += ms[1:]

    states = streams.create_stream_states(config, STREAMS, device=dev)
    per_frame, step_ms, whole_equal = [], [], True
    for k in range(N_FRAMES):
        lefts = torch.stack([torch.from_numpy(f[k][0])
                             for f in frames]).to(dev)
        rights = torch.stack([torch.from_numpy(f[k][1])
                              for f in frames]).to(dev)
        ts = torch.full((STREAMS,), 0.1 * k, device=dev)
        before = dict(read_counts(), lk_track=LK_CALLS[0])
        sync(dev)
        t0 = time.perf_counter()
        states, out = streams.detect_step_streams_scan(
            model, states, lefts, rights, ts, stereo, config)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = dict(read_counts(), lk_track=LK_CALLS[0])
        counts = {n: after[n] - before[n] for n in after}
        per_frame.append(counts)
        for i, o in enumerate(streams.unstack_states(out)):
            bad = differing_fields(o, singles[i][k])
            if bad:
                raise AssertionError(f"streams: stream {i} frame {k}: {bad} "
                                     "differ from its single-stream run")
            whole_equal = whole_equal and tree_equal(o, singles[i][k])
        want = {n: sum(c[k][n] for c in single_counts) for n in counts}
        if counts != want:
            raise AssertionError(f"streams: frame {k} launched {counts}, "
                                 f"the single-stream runs {want}")
        for name, c in DEFAULT_PATH_KERNELS.items():
            if counts[name] != STREAMS * c:
                raise AssertionError(f"streams: frame {k} launched {name} "
                                     f"{counts[name]} times, not "
                                     f"{STREAMS} x {c}")
    try:
        streams.detect_step_batched(model, states, lefts, rights, ts,
                                    stereo, config)
        raise AssertionError("detect_step_batched ran on CUDA tensors")
    except RuntimeError as e:
        if "detect_step_streams_scan" not in str(e):
            raise
    med = statistics.median(step_ms[1:])
    launches = [sum(v for n, v in c.items() if n != "lk_track")
                for c in per_frame]
    log(f"streams ({card()}): detect_step_streams_scan, {STREAMS} streams "
        f"at {H}x{W} pwc_v7 scale 2/2, {N_FRAMES} frames each: every "
        f"stream's {', '.join(STEP_FIELDS)} bit for bit its single-stream "
        f"run's (whole step output too: {whole_equal}); median "
        f"{med:.2f} ms per {STREAMS}-stream step = "
        f"{STREAMS / med * 1e3:.2f} pairs/s (single-stream runs: median "
        f"{statistics.median(single_ms):.2f} ms/frame); hand-written "
        f"kernel launches a frame {launches}, per kernel frame 1 "
        f"{json.dumps(per_frame[1])}; all ms "
        f"{[round(t, 2) for t in step_ms]}; detect_step_batched refused "
        "CUDA tensors")


def spatial_rank(rank: int, init: str, outdir: str, device: str) -> None:
    """One rank of the spatial phase, a process of its own on ``device``
    (both ranks on the one card): gloo over a (data 1, model 2) mesh,
    ``detect_step_streams_spatial`` on the moving-patch frames; the
    outputs, launches and step ms go to ``outdir/spatial<rank>.npz``."""
    import torch.distributed as dist

    from moving_object_detector_tpu_torch.parallel import multihost
    from moving_object_detector_tpu_torch.parallel.mesh import create_mesh
    from moving_object_detector_tpu_torch.parallel.spatial import (
        detect_step_streams_spatial,
    )
    from moving_object_detector_tpu_torch.parallel.streams import (
        create_stream_states,
        unstack_states,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    multihost.initialize(init, 2, rank, backend="gloo")
    try:
        mesh = create_mesh(2, model_parallel=2)
        model, config, stereo = serving_setup(dev)
        states = create_stream_states(config, 1, device=dev)
        out, step_ms = collections.defaultdict(list), []
        reset_counts()
        for k, (left, right, _) in enumerate(make_frames(SPATIAL_FRAMES)):
            sync(dev)
            t0 = time.perf_counter()
            states, o = detect_step_streams_spatial(
                model, states, torch.from_numpy(left).to(dev)[None],
                torch.from_numpy(right).to(dev)[None],
                torch.full((1,), 0.1 * k, device=dev), stereo, config, mesh,
                sgm_halo=SGM_HALO, flow_halo=FLOW_HALO)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            (o,) = unstack_states(o)
            for name, x in (("disparity", o.disparity.disparity),
                            ("flow", o.flow), ("label", o.label_image),
                            ("valid", o.detections.valid),
                            ("center", o.detections.center),
                            ("velocity", o.detections.velocity),
                            ("motion", o.motion), ("pose", o.odom_pose)):
                out[name].append(x.cpu().numpy())
        np.savez(os.path.join(outdir, f"spatial{rank}.npz"),
                 counts=json.dumps(read_counts()), step_ms=step_ms,
                 **{k: np.stack(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def stripe(img: np.ndarray, r: int, halo: int) -> np.ndarray:
    """Rank ``r``'s rows of a two-rank split with ``halo`` rows on each
    side, the image's edge rows repeated beyond its border."""
    s = img.shape[0] // 2
    return np.pad(img, ((halo, halo), (0, 0)), mode="edge")[
        r * s:r * s + s + 2 * halo]


def run_spatial(model, config, stereo, dev) -> None:
    """Two ranks on the one card (gloo, the halo and gather buffers staged
    through host memory), each running ``detect_step_streams_spatial``
    at the serving point with bench.py's halos: both ranks' outputs bit
    for bit equal; the gathered disparity bit for bit the plain SGM of
    each rank's stripe, cropped and stacked here, and the gathered flow
    bit for bit the net run here on the same stripes; the disparity
    against the unsharded full-resolution ``compute_disparity`` with
    ``tests/test_spatial.py``'s thresholds, the flow against the
    unsharded ``_flow_forward`` at scale 2; the patch detected; the
    census, SGM v2 and correlation kernels launched on each rank."""
    import torch.multiprocessing as mp

    from moving_object_detector_tpu_torch.ops.sgm import (
        compute_disparity,
        sgm_disparity_raw,
    )
    from moving_object_detector_tpu_torch.pipeline import _flow_forward

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(spatial_rank, args=("file://" + os.path.join(tmp, "store"),
                                     tmp, str(dev)), nprocs=2, join=True)
        wall = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"spatial{r}.npz")))
                 for r in range(2)]
    for key in ("disparity", "flow", "label", "valid", "center",
                "velocity", "motion", "pose"):
        if not np.array_equal(ranks[0][key], ranks[1][key], equal_nan=True):
            raise AssertionError(f"spatial: the two ranks' {key} differ")
    plain_sgm = dataclasses.replace(config.sgm, backend="xla")
    s = H // 2

    def striped(fn, a, b, halo):
        """fn on each rank's stripe pair, cropped and stacked."""
        return np.concatenate([fn(
            *(torch.from_numpy(stripe(x, r, halo)).to(dev) for x in (a, b))
        )[halo:halo + s].cpu().numpy() for r in range(2)])

    frames = make_frames(SPATIAL_FRAMES)
    agree, flow_med, patch_med = [], [], []
    prev = np.zeros((H, W), np.float32)  # the state's blank first image
    for k, (left, right, x) in enumerate(frames):
        disp, flow = ranks[0]["disparity"][k], ranks[0]["flow"][k]
        want = striped(lambda a, b: sgm_disparity_raw(a, b, plain_sgm),
                       left, right, SGM_HALO)
        if not np.array_equal(disp, want, equal_nan=True):
            raise AssertionError(f"spatial: frame {k} disparity is not the "
                                 "plain SGM of the stripes")
        want = striped(lambda a, b: _flow_forward(
            model, a, b, input_scale=config.flow_input_scale,
            corr_backend=config.flownet.corr_backend), prev, left, FLOW_HALO)
        if not np.array_equal(flow, want, equal_nan=True):
            raise AssertionError(f"spatial: frame {k} flow is not the net's "
                                 "on the stripes")
        lt, rt = (torch.from_numpy(v).to(dev) for v in (left, right))
        ref = compute_disparity(lt, rt, stereo, config.sgm).disparity
        ref = ref.cpu().numpy()
        both = (ref >= 0) & (disp >= 0)
        diff = np.abs(ref - disp)[both]
        agree.append(((ref >= 0).mean(), ((ref >= 0) == (disp >= 0)).mean(),
                      (diff <= 1.0).mean(), (diff == 0.0).mean()))
        if not (agree[-1][0] > 0.5 and agree[-1][1] > 0.97
                and agree[-1][2] > 0.98 and agree[-1][3] > 0.90):
            raise AssertionError(f"spatial: frame {k} disparity against the "
                                 f"unsharded SGM: {agree[-1]}")
        if k:  # frame 0's previous image is blank: no flow to compare
            ref_flow = _flow_forward(
                model, torch.from_numpy(prev).to(dev), lt,
                input_scale=config.flow_input_scale,
                corr_backend=config.flownet.corr_backend).cpu().numpy()
            err = np.abs(flow - ref_flow)
            flow_med.append(float(np.median(err)))
            patch_med.append(float(np.median(
                err[PATCH_Y:PATCH_Y + PATCH_H, x:x + PATCH_W])))
            if not flow_med[-1] < TOL_SPATIAL_FLOW:
                raise AssertionError(f"spatial: frame {k} flow median "
                                     f"|diff| {flow_med[-1]} px")
        prev = left
    dets = ranks[0]["valid"].sum(axis=1).tolist()
    if not any(dets[1:]):
        raise AssertionError("spatial: the moving patch was never detected")
    check_flow_graph(model, config, *(
        torch.from_numpy(stripe(f[0], 0, FLOW_HALO)).to(dev)
        for f in frames[:2]), "the spatial stripe")
    counts = [json.loads(str(r["counts"])) for r in ranks]
    n = SPATIAL_FRAMES
    for r, c in enumerate(counts):
        want = {"sgm1_census": n, "sgm_vertical": n, "sgm_horizontal": n,
                "sgm_wta": n, "corr": len(CORR_LEVELS) * n, "gather": n}
        bad = {k: c[k] for k, v in want.items() if c[k] != v}
        if bad or c["ransac_gn"] < n or c["gauss_newton"]:
            raise AssertionError(f"spatial: rank {r} launched {c}")
    step_ms = [float(t) for t in ranks[0]["step_ms"]]
    log(f"spatial ({card()}): 2 gloo ranks on one card, (data 1, model 2), "
        f"{n} frames at {H}x{W} pwc_v7, halos SGM {SGM_HALO} / flow "
        f"{FLOW_HALO}: ranks bit for bit equal; disparity bit for bit the "
        f"plain SGM of the {SPATIAL_SGM_STRIPE[0]}x{SPATIAL_SGM_STRIPE[1]} "
        f"stripes and flow the net's on the {s + 2 * FLOW_HALO}x{W} stripes; "
        f"disparity against the unsharded full-resolution SGM (valid, "
        f"status agree, <= 1 px, exact) "
        f"{[tuple(round(float(v), 4) for v in a) for a in agree]}; flow "
        f"median |diff| against the unsharded scale-2 flow, frames 1 on, "
        f"whole image {[round(v, 4) for v in flow_med]} px, on the patch "
        f"{[round(v, 4) for v in patch_med]} px; detections per frame "
        f"{dets}; launches rank 0 {json.dumps(counts[0])}, rank 1 "
        f"{json.dumps(counts[1])}; step ms rank 0 (host-staged gloo "
        f"transport) median of frames 2 on "
        f"{statistics.median(step_ms[2:]):.2f}, all "
        f"{[round(t, 1) for t in step_ms]}; spawn to join {wall:.1f} s")


def run_spatial_nccl(model, config, stereo, dev) -> None:
    """``detect_step_streams_spatial`` over a world of one NCCL rank (this
    process; device tensors through the all-gather) with no halo, frame
    by frame bit for bit equal to ``detect_step`` fed the unsharded
    full-resolution SGM and the unsharded flow."""
    import socket

    import torch.distributed as dist

    from moving_object_detector_tpu_torch.ops.sgm import compute_disparity
    from moving_object_detector_tpu_torch.parallel import multihost
    from moving_object_detector_tpu_torch.parallel.mesh import create_mesh
    from moving_object_detector_tpu_torch.parallel.spatial import (
        detect_step_streams_spatial,
    )
    from moving_object_detector_tpu_torch.parallel.streams import (
        create_stream_states,
        unstack_states,
    )
    from moving_object_detector_tpu_torch.pipeline import (
        PipelineState,
        _flow_forward,
        detect_step,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = create_mesh(1, model_parallel=1)
        states = create_stream_states(config, 1, device=dev)
        ref_state = PipelineState.create(config, device=dev)
        for k, (left, right, _) in enumerate(make_frames(SPATIAL_FRAMES)):
            lt, rt = torch.from_numpy(left).to(dev), torch.from_numpy(
                right).to(dev)
            states, out = detect_step_streams_spatial(
                model, states, lt[None], rt[None],
                torch.full((1,), 0.1 * k, device=dev), stereo, config, mesh,
                sgm_halo=0, flow_halo=0)
            flow = _flow_forward(model, ref_state.prev_left, lt,
                                 input_scale=config.flow_input_scale,
                                 corr_backend=config.flownet.corr_backend)
            ref_state, ref = detect_step(
                model, ref_state, lt, rt, 0.1 * k, stereo, config,
                flow_override=flow,
                disparity_override=compute_disparity(lt, rt, stereo,
                                                     config.sgm))
            bad = differing_fields(unstack_states(out)[0], ref)
            if bad:
                raise AssertionError(f"spatial, one NCCL rank: frame {k} "
                                     f"{bad} differ from the unsharded step")
    finally:
        dist.destroy_process_group()
    log(f"spatial, one NCCL rank ({card()}): {SPATIAL_FRAMES} frames, "
        f"{', '.join(STEP_FIELDS)} bit for bit the unsharded step's")


def run_alg(dev) -> None:
    """The alg toolkit on the card against the same calls on the CPU: the
    13-channel ICF bank on a 376 x 1242 RGB frame, a kNN store of
    capacity 4096 (wrapped) queried 256 times, 1,000 online-boosting
    updates."""
    from moving_object_detector_tpu_torch.alg import (
        boosting,
        classifiers,
        icf,
    )

    cpu = torch.device("cpu")
    tex = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "real_textures.npz"))
    base = np.concatenate([tex["china"][:H], tex["flower"][:H]], axis=1)
    base = base[:, :W].astype(np.float32) / 255.0
    rgb = np.stack([base, np.roll(base, 300, 1), np.roll(base[::-1], 600, 1)],
                   axis=-1)
    bank = icf.default_channel_bank()
    got = bank(torch.from_numpy(rgb).to(dev)).cpu()
    ref = bank(torch.from_numpy(rgb))
    color_err = float((got[:6] - ref[:6]).abs().max())
    mag_err = float((got[12] - ref[12]).abs().max())
    # An orientation bin may flip only where the angle lies on a bin edge
    # to within what the Sobel sums' rounding can move it: they run in
    # another order on the card, and their f32 error (about 1e-6 on
    # values up to 8) turns an angle by up to 1e-6 / |g| radians, 2e-5 /
    # |g| bins with a margin of 10.
    dx, dy = icf._sobel(icf.rgb_to_gray(torch.from_numpy(rgb)))
    pos = torch.remainder(torch.atan2(dy, dx), 2 * np.pi) * (6 / np.pi)
    on_edge = (pos - pos.round()).abs() < 1e-4 + 2e-5 / torch.hypot(dx, dy)
    flips = (got[6:12].argmax(0) != ref[6:12].argmax(0)) & (ref[12] > 0)
    bin_flips = int(flips.sum())
    off_edge_flips = int((flips & ~on_edge).sum())
    same_bin = (got[6:12] > 0) == (ref[6:12] > 0)
    bin_err = float(((got[6:12] - ref[6:12]).abs() * same_bin).max())
    # Colour channels on [0, 255] to 1e-3 (pow, cube root, division in
    # another library); magnitudes and binned values to 1e-4.
    if not (color_err <= 1e-3 and mag_err <= 1e-4 and off_edge_flips == 0
            and bin_err <= 1e-4):
        raise AssertionError(f"icf bank on the card: colour {color_err}, "
                             f"magnitude {mag_err}, bin flips {bin_flips} "
                             f"({off_edge_flips} off an edge), binned "
                             f"{bin_err}")
    bank_ms = median_ms(lambda: bank(torch.from_numpy(rgb).to(dev)),
                        reps=10)

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5000, 16)).astype(np.float32)
    labels = (pts[:, 0] + 0.5 * pts[:, 1] > 0).astype(np.int32)
    sides = (("card", dev), ("cpu", cpu))
    stores = {}
    for side, d in sides:
        st = classifiers.knn_init(4096, 16, device=d)
        for p, lab in zip(torch.from_numpy(pts).to(d), labels):
            st = classifiers.knn_add(st, int(lab), p)
        stores[side] = st
    queries = torch.from_numpy(rng.normal(size=(256, 16)).astype(
        np.float32))
    worst, ties, votes = 0.0, 0, 0
    for q in queries:
        lg, sg = classifiers._knn_neighbors(stores["card"], q.to(dev), 6)
        lc, sc = classifiers._knn_neighbors(stores["cpu"], q, 6)
        worst = max(worst, float(((sg.cpu() - sc).abs() / sc).max()))
        if float(sc[5] - sc[4]) <= 1e-5 * float(sc[5]):
            ties += 1  # the 5th and 6th neighbours too close to order
            continue
        votes += 1
        if int(classifiers.knn_predict(stores["card"], q.to(dev))) != int(
                classifiers.knn_predict(stores["cpu"], q)):
            raise AssertionError("knn on the card votes otherwise")
    if not worst <= 1e-5:
        raise AssertionError(f"knn distances differ by {worst} (relative)")
    t0 = time.perf_counter()
    classifiers.knn_predict(stores["card"], queries[0].to(dev))
    sync(dev)
    knn_ms = (time.perf_counter() - t0) * 1e3

    # tests/test_alg.py's ensemble and classes (4 x 3 stumps, 2-D, means
    # +-1.5, sd 0.3), 1,000 updates. With overlapping classes the
    # reference's estimators collapse (lambda >= 1 sets a stump's gain
    # to 1 and its variance to 0), in both packages.
    signs = np.where(np.arange(1000) % 2 == 0, 1.0, -1.0).astype(np.float32)
    samples = (rng.normal(0, 0.3, size=(1000, 2))
               + 1.5 * signs[:, None]).astype(np.float32)
    ens = {}
    for side, d in sides:
        e = boosting.online_boosting_init(4, 3, 2, subset_size=2, seed=0,
                                          device=d)
        xs = torch.from_numpy(samples).to(d)
        sync(d)
        t0 = time.perf_counter()
        for x, lab in zip(xs, signs):
            e = boosting.online_boosting_update(e, float(lab), x)
        sync(d)
        ens[side] = (e, (time.perf_counter() - t0) * 1e3 / len(signs))
    probe_signs = torch.where(torch.arange(64) % 2 == 0, 1.0, -1.0)
    probe = (torch.from_numpy(rng.normal(0, 0.3, size=(64, 2)).astype(
        np.float32)) + 1.5 * probe_signs[:, None])
    conf_err, acc = 0.0, 0
    for i, q in enumerate(probe):
        cg = float(boosting.online_boosting_predict_real(ens["card"][0],
                                                         q.to(dev)))
        cc = float(boosting.online_boosting_predict_real(ens["cpu"][0], q))
        conf_err = max(conf_err, abs(cg - cc))
        acc += (cg > 0) == (i % 2 == 0)
        if (cg > 0) != (cc > 0):
            raise AssertionError("boosting on the card predicts otherwise")
    lam_err = max(float(((getattr(ens["card"][0], k).cpu()
                          - getattr(ens["cpu"][0], k)).abs()
                         / getattr(ens["cpu"][0], k)).max())
                  for k in ("lambda_corr", "lambda_wrong"))
    # 1,000 updates through recursive estimators whose exp and sqrt come
    # from another library: accumulators to 1e-3 relative, confidences to
    # 1e-3, every prediction's sign equal.
    if not (conf_err <= 1e-3 and lam_err <= 1e-3 and acc == len(probe)):
        raise AssertionError(f"boosting on the card: confidence {conf_err}, "
                             f"accumulators {lam_err} (relative)")
    log(f"alg ({card()}): ICF bank 13 x {H} x {W} {bank_ms:.3f} ms "
        f"(upload included), against the CPU colour max |diff| "
        f"{color_err:.3g}, magnitude {mag_err:.3g}, {bin_flips} orientation "
        f"bins flipped of {H * W} pixels (all on a bin edge), binned values "
        f"{bin_err:.3g}; kNN capacity 4096 after "
        f"5,000 adds: 256 queries, distances within {worst:.3g} relative, "
        f"{votes} votes equal ({ties} near ties skipped), one query "
        f"{knn_ms:.2f} ms; online boosting 4 x 3 stumps, 1,000 updates: "
        f"{ens['card'][1]:.2f} ms an update on the card, "
        f"{ens['cpu'][1]:.2f} on the CPU, confidences within "
        f"{conf_err:.3g}, accumulators {lam_err:.3g} relative, "
        f"{acc} of {len(probe)} probes right")


TRAIN_CHUNK = 25  # steps a chunk of the chunked trainer (two chunks)
TRAIN_TIMED_STEPS = 10  # synchronized steps timed one by one
TRAIN_CLI_STEPS = 20  # train_flow.main's run, two chunks
# One pwc_v7 step with the correlation kernels against the same step with
# the plain correlation under autograd, relative: the loss, and the
# gradient's global norm, which the bf16 net, cuDNN's backward and the
# warp's scatter-add backward (atomics) move from run to run.
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_NORM = 1e-2
QUALITY_EPE = 4.5  # tests/test_flow_quality.py's floor, px


def train_net(dev, corr_backend: str = "auto"):
    """pwc_v7 from the bundled weights, its correlation on
    ``corr_backend``."""
    from moving_object_detector_tpu_torch import config as cfgmod
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    model, _ = load_flow_checkpoint(
        os.path.join(ROOT, "weights", "pwc_v7.fp16.npz"),
        cfgmod.FlowNetConfig(corr_backend=corr_backend), device=dev)
    return model


def only_corr_launched(counts: dict, n: int, what: str) -> None:
    """``n`` launches of each correlation kernel and none of any other."""
    want = {k: (n if k in ("corr", "corr_backward") else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def run_training(model, config, stereo, frames, dev, report) -> None:
    """Phase 15: flow-net training of pwc_v7 at train_flow.py's defaults
    (192 x 448, batch 8, "auto" backends) from the bundled weights."""
    from torch.profiler import ProfilerActivity, profile

    from corr_grad_cases import TRAIN_BATCH, TRAIN_HW, TRAIN_LEVELS
    from moving_object_detector_tpu_torch.eval import flow_epe
    from moving_object_detector_tpu_torch.pipeline import _flow_forward
    from moving_object_detector_tpu_torch.train import (
        data_synth,
        flow_trainer,
        train_flow,
    )
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    (h, w), b = TRAIN_HW, TRAIN_BATCH
    n_corr = len(TRAIN_LEVELS)
    batch = data_synth.generate_batch(
        torch.Generator(device=dev).manual_seed(0), b, h, w)
    first = {}
    for backend in ("auto", "xla"):
        net = train_net(dev, backend)
        state, tx = flow_trainer.create_train_state(net)
        reset_counts()
        state, m = flow_trainer.train_step(net, tx, state, batch)
        sync(dev)
        first[backend] = (float(m["loss"]), float(m["grad_norm"]))
        only_corr_launched(read_counts(), n_corr if backend == "auto" else 0,
                           f"one train step, corr_backend {backend}")
    (lk, nk), (lp, np_) = first["auto"], first["xla"]
    loss_err, norm_err = abs(lk / lp - 1), abs(nk / np_ - 1)
    log(f"one pwc_v7 train step {h}x{w} batch {b}: kernels loss {lk:.7g} "
        f"grad norm {nk:.7g}, plain correlation loss {lp:.7g} grad norm "
        f"{np_:.7g}: relative {loss_err:.3g} (tolerance {TOL_TRAIN_LOSS}), "
        f"{norm_err:.3g} ({TOL_TRAIN_NORM})")
    if not (loss_err <= TOL_TRAIN_LOSS and norm_err <= TOL_TRAIN_NORM):
        raise AssertionError("the kernels' train step differs from the "
                             "plain one")

    # The main path: the chunked trainer, fresh scenes made on the card
    # from a pool of one, constant lr 1e-4; the second chunk with
    # synchronizing CUDA calls made errors.
    net = train_net(dev)
    state, tx = flow_trainer.create_train_state(net, learning_rate=1e-4)
    chunk_fn, state = flow_trainer.make_chunked_train_step(
        net, tx, state, h, w, b, TRAIN_CHUNK, pool=1)
    reset_counts()
    chunk_ms, chunk_loss = [], []
    for k in range(2):
        sync(dev)
        t0 = time.perf_counter()
        if k:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = chunk_fn(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        chunk_loss.append(float(m["loss"]))  # the chunk's one host read
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    only_corr_launched(launches, 2 * TRAIN_CHUNK * n_corr,
                       "the chunked trainer")
    report["corr_backward"]["launches"] = launches["corr_backward"]
    log(f"chunked trainer, 2 x {TRAIN_CHUNK} steps, pool 1: mean loss "
        f"{chunk_loss[0]:.5f} then {chunk_loss[1]:.5f}; chunk wall ms "
        f"{[round(t, 1) for t in chunk_ms]} (the second: no synchronizing "
        f"call); launches {json.dumps(launches)}")
    if not chunk_loss[1] < chunk_loss[0]:
        raise AssertionError(f"the second chunk's loss {chunk_loss[1]} is "
                             f"not below the first's {chunk_loss[0]}")

    # Steps one by one: wall ms, memory, and one profiled step.
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(TRAIN_TIMED_STEPS):
        sync(dev)
        t0 = time.perf_counter()
        state, m = flow_trainer.train_step(net, tx, state, batch)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = flow_trainer.train_step(net, tx, state, batch)
        sync(dev)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    corr_dev = {name: sum(e.device_time for e in kernels if name in e.name)
                / 1e3 for name in ("corr_kernel", "corr_bwd_kernel")}
    train = dict(card=card(), step_ms_median=med, step_ms=step_ms,
                 samples_per_s=b / med * 1e3,
                 chunk_step_ms=chunk_ms[1] / TRAIN_CHUNK,
                 launches_per_step=len(kernels),
                 corr_launches_per_step=n_corr,
                 corr_backward_launches_per_step=n_corr,
                 device_busy_ms=busy_ms, device_busy_share=busy_ms / med,
                 corr_device_ms=corr_dev["corr_kernel"],
                 corr_backward_device_ms=corr_dev["corr_bwd_kernel"],
                 max_memory_allocated_gb=peak_gb,
                 first_step_loss_rel_err=loss_err,
                 first_step_grad_norm_rel_err=norm_err,
                 chunk_mean_loss=chunk_loss)

    # The CLI in process from pwc_v7 to an .npz, then served.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained.npz")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = train_flow.main([
                "--steps", str(TRAIN_CLI_STEPS), "--chunk",
                str(TRAIN_CLI_STEPS // 2), "--height", str(h), "--width",
                str(w), "--batch", str(b), "--resume",
                os.path.join(ROOT, "weights", "pwc_v7.fp16.npz"),
                "--checkpoint", path])
        lines = out.getvalue().splitlines()
        if rc != 0 or len(lines) != 2 or not os.path.exists(path):
            raise AssertionError(f"train_flow.main returned {rc}: "
                                 f"{lines} {err.getvalue()[-2000:]}")
        trained, tcfg = load_flow_checkpoint(path, config.flownet,
                                             device=dev)
    outs, _ = run_frames(trained, config.replace(flownet=tcfg), stereo,
                         frames[:2], dev)
    if not all(bool(torch.isfinite(o.flow).all()) for o in outs):
        raise AssertionError("the trained weights serve a non-finite flow")
    log(f"train_flow.main {TRAIN_CLI_STEPS} steps: {lines}; its .npz "
        f"served 2 frames "
        f"through detect_step with finite flow")

    # The port's generator scored as tests/test_flow_quality.py does.
    quality = {}
    for hh, ww, scale in ((192, 448, 1), (384, 896, 2)):
        data = data_synth.generate_batch(
            torch.Generator(device=dev).manual_seed(0), 4, hh, ww)
        epes, zero = [], []
        for i in range(4):
            flow = _flow_forward(model, data["img1"][i, 0],
                                 data["img2"][i, 0], input_scale=scale)
            gt = data["flow"][i].permute(1, 2, 0).cpu().numpy()
            epes.append(flow_epe(flow.cpu().numpy(), gt)["epe"])
            zero.append(flow_epe(np.zeros_like(gt), gt)["epe"])
        epe, zero_epe = float(np.mean(epes)), float(np.mean(zero))
        quality[f"{hh}x{ww} scale {scale}"] = dict(epe=epe,
                                                   zero_flow_epe=zero_epe)
        if not (epe < QUALITY_EPE and epe < 0.5 * zero_epe):
            raise AssertionError(f"pwc_v7 on the port's scenes at {hh}x{ww}"
                                 f" scale {scale}: EPE {epe} (zero flow "
                                 f"{zero_epe})")
    train["quality"] = quality
    log("training: " + json.dumps(train))

if __name__ == "__main__":
    sys.exit(main())
