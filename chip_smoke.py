"""Smoke test and kernel report of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``moving_object_detector_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints the build seconds.
2. Holds each of the twelve kernels against its plain PyTorch version on
   the card, at the serving shapes and at an odd shape: the SGM deltas and
   disparity bitwise (v2; the WTA for every combination of ``subpixel``,
   ``lr_check`` and ``uniqueness_ratio``, also at a width below 128, at
   widths that are and are not a multiple of 4, on a constant pair and on
   random int8 volumes), the v1 census pair, cost volume, aggregated total
   and disparity bitwise, the correlation within 1e-5 for r = 1..4 and
   B = 1, 2 with two runs bit-identical, the windowed gather equal with
   NaN positions equal, the connected components exactly on six kinds of
   input (three runs each), the cluster stats exactly (min / max by
   value; a NaN member coordinate gives NaN), the fused scene-flow
   construct with exact NaN masks and values within 1e-5. Prints each
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
   one component, serpentine, dense).
3. Runs ``pipeline.detect_step`` at the KITTI serving point (376 x 1242,
   pwc_v7 weights, flow and SGM at half resolution, two-window clusterer
   crop, default backends: windowed gather, CC and cluster-stats kernels)
   on frames made from ``tests/fixtures/real_textures.npz``: a textured
   background in depth strips and a pasted patch moving 12 px a frame.
   Checks shapes, finiteness, the known strip disparities and the patch's
   flow, and that every kernel of this path launched on it: a frame, the
   census kernel once (both views), each SGM v2 kernel once, the
   correlation four times, the plain census never. Prints
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
   default path's detections.
6. Profiles three serving frames with torch.profiler: device busy time
   per frame, kernel launches per frame, the kernels with the most device
   time.
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
   the unbroken 12-frame run. Runs 6 frames with ``association="gnn"``
   and compares the tracks with the greedy run's.
9. Prints the card's name and power limit, a ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, before printing any result, without CUDA or without the
package beside it. Uses one card.
"""

from __future__ import annotations

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
CROP_H, CROP_W = 192, 512  # ClustererConfig.cc_crop_h / cc_crop_w
ODD_H, ODD_W = 125, 350
PLAIN_CC_ITERS = 1 << 14  # rounds enough for the plain fixpoint to converge
OPS_PER_EDGE_TEST = 6  # 2 loads, subtract, abs, 2 compares (CC)
OPS_PER_FUSED_PIXEL = 100  # about 60 f32 operations and 10 divisions


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the kernels' own time summed by
    torch.profiler over ``reps`` calls, without the host's launch path
    that ``median_ms`` includes. A profiler run that comes back without
    a kernel record is repeated, at most twice; after that the time is
    reported as not measured (NaN), since it is an extra beside ``ms``."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / reps
        log(f"device_ms: no kernel record in profiler run {attempt}")
    return float("nan")


def timed(kernel, plain) -> dict:
    """The three measured times of a kernel record."""
    return dict(ms=median_ms(kernel), device_ms=device_ms(kernel),
                plain_ms=median_ms(plain, reps=5, warmup=1))


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def make_frames(n_frames=N_FRAMES, second_patch=False):
    """(left, right) f32 pairs: strips of known disparity, a moving patch;
    with ``second_patch`` another one near the right border."""
    tex = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "real_textures.npz"))
    bg = np.concatenate([tex["china"][:H], tex["flower"][:H]], axis=1)
    bg = bg[:, :W].astype(np.float32) / 255.0
    patch = tex["hopper"][100:100 + PATCH_H,
                          100:100 + PATCH_W].astype(np.float32) / 255.0
    right_bg = np.empty_like(bg)
    for x0, x1, d in STRIPS:
        right_bg[:, x0:x1] = np.roll(bg, -d, axis=1)[:, x0:x1]
    frames = []
    patch2 = tex["hopper"][240:240 + PATCH_H,
                           300:300 + PATCH_W].astype(np.float32) / 255.0
    for k in range(n_frames):
        x = 360 + SHIFT * k
        left = bg.copy()
        right = right_bg.copy()
        pasted = [(patch, x, PATCH_D)]
        if second_patch:
            pasted.append((patch2, PATCH2_X + SHIFT * k, PATCH2_D))
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
    from moving_object_detector_tpu_torch.ops import sgm, sgm_cuda

    rng = np.random.default_rng(0)
    serving = None
    for h, w in ((H // 2, W // 2), (ODD_H, ODD_W)) + WTA_EDGE_SHAPES:
        left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                            device=dev)
        right = torch.roll(left, -9, 1) + 0.02 * torch.randn(
            h, w, device=dev)
        cl, cr = sgm.census_transform(left), sgm.census_transform(right)
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
        log(f"sgm kernels bitwise equal to plain at {h}x{w} "
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
        for subpixel, lr in ((True, True), (False, True), (True, False)):
            out = sgm_v1_cuda.wta(total, subpixel, lr, 1.0)
            ref = sgm.wta_from_total(total, subpixel, lr, 1.0)
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"sgm1_wta differs at 2x{w} "
                                     f"subpixel={subpixel} lr={lr}")
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
        for subpixel, lr in ((True, True), (False, True), (True, False)):
            disp = sgm_v1_cuda.wta(total, subpixel, lr, 1.0)
            ref = sgm.wta_from_total(total, subpixel, lr, 1.0)
            if not torch.equal(disp.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"sgm1_wta differs at {h}x{w} "
                                     f"subpixel={subpixel} lr={lr}")
        n_valid = int((sgm_v1_cuda.wta(total) >= 0).sum())
        if not 0.5 * h * w < n_valid < h * w:
            raise AssertionError(f"sgm v1 check is vacuous: {n_valid} valid")
        log(f"sgm v1 kernels bitwise equal to plain at {h}x{w} "
            f"({n_valid} of {h * w} pixels valid)")
        if serving is None:
            serving = (h, w, left, right, cl, cr, cost, total)
    check_census_cases(dev, sgm, sgm_v1_cuda)

    h, w, left, right, cl, cr, cost, total = serving
    n = h * w
    scratch = torch.empty_like(total)
    for vertical in (False, True):  # each launch alone, storing
        one = lambda: sgm_v1_cuda._aggregate_pass(
            cost, scratch, 10, 120, vertical=vertical, accumulate=False)
        log(f"sgm1_aggregate launch along the "
            f"{'columns' if vertical else 'rows'} alone at {h}x{w}: "
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
        names = ("points", "velocity", "static_flow")
        # 1e-5 relative; the static flow is a difference of pixel
        # coordinates, so its 1e-5 is relative to the frame's extent.
        for name, a, b, scale in zip(names, out, ref,
                                     (0.0, 0.0, float(max(h, w)))):
            if not torch.equal(torch.isnan(a), torch.isnan(b)):
                raise AssertionError(f"fused {name} NaN masks differ at "
                                     f"{h}x{w}")
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            diff = (a - b).abs()
            if not bool((diff <= 1e-5 * (b.abs() + scale) + 1e-30).all()):
                raise AssertionError(
                    f"fused {name} differs at {h}x{w}: max {diff.max()}")
            err = max(err, float(diff.max()))
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


def run_frames(model, config, stereo, frames, dev, stage_ms=None,
               cc_per_frame=None):
    """Drive ``detect_step`` over the frames from a fresh state: (outputs,
    ms per step). ``cc_per_frame`` receives the CC launches of each
    frame."""
    from moving_object_detector_tpu_torch.pipeline import (
        PipelineState,
        detect_step,
    )

    state = PipelineState.create(config, device=dev)
    outs, step_ms = [], []
    for k, (left, right, _) in enumerate(frames):
        lt = torch.from_numpy(left).to(dev)
        rt = torch.from_numpy(right).to(dev)
        cc_before = read_counts()["cc"]
        sync(dev)
        t0 = time.perf_counter()
        state, out = detect_step(model, state, lt, rt, 0.1 * k, stereo,
                                 config, stage_ms=stage_ms)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        if cc_per_frame is not None:
            cc_per_frame.append(read_counts()["cc"] - cc_before)
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
                   what: str):
    """torch.profiler over the serving frames: device busy ms per frame
    (and its share of the unprofiled median ``step_ms``; the profiler
    itself slows the host), kernel launches per frame, top kernels."""
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


def kernel_counters():
    """Every wrapper's launch counter, by kernel name."""
    from moving_object_detector_tpu_torch.ops import (
        cluster_stats_cuda,
        clustering_cuda,
        flow_corr_cuda,
        gather_cuda,
        sceneflow_cuda,
        sgm_cuda,
        sgm_v1_cuda,
    )

    return (sgm_cuda.LAUNCHES, sgm_v1_cuda.LAUNCHES, flow_corr_cuda.LAUNCHES,
            gather_cuda.LAUNCHES, clustering_cuda.LAUNCHES,
            cluster_stats_cuda.LAUNCHES, sceneflow_cuda.LAUNCHES)


def reset_counts() -> None:
    for c in kernel_counters():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in kernel_counters() for k, v in c.items()}


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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    for r in report.values():  # NaN is not JSON: not measured is null
        if r["device_ms"] != r["device_ms"]:
            r["device_ms"] = None
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_checks_and_paths(dev, report) -> None:
    """Phases 2 to 6 of the module docstring; raises on the first failure."""
    from moving_object_detector_tpu_torch import config as cfgmod
    from moving_object_detector_tpu_torch.types import StereoModel
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    check_sgm_kernels(dev, report)
    check_sgm_v1_kernels(dev, report)
    check_corr_kernel(dev, report)
    check_gather_kernel(dev, report)
    cc_serving = check_cc_kernel(dev, report)
    check_stats_kernel(dev, report, cc_serving)
    check_fused_kernel(dev, report)
    for r in report.values():
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
            f"ms {r['ms']:.4f} (on the device {r['device_ms']:.4f}) "
            f"plain_ms {r['plain_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")

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
    frames = make_frames()
    run_frames(model, config, stereo, frames[:2], dev)  # warm-up

    # The main path: default backends, every kernel but the fused construct.
    from moving_object_detector_tpu_torch.ops import sgm

    plain_census, plain_census_calls = sgm.census_transform, []
    sgm.census_transform = lambda *a, **k: (plain_census_calls.append(1)
                                            or plain_census(*a, **k))
    reset_counts()
    cc_per_frame = []
    try:
        outs, step_ms = run_frames(model, config, stereo, frames, dev,
                                   cc_per_frame=cc_per_frame)
    finally:
        sgm.census_transform = plain_census
    launches = read_counts()
    log("launches on the main path: " + json.dumps(launches)
        + f"; cc launches per frame {cc_per_frame}")
    if launches.pop("sceneflow_fused") != 0:
        raise AssertionError("the default path launched the fused construct")
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

    stage_ms = {}
    run_frames(model, config, stereo, frames, dev, stage_ms=stage_ms)
    log("per-stage ms/frame (synchronized): " + json.dumps(
        {k: round(v / len(frames), 3) for k, v in stage_ms.items()}))

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
    plain_outs, plain_ms = run_frames(model, plain, stereo, frames[:n_plain],
                                      dev)
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
                          cc_per_frame=cc_per_frame2)
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

    profile_frames(model, config, stereo, frames[:3], dev, med,
                   "the serving backends")
    profile_frames(model, plain_scene, stereo, frames[:3], dev,
                   statistics.median(scene_ms[1:]),
                   "the plain gather, CC and stats")

    run_v1_runner_path(model, config, stereo, frames, outs, med, dev, report)
    run_cli(frames)
    run_gnn(model, config, stereo, frames[:6], outs[:6], dev)


def run_v1_runner_path(model, config, stereo, frames, outs, loop_ms, dev,
                       report) -> None:
    """This slice's path: the port's ``PipelineRunner`` at full width with
    the v1 SGM kernels, over the frames fed as a sequence."""
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner

    class KeepOutputs(PipelineRunner):
        """A runner that also keeps each frame's FrameOutput."""

        def _harvest(self, index, t, out):
            self.outs.append(out)
            return super()._harvest(index, t, out)

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
    stage_ms = {}
    run_frames(model, v1, stereo, frames, dev, stage_ms=stage_ms)  # warm-up
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


def run_main(argv) -> list:
    """``run.main(argv)`` in process: its parsed JSON lines."""
    from moving_object_detector_tpu_torch import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
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
        # The patch: disparity PATCH_D, centre column x + PATCH_W / 2.
        z_true = FX * BASELINE / PATCH_D
        hits = 0
        for r, (_, _, x) in zip(whole, frames):
            x_true = (x + PATCH_W / 2 - W / 2) * z_true / FX
            hits += any(abs(d["center"][2] - z_true) < 1.0
                        and abs(d["center"][0] - x_true) < 1.0
                        for d in r["detections"])
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
        worst = 0.0
        for a, b in zip(whole, first + second):
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
                raise AssertionError(f"save + resume differs from the "
                                     f"unbroken run on frame {a['frame']}")
        if len(first + second) != n or not worst <= 1e-4:
            raise AssertionError(f"save + resume: {len(first + second)} "
                                 f"frames, max |diff| {worst}")
        log(f"CLI save after {n // 2} frames + resume: ids, flags and times "
            f"equal to the unbroken {n}-frame run, centres and velocities "
            f"max |diff| {worst:.3g} (tolerance 1e-4)")


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


if __name__ == "__main__":
    sys.exit(main())
