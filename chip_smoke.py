"""Smoke test and kernel report of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``moving_object_detector_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints the build seconds.
2. Holds each kernel against its plain PyTorch version on the card, at
   the serving shapes and at an odd shape: the SGM deltas and disparity
   bitwise, the correlation within 1e-5. Prints each kernel's time and
   its plain version's time (CUDA events, median after warm-up).
3. Runs ``pipeline.detect_step`` at the KITTI serving point (376 x 1242,
   pwc_v7 weights, flow and SGM at half resolution, two-window clusterer
   crop) on frames made from ``tests/fixtures/real_textures.npz``: a
   textured background in depth strips and a pasted patch moving 12 px a
   frame. Checks shapes, finiteness, the known strip disparities and the
   patch's flow, that every kernel launched on this path, and that the
   same frames through the plain versions give the same disparity and
   nearly the same flow. Prints ms/frame, pairs/s and per-stage ms.
4. Profiles three serving frames with torch.profiler: device busy time
   per frame, kernel launches per frame, the kernels with the most device
   time.
5. Prints the card's name and power limit, a ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, before printing any result, without CUDA or without the
package beside it. Uses one card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM non-tensor-core f32 rate
# Scalar operations per SGM DP update (cost: xor, popc, select; recurrence:
# 4 min, 2 add, 1 sub; share of the warp min and neighbour shuffles).
OPS_PER_DP_UPDATE = 12
OPS_PER_WTA_CANDIDATE = 8  # 4 adds, cost, pack, 2 min (left + right view)

H, W = 376, 1242
N_FRAMES = 12
SHIFT = 12  # patch motion, px per frame
STRIPS = ((0, 300, 24), (300, 640, 14), (640, 950, 30), (950, W, 18))
PATCH_Y, PATCH_H, PATCH_W, PATCH_D = 140, 120, 200, 44
TOL_FLOW_MEAN = 0.05  # px, kernel vs plain correlation through the bf16 net


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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def make_frames():
    """(left, right) f32 pairs: strips of known disparity, a moving patch."""
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
    for k in range(N_FRAMES):
        x = 360 + SHIFT * k
        left = bg.copy()
        right = right_bg.copy()
        left[PATCH_Y:PATCH_Y + PATCH_H, x:x + PATCH_W] = patch
        right[PATCH_Y:PATCH_Y + PATCH_H,
              x - PATCH_D:x - PATCH_D + PATCH_W] = patch
        frames.append((left, right, x))
    return frames


def check_sgm_kernels(dev, report):
    from moving_object_detector_tpu_torch.ops import sgm, sgm_cuda

    rng = np.random.default_rng(0)
    serving = None
    for h, w in ((H // 2, W // 2), (125, 350)):
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
        for uniq in (0.0, 0.95):
            d = sgm_cuda.wta(hf, hb, vf, vb, cl, cr, uniqueness_ratio=uniq)
            ref = sgm.wta_from_total(
                sgm.total_from_deltas(phf, phb, pvf, pvb, cl, cr),
                uniqueness_ratio=uniq)
            if not torch.equal(d.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"sgm_wta differs at {h}x{w} u={uniq}")
        log(f"sgm kernels bitwise equal to plain at {h}x{w}")
        if serving is None:
            serving = (h, w, cl, cr, vf, vb, hf, hb)

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
            replaces=replaces, max_abs_err=0.0,
            ms=median_ms(kern), plain_ms=median_ms(plain, reps=5, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=None)


CORR_LEVELS = ((196, 3, 10), (128, 6, 20), (96, 12, 40), (64, 24, 80))


def check_corr_kernel(dev, report):
    from moving_object_detector_tpu_torch.ops import flow_corr_cuda, flow_ops

    g = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    ms = plain_ms = t_bytes = t_ops = 0.0
    for c, h, w in CORR_LEVELS + ((64, 125, 350), (7, 13, 37)):
        for r in (4, 2):
            f1 = torch.randn(1, c, h, w, device=dev, generator=g)
            f2 = torch.randn(1, c, h, w, device=dev, generator=g)
            out = flow_corr_cuda.correlation(f1, f2, r)
            ref = flow_ops.correlation(f1, f2, r)
            e = (out - ref).abs().max().item()
            if not e <= 1e-5:
                raise AssertionError(f"corr differs at {c}x{h}x{w} r={r}: {e}")
            err = max(err, e)
        if (c, h, w) in CORR_LEVELS:  # the main path's four calls
            ms += median_ms(lambda: flow_corr_cuda.correlation(f1, f2, 4))
            plain_ms += median_ms(lambda: flow_ops.correlation(f1, f2, 4),
                                  reps=5, warmup=1)
            t_bytes += (2 * c + 81) * h * w * 4
            t_ops += 2 * 81 * c * h * w
    log(f"corr kernel within {err:.3g} of plain (tolerance 1e-5)")
    bms, by = bound_ms(t_bytes, t_ops)
    report["corr"] = dict(
        name="corr", route="cuda",
        source="moving_object_detector_tpu_torch/csrc/corr.cu",
        replaces="ops/flow_corr_pallas.py:88 correlation_pallas "
                 "(_corr_kernel :37)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None)


def run_frames(model, config, stereo, frames, dev, stage_ms=None):
    from moving_object_detector_tpu_torch.pipeline import (
        PipelineState,
        detect_step,
    )

    state = PipelineState.create(config, device=dev)
    outs, step_ms = [], []
    for k, (left, right, _) in enumerate(frames):
        lt = torch.from_numpy(left).to(dev)
        rt = torch.from_numpy(right).to(dev)
        sync(dev)
        t0 = time.perf_counter()
        state, out = detect_step(model, state, lt, rt, 0.1 * k, stereo,
                                 config, stage_ms=stage_ms)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
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


def profile_frames(model, config, stereo, frames, dev, step_ms: float):
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
    log(f"profile over {n} frames: device busy {busy_ms / n:.2f} ms/frame "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from moving_object_detector_tpu_torch import _build, config as cfgmod
    from moving_object_detector_tpu_torch.ops import flow_corr_cuda, sgm_cuda
    from moving_object_detector_tpu_torch.types import StereoModel
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
        + json.dumps({k: round(v, 2) for k, v in per_source.items()}))

    report = {}
    check_sgm_kernels(dev, report)
    check_corr_kernel(dev, report)
    for r in report.values():
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
            f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")

    config = cfgmod.PipelineConfig(height=H, width=W, flow_input_scale=2,
                                   sgm_input_scale=2)
    model, fcfg = load_flow_checkpoint(
        os.path.join(ROOT, "weights", "pwc_v7.fp16.npz"),
        cfgmod.FlowNetConfig(), device=dev)
    config = config.replace(flownet=fcfg)
    stereo = StereoModel.create(fx=721.5, fy=721.5, cx=W / 2.0, cy=H / 2.0,
                                baseline=0.54, device=dev)
    frames = make_frames()
    run_frames(model, config, stereo, frames[:2], dev)  # warm-up

    counters = (sgm_cuda.LAUNCHES, flow_corr_cuda.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    outs, step_ms = run_frames(model, config, stereo, frames, dev)
    launches = {k: v for c in counters for k, v in c.items()}
    log("launches on the main path: " + json.dumps(launches))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
        report[name]["launches"] = n
    check_outputs(outs, frames, lambda o: o.capacity)
    dets = [int(o.detections.valid.sum()) for o in outs]
    tracks = [int(o.tracked.objects.valid.sum()) for o in outs]
    med = statistics.median(step_ms[1:])
    log(f"detect_step {H}x{W} pwc_v7 flow/2 sgm/2: median {med:.2f} ms/frame"
        f" = {1e3 / med:.2f} pairs/s over {len(step_ms) - 1} frames; "
        f"all ms {[round(t, 2) for t in step_ms]}")
    log(f"detections per frame {dets}; published tracks {tracks}")

    stage_ms = {}
    run_frames(model, config, stereo, frames, dev, stage_ms=stage_ms)
    log("per-stage ms/frame (synchronized): " + json.dumps(
        {k: round(v / len(frames), 3) for k, v in stage_ms.items()}))

    plain = config.replace(
        sgm=dataclasses.replace(config.sgm, backend="xla"),
        flownet=dataclasses.replace(fcfg, corr_backend="xla"))
    before = {k: v for c in counters for k, v in c.items()}
    plain_outs, plain_ms = run_frames(model, plain, stereo, frames, dev)
    after = {k: v for c in counters for k, v in c.items()}
    if after != before:
        raise AssertionError(f"the plain path launched kernels: {before} -> "
                             f"{after}")
    flow_err = []
    for a, b in zip(outs, plain_outs):
        if not torch.equal(a.disparity.disparity, b.disparity.disparity):
            raise AssertionError("kernel and plain disparity differ")
        flow_err.append((a.flow - b.flow).abs())
    mean_err = max(float(e.mean()) for e in flow_err)
    max_err = max(float(e.max()) for e in flow_err)
    log(f"plain path: disparity identical; flow mean |diff| {mean_err:.3g} "
        f"px (tolerance {TOL_FLOW_MEAN}), max {max_err:.3g} px; plain "
        f"median {statistics.median(plain_ms[1:]):.2f} ms/frame")
    if not mean_err <= TOL_FLOW_MEAN:
        raise AssertionError(f"flow kernel vs plain mean diff {mean_err}")

    profile_frames(model, config, stereo, frames[:3], dev, med)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
