"""Device time and kernel launches of one RANSAC of the PyTorch port.

    python3 scripts/ransac_device_ms.py [--root DIR] [--reps N]

Runs ``egomotion._ransac_gn_solve`` of the port in DIR (a checkout of
this repository; by default the one that holds this script) on the GPU at
the serving shape: the "serving" case of ``tests/gauss_newton_cases.py``
(512 features with outliers and invalid ones, 64 hypotheses of 3 injected
indices) under ``EgoMotionConfig()``. Prints one JSON line: the card and
its power limit, DIR, the device ms a call (from the profiler's kernel
records over N calls), the kernel launches a call, the device ms and
launches of each kernel name, and the host ms a call (synchronized,
median). The cases are read from this script's checkout, the port from
DIR, so two commits run in two processes on the same inputs; compare
them in one chip session, in turns.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ransac_device_ms: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(HERE, "tests")]
    from gauss_newton_cases import CAM, ransac_case
    from torch.profiler import ProfilerActivity, profile

    from moving_object_detector_tpu_torch import _build, egomotion
    from moving_object_detector_tpu_torch.config import EgoMotionConfig
    from moving_object_detector_tpu_torch.types import CameraModel

    if os.path.dirname(os.path.abspath(egomotion.__file__)) != os.path.join(
            root, "moving_object_detector_tpu_torch"):
        raise RuntimeError(f"imported {egomotion.__file__}, not {root}'s")
    _build.build_all()
    dev = torch.device("cuda")
    pts, uv, valid, idx = (torch.from_numpy(x).to(dev)
                           for x in ransac_case("serving"))
    cam = CameraModel.create(*CAM, device=dev)
    cfg = EgoMotionConfig()

    def call():
        return egomotion._ransac_gn_solve(pts, uv, valid, cam, None, cfg,
                                          idx)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    host = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
    # The profiler may drop a record: each kernel name's mean time counts
    # ceil(records / reps) times a call; "records" shows any shortfall.
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.device_time / 1e3)
    kernels = {n[:80]: {"device_ms": statistics.fmean(t)
                        * math.ceil(len(t) / args.reps),
                        "launches": math.ceil(len(t) / args.reps),
                        "records": len(t)}
               for n, t in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))}
    motion, success, count = call()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "card": card.strip(), "root": root, "reps": args.reps,
        "device_ms": sum(k["device_ms"] for k in kernels.values()),
        "launches": sum(k["launches"] for k in kernels.values()),
        "host_ms_median": statistics.median(host),
        "by_kernel": kernels,
        "success": bool(success), "count": int(count),
        "motion_t": [float(x) for x in motion[:3, 3]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
