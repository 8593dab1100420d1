"""The readings the benchmark's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 6 [--out chiprun_out/x.jsonl]

For each seed, one run of the cell in this process with a short window
at the cell's own load, and the numbers its judge compares (the lower
readings: sound runs of the program). For each control seed, the same
numbers of the control, the reference put in the program's place one
precision step down from the configuration's (the flow net's bf16
convolutions on float8 e4m3 operands, the f32 geometry with TF32
matmuls): its upper readings. For a training cell also the fault of half
the batch left out, the loss the mean over the rest, for set-up's first
steps and for the window's. One JSON line a reading. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"

from portbench.core import bench  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def serve_control(cfg, records, device, dtype="float8",
                  tf32_on=True) -> dict:
    """The control's numbers on the sampled pairs: each pair computed by
    the lower-precision reference (the net in ``dtype``, TF32 as
    ``tf32_on`` says) from the state the program started it with, then
    judged as the program's outputs are."""
    from portbench.core import judge_serve
    from portbench.drivers.stream import reference_setup
    from portbench.reference.step import run_frame

    net8, stereo, config8 = reference_setup(cfg, dtype, device)
    net, _, config = reference_setup(cfg, cfg["flownet"]["dtype"], device)
    per = []
    for rec in records:
        with tf32(tf32_on):
            out, nxt = run_frame(net8, rec["state_in"], rec["left"],
                                 rec["right"], rec["t"], stereo, config8)
        with tf32(False):
            per.append(judge_serve.judge_frame(
                net, stereo, config, dict(rec, outputs=out, state_out=nxt)))
    return judge_serve.worst(per)


def train_readings(cfg, seed, device, kept) -> dict:
    """The control's numbers and the half-batch fault's, each against the
    reference of the same seed, for both stretches the judge compares:
    set-up's first steps from the weights, and the window's from the
    state ``kept`` holds (the program's run of the same seed)."""
    from portbench.core import judge_train

    dtype = cfg["flownet"]["dtype"]
    out = {"control": {}, "half_batch": {}}
    for part, prefix in (("start", ""), ("window", "window_")):
        start = kept[part] if part == "window" else None
        with tf32(False):
            ref = judge_train.reference_steps(cfg, seed, 3, dtype, device,
                                              start=start)
        with tf32(True):
            ctl = judge_train.reference_steps(cfg, seed, 3, "float8", device,
                                              start=start)
        out["control"].update(judge_train.numbers(_as_prog(ctl), ref, prefix))
        with tf32(False):
            half = judge_train.reference_steps(
                cfg, seed, 3, dtype, device, loss_rows=cfg["batch"] // 2,
                start=start)
        out["half_batch"].update(judge_train.numbers(_as_prog(half), ref,
                                                     prefix))
    return out


def _as_prog(steps) -> dict:
    batches, losses, grads1, params0, after = steps
    return dict(batches=batches, losses=losses, grads1=grads1,
                params0=params0, params_k=after)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--out", default=None)
    p.add_argument("--variants", default="",
                   help="also judge the reference in these types in the "
                        "program's place, TF32 off: witnesses, e.g. "
                        "bfloat16,float8")
    p.add_argument("--program-dtype", default=None,
                   help="run the program's flow net in this type instead "
                        "of the configuration's (a witness: float32)")
    args = p.parse_args(argv)
    import importlib

    import torch

    from portbench.run import Context

    spec = bench.benchmark()
    cell = bench.cell(spec, args.workload)
    device = bench.require_cuda(cell["chips"])
    cfg = bench.config_file(spec, cell["config"])
    if args.program_dtype:
        cfg = dict(cfg, flownet=dict(cfg["flownet"],
                                     dtype=args.program_dtype))
    traffic = bench.traffic_file(cell["traffic"])
    drv = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for seed in [int(s) for s in args.seeds.split(",")]:
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        ctx = Context(ns, cell, cfg, traffic, device)
        ctx.keep_records = True
        t0 = time.perf_counter()
        out = drv.run(ctx)
        emit(dict(workload=cell["name"], seed=seed,
                  who="program" + (f" in {args.program_dtype}"
                                   if args.program_dtype else ""),
                  numbers=out["numbers"], e2e=out["e2e"],
                  seconds=time.perf_counter() - t0))
        if seed in controls:
            t0 = time.perf_counter()
            if traffic["driver"] == "stream":
                emit(dict(workload=cell["name"], seed=seed, who="control",
                          numbers=serve_control(cfg, out["records"], device),
                          seconds=time.perf_counter() - t0))
                for v in [v for v in args.variants.split(",") if v]:
                    emit(dict(workload=cell["name"], seed=seed,
                              who=f"reference in {v}, TF32 off", numbers=serve_control(
                                  cfg, out["records"], device, v, False)))
            else:
                for who, n in train_readings(cfg, seed % (1 << 63), device,
                                             out["kept"]).items():
                    emit(dict(workload=cell["name"], seed=seed, who=who,
                              numbers=n, seconds=time.perf_counter() - t0))
        del out
        torch.cuda.empty_cache()
    emit(dict(card=bench.power_limit(), kind=torch.cuda.get_device_name(0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
