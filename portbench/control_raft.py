"""The readings the RAFT cells' limits are set from, on the card.

    python3 portbench/control_raft.py --workload kitti_raft.max_busy \
        --seeds 1,2,3 --control-seeds 1,2 --seconds 6 \
        [--out chiprun_out/x.jsonl]

For each seed, one run of the cell in this process with a short window
at the cell's own load, and the numbers its judge compares (the lower
readings: sound runs of the program). For each control seed, the same
numbers of three controls, each the reference put in the program's place
on the run's sampled pairs (TF32 off) with one fault: one iteration short,
the encoders' bf16 values on the float8 e4m3 grid, the all-pairs volume's
product in bf16 where f32 is stated (their upper readings), and which of
the cell's checks each fails. One JSON line a reading. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"

from portbench.core import bench  # noqa: E402


def controls(cfg: dict) -> dict:
    """{name: the reference's configuration changes} of each control."""
    return {"iters_short": dict(iters=cfg["flownet"]["iters"] - 1),
            "encoders_float8": dict(encoder_dtype="float8"),
            "volume_bfloat16": dict(volume_dtype="bfloat16")}


def control_numbers(ctx, cfg, state, records, changes) -> dict:
    """The judge's numbers of the reference with ``changes`` in the
    program's place on the sampled pairs."""
    import torch

    from portbench.drivers import stream_raft
    from portbench.reference.step import run_frame

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net, stereo, config = stream_raft.reference_setup(cfg, state,
                                                      ctx.device, **changes)
    recs = []
    for rec in records:
        out, nxt = run_frame(net, rec["state_in"], rec["left"], rec["right"],
                             rec["t"], stereo, config)
        recs.append(dict(rec, outputs=out, state_out=nxt))
    return stream_raft.judge_records(ctx, cfg, state, recs,
                                     net_changes=changes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench.core import judge_serve
    from portbench.drivers import stream_raft
    from portbench.run import Context

    spec = bench.benchmark()
    cell = bench.cell(spec, args.workload)
    device = bench.require_cuda(cell["chips"])
    cfg = bench.config_file(spec, cell["config"])
    traffic = bench.traffic_file(cell["traffic"])
    picked = {int(s) for s in args.control_seeds.split(",") if s}
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
        out = stream_raft.run(ctx)
        emit(dict(workload=cell["name"], seed=seed, who="program",
                  numbers=out["numbers"], e2e=out["e2e"],
                  failed=[c["name"] for c in out["checks"] if not c["ok"]],
                  seconds=time.perf_counter() - t0))
        if seed in picked:
            for name, changes in controls(cfg).items():
                t0 = time.perf_counter()
                n = control_numbers(ctx, cfg, out["state_dict"],
                                    out["records"], changes)
                checks = judge_serve.checks(n, stream_raft.LIMITS)
                emit(dict(workload=cell["name"], seed=seed, who=name,
                          numbers=n,
                          failed=[c["name"] for c in checks if not c["ok"]],
                          seconds=time.perf_counter() - t0))
        del out
        torch.cuda.empty_cache()
    emit(dict(card=bench.power_limit(), kind=torch.cuda.get_device_name(0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
