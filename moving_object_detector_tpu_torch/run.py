"""CLI entry point: the launch-file analog (the JAX package's ``run.py``).

* ``--source synthetic``: a simulated moving-object scene;
* ``--source kitti --left-dir ... --right-dir ...``: two image
  directories at KITTI resolution (with --crop providing the image_crop
  stage);
* ``--source npz``: playing back a recorded sequence;
* ``--source live`` / ``socket``: growing directories / a TCP sensor.

Outputs go to ``--export-dir`` as file products (marker JSON, cluster /
flow / depth / velocity images); one JSON line per frame goes to stdout.
Runs on the CUDA device and exits with an error when there is none.

Example:
    python -m moving_object_detector_tpu_torch.run --source synthetic \
        --frames 8 --flow-input-scale 2 --sgm-input-scale 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source",
                   choices=["synthetic", "kitti", "npz", "live", "socket",
                            "interactive"],
                   default="synthetic")
    p.add_argument("--left-dir",
                   help="left image directory (kitti/live sources)")
    p.add_argument("--right-dir",
                   help="right image directory (kitti/live sources)")
    p.add_argument("--idle-timeout", type=float, default=10.0,
                   help="live source: stop after this many seconds with no "
                        "new frames")
    p.add_argument("--stop-file", default=None,
                   help="live source: stop when this file appears")
    p.add_argument("--npz", help="recorded .npz sequence path")
    p.add_argument("--host", default="127.0.0.1",
                   help="socket source: sensor server host")
    p.add_argument("--port", type=int, default=0,
                   help="socket source: sensor server port")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--height", type=int, default=376)
    p.add_argument("--width", type=int, default=1242)
    p.add_argument("--fx", type=float, default=721.5)
    p.add_argument("--baseline", type=float, default=0.54)
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--crop", action="store_true",
                   help="center-crop inputs to --height/--width "
                        "(image_crop stage)")
    p.add_argument("--export-dir", default=None)
    p.add_argument("--export-every", type=int, default=5)
    p.add_argument(
        "--preset", choices=["default", "tiny"], default="default",
        help="'tiny' shrinks the flow net and feature counts for quick "
             "smoke runs",
    )
    p.add_argument("--flow-checkpoint", default="auto",
                   help=".npz with trained PWC-Net params; 'auto' uses the "
                        "newest bundled weights if present, 'none' forces "
                        "random init")
    p.add_argument("--report", action="store_true",
                   help="print per-stage timing report")
    p.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the run into "
                        "this directory (trace.json, Chrome trace format)")
    p.add_argument("--save-state", default=None,
                   help=".npz file: snapshot the pipeline state after the "
                        "run (pose, previous frame, tracker bank) for "
                        "deterministic resume")
    p.add_argument("--resume-state", default=None,
                   help=".npz file: resume from a --save-state snapshot")
    p.add_argument("--flow-input-scale", type=int, default=1,
                   help="run the flow net at 1/N resolution (serving "
                        "latency knob; only deploy values that passed the "
                        "scale-N quality gates)")
    p.add_argument("--sgm-input-scale", type=int, default=1,
                   help="run SGM stereo at 1/N resolution (nearest-"
                        "upsampled disparities x N)")
    p.add_argument("--serve-port", type=int, default=None,
                   help="live dashboard port; not ported yet (ROADMAP.md)")
    p.add_argument("--serve-host", default="0.0.0.0",
                   help="bind address for --serve-port")
    p.add_argument("--reconfigure-file", default=None,
                   help="watched JSON file of Tunables fields "
                        "(dynamic_reconfigure analog): edits apply between "
                        "frames")
    p.add_argument("--color", action="store_true",
                   help="feed (H, W, 3) RGB frames (kitti/live/npz "
                        "sources): the flow net sees color when its "
                        "weights are RGB-trained; SGM and ego-motion "
                        "always run on luma.")
    return p


def _frame_record(r) -> dict:
    """The JSON line of one FrameResult."""
    return {
        "frame": r.index,
        "time": round(r.time, 4),
        "valid": r.frame_valid,
        "ego": r.ego_success,
        # capacity observability; omitted when clean
        **({"cluster_overflow": r.cluster_overflow}
           if r.cluster_overflow else {}),
        **({"tracker_saturated": True} if r.tracker_saturated else {}),
        "detections": [
            {"id": int(i), "center": c.tolist(), "velocity": v.tolist(),
             "bbox": b.tolist()}
            for i, c, v, b in zip(
                r.detections["id"], r.detections["center"],
                r.detections["velocity"], r.detections["bounding_box"])
        ],
        "tracks": [
            {"id": int(i), "center": c.tolist(), "velocity": v.tolist(),
             # column-major float[16]
             "covariance": cv.T.reshape(-1).tolist()}
            for i, c, v, cv in zip(
                r.tracks["id"], r.tracks["center"], r.tracks["velocity"],
                r.tracks["covariance"])
        ],
    }


def main(argv=None, device=None) -> int:
    """Run the CLI. ``device`` is for callers that want the CPU (the
    tests); the command line has no such switch and runs on ``cuda``."""
    args = build_parser().parse_args(argv)
    if args.source == "interactive" or args.serve_port is not None:
        what = ("--source interactive" if args.source == "interactive"
                else "--serve-port")
        print(f"{what} is not ported to the PyTorch package yet "
              "(ROADMAP.md Queue 1: io/scenes.py, io/dashboard.py)",
              file=sys.stderr)
        return 2

    import torch

    from . import resolve_device
    from .config import PipelineConfig
    from .io import readers
    from .io.runner import PipelineRunner
    from .models.pwc_net import PWCNet
    from .types import StereoModel

    device = resolve_device(device)
    if args.preset == "tiny":
        from .config import EgoMotionConfig, FlowNetConfig, SGMConfig

        config = PipelineConfig(
            height=args.height,
            width=args.width,
            flownet=FlowNetConfig(
                feature_channels=(8, 16, 32), search_range=2,
                use_context_net=False, dtype="float32",
            ),
            sgm=SGMConfig(max_disparity=32),
            egomotion=EgoMotionConfig(
                max_features=64, nms_radius=2, ransac_hypotheses=8,
                lk_pyramid_levels=1, min_inliers=4,
            ),
        )
    else:
        config = PipelineConfig(height=args.height, width=args.width)
    if args.color:
        config = config.replace(color=True)
    if args.flow_input_scale != 1 or args.sgm_input_scale != 1:
        config = config.replace(
            flow_input_scale=args.flow_input_scale,
            sgm_input_scale=args.sgm_input_scale,
        )
    stereo = StereoModel.create(
        fx=args.fx, fy=args.fx, cx=args.width / 2.0, cy=args.height / 2.0,
        baseline=args.baseline, device=device,
    )

    # Restore before building the source: a resumed run must know how many
    # frames the snapshot already consumed (the sources restart at frame 0).
    initial_state = None
    done = 0
    if args.resume_state:
        from .utils.checkpoint import restore_pipeline_state

        initial_state = restore_pipeline_state(args.resume_state,
                                               device=device)
        done = int(initial_state.frame_index)

    if args.source == "synthetic":
        seq = readers.SyntheticStereoSequence(
            height=args.height, width=args.width, fx=args.fx,
            baseline=args.baseline, fps=args.fps,
            n_frames=args.frames + done,
        )
    elif args.source == "kitti":
        if not (args.left_dir and args.right_dir):
            print("--left-dir/--right-dir required for kitti", file=sys.stderr)
            return 2
        seq = readers.ImageSequence(args.left_dir, args.right_dir, args.fps,
                                    color=args.color)
    elif args.source == "live":
        if not (args.left_dir and args.right_dir):
            print("--left-dir/--right-dir required for live", file=sys.stderr)
            return 2
        seq = readers.LiveDirectorySequence(
            args.left_dir, args.right_dir, fps=args.fps,
            idle_timeout=args.idle_timeout, stop_file=args.stop_file,
        )
    elif args.source == "socket":
        if not args.port:
            print("--port required for socket", file=sys.stderr)
            return 2
        seq = readers.SocketStereoSequence(
            args.host, args.port, idle_timeout=args.idle_timeout,
        )
    else:
        if not args.npz:
            print("--npz required", file=sys.stderr)
            return 2
        seq = readers.NpzSequence(args.npz, color=args.color)

    if args.crop:
        from .ops.image import center_crop_stereo

        base_seq, base_stereo = seq, stereo
        # Note: for a centered principal point, the center crop keeps
        # cx, cy at the (new) image center, matching the configured stereo.

        def cropped():
            for left, right, t in base_seq:
                lc, rc, _ = center_crop_stereo(
                    left, right, base_stereo, args.height, args.width)
                yield lc, rc, t

        seq = cropped()

    from .utils.checkpoint import load_flow_checkpoint, resolve_flow_checkpoint

    # The tiny preset's architecture never matches the bundled weights.
    ckpt = (
        None if args.preset == "tiny" and args.flow_checkpoint == "auto"
        else resolve_flow_checkpoint(args.flow_checkpoint)
    )
    if ckpt:
        # The checkpoint's kernel shapes define the architecture (slim/wide
        # decoder variants load without width flags).
        model, flow_cfg = load_flow_checkpoint(ckpt, config.flownet,
                                               device=device)
        config = dataclasses.replace(config, flownet=flow_cfg)
    else:
        torch.manual_seed(0)  # random init, the same in every run
        model = PWCNet(config.flownet).to(device).eval()

    # Live sources get queue_size=1 drop-stale semantics: when the
    # pipeline can't keep up with the sensor, stale frames are dropped,
    # not queued.
    live = args.source in ("live", "socket")
    runner = PipelineRunner(
        config, stereo, model,
        export_dir=args.export_dir, export_every=args.export_every,
        ring_capacity=1 if live else 4, drop_oldest=live,
        reconfigure_file=args.reconfigure_file, device=device,
    )
    if done > 0:
        # The file/synthetic sources restart from their first frame; fast
        # -forward past the frames the snapshot already processed so the
        # sequence (and its timestamps) continue where the snapshot left
        # off. Without this, the restarted t=0 makes dt clamp to 1e-3 s
        # and the first resumed frame's velocities explode ~100x.
        def _skipped(base_seq, n):
            for j, frame in enumerate(base_seq):
                if j >= n:
                    yield frame

        print(f"# resume: skipping {done} already-processed frames",
              file=sys.stderr)
        seq = _skipped(seq, done)
    from .utils.profiling import trace_context

    with trace_context(args.trace_dir):
        results = runner.run(
            seq, max_frames=args.frames, initial_state=initial_state
        )
    if args.save_state:
        runner.save_state(args.save_state)

    for r in results:
        print(json.dumps(_frame_record(r)))
    if args.report:
        print(runner.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
