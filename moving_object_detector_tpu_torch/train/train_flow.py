"""Flow-network training CLI: the JAX package's ``train/train_flow.py``
with the same flags and the same per-chunk log line.

Trains or finetunes the port's PWC-Net on scenes made on the device
(``train/data_synth.py``), on an ``.npz`` dataset with ground-truth flow
(NHWC ``img1`` / ``img2`` / ``flow`` arrays), or on host-made random-roll
pairs. Runs on ``cuda`` unless ``--device cpu`` is given. Under a
multi-process launcher (``WORLD_SIZE`` > 1, e.g. ``torchrun``) the step
is sharded over a (data, model) mesh of all ranks.

Example:
    python -m moving_object_detector_tpu_torch.train.train_flow \\
        --steps 200 --batch 8 --height 192 --width 448 \\
        --checkpoint /tmp/pwc_ckpt.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=448)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="where to save the params: a .npz path writes the "
                        "fp16 archive both packages load, any other path a "
                        "directory holding params.npz in f32")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume params from (.npz or a "
                        "directory written by --checkpoint)")
    p.add_argument("--dataset", default=None,
                   help=".npz with img1/img2/flow arrays (NHWC); default: "
                        "on-device layered-scene generator "
                        "(train/data_synth.py)")
    p.add_argument("--roll-data", action="store_true",
                   help="use the trivial host-side random-roll pairs instead"
                        " of the on-device generator")
    p.add_argument("--chunk", type=int, default=50,
                   help="train steps between host reads of the metrics "
                        "(on-device data only)")
    p.add_argument("--n-objects", type=int, default=4,
                   help="moving objects per generated scene")
    p.add_argument("--max-shift", type=float, default=24.0,
                   help="max object translation (px) in generated scenes")
    p.add_argument("--bg-max-shift", type=float, default=10.0,
                   help="max background translation (px)")
    p.add_argument("--real-frac", type=float, default=0.0,
                   help="fraction of texture draws taken from the real-"
                        "photo bank (tests/fixtures/real_textures.npz)")
    p.add_argument("--downsample-frac", type=float, default=0.0,
                   help="fraction of each batch drawn from the scale-2 "
                        "serving distribution (generate_pair_scale2)")
    p.add_argument("--local-motion-frac", type=float, default=0.0,
                   help="fraction of samples from the local-motion regime "
                        "(near-static background, guaranteed-moving "
                        "objects, half rectangles under pure translation)")
    p.add_argument("--motion-contrast", type=float, default=0.0,
                   help="loss up-weighting of independently-moving pixels "
                        "(flow_trainer.motion_contrast_weights): 0 = "
                        "uniform mean EPE; N weights a saturated moving "
                        "pixel (1+N)x a background pixel")
    p.add_argument("--pool", type=int, default=0,
                   help="fixed scene pool size (0 = fresh data each step);"
                        " bootstrap curriculum for from-scratch training")
    p.add_argument("--warmup", type=int, default=500,
                   help="linear LR warmup steps (cosine decay afterwards)")
    p.add_argument("--constant-lr", action="store_true",
                   help="disable the warmup+cosine schedule")
    p.add_argument("--save-every", type=int, default=0,
                   help="also checkpoint every N steps (0 = only at the end)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--estimator-channels", default=None,
                   help="comma ints: FlowEstimator decoder widths")
    p.add_argument("--context-channels", default=None,
                   help="comma ints: ContextNetwork widths")
    p.add_argument("--color", action="store_true",
                   help="train a 3-channel (RGB) net on colorized "
                        "synthetic data (FlowNetConfig.in_channels=3)")
    p.add_argument("--tiny", action="store_true",
                   help="small network for smoke runs")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "asked for)")
    return p


def _ints(text: str) -> tuple:
    return tuple(int(c) for c in text.split(","))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..config import FlowNetConfig
    from ..models.pwc_net import PWCNet, init_pwc_params
    from ..utils.checkpoint import load_flow_checkpoint, save_flow_params
    from .flow_trainer import (
        create_train_state,
        full_params,
        make_chunked_train_step,
        make_sharded_train_step,
        synthetic_flow_batch,
    )

    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..parallel import multihost
        from ..parallel.mesh import create_mesh

        multihost.initialize(device=args.device)
        mesh = create_mesh(None, args.model_parallel)
    elif args.model_parallel != 1:
        raise SystemExit("--model-parallel needs a multi-process launch "
                         "(WORLD_SIZE > 1)")
    device = resolve_device(args.device)

    cfg = (FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                         use_context_net=False, dtype="float32")
           if args.tiny else FlowNetConfig())
    if args.color:
        cfg = dataclasses.replace(cfg, in_channels=3)
    if args.estimator_channels:
        cfg = dataclasses.replace(
            cfg, estimator_channels=_ints(args.estimator_channels))
    if args.context_channels:
        cfg = dataclasses.replace(
            cfg, context_channels=_ints(args.context_channels))
    if args.resume:
        # The checkpoint's kernel shapes define the architecture.
        model, cfg = load_flow_checkpoint(args.resume, base_config=cfg,
                                          device=device)
    else:
        model = init_pwc_params(
            PWCNet(cfg), torch.Generator().manual_seed(args.seed)
        ).to(device)
    state, tx = create_train_state(
        model, learning_rate=args.lr,
        total_steps=None if args.constant_lr else args.steps,
        warmup_steps=args.warmup)

    def save(st, tag=""):
        if not args.checkpoint:
            return
        if mesh is not None:
            with torch.no_grad():
                for name, p in full_params(st).items():
                    model.get_parameter(name).copy_(p)
            if torch.distributed.get_rank() != 0:
                return
        save_flow_params(args.checkpoint + tag, model)
        print(f"saved params to {args.checkpoint}{tag}", file=sys.stderr)

    t0 = time.time()
    if args.dataset is None and not args.roll_data:
        chunk = max(1, min(args.chunk, args.steps))
        step_fn, state = make_chunked_train_step(
            model, tx, state, args.height, args.width, args.batch, chunk,
            n_objects=args.n_objects, max_shift=args.max_shift,
            bg_max_shift=args.bg_max_shift, pool=args.pool,
            downsample_frac=args.downsample_frac,
            local_motion_frac=args.local_motion_frac,
            real_frac=args.real_frac, motion_contrast=args.motion_contrast,
            mesh=mesh, seed=args.seed + 1)
        done = 0
        while done < args.steps:
            state, metrics = step_fn(state)
            done += chunk
            print(f"step {done:6d} loss {float(metrics['loss']):.4f} "
                  f"epe {float(metrics['epe']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
            if args.save_every and done % args.save_every < chunk:
                save(state, tag=f".step{done}")
        save(state)
        return 0

    if mesh is not None:
        step_fn, state = make_sharded_train_step(model, tx, mesh, state)
    else:
        from .flow_trainer import train_step

        def step_fn(st, batch):
            return train_step(model, tx, st, batch)

    rng = np.random.default_rng(args.seed)
    data = np.load(args.dataset) if args.dataset else None

    def next_batch():
        if data is None:
            b = synthetic_flow_batch(rng, args.batch, args.height,
                                     args.width)
        else:
            idx = rng.integers(0, data["img1"].shape[0], args.batch)
            b = {k: torch.from_numpy(np.ascontiguousarray(
                data[k][idx].transpose(0, 3, 1, 2)))
                for k in ("img1", "img2", "flow")}
        return {k: v.to(device, torch.float32) for k, v in b.items()}

    for k in range(args.steps):
        state, metrics = step_fn(state, next_batch())
        if k % args.log_every == 0 or k == args.steps - 1:
            print(f"step {k:5d} loss {float(metrics['loss']):.4f} "
                  f"epe {float(metrics['epe']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
    save(state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
