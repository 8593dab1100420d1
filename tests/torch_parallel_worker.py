"""Worker processes of the port's ``torch.distributed`` tests, and the
numpy inputs both packages' sides of those tests share. Imports numpy,
torch and the port only: the JAX side runs in the test process.

    python tests/torch_parallel_worker.py TASK RANK WORLD INIT_URL OUTDIR

``spatial`` (4 gloo ranks): the row-striped SGM and flow of
``tests/test_spatial.py`` on a (1, 4) and a (2, 2) mesh, the halo
asserts, the flow-net parameter placements and the streams x spatial
composition; each rank saves its results to ``OUTDIR/rank<RANK>.npz``.
``multihost`` (2 gloo ranks): the smoke of ``tests/test_multihost.py``;
prints ``worker <RANK> ok <total>``.
``train`` (4 gloo ranks): ``make_sharded_train_step`` on a (2, 2) mesh for
``TRAIN_STEPS`` steps of ``train_batch``, then one chunk of
``make_chunked_train_step`` over the mesh; each rank saves its metrics,
the full parameters after every step and its shards' placements to
``OUTDIR/rank<RANK>.npz``.

The flow net's weights come from ``OUTDIR/flow_params.npz`` (the JAX
package's random init, flattened to "params/..." keys), written by the
test before it starts the workers.
"""

from __future__ import annotations

import os
import sys

import numpy as np

SGM_CASES = {  # name: (h, w, d_true, seed, model_parallel, halo)
    "sgm_m4": (64, 160, 7, 0, 4, 12),
    "sgm_m2": (64, 160, 5, 2, 2, 16),
}
FLOW_HW, FLOW_HALO = (128, 96), 32
PWC_HW, PWC_HALO = (128, 384), 64  # bench.py's flow halo
COMP_HW, COMP_N, COMP_SHIFT = (64, 128), 2, 6
COMP_HALOS = dict(sgm_halo=12, flow_halo=24)


def smooth(img: np.ndarray) -> np.ndarray:
    """3 x 3 mean with zeros outside (``convolve2d(..., mode="same")``)."""
    h, w = img.shape
    p = np.pad(img, 1)
    out = sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    return (out / 9.0).astype(np.float32)


def stereo_pair(h, w, d_true, seed):
    """A textured scene; the right view is the left shifted by d_true."""
    img = smooth(np.random.default_rng(seed).uniform(0, 1, (h, w))
                 .astype(np.float32))
    return img, np.roll(img, -d_true, axis=1)


def flow_pair(seed=1):
    h, w = FLOW_HW
    img = np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(
        np.float32)
    return img, np.roll(img, -2, axis=1)


def pwc_pair():
    """Two frames of real texture with a patch moving 10 px, from the
    repo's fixtures, for the pwc_v7 weights."""
    h, w = PWC_HW
    tex = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "fixtures", "real_textures.npz"))
    bg = np.concatenate([tex["china"], tex["flower"]], 1)[:h, :w]
    patch = tex["hopper"][100:140, 100:180]
    frames = []
    for x in (100, 110):
        f = bg.astype(np.float32) / 255.0
        f[h // 2 - 20:h // 2 + 20, x:x + 80] = patch / 255.0
        frames.append(f)
    return frames


def composition_scenes():
    """(lefts, rights) (N, H, W): a textured scene per stream, uniform
    disparity COMP_SHIFT."""
    h, w = COMP_HW
    lefts = np.stack([stereo_pair(h, w, COMP_SHIFT, 3 + i)[0]
                      for i in range(COMP_N)])
    return lefts, np.roll(lefts, -COMP_SHIFT, axis=2)


TRAIN_STEPS, TRAIN_MESH = 2, (2, 2)  # the sharded train step's test
# make_chunked_train_step's (height, width, batch, chunk): one chunk.
TRAIN_CHUNK_ARGS = (32, 64, 4, 2)


def train_batch(k: int, m):
    """Step k's batch: ``synthetic_flow_batch`` of either package's
    trainer module ``m`` (8 x 32 x 64, the JAX sharding test's)."""
    return m.synthetic_flow_batch(np.random.default_rng(k), 8, 32, 64)


def flow_config(m):
    return m.FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                           use_context_net=False, dtype="float32")


def composition_config(m):
    """``tests/test_spatial.py``'s composition configuration, from either
    package's config module ``m``."""
    h, w = COMP_HW
    return m.PipelineConfig(
        height=h, width=w,
        scene_flow=m.SceneFlowConfig(dynamic_flow_diff=2.0),
        clusterer=m.ClustererConfig(
            cluster_size=100, depth_diff=0.3, dynamic_speed=0.3,
            neighbor_distance=2, max_objects=4),
        tracker=m.TrackerConfig(max_tracks=8),
        sgm=m.SGMConfig(max_disparity=16, census_window=(5, 5),
                        backend="xla"),
        egomotion=m.EgoMotionConfig(
            max_features=128, nms_radius=2, ransac_hypotheses=16,
            lk_pyramid_levels=2, min_inliers=8),
        flownet=flow_config(m),
    )


def _flow_model(outdir):
    from moving_object_detector_tpu_torch import config as tcfg
    from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        params_from_flax,
    )

    with np.load(os.path.join(outdir, "flow_params.npz")) as f:
        flat = dict(f)
    model = PWCNet(flow_config(tcfg))
    model.load_state_dict(params_from_flax(flat))
    return model


def run_spatial(outdir: str) -> dict:
    import torch
    from torch.distributed.tensor import Shard

    from moving_object_detector_tpu_torch import config as tcfg
    from moving_object_detector_tpu_torch.parallel.mesh import (
        create_mesh,
        flow_param_sharding,
    )
    from moving_object_detector_tpu_torch.parallel.spatial import (
        compute_disparity_spatial,
        detect_step_streams_spatial,
        flow_forward_spatial,
    )
    from moving_object_detector_tpu_torch.parallel.streams import (
        create_stream_states,
        detect_step_batched,
        shard_streams,
    )
    from moving_object_detector_tpu_torch.types import StereoModel

    meshes = {4: create_mesh(4, 4), 2: create_mesh(4, 2)}
    out = {}
    for name, (h, w, d_true, seed, mp, halo) in SGM_CASES.items():
        left, right = map(torch.from_numpy, stereo_pair(h, w, d_true, seed))
        stereo = StereoModel.create(100.0, 100.0, w / 2, h / 2, 0.5,
                                    device="cpu")
        out[name] = compute_disparity_spatial(
            left, right, stereo, tcfg.SGMConfig(max_disparity=32,
                                                backend="xla"),
            meshes[mp], halo=halo).disparity.numpy()
        if mp == 4:  # the asserts: a halo past the stripe, H % n != 0
            raised = []
            for hh, hl in ((h, h // 4 + 1), (h + 2, 4)):
                z = torch.zeros(hh, w)
                try:
                    compute_disparity_spatial(
                        z, z, stereo, tcfg.SGMConfig(max_disparity=32,
                                                     backend="xla"),
                        meshes[4], halo=hl)
                except AssertionError:
                    raised.append(True)
            out["asserts_raised"] = np.array(raised)

    model = _flow_model(outdir)
    img1, img2 = map(torch.from_numpy, flow_pair())
    out["flow_m4"] = flow_forward_spatial(model, img1, img2, meshes[4],
                                          halo=FLOW_HALO).numpy()
    # pwc_v7 (6 levels, bf16) at scale 2 with bench.py's halo.
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pwc, _ = load_flow_checkpoint(
        os.path.join(root, "weights", "pwc_v7.fp16.npz"), device="cpu")
    out["pwc_striped"] = flow_forward_spatial(
        pwc, *map(torch.from_numpy, pwc_pair()), meshes[2], halo=PWC_HALO,
        input_scale=2).numpy()
    placements = flow_param_sharding(meshes[2], model.named_parameters())
    out["sharded_params"] = np.array(sorted(
        n for n, p in placements.items() if p[1] == Shard(0)))
    out["replicated_over_data"] = np.array(all(
        not isinstance(p[0], Shard) for p in placements.values()))

    # Streams x spatial: each data group takes one of the two streams.
    mesh = meshes[2]
    cfg = composition_config(tcfg)
    h, w = COMP_HW
    stereo = StereoModel.create(100.0, 100.0, w / 2, h / 2, 0.48,
                                device="cpu")
    lefts, rights = map(torch.from_numpy, composition_scenes())
    ts0 = torch.full((COMP_N,), 0.1)
    ts1 = torch.full((COMP_N,), 0.2)
    lefts_l, rights_l, ts0_l, ts1_l = (
        x.to_local() for x in shard_streams(mesh, lefts, rights, ts0, ts1))
    states = create_stream_states(cfg, 1, device="cpu")
    states_sp, sp0 = detect_step_streams_spatial(
        model, states, lefts_l, rights_l, ts0_l, stereo, cfg, mesh,
        **COMP_HALOS)
    _, sp = detect_step_streams_spatial(
        model, states_sp, lefts_l, rights_l, ts1_l, stereo, cfg, mesh,
        **COMP_HALOS)
    _, ref = detect_step_batched(
        model, states_sp, lefts_l, rights_l, ts1_l, stereo, cfg,
        flow_overrides=sp.flow, disparity_overrides=sp.disparity)
    _, pl = detect_step_batched(model, states_sp, lefts_l, rights_l, ts1_l,
                                stereo, cfg)
    out.update(
        data_index=np.array(mesh.get_local_rank("data")),
        sp0_disparity=sp0.disparity.disparity.numpy(),
        sp_disparity=sp.disparity.disparity.numpy(),
        sp_flow=sp.flow.numpy(), sp_velocity=sp.scene_flow.velocity.numpy(),
        sp_label=sp.label_image.numpy(), sp_motion=sp.motion.numpy(),
        sp_valid=sp.detections.valid.numpy(),
        sp_frame_valid=sp.frame_valid.numpy(),
        ref_velocity=ref.scene_flow.velocity.numpy(),
        ref_label=ref.label_image.numpy(),
        pl_disparity=pl.disparity.disparity.numpy(), pl_flow=pl.flow.numpy(),
        pl_valid=pl.detections.valid.numpy())
    return out


def run_train(outdir: str) -> dict:
    import torch
    from torch.distributed.tensor import Shard

    from moving_object_detector_tpu_torch.parallel.mesh import create_mesh
    from moving_object_detector_tpu_torch.train import flow_trainer

    mesh = create_mesh(4, TRAIN_MESH[1])
    model = _flow_model(outdir)
    state, tx = flow_trainer.create_train_state(model)
    step, sharded = flow_trainer.make_sharded_train_step(model, tx, mesh,
                                                         state)
    out = {"sharded": np.array(sorted(
        n for n, p in sharded.params.items() if Shard(0) in p.placements))}
    for k in range(TRAIN_STEPS):
        sharded, metrics = step(sharded, train_batch(k, flow_trainer))
        for name in ("loss", "epe", "grad_norm"):
            out[f"{name}{k}"] = np.array(float(metrics[name]))
        for name, p in flow_trainer.full_params(sharded).items():
            out[f"step{k}/{name}"] = p.detach().numpy()
    out["local_numel"] = np.array(sum(p.to_local().numel()
                                      for p in sharded.params.values()))
    out["step"] = np.array(sharded.step)
    # A chunk of the chunked trainer over the same mesh.
    model = _flow_model(outdir)
    state, tx = flow_trainer.create_train_state(model)
    chunk_fn, state = flow_trainer.make_chunked_train_step(
        model, tx, state, *TRAIN_CHUNK_ARGS, mesh=mesh)
    state, metrics = chunk_fn(state)
    out["chunk_loss"] = np.array(float(metrics["loss"]))
    torch.distributed.barrier()
    return out


def run_multihost(rank: int) -> float:
    """One camera stream per process over a (2, 1) mesh: host-local
    batches become one global batch, a reduction crosses the process
    boundary, and the detection pipeline runs on each rank's stream."""
    import torch

    from moving_object_detector_tpu_torch.config import (
        ClustererConfig, EgoMotionConfig, FlowNetConfig, PipelineConfig,
        SGMConfig, TrackerConfig,
    )
    from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
    from moving_object_detector_tpu_torch.parallel import multihost
    from moving_object_detector_tpu_torch.parallel.streams import (
        create_stream_states, detect_step_batched,
    )
    from moving_object_detector_tpu_torch.types import StereoModel

    mesh = multihost.global_stream_mesh(model_parallel=1)
    assert mesh.shape == (2, 1), mesh.shape
    local = {"left": torch.full((1, 4, 6), float(rank + 1))}
    g = multihost.distribute_streams(mesh, local)
    assert tuple(g["left"].shape) == (2, 4, 6), g["left"].shape
    # Crosses the process boundary: stream 0 lives on rank 0, stream 1 on
    # rank 1 (1 * 24 + 2 * 24).
    total = float(g["left"].sum().full_tensor())
    assert abs(total - 72.0) < 1e-6, total
    back = multihost.host_local_results(g)
    np.testing.assert_array_equal(back["left"], local["left"].numpy())

    h, w = 32, 64
    config = PipelineConfig(
        height=h, width=w,
        clusterer=ClustererConfig(cluster_size=20, max_objects=2,
                                  neighbor_distance=2),
        tracker=TrackerConfig(max_tracks=4),
        sgm=SGMConfig(max_disparity=8, backend="xla"),
        egomotion=EgoMotionConfig(max_features=64, nms_radius=2,
                                  ransac_hypotheses=8, lk_pyramid_levels=1,
                                  min_inliers=4),
        flownet=FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                              use_context_net=False, dtype="float32"))
    stereo = StereoModel.create(50.0, 50.0, w / 2, h / 2, 0.5, device="cpu")
    torch.manual_seed(0)
    model = PWCNet(config.flownet)
    states = create_stream_states(config, 1, device="cpu")
    rng = np.random.default_rng(rank)
    lefts = rng.uniform(0, 1, (1, h, w)).astype(np.float32)
    gb = multihost.distribute_streams(mesh, {
        "l": torch.from_numpy(lefts),
        "r": torch.from_numpy(np.roll(lefts, -4, axis=2))})
    states, out = detect_step_batched(
        model, states, gb["l"].to_local(), gb["r"].to_local(),
        torch.full((1,), 0.1), stereo, config)
    disp = multihost.host_local_results(
        multihost.distribute_streams(mesh, out.disparity.disparity))
    assert disp.shape == (1, h, w), disp.shape
    assert np.isfinite(disp).all()
    return total


def main(argv) -> None:
    task, rank, world, init, outdir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from moving_object_detector_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(init, world, rank, device="cpu")
    try:
        if task in ("spatial", "train"):
            run = run_spatial if task == "spatial" else run_train
            np.savez(os.path.join(outdir, f"rank{rank}.npz"), **run(outdir))
            print(f"worker {rank} ok", flush=True)
        else:
            print(f"worker {rank} ok {run_multihost(rank)}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
