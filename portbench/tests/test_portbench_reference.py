"""The reference's frozen copies compute what the port computes, on the
CPU at a small size, where every kernel wrapper runs its plain version:
a run of frames of ``pipeline.detect_step`` against ``run_frame``, and
train steps of ``flow_trainer.train_step`` against the reference's, both
in f32 with the same weights."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import moving_object_detector_tpu_torch as P
from moving_object_detector_tpu_torch import pipeline
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.train import flow_trainer
from portbench.core import judge_serve
from portbench.reference import config as RC
from portbench.reference import pwc_net as RN
from portbench.reference import step as RS
from portbench.reference import trainer as RT
from portbench.reference import types as RTy

H, W = 64, 128


def _config(C):
    return C.PipelineConfig(
        height=H, width=W, flow_input_scale=2, sgm_input_scale=2,
        flownet=C.FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                                use_context_net=False, dtype="float32",
                                occlusion_cue=True),
        sgm=C.SGMConfig(max_disparity=32),
        egomotion=C.EgoMotionConfig(max_features=64, nms_radius=2,
                                    ransac_hypotheses=8, lk_pyramid_levels=1,
                                    min_inliers=4),
        clusterer=C.ClustererConfig(cluster_size=20))


def _nets():
    torch.manual_seed(0)
    pn = PWCNet(_config(P).flownet).eval()
    rn = RN.PWCNet(_config(RC).flownet).eval()
    rn.load_state_dict(pn.state_dict())
    return pn, rn


def test_run_frame_is_detect_step():
    pc, rc = _config(P), _config(RC)
    pn, rn = _nets()
    ps = P.StereoModel.create(100.0, 100.0, W / 2, H / 2, 0.54, device="cpu")
    rs = RTy.StereoModel.create(100.0, 100.0, W / 2, H / 2, 0.54,
                                device="cpu")
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (H, W + 60)).astype(np.float32)
    patch = rng.uniform(0, 1, (20, 24)).astype(np.float32)
    state = pipeline.PipelineState.create(pc, device="cpu")
    ran_tracker = False
    for k in range(5):
        left = base[:, 8 + 2 * k: 8 + 2 * k + W].copy()
        right = base[:, 14 + 2 * k: 14 + 2 * k + W].copy()
        left[20:40, 30 + 4 * k: 54 + 4 * k] = patch  # a mover
        right[20:40, 24 + 4 * k: 48 + 4 * k] = patch
        left, right = torch.from_numpy(left), torch.from_numpy(right)
        prev = judge_serve.state_dict_of(state)
        state, out = pipeline.detect_step(pn, state, left, right, 0.1 * k,
                                          ps, pc)
        ref, nxt = RS.run_frame(rn, prev, left, right, 0.1 * k, rs, rc)
        got = judge_serve.outputs_of(out)
        for name in ("disparity", "flow", "motion", "ego_success",
                     "scene_flow", "static_flow", "detections",
                     "label_image", "odom_pose", "tracked"):
            assert judge_serve._tree_differ(got[name], ref[name]) == 0, name
        assert judge_serve._tree_differ(
            judge_serve.as_reference(state.tracker), nxt["tracker"]) == 0
        ran_tracker |= bool(out.frame_valid)
    assert ran_tracker


def test_reference_train_step_is_the_trainers():
    pn, rn = _nets()
    pn.train(), rn.train()
    ps, ptx = flow_trainer.create_train_state(pn, total_steps=None)
    rs, rtx = RT.create_train_state(rn, total_steps=None)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        batch = flow_trainer.synthetic_flow_batch(
            np.random.default_rng(int(torch.randint(0, 99, (1,),
                                                    generator=gen))),
            2, 64, 64)
        _, pm = flow_trainer.train_step(pn, ptx, ps, batch)
        _, rm = RT.train_step(rn, rtx, rs, batch)
        assert float(pm["loss"]) == float(rm["loss"])
    for a, b in zip(pn.parameters(), rn.parameters()):
        assert torch.equal(a, b)


def test_float8_control_puts_every_bf16_value_on_the_e4m3_grid():
    cfg = RC.FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                           use_context_net=False, dtype="float8",
                           occlusion_cue=True)
    torch.manual_seed(1)
    net = RN.PWCNet(cfg).eval()
    assert RN._dtype(cfg) == RN.FP8
    assert all(m.dtype in (RN.FP8, torch.float32)
               for m in net.modules() if isinstance(m, RN.Conv))
    x = torch.tensor([1.0, 0.3, -2.5, 448.0 * 3])
    q = RN._fp8(x)
    assert q[-1] == x[-1] and not torch.equal(q, x)
    assert torch.equal(RN._fp8(q), q)  # on the grid
    f32 = RN.PWCNet(dataclasses.replace(cfg, dtype="float32")).eval()
    f32.load_state_dict(net.state_dict())
    img = torch.rand(1, 1, 64, 64)
    with torch.no_grad():
        a, b = net(img, img.roll(2, -1))[0], f32(img, img.roll(2, -1))[0]
    assert torch.isfinite(a).all() and not torch.equal(a, b)


def test_skip_batches_moves_the_generator_as_generate_batch_does():
    """The judge's reference starts the window's steps from a generator
    moved past the batches before by their draws alone."""
    from moving_object_detector_tpu_torch.train import data_synth as PD
    from portbench.core import judge_train

    cfg = {"batch": 3, "height": 32, "width": 48,
           "data": {"n_objects": 2, "max_shift": 6.0, "bg_max_shift": 3.0,
                    "downsample_frac": 0.34, "real_frac": 0.0,
                    "local_motion_frac": 0.0}}
    d = cfg["data"]
    args = (3, 32, 48, 2, 6.0, 3.0)
    kw = dict(downsample_frac=0.34, real_frac=0.0, local_motion_frac=0.0,
              channels=1)
    made = torch.Generator().manual_seed(2 ** 33 + 1)
    for _ in range(3):
        PD.generate_batch(made, *args, **kw)
    want = PD.generate_batch(made, *args, **kw)
    moved = torch.Generator().manual_seed(2 ** 33 + 1)
    judge_train.skip_batches(moved, 3, cfg, 1)
    from portbench.reference import data_synth as RD

    got = RD.generate_batch(moved, *args[:4], d["max_shift"],
                            d["bg_max_shift"], **kw)
    for k in ("img1", "img2", "flow"):
        assert torch.equal(got[k], want[k])


def _objects(centers):
    k = 4
    obj = RTy.MovingObjects.empty(k)
    c = obj.center.clone()
    valid = obj.valid.clone()
    for i, xyz in enumerate(centers):
        c[i] = torch.tensor(xyz)
        valid[i] = True
    return obj.replace(center=c, valid=valid)


def test_chain_numbers_count_and_centres():
    class Tracked:
        def __init__(self, objects):
            self.objects = objects

    def side(dets, tracks):
        return {"detections": _objects(dets),
                "tracked": Tracked(_objects(tracks))}

    a = side([(0, 0, 5), (1, 0, 8)], [(0, 0, 5)])
    assert judge_serve.chain_numbers(a, a) == {"chain_count_gap": 0,
                                               "chain_center_gap_m": 0.0}
    b = side([(0, 0, 5.5)], [])
    n = judge_serve.chain_numbers(a, b)
    assert n["chain_count_gap"] == 2
    # (1, 0, 8) lies sqrt(1 + 6.25) m from the one centre of the other side.
    assert abs(n["chain_center_gap_m"] - (1 + 2.5 ** 2) ** 0.5) < 1e-6
