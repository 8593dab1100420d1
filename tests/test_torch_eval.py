"""The port's ``eval.py`` against the JAX package's.

The numpy metrics are copies: on the same seeded inputs they give equal
results. ``evaluate_planar_sequence`` drives each package's own
``detect_step`` (the port's on the CPU, as a caller must ask it to) over
the held-out-texture sequence of ``tests/test_real_sequence.py`` at 96 x
224 (fx 150, the same field of view as its 192 x 448 run), scale 1, 4
frames, with the same pwc_v7 weights. The tolerances below stand beside
the differences measured on this input (CPU, both packages):

* SGM is bitwise equal (D1, density, MAE are equal);
* the flow net runs in bf16 in both, with other rounding: flow EPE
  0.8134 against 0.8096 px, Fl 0.0102 against 0.0108;
* the RANSAC's hypotheses cannot be drawn as ``jax.random.choice`` draws
  them (ROADMAP.md Queue 3), so the ego-motion differs: rotation error
  0.267 against 0.248 deg, translation 0.0467 against 0.0444 m; and the
  median velocity error of the three hits, 1.775 against 2.176 m/s (at
  this size a hit's depth velocity turns on which previous pixels the
  flow matches, and with the flow net in f32 on both sides the two read
  1.694 against 2.122, so most of it is the draws);
* hits, misses, phantoms and the centre error are equal.

With ``flow_oracle`` and ``disparity_oracle`` only the draws differ:
rotation 0.2534 against 0.2531 deg, translation 0.0630 against 0.0628 m,
velocity 0.4660 against 0.4702 m/s, the rest equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import eval as jeval
from moving_object_detector_tpu.config import PipelineConfig as JConfig
from moving_object_detector_tpu.io import readers as jreaders
from moving_object_detector_tpu.io import scenes as jscenes
from moving_object_detector_tpu.models.pwc_net import PWCNet as JPWCNet
from moving_object_detector_tpu.utils import checkpoint as jckpt
from moving_object_detector_tpu_torch import eval as teval
from moving_object_detector_tpu_torch.config import FlowNetConfig
from moving_object_detector_tpu_torch.io import readers as treaders
from moving_object_detector_tpu_torch.io import scenes as tscenes
from moving_object_detector_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "real_textures.npz")
H, W, FX, N_FRAMES = 96, 224, 150.0, 4

# Metric -> largest |port - JAX| accepted (None: equal).
TOL = {
    "frames": None, "d1": None, "d1_density": None, "disp_mae": None,
    "flow_epe": 0.02, "flow_fl": 0.005,
    "ego_rot_err_deg": 0.05, "ego_trans_err_m": 0.01, "ego_failures": None,
    "det_hits": None, "det_misses": None, "det_scoreable": None,
    "phantoms": None, "vel_err_median": 0.6, "center_err_median": 1e-6,
}
TOL_ORACLE = dict(TOL, flow_epe=None, flow_fl=None, ego_rot_err_deg=0.005,
                  ego_trans_err_m=0.002, vel_err_median=0.05)


def _assert_metrics_match(port, ref, tol):
    assert sorted(port) == sorted(ref)
    for key, bound in tol.items():
        if bound is None:
            assert port[key] == ref[key], (key, port[key], ref[key])
        else:
            assert abs(port[key] - ref[key]) <= bound, (
                key, port[key], ref[key], bound)
    # The same objects matched in the same frames.
    assert ([f["matched"] for f in port["detail_frames"]]
            == [f["matched"] for f in ref["detail_frames"]])
    assert ([f["k"] for f in port["detail_frames"]]
            == [f["k"] for f in ref["detail_frames"]])


# --- the numpy metrics --------------------------------------------------

def _boxes(rng, n):
    return (rng.normal(0, 2, (n, 3)) + [0, 0, 8],
            rng.uniform(0.5, 2, (n, 3)), rng.normal(0, 1, (n, 3)))


@pytest.mark.parametrize("n_pred,n_gt,iou", [
    (0, 0, 0.25), (0, 3, 0.25), (4, 0, 0.25), (6, 5, 0.25), (9, 9, 0.05),
])
def test_match_detections_equals_jax(n_pred, n_gt, iou):
    rng = np.random.default_rng(n_pred * 10 + n_gt)
    gt = _boxes(rng, n_gt)
    # Half the predictions near the truth, so that some pairs overlap.
    near = min(n_pred // 2, n_gt)
    pred = tuple(np.concatenate([g[:near] + rng.normal(0, 0.2, (near, 3)),
                                 e])
                 for g, e in zip(gt, _boxes(rng, n_pred - near)))
    a = teval.match_detections(*pred, *gt, iou_threshold=iou)
    b = jeval.match_detections(*pred, *gt, iou_threshold=iou)
    np.testing.assert_equal(vars(a) | {"matches": None},
                            vars(b) | {"matches": None})
    assert [vars(m) for m in a.matches] == [vars(m) for m in b.matches]
    assert (teval._aabb_iou([0.5, 0.5, 0.5], [1, 1, 1], [1, 0.5, 0.5],
                            [1, 1, 1])
            == jeval._aabb_iou([0.5, 0.5, 0.5], [1, 1, 1], [1, 0.5, 0.5],
                               [1, 1, 1]))


@pytest.mark.parametrize("masked", [False, True])
def test_flow_epe_and_d1_equal_jax(masked):
    rng = np.random.default_rng(7)
    gt = rng.normal(0, 8, (24, 40, 2))
    pred = gt + rng.normal(0, 2, gt.shape)
    pred[3, :5] = np.nan
    mask = rng.random((24, 40)) > 0.3 if masked else None
    assert teval.flow_epe(pred, gt, mask) == jeval.flow_epe(pred, gt, mask)
    none = np.zeros((24, 40), bool)
    np.testing.assert_equal(teval.flow_epe(pred, gt, none),
                            jeval.flow_epe(pred, gt, none))
    dgt = rng.uniform(5, 60, (24, 40))
    dgt[0] = np.nan
    dpred = dgt + rng.normal(0, 3, dgt.shape)
    dpred[1, :7] = -1.0
    assert (teval.disparity_d1(dpred, dgt, mask)
            == jeval.disparity_d1(dpred, dgt, mask))


def test_evaluate_synthetic_sequence_equals_jax():
    """Detections made from each frame's truth with noise and a spurious
    one, scored against each package's synthetic sequence."""
    kw = dict(height=64, width=128, fx=100.0, baseline=0.5, z_obj=4.0,
              obj_size=(20, 30), obj_speed_px=5.0, n_frames=6)
    tseq, jseq = treaders.SyntheticStereoSequence(**kw), \
        jreaders.SyntheticStereoSequence(**kw)
    rng = np.random.default_rng(11)

    class Result:
        def __init__(self, k):
            self.index = k
            y, x, hh, ww = tseq.frame(k)[3]["obj_box"]
            z = tseq.z_obj
            c = [(x + ww / 2 - 64) / 100 * z, (y + hh / 2 - 32) / 100 * z, z]
            self.detections = {
                "center": np.array([c, [3.0, 0.0, 9.0]])
                + rng.normal(0, 0.05, (2, 3)),
                "bounding_box": np.array([[1.2, 0.8, 0.2], [1.0, 1.0, 0.2]]),
                "velocity": np.array([[2.0, 0, 0], [0, 0, 0]])
                + rng.normal(0, 0.1, (2, 3)),
            }

    results = [Result(k) for k in range(kw["n_frames"])]
    got = teval.evaluate_synthetic_sequence(results, tseq)
    assert got == jeval.evaluate_synthetic_sequence(results, jseq)
    assert got["recall"] == 1.0 and got["precision"] == 0.5


def test_scale2_gate_allowlist_equals_jax():
    names = [None, "", "weights/pwc_v7.fp16.npz", "pwc_v6m3.fp16.npz",
             "/x/pwc_p3.fp16.npz", "pwc_v4.fp16.npz", "pwc_v2.fp16.npz",
             "pwc_v7_candidate.fp16.npz", "/data/pwc_v7.fp16.npz.bak"]
    for name in names:
        assert (tckpt.flow_checkpoint_scale2_gated(name)
                == jckpt.flow_checkpoint_scale2_gated(name)), name
    assert tckpt.flow_checkpoint_scale2_gated(
        tckpt.default_flow_checkpoint())


# --- evaluate_planar_sequence -------------------------------------------

def _sequence(m):
    data = np.load(FIXTURE)
    tex = {k: data[k].astype(np.float32) / 255.0
           for k in data.files if k.startswith("heldout_")}
    return m.PlanarSceneSequence(
        H, W, fx=FX, bg_depth=12.0, bg_texture=tex["heldout_camera"],
        objects=[
            m.PlaneObject(center0=(-1.2, -0.75, 6.0), size=(2.0, 1.28),
                          velocity=(2.0, 0.0, 0.0),
                          texture=tex["heldout_blade"]),
            m.PlaneObject(center0=(0.55, 0.5, 6.5), size=(1.7, 1.1),
                          velocity=(0.2, 0.0, -4.0),
                          texture=tex["heldout_freedom"]),
        ],
        cam_velocity=(0.5, 0.0, 0.3), yaw_rate=np.deg2rad(1.5),
        fps=10.0, n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def nets():
    ckpt = tckpt.default_flow_checkpoint()
    assert ckpt is not None and os.path.basename(ckpt) == "pwc_v7.fp16.npz"
    params, cfg = jckpt.load_flow_checkpoint(ckpt, JConfig().flownet)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    model, _ = tckpt.load_flow_checkpoint(ckpt, FlowNetConfig(),
                                          device="cpu")
    return (params, JPWCNet(config=cfg)), model


@pytest.mark.parametrize("oracle", [False, True], ids=["flow_net",
                                                       "oracles"])
def test_evaluate_planar_sequence_matches_jax(nets, oracle):
    (params, jmodel), model = nets
    kw = dict(details=True, flow_oracle=oracle, disparity_oracle=oracle)
    ref = jeval.evaluate_planar_sequence(_sequence(jscenes), params, jmodel,
                                         **kw)
    port = teval.evaluate_planar_sequence(_sequence(tscenes), model,
                                          device="cpu", **kw)
    _assert_metrics_match(port, ref, TOL_ORACLE if oracle else TOL)
    if oracle:
        assert port["d1"] == 0.0 and port["flow_epe"] == 0.0
    assert port["det_hits"] >= N_FRAMES - 1


def test_evaluate_planar_sequence_needs_cuda_or_the_cpu(monkeypatch):
    """No fallback: without CUDA and without a device it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.evaluate_planar_sequence(_sequence(tscenes), flow_oracle=True,
                                       disparity_oracle=True)
