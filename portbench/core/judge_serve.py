"""Whether the serving step's outputs are right: each sampled pair's
stages against the plain reference (``portbench/reference/``), stage by
stage.

The reference runs each stage from what the program's earlier stages
gave it (``reference.step.run_frame`` with ``given``) and from the state
the program started the pair with: ego-motion from the program's flow
and previous disparity, the scene flow from its disparity, flow and
motion, the clusterer from its cloud, the tracker from its detections and
previous tracks. So each stage is judged by itself, and a fault shows in
the stage that makes it. The start of the chain is checked apart: the
state a sampled pair starts from holds the previous pair's image, and the
state it leaves holds its own image, disparity, time, index, pose and
tracks. Beside the stages, the reference's own chain runs from the pair's
images to its tracks (its own disparity, flow, motion, cloud and
detections, from the state the program started the pair with), and the
program's detections and tracks are read against that chain's by their
counts and centres (``chain_count_gap``, ``chain_center_gap_m``). They are
read and not compared: the bf16 flow's rounding alone moves a point across
the clusterer's speed threshold, and sound runs and the control read
alike (PERF.md).

The reference computes in the precisions the configuration states: the
flow net's convolutions in bf16 (its warp, like the program's, in the
flow's type), everything else in f32 with TF32 off. Compared numbers:
the flow's mean end-point gap, and the ego-motion judged by what it says
(its MSAC score on the correspondences of the reference's own flow
against the reference's own motion's there: a RANSAC kernel that picks
another of two near-equal candidates reads a gap of motions, but no gap
of scores), have limits between the readings of sound runs and of the
lower-precision control; every other number counts values that differ
and has the limit 0, since the kernels on that path are bitwise their
plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

# Each compared number's limit; the readings each was set from are in
# PERF.md.
LIMITS = {
    "disparity_px_differ": 0,
    "flow_epe_px": 0.08,
    "ego_success_differ": 0,
    "ego_score_excess": 0.02,
    "scene_flow_differ": 0,
    "labels_differ": 0,
    "detections_differ": 0,
    "tracks_differ": 0,
    "state_differ": 0,
}


def _ref_types():
    from ..reference import tracker, types

    return types, tracker


def as_reference(obj):
    """A program dataclass as the reference's class of the same name (the
    same fields), tensors shared; tensors and plain values pass."""
    types, tracker = _ref_types()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(types, type(obj).__name__, None) or getattr(
            tracker, type(obj).__name__)
        return cls(**{f.name: as_reference(getattr(obj, f.name))
                      for f in dataclasses.fields(cls)})
    return obj


def state_dict_of(state) -> dict:
    """The program's ``PipelineState`` as the dict ``run_frame`` takes."""
    return dict(pose=state.pose, prev_left=state.prev_left,
                prev_disparity=as_reference(state.prev_disparity),
                prev_time=state.prev_time, has_prev=bool(state.has_prev),
                tracker=as_reference(state.tracker),
                frame_index=int(state.frame_index))


def outputs_of(out) -> dict:
    """The program's ``FrameOutput`` as the dict ``run_frame`` returns."""
    return {f.name: as_reference(getattr(out, f.name))
            for f in dataclasses.fields(out)}


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of ``a`` and ``b`` that differ, NaN equal to NaN; a shape
    or type mismatch counts every entry."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1)
    same = a == b
    if a.is_floating_point():
        same = same | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def _tree_differ(a, b) -> int:
    if isinstance(a, torch.Tensor):
        return _differ(a, torch.as_tensor(b, device=a.device))
    if dataclasses.is_dataclass(a):
        return sum(_tree_differ(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return int(a != b)


def judge_frame(net, stereo, config, rec: dict) -> dict:
    """The numbers of one sampled pair. ``rec`` holds ``state_in`` and
    ``state_out`` (``run_frame``'s state dicts), ``left`` and ``right``
    (the device images the step took), ``t``, ``outputs`` (the step's
    outputs as ``run_frame`` names them) and ``prev_image`` (the host
    left image of the pair processed before, or None)."""
    from ..reference.step import run_frame

    p = rec["outputs"]
    given = {k: p[k] for k in ("disparity", "flow", "motion", "ego_success",
                               "scene_flow", "detections")}
    ref, nxt = run_frame(net, rec["state_in"], rec["left"], rec["right"],
                         rec["t"], stereo, config, given=given,
                         own_motion=True)
    n = {}
    n["disparity_px_differ"] = _differ(p["disparity"].disparity,
                                       ref["disparity"].disparity)
    d = p["flow"].float() - ref["flow"].float()
    epe = torch.sqrt((d * d).sum(-1))
    n["flow_epe_px"] = float(epe.mean())
    # Beside it, read and not compared: the median and the 99th
    # percentile of the pixels' gaps.
    q = torch.quantile(epe.flatten()[::7], torch.tensor(
        [0.05, 0.25, 0.5, 0.99], device=epe.device))
    (n["flow_epe_p05_px"], n["flow_epe_p25_px"], n["flow_epe_median_px"],
     n["flow_epe_p99_px"]) = (float(v) for v in q)
    ok_p, ok_r = bool(p["ego_success"]), bool(ref["ego_success"])
    n["ego_success_differ"] = int(ok_p != ok_r)
    n["ego_motion_gap"] = float((p["motion"] - ref["motion"]).abs().max())
    # Read and not compared: the gap to the motion of the reference's own
    # flow.
    n["ego_motion_gap_own_flow"] = float(
        (p["motion"] - ref["motion_own"]).abs().max())
    # What the motion says: its MSAC score on the correspondences of the
    # reference's own flow, against the score there of the reference's
    # own motion, as a share of the latter (0 where it explains them as
    # well or better).
    s_ref = ref["score"](ref["motion_own"])
    n["ego_score_excess"] = max(0.0, (ref["score"](p["motion"]) - s_ref)
                                / max(s_ref, 1e-6))
    n["scene_flow_differ"] = (
        _differ(p["scene_flow"].points, ref["scene_flow"].points)
        + _differ(p["scene_flow"].velocity, ref["scene_flow"].velocity)
        + _differ(p["static_flow"], ref["static_flow"]))
    n["labels_differ"] = _differ(p["label_image"], ref["label_image"])
    # Read and not compared: what the pair held.
    n["detections_n"] = int(p["detections"].valid.sum())
    n["tracks_n"] = int(p["tracked"].objects.valid.sum())
    n["detections_differ"] = (
        _tree_differ(p["detections"], ref["detections"])
        + _differ(torch.as_tensor(p["cluster_overflow"]).reshape(()).cpu(),
                  torch.as_tensor(ref["cluster_overflow"]).reshape(()).cpu()))
    so = rec["state_out"]
    n["tracks_differ"] = (_tree_differ(p["tracked"], ref["tracked"])
                          + _tree_differ(so["tracker"], nxt["tracker"]))
    n.update(chain_numbers(p, run_frame(
        net, rec["state_in"], rec["left"], rec["right"], rec["t"], stereo,
        config, own=ref)[0]))
    si = rec["state_in"]
    state = [
        _differ(so["prev_left"], rec["left"].float()),
        _differ(so["prev_disparity"].disparity, p["disparity"].disparity),
        _differ(torch.as_tensor(so["prev_time"], dtype=torch.float32).cpu(),
                torch.as_tensor(rec["t"], dtype=torch.float32)),
        int(so["frame_index"] != si["frame_index"] + 1),
        int(not so["has_prev"]),
        _differ(so["pose"], nxt["pose"]),
        _differ(p["odom_pose"], ref["odom_pose"]),
    ]
    if rec.get("prev_image") is not None:
        prev = torch.as_tensor(rec["prev_image"]).to(si["prev_left"].device)
        state.append(_differ(si["prev_left"], prev.float()))
    n["state_differ"] = sum(state)
    return n


def _centers(objects) -> torch.Tensor:
    return objects.center[objects.valid].float()


def chain_numbers(p: dict, chain: dict) -> dict:
    """The program's detections and published tracks against those of the
    reference's own chain from the pair's images (its own disparity,
    flow, motion, scene flow and clusters): ``chain_count_gap``, the
    detections and tracks one side has more of; ``chain_center_gap_m``,
    the farthest that a centre on either side lies from the nearest
    centre on the other (0 where a side has none)."""
    count, far = 0, 0.0
    for a, b in ((p["detections"], chain["detections"]),
                 (p["tracked"].objects, chain["tracked"].objects)):
        ca, cb = _centers(a), _centers(b)
        count += abs(ca.shape[0] - cb.shape[0])
        if ca.shape[0] and cb.shape[0]:
            d = torch.cdist(ca, cb)
            far = max(far, float(d.min(1).values.max()),
                      float(d.min(0).values.max()))
    return {"chain_count_gap": count, "chain_center_gap_m": far}


def worst(per_frame: list) -> dict:
    """The sample's numbers: the largest gap, the sum of counts."""
    out = {}
    for name in per_frame[0]:
        vals = [f[name] for f in per_frame]
        out[name] = max(vals) if isinstance(vals[0], float) else sum(vals)
    return out


def checks(numbers: dict, limits: dict = LIMITS) -> list:
    return [dict(name=k, value=numbers[k], limit=limits[k],
                 ok=bool(numbers[k] <= limits[k])) for k in limits]
