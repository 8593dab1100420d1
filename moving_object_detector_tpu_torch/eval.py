"""Evaluation metrics: detection/velocity/flow/disparity parity measures
(the JAX package's ``eval.py``: the numpy metrics copied,
``evaluate_planar_sequence`` driving the port's ``detect_step``).

The reference has no quantitative evaluation at all (SURVEY.md §4 — its
validation is a human watching RViz). This module provides the metrics the
parity story needs (BASELINE.json configs: "IoU/velocity parity", "KITTI
flow metrics"):

* 3D axis-aligned IoU matching between detection sets (greedy, like the
  tracker's association);
* per-matched-pair center / velocity / bounding-box errors;
* dense flow endpoint error (EPE) and KITTI outlier rate (Fl);
* disparity D1 (KITTI: |d - d_gt| > 3 px and > 5%) and density;
* sequence-level aggregation for recorded or synthetic runs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def _aabb_iou(center_a, size_a, center_b, size_b) -> float:
    """IoU of two axis-aligned 3D boxes given centers and sizes."""
    lo_a = np.asarray(center_a) - np.asarray(size_a) / 2
    hi_a = np.asarray(center_a) + np.asarray(size_a) / 2
    lo_b = np.asarray(center_b) - np.asarray(size_b) / 2
    hi_b = np.asarray(center_b) + np.asarray(size_b) / 2
    inter = np.maximum(0.0, np.minimum(hi_a, hi_b) - np.maximum(lo_a, lo_b))
    vol_i = float(np.prod(inter))
    vol_a = float(np.prod(np.maximum(hi_a - lo_a, 0)))
    vol_b = float(np.prod(np.maximum(hi_b - lo_b, 0)))
    denom = vol_a + vol_b - vol_i
    return vol_i / denom if denom > 0 else 0.0


@dataclasses.dataclass
class DetectionMatch:
    index_pred: int
    index_gt: int
    iou: float
    center_error: float
    velocity_error: float


@dataclasses.dataclass
class DetectionMetrics:
    n_pred: int
    n_gt: int
    matches: list
    precision: float
    recall: float
    mean_iou: float
    mean_center_error: float
    mean_velocity_error: float


def match_detections(
    pred_centers,
    pred_sizes,
    pred_velocities,
    gt_centers,
    gt_sizes,
    gt_velocities,
    iou_threshold: float = 0.25,
) -> DetectionMetrics:
    """Greedy IoU matching (highest IoU first) + per-pair errors."""
    pred_centers = np.atleast_2d(np.asarray(pred_centers, np.float64))
    gt_centers = np.atleast_2d(np.asarray(gt_centers, np.float64))
    n_p = 0 if pred_centers.size == 0 else len(pred_centers)
    n_g = 0 if gt_centers.size == 0 else len(gt_centers)
    pairs = []
    for i in range(n_p):
        for j in range(n_g):
            iou = _aabb_iou(
                pred_centers[i], np.asarray(pred_sizes)[i],
                gt_centers[j], np.asarray(gt_sizes)[j],
            )
            if iou >= iou_threshold:
                pairs.append((iou, i, j))
    pairs.sort(reverse=True)
    used_p, used_g = set(), set()
    matches = []
    for iou, i, j in pairs:
        if i in used_p or j in used_g:
            continue
        used_p.add(i)
        used_g.add(j)
        ce = float(np.linalg.norm(pred_centers[i] - gt_centers[j]))
        ve = float(
            np.linalg.norm(
                np.asarray(pred_velocities)[i] - np.asarray(gt_velocities)[j]
            )
        )
        matches.append(DetectionMatch(i, j, iou, ce, ve))
    precision = len(matches) / n_p if n_p else (1.0 if n_g == 0 else 0.0)
    recall = len(matches) / n_g if n_g else 1.0
    return DetectionMetrics(
        n_pred=n_p,
        n_gt=n_g,
        matches=matches,
        precision=precision,
        recall=recall,
        mean_iou=float(np.mean([m.iou for m in matches])) if matches else 0.0,
        mean_center_error=(
            float(np.mean([m.center_error for m in matches])) if matches else np.nan
        ),
        mean_velocity_error=(
            float(np.mean([m.velocity_error for m in matches])) if matches else np.nan
        ),
    )


def flow_epe(pred_flow, gt_flow, valid_mask=None):
    """Mean endpoint error + KITTI Fl outlier rate (>3 px and >5%)."""
    pred = np.asarray(pred_flow, np.float64)
    gt = np.asarray(gt_flow, np.float64)
    err = np.linalg.norm(pred - gt, axis=-1)
    mag = np.linalg.norm(gt, axis=-1)
    valid = np.isfinite(err)
    if valid_mask is not None:
        valid &= np.asarray(valid_mask, bool)
    if not valid.any():
        return {"epe": np.nan, "fl": np.nan, "density": 0.0}
    e = err[valid]
    m = mag[valid]
    outlier = (e > 3.0) & (e > 0.05 * np.maximum(m, 1e-9))
    return {
        "epe": float(e.mean()),
        "fl": float(outlier.mean()),
        "density": float(valid.mean()),
    }


def disparity_d1(pred_disp, gt_disp, gt_valid=None):
    """KITTI D1: fraction of valid pixels with |err| > 3 px and > 5% of gt,
    plus density of valid predictions."""
    pred = np.asarray(pred_disp, np.float64)
    gt = np.asarray(gt_disp, np.float64)
    gt_ok = np.isfinite(gt) & (gt > 0)
    if gt_valid is not None:
        gt_ok &= np.asarray(gt_valid, bool)
    pred_ok = np.isfinite(pred) & (pred >= 0)
    both = gt_ok & pred_ok
    if not both.any():
        return {"d1": np.nan, "density": 0.0, "mae": np.nan}
    err = np.abs(pred[both] - gt[both])
    bad = (err > 3.0) & (err > 0.05 * gt[both])
    return {
        "d1": float(bad.mean()),
        "density": float(both.sum() / max(gt_ok.sum(), 1)),
        "mae": float(err.mean()),
    }


def evaluate_synthetic_sequence(results, sequence) -> dict:
    """Aggregate detection metrics of PipelineRunner results against a
    SyntheticStereoSequence's ground truth."""
    per_frame = []
    for r in results:
        if r.index == 0:
            continue
        _, _, _, truth = sequence.frame(r.index)
        y, x, hh, ww = truth["obj_box"]
        # Ground-truth box in camera coordinates.
        z = truth["z"]
        fx = sequence.fx
        cx = sequence.w / 2.0
        cy = sequence.h / 2.0
        x0 = (x - cx) / fx * z
        x1 = (x + ww - cx) / fx * z
        y0 = (y - cy) / fx * z
        y1 = (y + hh - cy) / fx * z
        gt_center = [(x0 + x1) / 2, (y0 + y1) / 2, z]
        gt_size = [x1 - x0, y1 - y0, 0.2]
        m = match_detections(
            r.detections["center"],
            r.detections["bounding_box"],
            r.detections["velocity"],
            [gt_center],
            [gt_size],
            [list(truth["velocity"])],
            iou_threshold=0.1,
        )
        per_frame.append(m)
    if not per_frame:
        return {}
    return {
        "frames": len(per_frame),
        "recall": float(np.mean([m.recall for m in per_frame])),
        "precision": float(np.mean([m.precision for m in per_frame])),
        "mean_velocity_error": float(
            np.nanmean([m.mean_velocity_error for m in per_frame])
        ),
        "mean_center_error": float(
            np.nanmean([m.mean_center_error for m in per_frame])
        ),
    }


def evaluate_planar_sequence(
    seq,
    flow_model=None,
    flow_input_scale: int = 1,
    sgm_input_scale: int = 1,
    dynamic_disparity_rate: float = 0.0,
    config=None,
    min_visible_frac: float = 1.5,
    hit_margin_px: int = 16,
    details: bool = False,
    flow_oracle: bool = False,
    disparity_oracle: bool = False,
    device=None,
) -> dict:
    """Run the FULL pipeline over a PlanarSceneSequence and score every
    product against the renderer's analytic ground truth (io/scenes.py).

    This is the quantitative replacement for the reference's entire
    validation story (a human watching rviz over a Gazebo run,
    README.md:54-68): per-frame SGM D1, optical-flow EPE/Fl on
    previously-visible pixels, ego-motion rotation/translation error, and
    end-to-end detection hits / phantoms / velocity error against every
    scene object.

    Detection scoring: a GT object is *scoreable* in a frame when its
    visible pixel count is at least ``min_visible_frac * cluster_size``
    (an occluded or frame-exiting object is not a miss). A detection is a
    hit for the GT object whose (padded) visible-pixel box contains its
    projected center; matching none of the objects makes it a phantom.

    ``flow_model`` is a ``PWCNet`` holding its weights (``params_from_flax``
    or ``load_flow_checkpoint``), on ``device``; it is unused with
    ``flow_oracle``. ``flow_oracle``/``disparity_oracle`` replace the
    corresponding perception stage's output with the renderer's analytic
    ground truth (detect_step's flow_override/disparity_override). Running
    the four combinations attributes the velocity error budget between
    flow error, disparity (subpixel) error, and the downstream
    scene-flow/median-selection terms.

    Runs on ``cuda`` unless ``device`` says otherwise (``"cpu"`` for the
    tests); each frame's outputs come to the host as one batch of copies.
    Returns a flat dict of aggregate metrics.
    """
    import dataclasses as _dc

    import torch

    from . import resolve_device
    from .config import PipelineConfig
    from .pipeline import PipelineState, detect_step
    from .types import DisparityImage, StereoModel, to_host

    dev = resolve_device(device)
    h, w = seq.h, seq.w
    if config is None:
        config = PipelineConfig(
            height=h, width=w,
            flow_input_scale=flow_input_scale,
            sgm_input_scale=sgm_input_scale,
        )
        # Resolution-rescaled tunables, exactly as a reference user would
        # set via dynamic_reconfigure for a non-KITTI stream
        # (Clusterer.cfg:8, SceneFlowConstructor.cfg:8): cluster_size is
        # a frame-area fraction, dynamic_flow_diff a pixel threshold.
        ref_frac = 2500.0 / (1242.0 * 376.0)
        config = _dc.replace(
            config,
            clusterer=_dc.replace(
                config.clusterer,
                cluster_size=max(50, int(ref_frac * h * w)),
            ),
            scene_flow=_dc.replace(
                config.scene_flow,
                dynamic_flow_diff=config.scene_flow.dynamic_flow_diff
                * (w / 1242.0),
                # m/s threshold: physical units, no resolution rescale.
                dynamic_disparity_rate=dynamic_disparity_rate,
            ),
        )
    stereo = StereoModel.create(
        fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, baseline=seq.baseline,
        device=dev,
    )
    state = PipelineState.create(config, device=dev)

    d1s, flows, rot_errs, trans_errs = [], [], [], []
    detail_frames = []
    hits = misses = phantoms = 0
    vel_errs, center_errs = [], []
    ego_fail = 0
    for k in range(seq.n_frames):
        left, right, t, truth = seq.frame(k)
        overrides = {}
        if flow_oracle:
            overrides["flow_override"] = torch.as_tensor(
                truth["flow"], dtype=torch.float32, device=dev)
        if disparity_oracle:
            overrides["disparity_override"] = DisparityImage.create(
                torch.as_tensor(truth["disparity"], dtype=torch.float32,
                                device=dev),
                stereo.cam.fx, stereo.baseline, min_disparity=0.0,
                max_disparity=float(config.sgm.max_disparity))
        state, out = detect_step(
            flow_model, state, torch.as_tensor(left, device=dev),
            torch.as_tensor(right, device=dev), t, stereo, config,
            **overrides)
        # One batch of copies of what the scoring reads.
        out = to_host(_dc.replace(out, **{
            f.name: None for f in _dc.fields(out) if f.name not in (
                "disparity", "flow", "motion", "ego_success", "detections")}))
        d1s.append(
            disparity_d1(np.asarray(out.disparity.disparity),
                         truth["disparity"])
        )
        if k == 0:
            continue
        flows.append(
            flow_epe(np.asarray(out.flow), truth["flow"],
                     valid_mask=truth["prev_visible"])
        )
        m_est = np.asarray(out.motion, np.float64)
        m_gt = truth["motion_prev2now"].astype(np.float64)
        dr = m_est[:3, :3] @ m_gt[:3, :3].T
        ang = np.degrees(
            np.arccos(np.clip((np.trace(dr) - 1.0) / 2.0, -1.0, 1.0))
        )
        rot_errs.append(float(ang))
        trans_errs.append(float(np.linalg.norm(m_est[:3, 3] - m_gt[:3, 3])))
        ego_fail += int(not bool(out.ego_success))

        valid = np.asarray(out.detections.valid)
        centers = np.asarray(out.detections.center)
        vels = np.asarray(out.detections.velocity)
        min_px = min_visible_frac * config.clusterer.cluster_size
        scoreable_idx = [
            j for j, o in enumerate(truth["objects"])
            if o["px_box"] is not None and o["visible_px"] >= min_px
        ]
        scoreable = [truth["objects"][j] for j in scoreable_idx]
        matched = [False] * len(scoreable)
        # Candidate (distance, detection, object) pairs: GT objects whose
        # padded image box contains the detection center. Image-box
        # containment alone mis-scores CROSSING objects: during the
        # occlusion scene's crossover both boxes contain both detections,
        # and first-match attribution scored the near object's detection
        # against the far object — a phantom 3.4 m center error / 1.9 m/s
        # velocity error (the objects' 3D separation), not a detector
        # failure (the JAX package's scale-2 scene matrix). Assignment
        # is therefore GLOBAL nearest-pair-first over the whole frame, not
        # per-detection in index order: a duplicate detection can no
        # longer claim the farther object before that object's own closer
        # detection is processed.
        pairs = []
        frame_phantoms = []
        for i in np.flatnonzero(valid):
            cz = centers[i, 2]
            if cz <= 0:
                phantoms += 1
                frame_phantoms.append({
                    "center": centers[i].tolist(),
                    "vel": vels[i].tolist(), "px": None,
                })
                continue
            u = seq.fx * centers[i, 0] / cz + seq.cx
            v = seq.fy * centers[i, 1] / cz + seq.cy
            cand = [
                (float(np.linalg.norm(centers[i] - o["center_cam"])),
                 int(i), j)
                for j, o in enumerate(scoreable)
                if (o["px_box"][1] - hit_margin_px <= u
                    <= o["px_box"][1] + o["px_box"][3] + hit_margin_px
                    and o["px_box"][0] - hit_margin_px <= v
                    <= o["px_box"][0] + o["px_box"][2] + hit_margin_px)
            ]
            if not cand:
                phantoms += 1
                frame_phantoms.append({
                    "center": centers[i].tolist(),
                    "vel": vels[i].tolist(),
                    "px": [float(u), float(v)],
                })
                continue
            pairs.extend(cand)
        det_assigned = set()
        for _, i, j in sorted(pairs):
            if matched[j] or i in det_assigned:
                # Detections left unassigned are duplicate detections of
                # an already-matched object — neither hits nor phantoms
                # (unchanged semantics).
                continue
            o = scoreable[j]
            matched[j] = True
            det_assigned.add(i)
            hits += 1
            vel_errs.append(float(np.linalg.norm(
                vels[i] - o["velocity_cam"]
            )))
            center_errs.append(float(np.linalg.norm(
                centers[i] - o["center_cam"]
            )))
        misses += matched.count(False)
        if details:
            detail_frames.append({
                "k": k,
                "scoreable": [
                    {"obj_index": scoreable_idx[jj],
                     "px_box": o["px_box"], "visible_px": o["visible_px"],
                     "vel_cam": o["velocity_cam"].tolist(),
                     "center_cam": o["center_cam"].tolist()}
                    for jj, o in enumerate(scoreable)
                ],
                "matched": list(matched),
                "detections": [
                    {"center": centers[i].tolist(),
                     "vel": vels[i].tolist()}
                    for i in np.flatnonzero(valid)
                ],
                "phantoms": frame_phantoms,
            })

    n_scored = hits + misses
    return {
        "frames": seq.n_frames,
        "d1": float(np.nanmean([d["d1"] for d in d1s])),
        "d1_density": float(np.nanmean([d["density"] for d in d1s])),
        "disp_mae": float(np.nanmean([d["mae"] for d in d1s])),
        "flow_epe": float(np.nanmean([f["epe"] for f in flows])),
        "flow_fl": float(np.nanmean([f["fl"] for f in flows])),
        "ego_rot_err_deg": float(np.mean(rot_errs)),
        "ego_trans_err_m": float(np.mean(trans_errs)),
        "ego_failures": ego_fail,
        "det_hits": hits,
        "det_misses": misses,
        "det_scoreable": n_scored,
        "phantoms": phantoms,
        "vel_err_median": float(np.median(vel_errs)) if vel_errs
        else float("nan"),
        "center_err_median": float(np.median(center_errs)) if center_errs
        else float("nan"),
        **({"detail_frames": detail_frames} if details else {}),
    }
