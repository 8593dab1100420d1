"""Multi-object tracking (the JAX package's ``tracker.py``): a
fixed-capacity bank of constant-velocity Kalman filters with greedy
nearest-neighbour association.

State x = (px, py, vx, vy); Q = diag(0.003, 0.003, 0.01, 0.01), R = 0.2 I,
P0 = 0.1 I; association cost -N(x; mean, cov) gated at sqrt(mahalanobis)
> 3 or euclidean > 1.5, resolved best-first; unmatched detections spawn
unless within 2 * object_radius of a track (including ones spawned
earlier in the same frame); tracks are pruned on covariance traces and
published after ``correction_count_limit`` corrections. All math f32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .config import TrackerConfig
from .types import MovingObjects, TrackedObjects


@dataclasses.dataclass(frozen=True)
class TrackerState:
    mean: torch.Tensor  # (T, 4) px, py, vx, vy
    cov: torch.Tensor  # (T, 4, 4)
    active: torch.Tensor  # (T,) bool
    id: torch.Tensor  # (T,) int32
    correction_count: torch.Tensor  # (T,) int32
    last_correction_time: torch.Tensor  # (T,) f32
    last_prediction_time: torch.Tensor  # (T,) f32
    last_obs: torch.Tensor  # (T, 9) center, velocity, bbox
    next_id: torch.Tensor  # () int32

    @classmethod
    def create(cls, capacity: int, device=None) -> "TrackerState":
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            mean=torch.zeros((capacity, 4), **f32),
            cov=torch.eye(4, **f32).repeat(capacity, 1, 1),
            active=torch.zeros((capacity,), dtype=torch.bool, device=device),
            id=torch.full((capacity,), -1, **i32),
            correction_count=torch.zeros((capacity,), **i32),
            last_correction_time=torch.full((capacity,), -1.0, **f32),
            last_prediction_time=torch.zeros((capacity,), **f32),
            last_obs=torch.zeros((capacity, 9), **f32),
            next_id=torch.zeros((), **i32),
        )

    def replace(self, **kw) -> "TrackerState":
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.mean.shape[0]


def _process_noise(cfg: TrackerConfig, device) -> torch.Tensor:
    return torch.diag(torch.tensor(
        [cfg.process_noise_pos, cfg.process_noise_pos,
         cfg.process_noise_vel, cfg.process_noise_vel],
        dtype=torch.float32, device=device))


def predict(state: TrackerState, t, cfg: TrackerConfig) -> TrackerState:
    """mean' = A mean, cov' = A cov A^T + Q for every active track."""
    dt = torch.clamp(t - state.last_prediction_time, min=cfg.min_dt)
    a = torch.eye(4, dtype=torch.float32, device=dt.device).repeat(
        state.capacity, 1, 1)
    a[:, 0, 2] = dt
    a[:, 1, 3] = dt
    new_mean = torch.einsum("tij,tj->ti", a, state.mean)
    new_cov = torch.einsum("tij,tjk,tlk->til", a, state.cov, a) + \
        _process_noise(cfg, dt.device)
    keep = state.active
    return state.replace(
        mean=torch.where(keep[:, None], new_mean, state.mean),
        cov=torch.where(keep[:, None, None], new_cov, state.cov),
        last_prediction_time=torch.where(keep, t, state.last_prediction_time),
    )


def _chol_inv_det4(a: torch.Tensor):
    """Inverse and determinant of SPD (..., 4, 4) matrices, unrolled
    Cholesky (the JAX package's closed form)."""
    eps = 1e-12
    aij = lambda i, j: a[..., i, j]
    sq = lambda v: torch.sqrt(torch.clamp(v, min=eps))
    l00 = sq(aij(0, 0))
    l10 = aij(1, 0) / l00
    l20 = aij(2, 0) / l00
    l30 = aij(3, 0) / l00
    l11 = sq(aij(1, 1) - l10 * l10)
    l21 = (aij(2, 1) - l20 * l10) / l11
    l31 = (aij(3, 1) - l30 * l10) / l11
    l22 = sq(aij(2, 2) - l20 * l20 - l21 * l21)
    l32 = (aij(3, 2) - l30 * l20 - l31 * l21) / l22
    l33 = sq(aij(3, 3) - l30 * l30 - l31 * l31 - l32 * l32)
    prod_diag = l00 * l11 * l22 * l33
    det = prod_diag * prod_diag
    m00, m11, m22, m33 = 1.0 / l00, 1.0 / l11, 1.0 / l22, 1.0 / l33
    m10 = -(l10 * m00) * m11
    m21 = -(l21 * m11) * m22
    m32 = -(l32 * m22) * m33
    m20 = -(l20 * m00 + l21 * m10) * m22
    m31 = -(l31 * m11 + l32 * m21) * m33
    m30 = -(l30 * m00 + l31 * m10 + l32 * m20) * m33
    z = torch.zeros_like(m00)
    m = torch.stack([
        torch.stack([m00, z, z, z], -1),
        torch.stack([m10, m11, z, z], -1),
        torch.stack([m20, m21, m22, z], -1),
        torch.stack([m30, m31, m32, m33], -1),
    ], dim=-2)
    return torch.einsum("...ki,...kj->...ij", m, m), det


def _association_cost(state: TrackerState, obs4, obs_valid,
                      cfg: TrackerConfig):
    """(T, O) cost -N(obs; mean, cov), inf where gated or invalid."""
    inv_cov, det = _chol_inv_det4(state.cov)
    diff = obs4[None, :, :] - state.mean[:, None, :]
    mahal_sq = torch.einsum("toi,tij,toj->to", diff, inv_cov, diff)
    eucl = torch.linalg.vector_norm(diff, dim=-1)
    gate = (mahal_sq <= cfg.gating_mahalanobis ** 2) & (
        eucl <= cfg.gating_deviation)
    norm_const = 1.0 / ((2.0 * math.pi) ** 2
                        * torch.sqrt(torch.clamp(det, min=1e-30)))
    cost = -(norm_const[:, None] * torch.exp(-0.5 * mahal_sq))
    invalid = ~gate | ~state.active[:, None] | ~obs_valid[None, :]
    return torch.where(invalid, torch.full_like(cost, float("inf")), cost)


def _greedy_associate(cost: torch.Tensor) -> torch.Tensor:
    """Best-first assignment with row/column elimination: per track, the
    matched observation index or -1. A fixed min(T, O) rounds of a masked
    argmin on the device, with no host sync (the JAX fori_loop)."""
    n_trackers, n_obs = cost.shape
    dev = cost.device
    rows = torch.arange(n_trackers, device=dev)
    cols = torch.arange(n_obs, device=dev)
    c = cost.detach().clone()
    match = torch.full((n_trackers,), -1, dtype=torch.int32, device=dev)
    for _ in range(min(n_trackers, n_obs)):
        flat = torch.argmin(c.reshape(-1))
        r, col = flat // n_obs, flat % n_obs
        found = torch.isfinite(c.reshape(-1)[flat])
        match = torch.where(found & (rows == r), col.to(torch.int32), match)
        c = c.masked_fill(found & ((rows[:, None] == r)
                                   | (cols[None, :] == col)), float("inf"))
    return match


def correct(state: TrackerState, t, detections: MovingObjects,
            cfg: TrackerConfig, object_radius=None,
            covariance_trace_limit=None) -> TrackerState:
    """Associate, KF-correct, spawn and prune."""
    dev = state.mean.device
    object_radius = torch.as_tensor(
        cfg.object_radius if object_radius is None else object_radius,
        dtype=torch.float32, device=dev)
    covariance_trace_limit = torch.as_tensor(
        cfg.covariance_trace_limit if covariance_trace_limit is None
        else covariance_trace_limit, dtype=torch.float32, device=dev)
    obs4 = torch.cat([detections.center[:, :2], detections.velocity[:, :2]],
                     dim=1)
    obs_record = torch.cat([detections.center, detections.velocity,
                            detections.bounding_box], dim=1)
    obs_valid = detections.valid

    match = _greedy_associate(_association_cost(state, obs4, obs_valid, cfg))
    matched = match >= 0
    midx = torch.clamp(match, min=0).long()

    z = obs4[midx]
    r_noise = torch.eye(4, dtype=torch.float32, device=dev) * \
        cfg.measurement_noise
    gain = torch.einsum("tij,tjk->tik", state.cov,
                        _chol_inv_det4(state.cov + r_noise)[0])
    new_mean = state.mean + torch.einsum("tij,tj->ti", gain, z - state.mean)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    new_cov = torch.einsum("tij,tjk->tik", eye[None] - gain, state.cov)
    state = state.replace(
        mean=torch.where(matched[:, None], new_mean, state.mean),
        cov=torch.where(matched[:, None, None], new_cov, state.cov),
        correction_count=torch.where(matched, state.correction_count + 1,
                                     state.correction_count),
        last_correction_time=torch.where(matched, t,
                                         state.last_correction_time),
        last_obs=torch.where(matched[:, None], obs_record[midx],
                             state.last_obs),
    )

    # Spawn unmatched detections one after another, so each sees the
    # tracks spawned before it in this frame.
    obs_matched = torch.zeros((obs4.shape[0],), dtype=torch.bool,
                              device=dev)
    obs_matched[midx[matched]] = True
    spawn_cand = (obs_valid & ~obs_matched).tolist()
    mean, cov, active = state.mean.clone(), state.cov.clone(), \
        state.active.clone()
    ids, ccount = state.id.clone(), state.correction_count.clone()
    lct, lpt = state.last_correction_time.clone(), \
        state.last_prediction_time.clone()
    last_obs, next_id = state.last_obs.clone(), state.next_id.clone()
    for i, is_cand in enumerate(spawn_cand):
        if not is_cand:
            continue
        pos = obs4[i, :2]
        dist = torch.linalg.vector_norm(mean[:, :2] - pos[None, :], dim=1)
        close = (active & (dist < object_radius * 2.0)).any()
        free_slot = torch.argmin(active.to(torch.int32))
        flags = torch.stack([close, active[free_slot]]).tolist()
        if flags[0] or flags[1]:
            continue
        slot = int(free_slot)
        mean[slot] = obs4[i]
        cov[slot] = eye * cfg.initial_cov
        active[slot] = True
        ids[slot] = next_id
        ccount[slot] = 0
        lct[slot] = t
        lpt[slot] = t
        last_obs[slot] = obs_record[i]
        next_id = next_id + 1
    pos_trace = cov[:, 0, 0] + cov[:, 1, 1]
    vel_trace = cov[:, 2, 2] + cov[:, 3, 3]
    keep = (pos_trace < covariance_trace_limit) & (
        vel_trace < covariance_trace_limit)
    return TrackerState(mean=mean, cov=cov, active=active & keep, id=ids,
                        correction_count=ccount, last_correction_time=lct,
                        last_prediction_time=lpt, last_obs=last_obs,
                        next_id=next_id)


def track_step(state: TrackerState, t, detections: MovingObjects,
               cfg: TrackerConfig = TrackerConfig(), object_radius=None,
               covariance_trace_limit=None, correction_count_limit=None):
    """Predict + correct + publish: (new_state, TrackedObjects)."""
    dev = state.mean.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    correction_count_limit = torch.as_tensor(
        cfg.correction_count_limit if correction_count_limit is None
        else correction_count_limit, dtype=torch.int32, device=dev)
    state = predict(state, t, cfg)
    state = correct(state, t, detections, cfg, object_radius=object_radius,
                    covariance_trace_limit=covariance_trace_limit)
    publish = (state.active & (state.correction_count
                               >= correction_count_limit)
               & (state.last_correction_time == t))
    center = torch.cat([state.mean[:, :2], state.last_obs[:, 2:3]], dim=1)
    velocity = torch.cat([state.mean[:, 2:4], state.last_obs[:, 5:6]], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    objects = MovingObjects(
        id=torch.where(publish, state.id, torch.full_like(state.id, -1)),
        center=torch.where(publish[:, None], center, zero),
        velocity=torch.where(publish[:, None], velocity, zero),
        bounding_box=torch.where(publish[:, None], state.last_obs[:, 6:9],
                                 zero),
        valid=publish)
    cov = torch.where(publish[:, None, None], state.cov, zero)
    return state, TrackedObjects(objects=objects, covariance=cov)
