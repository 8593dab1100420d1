"""Multi-object tracking (the JAX package's ``tracker.py``): a
fixed-capacity bank of constant-velocity Kalman filters with greedy
nearest-neighbour association ("nn") or optimal assignment ("gnn",
``ops/assignment.py``).

State x = (px, py, vx, vy); Q = diag(0.003, 0.003, 0.01, 0.01), R = 0.2 I,
P0 = 0.1 I; association cost -N(x; mean, cov) gated at sqrt(mahalanobis)
> 3 or euclidean > 1.5, resolved best-first; unmatched detections spawn
unless within 2 * object_radius of a track (including ones spawned
earlier in the same frame); tracks are pruned on covariance traces and
published after ``correction_count_limit`` corrections. All math f32.

The pipeline's stage is ``track_frame``: ``track_step`` where the frame is
valid, else the state unchanged and nothing published, selected on the
device. Its "nn" body never waits for the card, so on CUDA inputs the
stage replays a CUDA graph of itself, one a signature
(``utils/cuda_graphs.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from .config import TrackerConfig
from .types import MovingObjects, TrackedObjects
from .utils import cuda_graphs, profiling, trees


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


class _Constants(NamedTuple):
    eye: torch.Tensor  # (4, 4) I
    process_noise: torch.Tensor  # Q
    measurement_noise: torch.Tensor  # R
    initial_cov: torch.Tensor  # P0


# One set a (device, config), built on first use and kept: a captured
# tracker graph reads them by address.
_constants: dict = {}


def _constants_for(cfg: TrackerConfig, device) -> _Constants:
    key = (torch.device(device), cfg)
    k = _constants.get(key)
    if k is None:
        eye = torch.eye(4, dtype=torch.float32, device=device)
        with profiling.sync_point("tracker_constants"):  # Q copied in
            noise = torch.tensor(
                [cfg.process_noise_pos, cfg.process_noise_pos,
                 cfg.process_noise_vel, cfg.process_noise_vel],
                dtype=torch.float32, device=device)
        k = _constants[key] = _Constants(
            eye=eye, process_noise=torch.diag(noise),
            measurement_noise=eye * cfg.measurement_noise,
            initial_cov=eye * cfg.initial_cov)
    return k


def predict(state: TrackerState, t, cfg: TrackerConfig) -> TrackerState:
    """mean' = A mean, cov' = A cov A^T + Q for every active track."""
    k = _constants_for(cfg, state.mean.device)
    dt = torch.clamp(t - state.last_prediction_time, min=cfg.min_dt)
    a = k.eye.repeat(state.capacity, 1, 1)
    a[:, 0, 2] = dt
    a[:, 1, 3] = dt
    new_mean = torch.einsum("tij,tj->ti", a, state.mean)
    new_cov = torch.einsum("tij,tjk,tlk->til", a, state.cov, a) + \
        k.process_noise
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
        found = torch.isfinite(torch.take(c, flat))
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

    cost = _association_cost(state, obs4, obs_valid, cfg)
    if cfg.association == "gnn":
        from .ops.assignment import auction_assignment

        match = auction_assignment(cost)
    else:
        match = _greedy_associate(cost)
    matched = match >= 0
    midx = torch.clamp(match, min=0).long()

    z = obs4[midx]
    k = _constants_for(cfg, dev)
    gain = torch.einsum("tij,tjk->tik", state.cov,
                        _chol_inv_det4(state.cov + k.measurement_noise)[0])
    new_mean = state.mean + torch.einsum("tij,tj->ti", gain, z - state.mean)
    new_cov = torch.einsum("tij,tjk->tik", k.eye[None] - gain, state.cov)
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
    # tracks spawned before it in this frame: a round a detection slot,
    # which writes its detection into the first free track slot only
    # where it spawns (no host read: the JAX package's fori_loop).
    n_obs = obs4.shape[0]
    cand = obs_valid & ~(match[:, None] == torch.arange(
        n_obs, device=dev)).any(0)
    rows = torch.arange(state.capacity, device=dev)
    reach = object_radius * 2.0
    mean, cov, active = state.mean, state.cov, state.active
    ids, ccount = state.id, state.correction_count
    lct, lpt = state.last_correction_time, state.last_prediction_time
    last_obs, next_id = state.last_obs, state.next_id
    for i in range(n_obs):
        dist = torch.linalg.vector_norm(mean[:, :2] - obs4[i, :2][None, :],
                                        dim=1)
        close = (active & (dist < reach)).any()
        # No slot is free where every one is active.
        spawn = cand[i] & ~close & ~active.all()
        put = (rows == torch.argmin(active.to(torch.int32))) & spawn
        mean = torch.where(put[:, None], obs4[i], mean)
        cov = torch.where(put[:, None, None], k.initial_cov, cov)
        active = active | put
        ids = torch.where(put, next_id, ids)
        ccount = ccount.masked_fill(put, 0)
        lct = torch.where(put, t, lct)
        lpt = torch.where(put, t, lpt)
        last_obs = torch.where(put[:, None], obs_record[i], last_obs)
        next_id = next_id + spawn.to(torch.int32)
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


def _track_frame_eager(cfg: TrackerConfig, state: TrackerState, t,
                       detections: MovingObjects, frame_valid,
                       object_radius, covariance_trace_limit,
                       correction_count_limit):
    """``track_frame``'s body, every argument after ``cfg`` a tensor."""
    new = track_step(state, t, detections, cfg, object_radius=object_radius,
                     covariance_trace_limit=covariance_trace_limit,
                     correction_count_limit=correction_count_limit)
    k, dev = state.capacity, state.mean.device
    idle = (state, TrackedObjects(
        objects=MovingObjects.empty(k, dev),
        covariance=torch.zeros((k, 4, 4), dtype=torch.float32, device=dev)))
    olds = iter(trees.leaves(idle))
    return trees.map_tensors(new, lambda a: torch.where(frame_valid, a,
                                                        next(olds)))


_tracker_cache = cuda_graphs.GraphCache("tracker")


def track_frame(state: TrackerState, t, detections: MovingObjects,
                frame_valid, cfg: TrackerConfig = TrackerConfig(),
                object_radius=None, covariance_trace_limit=None,
                correction_count_limit=None):
    """The pipeline's tracker stage: ``track_step`` where the 0-d bool
    ``frame_valid`` holds, else ``state`` as it was and no track published
    (empty ``TrackedObjects``), selected on the device: no host read.

    "nn" association on CUDA tensors that autograd does not track replays
    the process's CUDA graph of the stage for this signature: the device,
    the track and detection capacities, the configuration
    (``_tracker_cache``); other inputs ("gnn" with its host-driven
    auction, the CPU) run it eagerly and count 0 captures and replays."""
    dev = state.mean.device

    def scalar(v, default, dtype):
        return torch.as_tensor(default if v is None else v, dtype=dtype,
                               device=dev)

    args = (state, scalar(t, None, torch.float32), detections,
            scalar(frame_valid, None, torch.bool),
            scalar(object_radius, cfg.object_radius, torch.float32),
            scalar(covariance_trace_limit, cfg.covariance_trace_limit,
                   torch.float32),
            scalar(correction_count_limit, cfg.correction_count_limit,
                   torch.int32))
    key = None
    if cfg.association == "nn" and cuda_graphs.graphable(
            *trees.leaves(args)):
        key = (dev, state.capacity, detections.capacity, cfg)
    return _tracker_cache(key, functools.partial(_track_frame_eager, cfg),
                          args)
