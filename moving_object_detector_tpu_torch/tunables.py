"""Runtime-tunable scalars (the JAX package's ``tunables.py``).

The hot thresholds ride through ``detect_step`` as 0-d tensors, so a
caller can pass other values between frames without touching the config.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import PipelineConfig

_INT_FIELDS = ("cluster_size", "correction_count_limit", "neighbor_distance")


@dataclasses.dataclass(frozen=True)
class Tunables:
    dynamic_flow_diff: torch.Tensor  # px
    dynamic_disparity_rate: torch.Tensor  # px/s, 0 = off
    max_color_velocity: torch.Tensor  # m/s, visualization scaling
    cluster_size: torch.Tensor  # px (int32)
    depth_diff: torch.Tensor  # m
    dynamic_speed: torch.Tensor  # m/s
    neighbor_distance: torch.Tensor  # px (int32), <= config radius
    covariance_trace_limit: torch.Tensor
    correction_count_limit: torch.Tensor  # (int32)
    object_radius: torch.Tensor  # m

    @staticmethod
    def config_values(config: PipelineConfig) -> dict:
        """Each field's value in ``config``, as a host number."""
        sf, cl, tr = config.scene_flow, config.clusterer, config.tracker
        return dict(
            dynamic_flow_diff=sf.dynamic_flow_diff,
            dynamic_disparity_rate=sf.dynamic_disparity_rate,
            max_color_velocity=sf.max_color_velocity,
            cluster_size=cl.cluster_size,
            depth_diff=cl.depth_diff,
            dynamic_speed=cl.dynamic_speed,
            neighbor_distance=cl.neighbor_distance,
            covariance_trace_limit=tr.covariance_trace_limit,
            correction_count_limit=tr.correction_count_limit,
            object_radius=tr.object_radius,
        )

    @staticmethod
    def stored(name: str, value) -> float:
        """``value`` as field ``name`` holds it (int32 or f32), read back
        as a float, without touching a device: the host mirror a caller
        keeps of the knobs it set."""
        return float(torch.tensor(
            value, dtype=torch.int32 if name in _INT_FIELDS
            else torch.float32))

    @classmethod
    def from_config(cls, config: PipelineConfig, device=None) -> "Tunables":
        return cls(**{
            k: torch.tensor(
                v, device=device,
                dtype=torch.int32 if k in _INT_FIELDS else torch.float32)
            for k, v in cls.config_values(config).items()})

    def replace_values(self, **kw) -> "Tunables":
        """A copy with the given scalars updated (a retune between
        frames), each on the device and in the type of the field it
        replaces."""
        conv = {
            k: torch.tensor(
                v, device=getattr(self, k).device,
                dtype=torch.int32 if k in _INT_FIELDS else torch.float32)
            for k, v in kw.items()}
        return dataclasses.replace(self, **conv)
