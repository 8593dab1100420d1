"""Flow-net weights and pipeline-state snapshots.

The bundled ``weights/*.fp16.npz`` archives hold the Flax parameter tree
flattened to "params/Module_i/.../kernel" keys with HWIO kernels. They
are read with numpy alone; ``params_from_flax`` renames every key to the
port's module path and transposes kernels to OIHW.

A pipeline-state snapshot (pose, previous frame and disparity, tracker
bank, frame index) is one ``.npz`` of plain arrays under "/"-joined
keys, the port's own format: the reference package's snapshot directories
cannot be read here, and these files cannot be read there. A reference
``PipelineState`` crosses over as numpy leaves through
``pipeline_state_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from ..config import FlowNetConfig
from ..models.pwc_net import PWCNet, infer_flow_config

_RULES = (
    (re.compile(r"params/FeaturePyramid_0/ConvBlock_(\d+)/Conv_0/"),
     lambda m, n: f"pyramid.convs.{m[1]}."),
    (re.compile(r"params/FlowEstimator_(\d+)/ConvBlock_(\d+)/Conv_0/"),
     lambda m, n: f"estimators.{m[1]}.convs.{m[2]}."),
    (re.compile(r"params/FlowEstimator_(\d+)/Conv_0/"),
     lambda m, n: f"estimators.{m[1]}.flow_head."),
    (re.compile(r"params/FlowEstimator_(\d+)/Conv_1/"),
     lambda m, n: f"estimators.{m[1]}.up."),
    (re.compile(r"params/ContextNetwork_0/Conv_(\d+)/"),
     lambda m, n: ("context.residual." if int(m[1]) == n - 1
                   else f"context.convs.{m[1]}.")),
)


def params_from_flax(flat: dict) -> dict:
    """Map a flat Flax parameter dict to a PWCNet ``state_dict``.

    Flax numbers ``FlowEstimator_i`` in construction order, coarse to fine,
    which is the order of ``PWCNet.estimators``; the context network's
    last conv is its 2-channel residual head. Kernels go HWIO -> OIHW;
    values become f32 tensors."""
    n_ctx = len({k.split("/")[2] for k in flat
                 if k.startswith("params/ContextNetwork_0/")})
    out = {}
    for key, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        for pattern, name in _RULES:
            m = pattern.match(key)
            if m:
                leaf = key[m.end():]
                break
        else:
            raise KeyError(f"unknown Flax parameter {key}")
        if leaf == "kernel":
            out[name(m, n_ctx) + "weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf == "bias":
            out[name(m, n_ctx) + "bias"] = torch.tensor(arr)
        else:
            raise KeyError(f"unknown Flax parameter {key}")
    return out


def load_flow_checkpoint(path: str, base_config: FlowNetConfig | None = None,
                         device=None):
    """Build the PWCNet a ``.npz`` checkpoint describes and load its
    weights. Returns ``(model, config)``; the architecture is inferred
    from the kernel shapes, the other fields come from ``base_config``.
    Runs on ``cuda`` unless ``device`` says otherwise."""
    from .. import resolve_device

    device = resolve_device(device)
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port reads .npz weight archives only")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    cfg = infer_flow_config({k: v.shape for k, v in flat.items()},
                            base_config)
    model = PWCNet(cfg)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model.to(device).eval(), cfg


_WEIGHT_NAMES = ("pwc_v7.fp16.npz", "pwc_v6m3.fp16.npz", "pwc_v5.fp16.npz",
                 "pwc_v4e.fp16.npz", "pwc_v4.fp16.npz", "pwc_v2.fp16.npz")


def default_flow_checkpoint() -> str | None:
    """Path of the bundled trained flow weights (``weights/`` at the repo
    root), the newest first, or None if there are none."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in _WEIGHT_NAMES:
        path = os.path.join(root, "weights", name)
        if os.path.exists(path):
            return path
    return None


def resolve_flow_checkpoint(arg: str | None) -> str | None:
    """CLI convention: "auto" (or None) -> the bundled weights if present;
    "none" -> random init; anything else -> an explicit ``.npz`` path."""
    if arg in (None, "auto"):
        return default_flow_checkpoint()
    if arg == "none":
        return None
    if os.path.isdir(arg) or not arg.endswith(".npz"):
        raise ValueError(
            f"{arg}: the port reads .npz weight archives only; export a "
            "checkpoint directory of the reference package to .npz first "
            "(its save_flow_params with a .npz path)")
    return arg


def _leaf(node, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def pipeline_state_from_numpy(tree, device=None):
    """The port's ``PipelineState`` from a tree of numpy leaves shaped
    like the reference package's ``PipelineState`` (an object with those
    attributes or nested dicts of those names), on ``device`` (cuda unless
    given)."""
    from .. import resolve_device
    from ..pipeline import PipelineState
    from ..tracker import TrackerState
    from ..types import DisparityImage

    dev = resolve_device(device)

    def tensors(cls, node):
        out = {}
        for f in dataclasses.fields(cls):
            arr = np.asarray(_leaf(node, f.name))
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            out[f.name] = torch.from_numpy(np.array(arr)).to(dev)
        return cls(**out)

    return PipelineState(
        pose=torch.from_numpy(np.array(_leaf(tree, "pose"),
                                       np.float32)).to(dev),
        prev_left=torch.from_numpy(np.array(_leaf(tree, "prev_left"),
                                            np.float32)).to(dev),
        prev_disparity=tensors(DisparityImage, _leaf(tree, "prev_disparity")),
        prev_time=torch.from_numpy(np.array(_leaf(tree, "prev_time"),
                                            np.float32)).to(dev),
        has_prev=bool(np.asarray(_leaf(tree, "has_prev"))),
        tracker=tensors(TrackerState, _leaf(tree, "tracker")),
        frame_index=int(np.asarray(_leaf(tree, "frame_index"))),
    )


def _flatten_state(node, prefix: str, out: dict) -> None:
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            _flatten_state(value, prefix + f.name + "/", out)
        elif isinstance(value, torch.Tensor):
            out[prefix + f.name] = value.detach().cpu().numpy()
        else:
            out[prefix + f.name] = np.asarray(value)


def save_pipeline_state(path: str, state) -> None:
    """Snapshot a ``PipelineState`` into one ``.npz`` at exactly ``path``."""
    flat: dict = {}
    _flatten_state(state, "", flat)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def restore_pipeline_state(path: str, device=None):
    """Load a snapshot written by ``save_pipeline_state`` onto ``device``
    (cuda unless given)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port's snapshots are single .npz "
            "files (a snapshot directory of the reference package is "
            "another format)")
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return pipeline_state_from_numpy(tree, device)
