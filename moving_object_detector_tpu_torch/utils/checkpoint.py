"""Flow-net weights and pipeline-state snapshots.

The bundled ``weights/*.fp16.npz`` archives hold the Flax parameter tree
flattened to "params/Module_i/.../kernel" keys with HWIO kernels. They
are read with numpy alone; ``params_from_flax`` renames every key to the
port's module path and transposes kernels to OIHW, ``params_to_flax``
goes back. ``save_flow_params`` writes what the port trains in the same
keys: to a ``.npz`` path the fp16 archive both packages load, to any
other path ``<path>/params.npz`` in f32, the port's stand-in for the
reference package's Orbax checkpoint directory (which the port cannot
read or write). RAFT (``models/raft.py``) loads under its published
parameter names (``load_raft_state_dict``) or is drawn from a seed
(``build_raft``).

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

from ..config import FlowNetConfig, RAFTConfig
from ..models.pwc_net import PWCNet, infer_flow_config
from ..models.raft import RAFT, init_raft_params

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


def params_to_flax(state_dict: dict) -> dict:
    """The exact inverse of ``params_from_flax``: a PWCNet ``state_dict``
    as flat Flax keys ("params/Module_i/.../kernel"), kernels OIHW ->
    HWIO, as f32 numpy arrays."""
    n_ctx = len({k.split(".")[2] for k in state_dict
                 if k.startswith("context.convs.")}) + (
        1 if any(k.startswith("context.residual.") for k in state_dict)
        else 0)
    back = (
        (re.compile(r"pyramid\.convs\.(\d+)\."),
         lambda m: f"params/FeaturePyramid_0/ConvBlock_{m[1]}/Conv_0/"),
        (re.compile(r"estimators\.(\d+)\.convs\.(\d+)\."),
         lambda m: f"params/FlowEstimator_{m[1]}/ConvBlock_{m[2]}/Conv_0/"),
        (re.compile(r"estimators\.(\d+)\.flow_head\."),
         lambda m: f"params/FlowEstimator_{m[1]}/Conv_0/"),
        (re.compile(r"estimators\.(\d+)\.up\."),
         lambda m: f"params/FlowEstimator_{m[1]}/Conv_1/"),
        (re.compile(r"context\.convs\.(\d+)\."),
         lambda m: f"params/ContextNetwork_0/Conv_{m[1]}/"),
        (re.compile(r"context\.residual\."),
         lambda m: f"params/ContextNetwork_0/Conv_{n_ctx - 1}/"),
    )
    out = {}
    for key, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        for pattern, name in back:
            m = pattern.fullmatch(key.rsplit(".", 1)[0] + ".")
            if m:
                break
        else:
            raise KeyError(f"unknown PWCNet parameter {key}")
        leaf = key.rsplit(".", 1)[1]
        if leaf == "weight":
            out[name(m) + "kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        elif leaf == "bias":
            out[name(m) + "bias"] = arr
        else:
            raise KeyError(f"unknown PWCNet parameter {key}")
    return out


def save_flow_params(path: str, model) -> None:
    """Save a PWCNet's weights in the Flax layout: a ``.npz`` path gets the
    compressed fp16 flat-key archive of the JAX package's
    ``save_flow_params_npz`` (loadable by both packages); any other path
    is a directory that gets ``params.npz``, the same keys in f32."""
    flat = params_to_flax(model.state_dict())
    if path.endswith(".npz"):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        np.savez_compressed(path, **{k: v.astype(np.float16)
                                     for k, v in flat.items()})
        return
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **flat)


def _archive(path: str) -> str:
    """The ``.npz`` that holds a checkpoint's weights: the path itself, or
    ``params.npz`` in a directory written by ``save_flow_params``."""
    if path.endswith(".npz"):
        return path
    inner = os.path.join(path, "params.npz")
    if os.path.isdir(path) and os.path.exists(inner):
        return inner
    raise ValueError(
        f"{path}: the port reads .npz weight archives and the directories "
        "its save_flow_params writes; export a checkpoint directory of the "
        "reference package to .npz first (its save_flow_params with a "
        ".npz path)")


def load_flow_checkpoint(path: str, base_config: FlowNetConfig | None = None,
                         device=None):
    """Build the PWCNet a checkpoint describes and load its weights: a
    ``.npz`` archive or a directory written by ``save_flow_params``.
    Returns ``(model, config)``; the architecture is inferred from the
    kernel shapes, the other fields come from ``base_config``. Runs on
    ``cuda`` unless ``device`` says otherwise."""
    from .. import resolve_device

    device = resolve_device(device)
    with np.load(_archive(path)) as data:
        flat = {k: data[k] for k in data.files}
    cfg = infer_flow_config({k: v.shape for k, v in flat.items()},
                            base_config)
    model = PWCNet(cfg)
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model.to(device).eval(), cfg


def build_raft(config: RAFTConfig, seed: int, device=None) -> RAFT:
    """A RAFT of ``config`` with weights drawn from ``seed`` as the
    published modules initialise them (``models.raft.init_raft_params``;
    on the CPU, so a seed gives the same weights on every device), in eval
    mode on ``device`` (``cuda`` unless given)."""
    from .. import resolve_device

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    return init_raft_params(RAFT(config), gen).to(device).eval()


def load_raft_state_dict(state, config: RAFTConfig | None = None,
                         device=None) -> RAFT:
    """A RAFT of ``config`` (the published widths by default) holding a
    state dict under the published parameter names: a dict of tensors or
    the path of a published ``.pth`` (``raft-kitti.pth``); a ``module.``
    prefix, as ``nn.DataParallel`` saved them, is stripped. Loaded
    strictly, in eval mode on ``device`` (``cuda`` unless given)."""
    from .. import resolve_device

    device = resolve_device(device)
    if isinstance(state, (str, os.PathLike)):
        state = torch.load(state, map_location="cpu", weights_only=True)
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    model = RAFT(config or RAFTConfig())
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


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


# Exact basenames of the bundled weight archives that passed the JAX
# package's flow_input_scale=2 serving gates (the EPE floor at 384 x 896
# and the end-to-end detection gates at both scales) on that exact file.
# Exact names, not prefixes: an ungated export such as
# "pwc_v7_candidate.fp16.npz" must not claim the gate.
_SCALE2_GATED_BASENAMES = frozenset({
    "pwc_v4e.fp16.npz", "pwc_v5.fp16.npz", "pwc_v6m3.fp16.npz",
    "pwc_p1.fp16.npz", "pwc_v7.fp16.npz", "pwc_p3.fp16.npz",
})


def flow_checkpoint_scale2_gated(path: str | None) -> bool:
    """True iff these weights passed the serving quality gates at
    flow_input_scale=2: the precondition for serving the half-resolution
    flow path. Keyed on the exact allowlist above."""
    if not path:
        return False
    return os.path.basename(path) in _SCALE2_GATED_BASENAMES


def resolve_flow_checkpoint(arg: str | None) -> str | None:
    """CLI convention: "auto" (or None) -> the bundled weights if present;
    "none" -> random init; anything else -> an explicit ``.npz`` path or a
    directory written by ``save_flow_params``."""
    if arg in (None, "auto"):
        return default_flow_checkpoint()
    if arg == "none":
        return None
    _archive(arg)  # raises for what the port cannot read
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
