"""Frozen copy of ``moving_object_detector_tpu_torch/utils/checkpoint.py``
(the weights' reader) at fc97bde, the benchmark's plain reference: it
imports nothing of the port.

The bundled flow-net weights, read with numpy alone.

The ``weights/*.fp16.npz`` archives hold the Flax parameter tree
flattened to "params/Module_i/.../kernel" keys with HWIO kernels;
``params_from_flax`` renames every key to the net's module path and
transposes kernels to OIHW.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from .config import FlowNetConfig
from .pwc_net import PWCNet, infer_flow_config

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


def load_flow_weights(path: str, dtype: str, device) -> PWCNet:
    """The net an ``.npz`` archive describes, its weights loaded, computing
    in ``dtype`` ("float32", "bfloat16" or "float8"), on ``device``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    cfg = infer_flow_config({k: v.shape for k, v in flat.items()},
                            FlowNetConfig())
    model = PWCNet(dataclasses.replace(cfg, dtype=dtype))
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model.to(device).eval()
