"""Multi-camera pipelines: data parallelism over streams.

N camera streams step together. A batch of states is one
``PipelineState`` whose tensors carry a leading N axis and whose host
fields (``has_prev``, ``frame_index``) are tuples of N
(``stack_states`` / ``unstack_states``). The step runs each stream's
frame program in turn (``detect_step_streams_scan``), so every CUDA
kernel keeps its one-image launch; across cards the streams shard over
the mesh's "data" axis (``shard_streams``), one process per card, with
no cross-stream communication.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import PipelineConfig
from ..pipeline import PipelineState, detect_step
from ..types import StereoModel
from .mesh import shard_batch


def stack_states(items):
    """One tree from N trees of the same structure: tensors stacked on a
    new leading axis, dataclasses walked field by field, host values
    (bools, ints) gathered into a tuple of N. Works for ``PipelineState``
    and ``FrameOutput`` alike."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: stack_states([getattr(x, f.name) for x in items])
            for f in dataclasses.fields(first)})
    return tuple(items)


def _index(node, i: int):
    if isinstance(node, (torch.Tensor, tuple)):
        return node[i]
    if dataclasses.is_dataclass(node):
        return type(node)(**{f.name: _index(getattr(node, f.name), i)
                             for f in dataclasses.fields(node)})
    raise TypeError(f"cannot unstack a {type(node).__name__}")


def _leading(node) -> int:
    """N of a stacked tree: the length of its first tensor or tuple."""
    if isinstance(node, (torch.Tensor, tuple)):
        return len(node)
    return _leading(getattr(node, dataclasses.fields(node)[0].name))


def unstack_states(stacked) -> list:
    """The inverse of ``stack_states``: a list of N trees."""
    return [_index(stacked, i) for i in range(_leading(stacked))]


def create_stream_states(config: PipelineConfig, n_streams: int,
                         device=None) -> PipelineState:
    """A batch of ``n_streams`` fresh states (leading stream axis)."""
    return stack_states([PipelineState.create(config, device=device)
                         for _ in range(n_streams)])


def _step_streams(flow_model, states, lefts, rights, ts, stereo, config,
                  flow_overrides=None, disparity_overrides=None):
    """``detect_step`` on each stream in turn; (states', outputs) stacked.
    Overrides are stacked per stream (a stacked ``DisparityImage``)."""
    new_states, outputs = [], []
    for i, state in enumerate(unstack_states(states)):
        state, out = detect_step(
            flow_model, state, lefts[i], rights[i], ts[i], stereo, config,
            flow_override=(None if flow_overrides is None
                           else flow_overrides[i]),
            disparity_override=(None if disparity_overrides is None
                                else _index(disparity_overrides, i)))
        new_states.append(state)
        outputs.append(out)
    return stack_states(new_states), stack_states(outputs)


def detect_step_streams_scan(flow_model, states: PipelineState, lefts,
                             rights, ts, stereo: StereoModel,
                             config: PipelineConfig):
    """The supported single-card multi-stream step: each stream's frame
    program runs unbatched, one after another, on the configured backends
    (the CUDA kernels on the card), so a frame launches N times the
    single-stream kernels. Aggregate throughput is about N x the
    single-stream frame time: serialization, which on one card is the
    honest ceiling. ``states`` / ``lefts`` / ``rights`` / ``ts`` carry a
    leading N axis; the flow net and calibration are shared. Returns
    (states', outputs), both stacked."""
    return _step_streams(flow_model, states, lefts, rights, ts, stereo,
                         config)


def detect_step_batched(flow_model, states: PipelineState, lefts, rights,
                        ts, stereo: StereoModel, config: PipelineConfig,
                        flow_overrides=None, disparity_overrides=None,
                        unsafe_vmap_on_tpu: bool = False):
    """The JAX package's vmapped step over a leading stream axis, with
    every "auto" backend pinned to its plain form ("xla"): the port's
    kernels take one (H, W) image. The optional overrides carry
    externally computed per-stream perception results (stacked), e.g. the
    row-striped SGM and flow of ``parallel/spatial.py``.

    Refused on CUDA tensors unless ``unsafe_vmap_on_tpu=True`` (the JAX
    keyword, kept so callers port unchanged): on the card the plain forms
    would replace the kernels; ``detect_step_streams_scan`` is the
    multi-stream step there. CPU use (tests, CPU processes) is
    unaffected."""
    if lefts.device.type == "cuda" and not unsafe_vmap_on_tpu:
        raise RuntimeError(
            "detect_step_batched runs the plain forms in place of the CUDA "
            "kernels and is disabled on CUDA tensors. Use "
            "detect_step_streams_scan for single-card multi-stream, "
            "detect_step_streams_spatial for row-striped cards, or pass "
            "unsafe_vmap_on_tpu=True to override.")
    repl = {}
    if config.clusterer.cc_backend == "auto":
        repl["clusterer"] = dataclasses.replace(config.clusterer,
                                                cc_backend="xla")
    if config.sgm.backend == "auto":
        repl["sgm"] = dataclasses.replace(config.sgm, backend="xla")
    if config.scene_flow.gather_backend == "auto":
        repl["scene_flow"] = dataclasses.replace(config.scene_flow,
                                                 gather_backend="xla")
    if config.flownet.corr_backend == "auto":
        repl["flownet"] = dataclasses.replace(config.flownet,
                                              corr_backend="xla")
    if repl:
        config = config.replace(**repl)
    return _step_streams(flow_model, states, lefts, rights, ts, stereo,
                         config, flow_overrides, disparity_overrides)


def shard_streams(mesh, *arrays):
    """Leading-stream-axis tensors (images, timestamps) over the mesh's
    "data" axis: each rank keeps its streams (DTensors, ``to_local()`` for
    the rank's slice). A rank makes the states of its own streams with
    ``create_stream_states(config, n_local)``: their host fields are not
    tensors to shard."""
    out = tuple(shard_batch(mesh, a) for a in arrays)
    return out if len(out) > 1 else out[0]
