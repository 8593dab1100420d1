"""A stand-in for the port's captured-graph type on the CPU (the tests of
``utils/cuda_graphs.py`` and of the flow, tracker and ego-motion stages
share it).

A CUDA graph needs a card. ``StubGraph`` replaces
``cuda_graphs.Graph``'s capture and keeps its real replay
(``Graph.__call__``) around a stand-in graph whose ``replay`` recomputes
the captured function into the static outputs, as the card's graph
rewrites its pool. The card's own graphs are held bitwise to the eager
stages in ``tests/test_torch_kernels_gpu.py``. The port alone: no JAX.
"""

import types

import torch

from moving_object_detector_tpu_torch import egomotion, pipeline, tracker
from moving_object_detector_tpu_torch.utils import cuda_graphs, trees


class Replayer:
    """Stands in for ``torch.cuda.CUDAGraph``: ``replay`` runs the
    captured function on the static inputs into the static outputs."""

    def __init__(self, fn, static, outputs):
        self.fn, self.static, self.outputs = fn, static, outputs

    def replay(self):
        fresh = self.fn(*self.static)
        for dst, src in zip(trees.leaves(self.outputs), trees.leaves(fresh)):
            dst.copy_(src)


class StubGraph(cuda_graphs.Graph):
    """``Graph`` with the capture done on the CPU: the eager result
    returned, outputs of its own, one segment and no cut. ``captured``
    logs each capture's (stage name, static inputs)."""

    captured = []

    @classmethod
    def capture(cls, name, fn, static, spans=None, hold=None,
                generators=()):
        first = fn(*static)
        outputs = trees.map_tensors(first, torch.empty_like)
        cls.captured.append((name, static))
        return cls([Replayer(fn, static, outputs)], [], trees.leaves(static),
                   outputs, spans=spans), first


def as_on_a_card(monkeypatch):
    """``cuda_graphs.graphable`` as on a card: the tensors taken for CUDA
    ones, its autograd test left as it is."""
    real = cuda_graphs.graphable
    cuda = torch.device("cuda")
    monkeypatch.setattr(cuda_graphs, "graphable", lambda *ts: real(*[
        types.SimpleNamespace(device=cuda, requires_grad=t.requires_grad)
        for t in ts]))


def install(monkeypatch):
    """``StubGraph`` in place of ``Graph``, with an empty log, and empty
    flow, tracker and both ego-motion caches for the test."""
    monkeypatch.setattr(cuda_graphs, "Graph", StubGraph)
    monkeypatch.setattr(StubGraph, "captured", [])
    for cache in (pipeline._flow_cache, tracker._tracker_cache,
                  egomotion._dense_cache, egomotion._lk_cache):
        monkeypatch.setattr(cache, "graphs", {})
    return StubGraph
