"""The port's CUDA graphs: the one place that captures a stage's work into
CUDA graphs and replays it.

Graphing a stage takes, in the stage's own file, a cache made once at
module level (``GraphCache("<stage>")``), a key and one call: ``cache(key,
fn, args)`` in place of ``fn(*args)``. ``args`` is a tuple of trees of
tensors (``utils/trees.py``); ``fn``, the stage's eager body, returns such a
tree and makes the host wait for nothing (a capture fails on a wait); the
key is what a graph is valid for beyond the tensors' values (the device,
shapes, dtypes, configuration), None where ``graphable`` is false. The
cache counts ``<stage>_graph_captures`` and ``<stage>_graph_replays`` a
call; a capture is sync site ``<stage>_graph_capture``. A hand-written
kernel whose wrapper calls ``cut_point`` launches between the graphs,
through its module attribute, where the benchmark's wrappers see it.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from . import profiling, trees

# The graphs a stage holds, never freed: with torch 2.11 and CUDA 12.8 on
# an H100, a graph destroyed and another captured after it make the next
# replay of an older graph crash under torch.profiler, once a profiler has
# run before those captures. Signatures past the bound run eagerly.
MAX_GRAPHS = 8

# The capture being cut (``_Capture``), while one runs.
_cutting = None


def graphable(*tensors) -> bool:
    """Whether work on ``tensors`` can replay a graph: they are CUDA
    tensors (the first one's device) that autograd has no reason to
    track."""
    tracked = torch.is_grad_enabled() and any(t.requires_grad
                                              for t in tensors)
    return tensors[0].device.type == "cuda" and not tracked


def cut_point(module: str, name: str, args: tuple, shape, dtype, device):
    """Called by the kernel wrapper ``module.name`` before its launch.
    While a capture runs on this stream it ends the current graph, keeps
    the launch (the wrapper, ``args`` and an output buffer of ``shape``) for
    each replay to make between that graph and the next, begins the next
    graph, and returns the buffer; else None, and the wrapper launches."""
    capture = _cutting
    if capture is None or not torch.cuda.is_current_stream_capturing():
        return None
    return capture.cut(sys.modules[module], name, args, shape, dtype, device)


class _Capture:
    """A function captured into CUDA graphs of one private memory pool, a
    new graph after each ``cut``."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.segments, self.cuts = [], []

    def _begin(self):
        self.segments.append(torch.cuda.CUDAGraph())
        self.segments[-1].capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")

    def cut(self, module, name, args, shape, dtype, device):
        self.segments[-1].capture_end()
        out = torch.empty(shape, dtype=dtype, device=device)
        self.cuts.append((module, name, args, out))
        self._begin()
        return out

    def run(self, fn, args):
        """``fn(*args)``'s output, its work captured on the current
        stream."""
        global _cutting
        self._begin()
        _cutting = self
        try:
            return fn(*args)
        finally:
            _cutting = None
            if torch.cuda.is_current_stream_capturing():
                self.segments[-1].capture_end()


class Graph:
    """A function captured into CUDA graphs and replayed: ``segments``, the
    graphs, one more than ``cuts``, the launches cut out between them,
    each (module, wrapper's name, arguments, output buffer); ``inputs``, the
    static input tensors; ``outputs``, the static output tree; ``counters``,
    {name: n} the captured function counted; ``spans``, None or two span
    names, the first segment's and the rest's; ``held``, what else the
    graphs read by address, kept alive with them."""

    def __init__(self, segments, cuts, inputs, outputs, counters=None,
                 spans=None, held=None):
        self.segments, self.cuts = segments, cuts
        self.inputs, self.outputs = inputs, outputs
        self.counters = counters or {}
        self.spans, self.held = spans, held

    @classmethod
    def capture(cls, name: str, fn, static: tuple, spans=None, hold=None):
        """(graph, result): ``fn(*static)`` run eagerly on a side stream,
        which builds what is made lazily (kernels' libraries, cuDNN's plans,
        constants), then captured there on the same static inputs, inside
        ``hold()`` where given, whose value the graph keeps (sync site
        ``<name>_graph_capture``); and the eager run's result."""
        inputs = trees.leaves(static)
        dev = inputs[0].device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = fn(*static)
        cur.wait_stream(side)
        for x in trees.leaves(first):
            x.record_stream(cur)
        capture = _Capture()
        with (hold or contextlib.nullcontext)() as held, \
                profiling.sync_point(f"{name}_graph_capture"):
            torch.cuda.synchronize(dev)
            # The function's own counters land in a recorder of the
            # capture's, to be added at each replay.
            with torch.cuda.stream(side), profiling.recording() as rec:
                out = capture.run(fn, static)
        counters = {n: k for (n, _), k in rec.counters.items()}
        return cls(capture.segments, capture.cuts, inputs, out, counters,
                   spans, held), first

    def _replay(self, first: int, last: int):
        """Segments ``first`` .. ``last - 1``, each followed by its cut
        launch, through the wrapper's module attribute as it is now."""
        for k in range(first, last):
            self.segments[k].replay()
            if k < len(self.cuts):
                module, name, args, out = self.cuts[k]
                getattr(module, name)(*args, out=out)

    def __call__(self, args: tuple):
        """The captured function on ``args``: their tensors copied into the
        static inputs, the graphs replayed, the counters added, and copies
        of the static outputs, which the next replay leaves be."""
        with torch.no_grad():
            torch._foreach_copy_(self.inputs, trees.leaves(args))
        n = len(self.segments)
        if self.spans is None:
            self._replay(0, n)
        else:
            with profiling.span(self.spans[0]):
                self._replay(0, 1)
            with profiling.span(self.spans[1]):
                self._replay(1, n)
        for name, k in self.counters.items():
            profiling.count(name, k)
        return trees.map_tensors(self.outputs, torch.clone)


class GraphCache:
    """One stage's graphs, one a key, at most ``MAX_GRAPHS``, never freed;
    ``name`` names the stage's counters and sync site."""

    def __init__(self, name: str):
        self.name = name
        self.graphs: dict = {}
        self._counters = (f"{name}_graph_captures", f"{name}_graph_replays")

    def __call__(self, key, fn, args: tuple, capture=None):
        """``fn(*args)``: replayed from the graph of ``key``; else, while
        fewer than ``MAX_GRAPHS`` are held, captured (``capture()``, the
        stage's own (graph, result), or ``Graph.capture`` of ``fn`` on
        clones of ``args``) and the eager result returned; else, and where
        ``key`` is None, run eagerly."""
        graph = None if key is None else self.graphs.get(key)
        new = (key is not None and graph is None
               and len(self.graphs) < MAX_GRAPHS)
        captures, replays = self._counters
        profiling.count(captures, int(new))
        profiling.count(replays, int(graph is not None))
        if graph is not None:
            return graph(args)
        if not new:
            return fn(*args)
        if capture is None:
            graph, out = Graph.capture(self.name, fn,
                                       trees.map_tensors(args, torch.clone))
        else:
            graph, out = capture()
        self.graphs[key] = graph
        return out
