"""Ops layer: device operations (kernels, copies and fills) the profiler
records in the traced part, divided by the pairs dispatched in it."""


def read(run, name):
    t = run.trace
    if run.kind != "serve" or not t or not t.get("launches"):
        return None
    return t["launches"] / t["units"]
