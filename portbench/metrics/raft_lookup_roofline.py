"""Kernels layer: RAFT's lookup kernel's share of its roofline in the
traced part, in %: the sum over its calls of each call's bound,
max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) from the call's shapes
(``bounds/raft_lookup.py``), over its device time. None where the
lookup never ran."""


def read(run, name):
    for k in (run.trace or {}).get("kernels", []):
        if k["kernel"] == "raft_lookup" and k["calls"] and k["device_s"] > 0:
            return 100.0 * k["bound_s"] / k["device_s"]
    return None
