"""Training loop: device operations (kernels, copies and fills) the
profiler records in the traced part, divided by the train steps in it
(each with the making of its batch)."""


def read(run, name):
    t = run.trace
    if run.kind != "train" or not t or not t.get("launches"):
        return None
    return t["launches"] / t["units"]
