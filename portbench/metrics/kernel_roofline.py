"""Kernels layer: the hand-written kernels' share of their roofline in
the traced part, in %: the sum over their calls of each call's bound,
max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) from the call's shapes
(``bounds/``), over the sum of their device time. None where no bounded
kernel ran."""


def read(run, name):
    t = run.trace
    ks = [k for k in (t or {}).get("kernels", [])
          if k["calls"] and k["device_s"] > 0]
    if not ks:
        return None
    return 100.0 * sum(k["bound_s"] for k in ks) / sum(k["device_s"]
                                                      for k in ks)
