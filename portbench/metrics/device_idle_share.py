"""Device layer: the share of the traced part's wall time in which no
operation ran on the card, in %: 1 minus the union of the device
intervals over the part."""


def read(run, name):
    t = run.trace
    if not t or not t.get("launches"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
