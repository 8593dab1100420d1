"""Device layer: the flow net's convolution FLOPs of the work done over
the time it took, as a share of the H100 SXM's dense bf16 peak of 989
TFLOP/s, in %. The FLOPs are ``core/flops.py``'s: a pair's forward pass,
or a train step's forward pass times 3. The work and time: what the
window of a closed loop or a training cell completed outside the traced
part, over that part of the window (an open loop's offered rate would
fix the share: it reads none). The serving count is the flow net's alone: SGM, ego-motion, scene flow,
clustering and tracking do no model FLOPs."""

PEAK_BF16_FLOPS = 989e12


def read(run, name):
    if not run.units_seconds or not run.flops_per_unit:
        return None
    return (100.0 * run.flops_per_unit * run.units_completed
            / run.units_seconds / PEAK_BF16_FLOPS)
