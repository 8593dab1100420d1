"""Inputs of the correlation backward's tests (numpy only): the CPU
tests, the card tests and ``chip_smoke.py`` share them.

``TRAIN_LEVELS``: the four correlation calls of a pwc_v7 train step at
``train_flow.py``'s defaults (192 x 448, batch 8, r = 4), as (B, C, H, W).
``ODD_CASES``: (B, C, H, W, r) for r = 1..4 with B = 1 and 2, C = 1 and 7,
odd H and W, H or W below r, and a 1 x 1 image.
``PLAN_CASES``: the switch points of the kernel's plan
(``flow_corr_cuda.backward_plan``): C just below, at and above its 8
channel slots and its 16 channels a round, and C a multiple of neither
(196, the last training level's); W % 4 = 0, 1, 2, 3 (16-byte copies or
4-byte ones), planes of an odd H x W, W below, at and above the 32-pixel
tile; H or W below r; B = 1 and 8.
"""

import numpy as np

TRAIN_HW, TRAIN_BATCH = (192, 448), 8
TRAIN_LEVELS = ((8, 64, 24, 56), (8, 96, 12, 28), (8, 128, 6, 14),
                (8, 196, 3, 7))
ODD_CASES = [case for r in (1, 2, 3, 4) for case in (
    (1, 1, 5, 7, r), (2, 7, 9, 11, r), (2, 7, 2, 13, r), (1, 7, 11, 3, r),
    (1, 1, 1, 1, r))]
PLAN_CASES = [
    (1, 16, 5, 32, 4), (8, 17, 3, 33, 4), (1, 15, 7, 31, 4),
    (2, 9, 4, 30, 3), (8, 8, 2, 3, 4), (1, 196, 3, 7, 4),
    (1, 33, 9, 65, 2), (2, 31, 6, 14, 1)]
# The kernel against the plain backward: the largest |difference| over
# the largest |gradient| (at least 1). Each gradient element is a sum of
# (2r+1)^2 products; the kernel sums them with fused multiply-adds over
# the window's rows, then its columns, the plain form in offset order
# with a rounding after each product.
TOL_CORR_GRAD = 1e-5


def grad_case(b, c, h, w, r, seed=0):
    """(f1, f2, g) f32 NCHW: features and the output's gradient."""
    rng = np.random.default_rng(seed + 7919 * (b + c + h + w + r))
    k = (2 * r + 1) ** 2
    return (rng.standard_normal((b, c, h, w)).astype(np.float32),
            rng.standard_normal((b, c, h, w)).astype(np.float32),
            rng.standard_normal((b, k, h, w)).astype(np.float32))


def grad_error(out, ref) -> float:
    """max |out - ref| / max(1, max |ref|) over the pair of gradients."""
    return max(float(np.abs(np.asarray(o) - np.asarray(e)).max())
               / max(1.0, float(np.abs(np.asarray(e)).max()))
               for o, e in zip(out, ref))
