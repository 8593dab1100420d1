"""Edge cases the redesigned v1 SGM aggregation and cluster-stats kernels
must honour, on the CPU: the port's plain versions (what their wrappers run
for CPU tensors, and what the CUDA kernels are held against on the card)
against the JAX package, on the same seeded numpy inputs.

The aggregation walks each line both ways in steps copied a chunk at a
time into a ring, the two walks meeting in the middle, with byte deltas in
shared memory up to a line length and a P2, and a read-modify-write in
global memory beyond; so its cases are lengths 1, 2, odd and around a
chunk and the ring, lines on both sides of the shared-memory limits and
P2 on both sides of the byte limit, the (P1, P2) pairs (0, 0), (10, 120),
(3, 500), (200, 120) and (10, 8063), and negative int8 costs. The stats
kernel takes 32 pixels of a row a warp, looks labels up in a sorted table
of the roots and meets its blocks in a per-stream accumulator; so its
cases are cap 1 and 32, repeated roots, no slot used, one cluster over
the image, signed zeros and NaN among the members' coordinates, a strided
crop of points and an image that is not a multiple of the block. The sizes come from the
wrapper modules (tests/dp_cc_cases.py), so that they follow the kernels.
Everything here is integer or selection code: every comparison is exact.
The same cases run kernel against plain version on the card in
tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.config import SGMConfig as JSGMConfig
from moving_object_detector_tpu.ops import sgm as jsgm
from moving_object_detector_tpu.ops.cluster_stats_pallas import (
    cluster_stats_pallas,
)
from moving_object_detector_tpu.ops.sgm_pallas import (
    aggregate_cost_volume_pallas,
)
from moving_object_detector_tpu_torch.ops import (
    cluster_stats_cuda,
    sgm_cuda,
    sgm_v1_cuda,
)
from dp_cc_cases import (
    AGG_CASES,
    AGG_FULL,
    AGG_PALLAS_CASES,
    AGG_SERVING,
    H100_SMS,
    STATS_CASES,
    agg_cost,
    stats_case,
)

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "moving_object_detector_tpu_torch", "csrc")


def _int(source: str, name: str) -> int:
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wrapper_constants_are_the_kernels():
    """The ring, strip, byte-delta and shared-memory limits the aggregation
    cases are sized from, and the stats block and cap, are the ones the
    kernels are built with."""
    assert sgm_v1_cuda.AGG_ROW_STEPS == _int("sgm_v1.cu", "kAggRowSteps")
    assert sgm_v1_cuda.AGG_COL_STEPS == _int("sgm_v1.cu", "kAggColSteps")
    assert sgm_v1_cuda.AGG_RING_BUFS == _int("sgm_v1.cu", "kAggRingBufs")
    assert sgm_v1_cuda.AGG_MAX_STRIP == _int("sgm_v1.cu", "kAggMaxStrip")
    assert sgm_v1_cuda.AGG_DELTA8_MAX_P2 == _int("sgm_v1.cu",
                                                 "kDelta8MaxP2")
    assert sgm_cuda.SMEM_PER_BLOCK == _int("sgm_v1.cu", "kSmemPerBlock")
    assert cluster_stats_cuda.STATS_THREADS == _int("cluster_stats.cu",
                                                    "kThreads")
    assert cluster_stats_cuda.MAX_CAP == _int("cluster_stats.cu", "kMaxCap")
    assert cluster_stats_cuda.ACC_WORDS == 1 + _int(
        "cluster_stats.cu", "kAcc") * cluster_stats_cuda.MAX_CAP


def test_aggregation_plan_switches_where_the_cases_say():
    """The row and column launches stage their deltas up to AGG_SMEM_WIDTH
    / AGG_SMEM_HEIGHT and P2 <= 255 and take the read-modify-write variant
    beyond; the column strip fills the card once and shrinks where a
    strip's deltas would not fit. The edge cases lie on both sides."""
    plan = sgm_v1_cuda.agg_plan
    lim = sgm_cuda.SMEM_PER_BLOCK
    wide, tall = sgm_v1_cuda.AGG_SMEM_WIDTH, sgm_v1_cuda.AGG_SMEM_HEIGHT
    assert sgm_v1_cuda.agg_smem_bytes(wide, 1, False, True) <= lim
    assert sgm_v1_cuda.agg_smem_bytes(wide + 1, 1, False, True) > lim
    assert plan(2, wide, 120, H100_SMS)[0] == (1, True)
    assert plan(2, wide + 1, 120, H100_SMS)[0] == (1, False)
    assert plan(tall, 2, 120, H100_SMS)[1] == (1, True)
    assert plan(tall + 1, 2, 120, H100_SMS)[1] == (1, False)
    assert plan(5, 33, 255, H100_SMS) == ((1, True), (1, True))
    assert plan(5, 33, 256, H100_SMS) == ((1, False), (1, False))
    # The serving shape: 125 blocks of 5 columns; the full frame: the
    # card's strip of 8 does not fit, 3 columns do.
    assert plan(*AGG_SERVING, 120, H100_SMS) == ((1, True), (5, True))
    assert plan(*AGG_FULL, 120, H100_SMS) == ((1, True), (3, True))
    for h, w, _, p2, _ in AGG_CASES + [(*AGG_SERVING, 0, 120, ""),
                                       (*AGG_FULL, 0, 120, "")]:
        for (strip, staged), length, vertical in zip(
                plan(h, w, p2, H100_SMS), (w, h), (False, True)):
            assert 1 <= strip <= sgm_v1_cuda.AGG_MAX_STRIP
            assert sgm_v1_cuda.agg_smem_bytes(length, strip, vertical,
                                              staged) <= lim
    cases = {(h, w) for h, w, _, _, _ in AGG_CASES}
    assert {(2, wide), (2, wide + 1), (tall, 2), (tall + 1, 2)} <= cases


def _clipped(cost):
    return np.clip(cost.astype(np.int32), 0, 127)


@pytest.mark.parametrize("h,w,p1,p2,kind", AGG_CASES)
def test_aggregate_equals_the_jax_paths(h, w, p1, p2, kind):
    """``sgm_v1_cuda.aggregate`` (on CPU tensors the plain version) against
    the JAX package's four XLA path scans (``aggregate_cost_volume``) on
    the clipped cost, exactly."""
    cost = agg_cost(h, w, kind)
    ref = np.asarray(jsgm.aggregate_cost_volume(
        jnp.asarray(_clipped(cost).astype(np.float32)),
        JSGMConfig(p1=p1, p2=p2)))
    out = sgm_v1_cuda.aggregate(torch.from_numpy(cost), p1, p2)
    assert out.dtype == torch.int16 and tuple(out.shape) == (h, w, 128)
    np.testing.assert_array_equal(out.numpy().astype(np.float32), ref)


@pytest.mark.parametrize("h,w,p1,p2,kind", AGG_PALLAS_CASES)
def test_aggregate_equals_pallas_interpret(h, w, p1, p2, kind):
    """The Pallas kernel itself (``_dual_scan_kernel``), which clips the
    int8 cost on read as the port does: bitwise."""
    cost = agg_cost(h, w, kind)
    ref = np.asarray(aggregate_cost_volume_pallas(
        jnp.asarray(cost.astype(np.float32)), p1=p1, p2=p2, interpret=True))
    out = sgm_v1_cuda.aggregate(torch.from_numpy(cost), p1, p2)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_aggregate_at_the_serving_shape_equals_the_jax_paths():
    h, w = AGG_SERVING
    cost = agg_cost(h, w, "hamming")
    ref = np.asarray(jsgm.aggregate_cost_volume(
        jnp.asarray(cost.astype(np.float32)), JSGMConfig()))
    out = sgm_v1_cuda.aggregate(torch.from_numpy(cost), 10, 120)
    np.testing.assert_array_equal(out.numpy().astype(np.float32), ref)


def test_p1_above_p2_gives_the_paths_of_p1_equal_p2():
    """The kernel clamps P1 to P2: exact, since L(d -+ 1) + P1 >= min L +
    P1 never beats min L + P2 then. The plain version and the JAX package
    take P1 as given."""
    cost = agg_cost(9, 25, "int8")
    for p1 in (121, 200, 4000):
        assert torch.equal(
            sgm_v1_cuda.aggregate(torch.from_numpy(cost), p1, 120),
            sgm_v1_cuda.aggregate(torch.from_numpy(cost), 120, 120))


def _stats(name):
    labels, points, roots = stats_case(name)
    out = cluster_stats_cuda.cluster_stats(
        torch.from_numpy(labels), torch.from_numpy(points),
        torch.from_numpy(roots))
    ref = cluster_stats_pallas(jnp.asarray(labels), jnp.asarray(points),
                               jnp.asarray(roots), interpret=True)
    return labels, points, roots, [o.numpy() for o in out], \
        [np.asarray(r) for r in ref]


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_cluster_stats_equal_pallas_interpret(case):
    """cid and csize equal, mins and maxs equal by value (a zero may carry
    either sign) with NaN in the same places. With repeated roots the last
    slot wins the pixels in both; the earlier slot of a repeated root is
    empty in the port, as in the JAX package's unrolled passes
    (clusterer.py), which count a slot's members by cid, while the Pallas
    kernel gives it the cluster's statistics again. The detector's roots
    are distinct CC labels, so it never repeats one."""
    labels, points, roots, out, ref = _stats(case)
    n, cap = labels.size, roots.size
    cid, mins, maxs, csize = out
    np.testing.assert_array_equal(cid, ref[0])
    shadowed = np.array([roots[c] < n and (roots[c + 1:] == roots[c]).any()
                         for c in range(cap)])
    keep = ~shadowed
    np.testing.assert_array_equal(csize[keep], ref[3][keep])
    for a, b in ((mins, ref[1]), (maxs, ref[2])):
        a, b = a[keep], b[keep]
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert (a[~np.isnan(a)] == b[~np.isnan(b)]).all()
    assert (csize[shadowed] == 0).all()
    assert (mins[shadowed] == np.inf).all() and \
        (maxs[shadowed] == -np.inf).all()
    assert int(csize.sum()) == int((cid < cap).sum())
    kind = STATS_CASES[case][3]
    if kind == "unused":
        assert (cid == cap).all() and not csize.any()
    if kind == "whole":
        assert (cid == 0).all() and csize[0] == n
    if kind == "repeated":
        assert shadowed.any() and csize[keep & (roots < n)].all()
    if kind == "zeros_nan":
        assert np.isnan(mins[2, 2]) and np.isnan(maxs[2, 2])
        assert np.isnan(mins).sum() == 1
        used = csize > 0
        assert (mins[used, 0] == 0.0).all() and (maxs[used, 1] == 0.0).all()
    if kind == "crop":
        assert not points.flags.c_contiguous

