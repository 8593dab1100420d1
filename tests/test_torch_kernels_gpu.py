"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. The file imports no JAX, so it runs on a GPU machine that has
none; the repository's conftest imports JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py
"""

import collections

import numpy as np
import pytest
import torch

from moving_object_detector_tpu_torch.ops import (
    cluster_stats,
    cluster_stats_cuda,
    clustering,
    clustering_cuda,
    flow_corr_cuda,
    flow_ops,
    gather_cuda,
    gauss_newton_cuda,
    geometry,
    sceneflow_cuda,
    sgm,
    sgm_cuda,
    sgm_v1_cuda,
)
from corr_grad_cases import (
    ODD_CASES,
    PLAN_CASES,
    TOL_CORR_GRAD,
    TRAIN_LEVELS,
    grad_case,
    grad_error,
)
from dp_cc_cases import (
    AGG_CASES,
    AGG_FULL,
    AGG_PENALTIES,
    AGG_SERVING,
    CC_CASES,
    CENSUS_CASES,
    COST_CASES,
    DP_CASES,
    STATS_CASES,
    VDP_CASES,
    WTA_V1_CASES,
    WTA_V1_FLAGS,
    agg_cost,
    census_pair,
    cost_pair,
    on_device,
    stats_case,
    wta_total,
)
from gauss_newton_cases import (
    CAM,
    RANSAC_CASES,
    correspondences,
    problem,
    ransac_case,
    sound,
)
from sceneflow_cases import FUSED_CASES, fused_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w", [(188, 621), (125, 350), (37, 171)])
def test_sgm_kernels_bitwise_equal_plain(cuda, h, w):
    rng = np.random.default_rng(h)
    left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                        device=cuda)
    right = torch.roll(left, -9, 1) + 0.02 * torch.randn(h, w, device=cuda)
    cl, cr = sgm.census_transform(left), sgm.census_transform(right)
    vf, vb = sgm_cuda.vertical_deltas(cl, cr, 10, 120)
    hf, hb = sgm_cuda.horizontal_deltas(cl, cr, 10, 120)
    plain = (*sgm.vertical_deltas(cl, cr, 10, 120),
             *sgm.horizontal_deltas(cl, cr, 10, 120))
    for a, b in zip((vf, vb, hf, hb), plain):
        assert torch.equal(a, b)
    total = sgm.total_from_deltas(hf, hb, vf, vb, cl, cr)
    for uniq in (0.0, 0.95):
        out = sgm_cuda.wta(hf, hb, vf, vb, cl, cr, uniqueness_ratio=uniq)
        ref = sgm.wta_from_total(total, uniqueness_ratio=uniq)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


# name: (h, w, constant pair, subpixel, lr_check, uniqueness_ratio); the
# cases of tests/test_torch_kernel_redesign.py, there against the JAX
# package on the CPU.
WTA_CASES = {
    "constant_ties_over_d": (6, 37, True, True, True, 0.0),
    "width_37_below_d": (6, 37, False, True, True, 0.0),
    "width_350": (5, 350, False, True, True, 0.0),
    "width_351_not_multiple_of_4": (5, 351, False, True, True, 0.0),
    "lr_check_off": (6, 150, False, True, False, 0.0),
    "subpixel_off": (6, 150, False, False, True, 0.0),
    "uniqueness_0.95": (6, 150, False, True, True, 0.95),
    "serving_all_off": (188, 621, False, False, False, 0.95),
}


@pytest.mark.parametrize("case", sorted(WTA_CASES))
def test_sgm_wta_edge_cases_bitwise_equal_plain(cuda, case):
    h, w, constant, subpixel, lr_check, uniq = WTA_CASES[case]
    rng = np.random.default_rng(w)
    left = np.full((h, w), 0.5) if constant else rng.uniform(0, 1, (h, w))
    left = torch.tensor(left, dtype=torch.float32, device=cuda)
    right = left if constant else (
        torch.roll(left, -7, 1) + 0.02 * torch.randn(h, w, device=cuda))
    cl, cr = sgm.census_transform(left), sgm.census_transform(right)
    vols = (*sgm.horizontal_deltas(cl, cr, 10, 120),
            *sgm.vertical_deltas(cl, cr, 10, 120))
    kw = dict(subpixel=subpixel, lr_check=lr_check, lr_max_diff=1.0,
              uniqueness_ratio=uniq)
    before = sgm_cuda.LAUNCHES["sgm_wta"]
    out = sgm_cuda.wta(*vols, cl, cr, **kw)
    assert sgm_cuda.LAUNCHES["sgm_wta"] == before + 1
    ref = sgm.wta_from_total(sgm.total_from_deltas(*vols, cl, cr), **kw)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    if constant:
        assert bool((out == 0).all())


# (p1, p2): the serving pair, P1 = P2 = 0, P2 = 127 (the int8 limit),
# P1 > P2.
DP_PENALTIES = [(10, 120), (0, 0), (10, 127), (40, 7)]


@pytest.mark.parametrize("p1,p2", DP_PENALTIES)
@pytest.mark.parametrize("h,w", [(188, 621), (125, 350), (37, 171)]
                         + sorted({(h, w) for h, w, _, _ in DP_CASES}))
def test_sgm_horizontal_bitwise_equal_plain(cuda, h, w, p1, p2):
    rng = np.random.default_rng(h * w + p1)
    left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                        device=cuda)
    right = torch.roll(left, -9, 1) + 0.02 * torch.randn(h, w, device=cuda)
    cl, cr = sgm.census_transform(left), sgm.census_transform(right)
    before = sgm_cuda.LAUNCHES["sgm_horizontal"]
    hf, hb = sgm_cuda.horizontal_deltas(cl, cr, p1, p2)
    assert sgm_cuda.LAUNCHES["sgm_horizontal"] == before + 1
    pf, pb = sgm.horizontal_deltas(cl, cr, p1, p2)
    assert torch.equal(hf, pf) and torch.equal(hb, pb)


def test_sgm_horizontal_widest_row_and_refusal(cuda):
    """The widest row staged in shared memory (opted in above 48 KB) and
    the first one past it, which reads the census from global memory: the
    forward deltas of the first 300 pixels depend on those pixels alone,
    the backward ones of the last 173 on the last 300, so those agree with
    the plain version on the slices. No width is refused."""
    for w in (sgm_cuda.DP_SMEM_WIDTH, sgm_cuda.DP_SMEM_WIDTH + 1):
        cl, cr = torch.randint(0, 1 << 24, (2, 2, w), dtype=torch.int32,
                               device=cuda)
        hf, hb = sgm_cuda.horizontal_deltas(cl, cr, 10, 120)
        torch.cuda.synchronize()
        pf, _ = sgm.horizontal_deltas(cl[:, :300], cr[:, :300], 10, 120)
        _, pb = sgm.horizontal_deltas(cl[:, -300:], cr[:, -300:], 10, 120)
        assert torch.equal(hf[:, :300], pf)
        assert torch.equal(hb[:, -173:], pb[:, 127:])


def _random_wta_inputs(cuda, h, w):
    vols = [torch.randint(-128, 128, (h, w, 128), dtype=torch.int8,
                          device=cuda) for _ in range(4)]
    cl, cr = torch.randint(0, 1 << 24, (2, h, w), dtype=torch.int32,
                           device=cuda)
    return vols, cl, cr


def test_sgm_wta_takes_arbitrary_int8_volumes_and_refuses_wide_rows(cuda):
    """Random int8 volumes, negative deltas included, at a narrow row and
    just past the old ceiling of 8192 (staged in shared memory, opted in
    above 48 KB), at 9,000, at the widest staged row and at the first width
    past the shared-memory limit (the global-memory variant): bitwise equal
    to the plain version, for the LR check on and off. No width is
    refused."""
    for w in (131, 8193, 9000, sgm_cuda.WTA_SMEM_WIDTH,
              sgm_cuda.WTA_SMEM_WIDTH + 1):
        h = 9 if w == 131 else 2
        vols, cl, cr = _random_wta_inputs(cuda, h, w)
        total = sgm.total_from_deltas(*vols, cl, cr)
        for lr, uniq in ((True, 0.9), (True, 0.0), (False, 0.0)):
            kw = dict(lr_check=lr, uniqueness_ratio=uniq)
            out = sgm_cuda.wta(*vols, cl, cr, **kw)
            ref = sgm.wta_from_total(total, **kw)
            assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), \
                (w, kw)
    zeros = torch.zeros((1, 9000, 128), dtype=torch.int8, device=cuda)
    census = torch.zeros((1, 9000), dtype=torch.int32, device=cuda)
    out = sgm_cuda.wta(zeros, zeros, zeros, zeros, census, census)
    assert bool((out == 0).all())


@pytest.mark.parametrize("w", [4097, 19000, sgm_v1_cuda.WTA_SMEM_WIDTH,
                               sgm_v1_cuda.WTA_SMEM_WIDTH + 1])
def test_sgm_v1_wta_takes_wide_rows(cuda, w):
    """Past the old ceiling of 4096 (the shared memory opted in above 48
    KB), at 19,000, at the widest staged row (its right view padded by 4
    words every 16) and at the first width past the shared-memory limit
    (the global-memory variant): bitwise equal to the plain version."""
    total = torch.randint(0, 600, (2, w, 128), dtype=torch.int16,
                          device=cuda)
    for subpixel, lr in ((True, True), (False, True), (True, False)):
        out = sgm_v1_cuda.wta(total, subpixel, lr, 1.0)
        ref = sgm.wta_from_total(total, subpixel, lr, 1.0)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("h,w,p1,p2", VDP_CASES)
def test_sgm_vertical_edge_cases_bitwise_equal_plain(cuda, h, w, p1, p2):
    """Heights at and around the row block, widths below D and with a
    partial last strip, the four penalty pairs: both directions bitwise,
    one launch."""
    rng = np.random.default_rng(h * w + p2)
    left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                        device=cuda)
    right = torch.roll(left, -9, 1) + 0.02 * torch.randn(h, w, device=cuda)
    cl, cr = sgm.census_transform(left), sgm.census_transform(right)
    before = sgm_cuda.LAUNCHES["sgm_vertical"]
    vf, vb = sgm_cuda.vertical_deltas(cl, cr, p1, p2)
    assert sgm_cuda.LAUNCHES["sgm_vertical"] == before + 1
    pf, pb = sgm.vertical_deltas(cl, cr, p1, p2)
    assert torch.equal(vf, pf) and torch.equal(vb, pb)


def test_sgm_vertical_refuses_a_negative_p1(cuda):
    cl = torch.zeros((4, 40), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="P1=-1"):
        sgm_cuda.vertical_deltas(cl, cl, -1, 120)


@pytest.mark.parametrize("case", sorted(CENSUS_CASES))
def test_census_pair_edge_cases_bitwise_equal_plain(cuda, case):
    """Both views in one launch, each equal to the plain transform and to
    the kernel run on that view alone."""
    _, _, window, _ = CENSUS_CASES[case]
    left, right = (torch.from_numpy(x).to(cuda) for x in census_pair(case))
    before = sgm_v1_cuda.LAUNCHES["sgm1_census"]
    cl, cr = sgm_v1_cuda.census_pair(left, right, window)
    assert sgm_v1_cuda.LAUNCHES["sgm1_census"] == before + 1
    for out, img in ((cl, left), (cr, right)):
        assert torch.equal(out, sgm.census_transform(img, window))
        assert torch.equal(out, sgm_v1_cuda.census(img, window))


V1_SHAPES = [(188, 621), (125, 350), (16, 50), (7, 33)]


def _v1_pair(cuda, h, w):
    rng = np.random.default_rng(h + w)
    left = torch.tensor(rng.uniform(0, 1, (h, w)), dtype=torch.float32,
                        device=cuda)
    right = torch.roll(left, -9, 1) + 0.02 * torch.randn(h, w, device=cuda)
    return left, right


@pytest.mark.parametrize("window", [(5, 5), (3, 7), (1, 3)])
@pytest.mark.parametrize("h,w", V1_SHAPES)
def test_sgm_v1_census_kernel_bitwise_equal_plain(cuda, h, w, window):
    before = sgm_v1_cuda.LAUNCHES["sgm1_census"]
    for img in _v1_pair(cuda, h, w):
        assert torch.equal(sgm_v1_cuda.census(img, window),
                           sgm.census_transform(img, window))
    assert sgm_v1_cuda.LAUNCHES["sgm1_census"] == before + 2


@pytest.mark.parametrize("h,w", V1_SHAPES)
def test_sgm_v1_cost_kernel_equals_plain(cuda, h, w):
    left, right = _v1_pair(cuda, h, w)
    cl, cr = sgm.census_transform(left), sgm.census_transform(right)
    cost = sgm_v1_cuda.cost_volume(cl, cr)
    assert cost.dtype == torch.int8
    assert torch.equal(cost.to(torch.int32), sgm.hamming_cost(cl, cr, 128))


@pytest.mark.parametrize("p1,p2", [(10, 120), (3, 500), (0, 0)])
@pytest.mark.parametrize("h,w", V1_SHAPES)
def test_sgm_v1_aggregate_kernel_equals_plain(cuda, h, w, p1, p2):
    """Hamming costs and a volume of arbitrary int8 values (negative ones
    are clipped to 0 on read); two launches a call."""
    left, right = _v1_pair(cuda, h, w)
    cost = sgm_v1_cuda.cost_volume(sgm.census_transform(left),
                                   sgm.census_transform(right))
    noise = torch.randint(-128, 128, (h, w, 128), dtype=torch.int8,
                          device=cuda)
    before = sgm_v1_cuda.LAUNCHES["sgm1_aggregate"]
    for vol in (cost, noise):
        out = sgm_v1_cuda.aggregate(vol, p1, p2)
        assert out.dtype == torch.int16
        assert torch.equal(out, sgm.aggregate_cost_volume(vol, p1, p2))
    assert sgm_v1_cuda.LAUNCHES["sgm1_aggregate"] == before + 4


@pytest.mark.parametrize("subpixel,lr_check", [(True, True), (False, True),
                                               (True, False), (False, False)])
@pytest.mark.parametrize("h,w", V1_SHAPES)
def test_sgm_v1_wta_kernel_bitwise_equal_plain(cuda, h, w, subpixel,
                                               lr_check):
    left, right = _v1_pair(cuda, h, w)
    cl, cr = sgm.census_transform(left), sgm.census_transform(right)
    total = sgm.aggregate_cost_volume(sgm.hamming_cost(cl, cr, 128), 10, 120)
    noise = torch.randint(0, 600, (h, w, 128), dtype=torch.int16,
                          device=cuda)
    for vol in (total, noise):
        out = sgm_v1_cuda.wta(vol, subpixel, lr_check, 1.0)
        ref = sgm.wta_from_total(vol, subpixel, lr_check, 1.0)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_sgm_v1_cost_edge_cases_equal_plain(cuda, case):
    """Widths 1, below D and around the kernel's segment of COST_TX
    pixels, a height of 1, census words with all 32 bits different beside
    x < d: one launch, equal to the plain version."""
    _, _, window, _ = COST_CASES[case]
    left, right = (torch.from_numpy(x).to(cuda) for x in cost_pair(case))
    cl, cr = sgm.census_transform(left, window), sgm.census_transform(
        right, window)
    before = sgm_v1_cuda.LAUNCHES["sgm1_cost"]
    cost = sgm_v1_cuda.cost_volume(cl, cr)
    assert sgm_v1_cuda.LAUNCHES["sgm1_cost"] == before + 1
    assert torch.equal(cost.to(torch.int32), sgm.hamming_cost(cl, cr, 128))


@pytest.mark.parametrize("subpixel,lr_check,lr_max_diff", WTA_V1_FLAGS)
@pytest.mark.parametrize("case", sorted(WTA_V1_CASES))
def test_sgm_v1_wta_edge_cases_bitwise_equal_plain(cuda, case, subpixel,
                                                   lr_check, lr_max_diff):
    """Ties over d and in the right view, minima at d = 0, 1, 126, 127, an
    offset of exactly +0.5, x < best, negative totals, the int16 extremes:
    one launch, bitwise equal to the plain version."""
    tot = torch.from_numpy(wta_total(case)).to(cuda)
    before = sgm_v1_cuda.LAUNCHES["sgm1_wta"]
    out = sgm_v1_cuda.wta(tot, subpixel, lr_check, lr_max_diff)
    assert sgm_v1_cuda.LAUNCHES["sgm1_wta"] == before + 1
    ref = sgm.wta_from_total(tot, subpixel, lr_check, lr_max_diff)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_sgm_v1_cost_and_wta_at_the_full_frame(cuda):
    """376 x 1242 (the serving point before the SGM's scale of 2): the cost
    kernel equal to the plain version, the WTA bitwise for all four
    (subpixel, lr_check) pairs, also on a total that starts 2 bytes into
    its storage (the wrapper copies it to the 16-byte alignment the kernel
    reads with)."""
    left, right = _v1_pair(cuda, 376, 1242)
    cl, cr = sgm.census_transform(left), sgm.census_transform(right)
    cost = sgm_v1_cuda.cost_volume(cl, cr)
    assert torch.equal(cost.to(torch.int32), sgm.hamming_cost(cl, cr, 128))
    total = sgm.aggregate_cost_volume(cost, 10, 120)
    flat = torch.empty(total.numel() + 1, dtype=torch.int16, device=cuda)
    shifted = flat[1:].view(total.shape)
    shifted.copy_(total)
    assert shifted.data_ptr() % 16 == 2
    for vol in (total, shifted):
        for subpixel in (True, False):
            for lr_check in (True, False):
                out = sgm_v1_cuda.wta(vol, subpixel, lr_check, 1.0)
                ref = sgm.wta_from_total(vol, subpixel, lr_check, 1.0)
                assert torch.equal(out.view(torch.int32),
                                   ref.view(torch.int32))


@pytest.mark.parametrize("h,w", V1_SHAPES[:3])
def test_sgm_v1_path_equals_v2_path_bitwise(cuda, h, w):
    from moving_object_detector_tpu_torch.config import SGMConfig

    left, right = _v1_pair(cuda, h, w)
    v1 = sgm.sgm_disparity_raw(left, right, SGMConfig(backend="pallas_v1"))
    v2 = sgm.sgm_disparity_raw(left, right, SGMConfig(backend="pallas"))
    assert torch.equal(v1.view(torch.int32), v2.view(torch.int32))
    assert float((v1 >= 0).float().mean()) > 0.5


@pytest.mark.parametrize("h,w,p1,p2,kind", AGG_CASES)
def test_sgm_v1_aggregate_edge_cases_equal_plain(cuda, h, w, p1, p2, kind):
    """Lengths 1, 2, odd and around the ring's chunks, lines on both sides
    of the shared-memory limits, P2 on both sides of the byte deltas'
    limit, negative int8 costs: bitwise."""
    cost = torch.from_numpy(agg_cost(h, w, kind)).to(cuda)
    assert torch.equal(sgm_v1_cuda.aggregate(cost, p1, p2),
                       sgm.aggregate_cost_volume(cost, p1, p2))


@pytest.mark.parametrize("p1,p2", AGG_PENALTIES)
@pytest.mark.parametrize("shape", [AGG_SERVING, AGG_FULL])
def test_sgm_v1_aggregate_serving_and_full_frame_equal_plain(cuda, shape,
                                                             p1, p2):
    cost = torch.from_numpy(agg_cost(*shape, "int8")).to(cuda)
    assert torch.equal(sgm_v1_cuda.aggregate(cost, p1, p2),
                       sgm.aggregate_cost_volume(cost, p1, p2))


@pytest.mark.parametrize("staged", [True, False])
def test_sgm_v1_aggregate_blocks_wider_than_the_image(cuda, staged):
    """A strip of AGG_MAX_STRIP lines a block over fewer lines than that:
    the warps past the image walk nothing and still meet the barrier."""
    h, w = 11, 5
    cost = torch.from_numpy(agg_cost(h, w, "int8")).to(cuda)
    total = torch.empty((h, w, 128), dtype=torch.int16, device=cuda)
    strip = sgm_v1_cuda.AGG_MAX_STRIP
    sgm_v1_cuda._aggregate_pass(cost, total, 10, 120, False, (strip, staged))
    sgm_v1_cuda._aggregate_pass(cost, total, 10, 120, True, (strip, staged))
    assert torch.equal(total, sgm.aggregate_cost_volume(cost, 10, 120))


def test_sgm_v1_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    cost = torch.zeros((4, 8, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int16"):
        sgm_v1_cuda.aggregate(cost, 10, 9000)
    with pytest.raises(ValueError):
        sgm_v1_cuda.aggregate(cost.to(torch.int32), 10, 120)
    with pytest.raises(ValueError):
        sgm_v1_cuda.wta(cost)
    with pytest.raises(TypeError):
        sgm_v1_cuda.cost_volume(torch.zeros((4, 8), device=cuda),
                                torch.zeros((4, 8), device=cuda))


def test_auction_assignment_on_the_card_equals_cpu(cuda):
    from moving_object_detector_tpu_torch.ops.assignment import (
        auction_assignment,
    )

    rng = np.random.default_rng(0)
    cost = np.full((64, 16), np.inf, np.float32)
    open_ = rng.uniform(size=cost.shape) < 0.08
    cost[open_] = -rng.uniform(0, 1, int(open_.sum())).astype(np.float32)
    out = auction_assignment(torch.from_numpy(cost).to(cuda))
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu(), auction_assignment(torch.from_numpy(cost)))


@pytest.mark.parametrize("r", [4, 2])
@pytest.mark.parametrize("c,h,w", [(196, 3, 10), (64, 24, 80), (7, 13, 37)])
def test_correlation_kernel_matches_plain(cuda, c, h, w, r):
    g = torch.Generator(device=cuda).manual_seed(c + h + w)
    f1 = torch.randn(1, c, h, w, device=cuda, generator=g)
    f2 = torch.randn(1, c, h, w, device=cuda, generator=g)
    out = flow_corr_cuda.correlation(f1, f2, r)
    ref = flow_ops.correlation(f1, f2, r)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("b,c,h,w,r", [
    (2, 7, 5, 3, 1), (2, 7, 5, 3, 4), (1, 7, 2, 21, 2), (1, 7, 2, 21, 3),
    (1, 196, 3, 10, 4), (2, 196, 3, 10, 2), (1, 128, 6, 20, 4),
    (1, 96, 12, 40, 4), (2, 64, 125, 350, 3)])
def test_correlation_kernel_edge_cases_match_plain(cuda, b, c, h, w, r):
    """Few and many channels, images below one tile, B = 2, rows that are
    and are not 16-byte aligned: within 1e-5 (the sum order differs), and
    the same bits in two runs (the channel slices are added in order)."""
    g = torch.Generator(device=cuda).manual_seed(c + h + w + r)
    f1 = torch.randn(b, c, h, w, device=cuda, generator=g)
    f2 = torch.randn(b, c, h, w, device=cuda, generator=g)
    out = flow_corr_cuda.correlation(f1, f2, r)
    assert (out - flow_ops.correlation(f1, f2, r)).abs().max().item() <= 1e-5
    assert torch.equal(out, flow_corr_cuda.correlation(f1, f2, r))
    # Contiguous tensors that start 4 bytes into their storage are not
    # 16-byte aligned: they take the 4-byte copies whatever the width.
    n = f1.numel()
    v1 = torch.randn(n + 1, device=cuda, generator=g)[1:].view_as(f1)
    v2 = torch.randn(n + 1, device=cuda, generator=g)[1:].view_as(f1)
    assert v1.is_contiguous() and v1.data_ptr() % 16 == 4
    out = flow_corr_cuda.correlation(v1, v2, r)
    assert (out - flow_ops.correlation(v1, v2, r)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("b,c,h,w,r", [lvl + (4,) for lvl in TRAIN_LEVELS]
                         + ODD_CASES + PLAN_CASES + [(2, 64, 125, 350, 3)])
def test_correlation_backward_kernel_matches_plain(cuda, b, c, h, w, r):
    """``corr_backward`` against ``flow_ops.correlation_backward`` at the
    train step's four levels, the odd shapes and the plan's switch points:
    within TOL_CORR_GRAD of the gradients' scale, and the same bits in two
    runs (gathers, no atomics). Inputs that start 4 bytes into their
    storage take the 4-byte copies whatever the width."""
    f1, f2, g = (torch.from_numpy(x).to(cuda)
                 for x in grad_case(b, c, h, w, r))
    out = flow_corr_cuda.corr_backward(f1, f2, g, r)
    ref = flow_ops.correlation_backward(f1, f2, g, r)
    assert grad_error([o.cpu() for o in out],
                      [e.cpu() for e in ref]) <= TOL_CORR_GRAD
    again = flow_corr_cuda.corr_backward(f1, f2, g, r)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    v1, v2 = (torch.cat([x.new_zeros(1), x.flatten()])[1:].view_as(x)
              for x in (f1, f2))
    assert v1.data_ptr() % 16 == 4
    out = flow_corr_cuda.corr_backward(v1, v2, g, r)
    assert grad_error([o.cpu() for o in out],
                      [e.cpu() for e in ref]) <= TOL_CORR_GRAD


def test_correlation_function_trains_through_both_kernels(cuda):
    """The autograd Function on CUDA tensors: one forward and one backward
    launch, the gradients the plain backward's; a refusal for what the
    kernels do not take."""
    f1, f2, g = (torch.from_numpy(x).to(cuda)
                 for x in grad_case(2, 7, 9, 11, 3))
    a1 = f1.clone().requires_grad_()
    a2 = f2.clone().requires_grad_()
    before = dict(flow_corr_cuda.LAUNCHES)
    out = flow_corr_cuda.correlation(a1, a2, 3)
    out.backward(g)
    torch.cuda.synchronize()
    assert flow_corr_cuda.LAUNCHES["corr"] == before["corr"] + 1
    assert (flow_corr_cuda.LAUNCHES["corr_backward"]
            == before["corr_backward"] + 1)
    ref = flow_ops.correlation_backward(f1, f2, g, 3)
    assert grad_error([a1.grad.cpu(), a2.grad.cpu()],
                      [e.cpu() for e in ref]) <= TOL_CORR_GRAD
    with pytest.raises(TypeError):
        flow_corr_cuda.corr_backward(f1.double(), f2.double(), g.double(), 3)
    with pytest.raises(ValueError, match="search_range"):
        flow_corr_cuda.corr_backward(f1, f2, g, 5)
    with pytest.raises(ValueError, match="gradient shape"):
        flow_corr_cuda.corr_backward(f1, f2, g[:, :9], 3)


def _equal_with_nans(a, b):
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("h,w,vr,hr", [(376, 1242, 16, 128),
                                       (125, 350, 5, 130), (37, 171, 0, 0)])
def test_gather_kernel_equals_plain(cuda, h, w, vr, hr):
    rng = np.random.default_rng(h)
    src = rng.uniform(1, 100, (h, w)).astype(np.float32)
    src[rng.random((h, w)) < 0.05] = np.nan
    ii, jj = np.mgrid[0:h, 0:w]
    vp = ii + rng.integers(-(vr + 12), vr + 13, (h, w))
    up = jj + rng.integers(-(hr + 200), hr + 201, (h, w))
    far = rng.random((h, w)) < 0.05
    vp[far] = rng.integers(-3 * h, 4 * h, far.sum())
    up[far] = rng.integers(-3 * w, 4 * w, far.sum())
    args = [torch.from_numpy(x).to(cuda) for x in
            (src, vp.astype(np.int32), up.astype(np.int32))]
    out = gather_cuda.window_gather(*args, v_radius=vr, h_radius=hr)
    ref = geometry.window_gather(*args, v_radius=vr, h_radius=hr)
    assert _equal_with_nans(out, ref)
    assert bool(torch.isfinite(out).any()) and bool(torch.isnan(out).any())


def _cc_case(name, h, w):
    rng = np.random.default_rng(len(name) + h)
    depth = (np.round(rng.random((h, w)) * 3) + 2.0).astype(np.float32)
    if name == "random":
        dyn = rng.random((h, w)) < 0.3
    elif name == "dense":
        dyn = rng.random((h, w)) < 0.5
    elif name == "one_component":
        dyn = np.ones((h, w), bool)
        depth[:] = 5.0
    elif name == "serpentine":
        dyn = np.zeros((h, w), bool)
        dyn[::6, :] = True
        for k, r in enumerate(range(0, h - 6, 6)):
            dyn[r:r + 6, w - 1 if k % 2 == 0 else 0] = True
        depth[:] = 5.0
    elif name == "empty":
        dyn = np.zeros((h, w), bool)
    return dyn, depth


@pytest.mark.parametrize("name", ["random", "dense", "one_component",
                                  "serpentine", "empty"])
@pytest.mark.parametrize("h,w", [(192, 512), (125, 350)])
def test_cc_kernel_equals_converged_plain(cuda, name, h, w):
    """Exact labels, three runs (a racy union would differ between runs).
    The plain fixpoint gets rounds enough to converge; the kernel ignores
    ``max_iters``."""
    dyn, depth = _cc_case(name, h, w)
    dyn_t = torch.from_numpy(dyn).to(cuda)
    z_t = torch.from_numpy(depth).to(cuda)
    for radius in (torch.tensor(4), torch.tensor(2)):
        ref, iters = clustering.connected_components(
            dyn_t, z_t, 0.15, neighbor_distance=radius.to(cuda),
            max_iters=4096, stencil_radius=4, return_iters=True)
        assert iters < 4096
        for _ in range(3):
            out = clustering_cuda.connected_components(
                dyn_t, z_t, 0.15, neighbor_distance=radius.to(cuda),
                max_iters=1, stencil_radius=4)
            assert torch.equal(out, ref), (name, int(radius))


def test_cc_kernel_reads_strided_views(cuda):
    """A crop of the frame's dynamic map and of the z plane of an
    (H, W, 3) cloud, as the clusterer passes them."""
    dyn, depth = _cc_case("random", 200, 600)
    pts = torch.zeros(200, 600, 3, device=cuda)
    pts[..., 2] = torch.from_numpy(depth).to(cuda)
    dyn_t = torch.from_numpy(dyn).to(cuda)
    sl = (slice(3, 195), slice(40, 552))
    out = clustering_cuda.connected_components(
        dyn_t[sl], pts[sl][..., 2], 0.15, neighbor_distance=4)
    ref = clustering.connected_components(
        dyn_t[sl].contiguous(), pts[sl][..., 2].contiguous(), 0.15,
        neighbor_distance=4, max_iters=4096)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_cc_kernel_tile_border_cases_equal_converged_plain(cuda, case):
    """The cases of tests/test_torch_dp_cc_redesign.py (edges exactly on
    the tiles' borders and corners, a NaN bridge, radius 0, above the
    stencil and beyond the local phase's reach, partial tiles, a
    serpentine), contiguous and as strided views into a larger frame; three
    runs each."""
    make, radius, stencil, _ = CC_CASES[case]
    dyn, depth = make()
    dyn_t = torch.from_numpy(dyn).to(cuda)
    z_t = torch.from_numpy(depth).to(cuda)
    nd = torch.tensor(radius, dtype=torch.int32, device=cuda)
    ref, iters = clustering.connected_components(
        dyn_t, z_t, 0.15, neighbor_distance=nd, max_iters=4096,
        stencil_radius=stencil, return_iters=True)
    assert iters < 4096
    h, w = dyn.shape
    big_dyn = torch.zeros((h + 7, w + 11), dtype=torch.bool, device=cuda)
    big_z = torch.zeros((h + 7, w + 11, 3), device=cuda)
    big_dyn[5:5 + h, 3:3 + w] = dyn_t
    big_z[5:5 + h, 3:3 + w, 2] = z_t
    views = (dyn_t, z_t), (big_dyn[5:5 + h, 3:3 + w],
                           big_z[5:5 + h, 3:3 + w, 2])
    for d, z in views:
        for _ in range(3):
            out = clustering_cuda.connected_components(
                d, z, 0.15, neighbor_distance=nd, stencil_radius=stencil)
            assert torch.equal(out, ref), case


def test_cc_kernel_refuses_a_stencil_beyond_its_halo(cuda):
    dyn = torch.ones((20, 40), dtype=torch.bool, device=cuda)
    z = torch.ones((20, 40), device=cuda)
    limit = clustering_cuda.MAX_STENCIL
    out = clustering_cuda.connected_components(dyn, z, 0.1,
                                               neighbor_distance=limit)
    assert bool((out == 0).all())
    with pytest.raises(ValueError, match=str(limit)):
        clustering_cuda.connected_components(dyn, z, 0.1,
                                             neighbor_distance=limit + 1)


@pytest.mark.parametrize("h,w,cap", [(192, 512, 16), (125, 350, 32),
                                     (37, 171, 1)])
def test_cluster_stats_kernel_equals_plain(cuda, h, w, cap):
    dyn, depth = _cc_case("random", h, w)
    dyn_t = torch.from_numpy(dyn).to(cuda)
    labels = clustering_cuda.connected_components(
        dyn_t, torch.from_numpy(depth).to(cuda), 0.15, neighbor_distance=4)
    n = h * w
    found = torch.unique(labels[labels < n])
    roots = torch.full((cap,), n, dtype=torch.int32, device=cuda)
    k = min(cap - cap // 4, found.numel())
    roots[:k] = found[:k].to(torch.int32)  # the last slots stay unused
    frame = torch.randn(h + 4, w + 6, 3, device=cuda)
    points = frame[2:h + 2, 3:w + 3]  # a strided view, read in place
    member = torch.isin(labels, roots[:k])
    points[~member] = float("nan")
    out = cluster_stats_cuda.cluster_stats(labels, points, roots)
    ref = cluster_stats.cluster_stats(labels, points, roots)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])
    # Values, not bits: a zero may carry either sign.
    assert bool((out[1] == ref[1]).all()) and bool((out[2] == ref[2]).all())
    assert int(out[3].sum()) > 0


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cluster_stats_kernel_propagates_a_nan_member(cuda, axis):
    """A NaN coordinate on a member pixel: NaN min and max for that slot
    and axis, as in the plain version; nothing else changes."""
    h, w, cap = 125, 350, 8
    dyn, depth = _cc_case("random", h, w)
    labels = clustering_cuda.connected_components(
        torch.from_numpy(dyn).to(cuda), torch.from_numpy(depth).to(cuda),
        0.15, neighbor_distance=4)
    found, sizes = torch.unique(labels[labels < h * w], return_counts=True)
    roots = found[torch.argsort(sizes, descending=True)][:cap].to(
        torch.int32)
    points = torch.randn(h, w, 3, device=cuda)
    i, j = (labels == roots[1]).nonzero()[2]
    points[i, j, axis] = float("nan")
    out = cluster_stats_cuda.cluster_stats(labels, points, roots)
    ref = cluster_stats.cluster_stats(labels, points, roots)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])
    assert _equal_with_nans(out[1], ref[1])
    assert _equal_with_nans(out[2], ref[2])
    for corner in (out[1], out[2]):
        assert bool(torch.isnan(corner[1, axis]))
        assert int(torch.isnan(corner).sum()) == 1


def _stats_equal(out, ref):
    """cid and csize equal, mins and maxs equal by value with NaN in the
    same places (a zero may carry either sign)."""
    return (torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])
            and _equal_with_nans(out[1], ref[1])
            and _equal_with_nans(out[2], ref[2]))


def _stats_inputs(cuda, case):
    labels, points, roots = stats_case(case)
    return (torch.from_numpy(labels).to(cuda), on_device(points, cuda),
            torch.from_numpy(roots).to(cuda))


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_cluster_stats_kernel_edge_cases_equal_plain(cuda, case):
    labels, points, roots = _stats_inputs(cuda, case)
    before = cluster_stats_cuda.LAUNCHES["cluster_stats"]
    out = cluster_stats_cuda.cluster_stats(labels, points, roots)
    assert cluster_stats_cuda.LAUNCHES["cluster_stats"] == before + 1
    assert _stats_equal(out, cluster_stats.cluster_stats(labels, points,
                                                         roots))


def test_cluster_stats_kernel_back_to_back_and_on_two_streams(cuda):
    """The accumulator the kernel's blocks meet in is left zeroed for the
    next call, and each stream has its own: calls in a row, and calls on
    two streams at once, each equal to its plain version."""
    cases = [_stats_inputs(cuda, c) for c in sorted(STATS_CASES)]
    refs = [cluster_stats.cluster_stats(*c) for c in cases]
    for _ in range(3):
        outs = [cluster_stats_cuda.cluster_stats(*c) for c in cases]
        assert all(_stats_equal(o, r) for o, r in zip(outs, refs))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(4):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                for c in cases[k::2]:
                    outs[k].append(cluster_stats_cuda.cluster_stats(*c))
    torch.cuda.synchronize()
    for k in range(2):
        mine = refs[k::2] * 4
        assert all(_stats_equal(o, r) for o, r in zip(outs[k], mine))


def test_cluster_stats_kernel_at_the_full_frame(cuda):
    h, w, cap = 376, 1242, 32
    dyn, depth = _cc_case("random", h, w)
    labels = clustering_cuda.connected_components(
        torch.from_numpy(dyn).to(cuda), torch.from_numpy(depth).to(cuda),
        0.15, neighbor_distance=4)
    found, sizes = torch.unique(labels[labels < h * w], return_counts=True)
    roots = torch.full((cap,), h * w, dtype=torch.int32, device=cuda)
    k = min(cap - 4, found.numel())
    roots[:k] = found[torch.argsort(sizes, descending=True)][:k].to(
        torch.int32)
    points = torch.randn(h, w, 3, device=cuda)
    out = cluster_stats_cuda.cluster_stats(labels, points, roots)
    assert _stats_equal(out, cluster_stats.cluster_stats(labels, points,
                                                         roots))
    assert int(out[3].sum()) > 0
    # The four outputs are views of one allocation.
    base = out[0].untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base for o in out)


@pytest.mark.parametrize("h,w", [(376, 1242), (125, 350)])
def test_fused_scene_flow_kernel_matches_plain(cuda, h, w):
    """NaN masks exact, values within 1e-5 relative (1e-5 of the frame's
    extent for the static flow, a difference of pixel coordinates)."""
    rng = np.random.default_rng(w)
    d_now = rng.uniform(1, 100, (h, w)).astype(np.float32)
    d_prev = rng.uniform(1, 100, (h, w)).astype(np.float32)
    d_now[rng.random((h, w)) < 0.1] = -1.0
    d_prev[rng.random((h, w)) < 0.1] = np.nan
    d_prev[5:9] = 0.0
    flow = rng.normal(0, 8, (h, w, 2)).astype(np.float32)
    flow[rng.random((h, w)) < 0.02] = 400.0
    flow[rng.random((h, w)) < 0.02] = np.nan
    params = torch.tensor(
        [721.5, 720.0, w / 2 - 3, h / 2 + 2, 721.5, 0.54, 0.5, 127.0,
         721.5, 0.54, 0.5, 127.0,
         0.99999, -0.001, 0.004, 0.05, 0.001, 0.99999, -0.002, -0.02,
         -0.004, 0.002, 0.99999, 0.3, 0.1, 5.0, 30.0], device=cuda)
    args = [torch.from_numpy(x).to(cuda) for x in (d_now, d_prev, flow)]
    out = sceneflow_cuda.scene_flow_fused_cuda(*args, params)
    ref = sceneflow_cuda.scene_flow_fused(*args, params)
    _fused_close(out, ref, float(max(h, w)))
    assert bool(torch.isfinite(out[1]).any())


def test_wrappers_count_launches(cuda):
    before = dict(sgm_cuda.LAUNCHES), dict(flow_corr_cuda.LAUNCHES)
    cl = torch.randint(0, 1 << 24, (8, 40), dtype=torch.int32, device=cuda)
    sgm_cuda.vertical_deltas(cl, cl, 10, 120)
    flow_corr_cuda.correlation(torch.randn(1, 3, 5, 7, device=cuda),
                               torch.randn(1, 3, 5, 7, device=cuda), 2)
    torch.cuda.synchronize()
    assert sgm_cuda.LAUNCHES["sgm_vertical"] == before[0]["sgm_vertical"] + 1
    assert flow_corr_cuda.LAUNCHES["corr"] == before[1]["corr"] + 1
    counts = {**gather_cuda.LAUNCHES, **clustering_cuda.LAUNCHES,
              **cluster_stats_cuda.LAUNCHES, **sceneflow_cuda.LAUNCHES}
    src = torch.rand(6, 9, device=cuda)
    idx = torch.zeros((6, 9), dtype=torch.int32, device=cuda)
    gather_cuda.window_gather(src, idx, idx)
    labels = clustering_cuda.connected_components(
        src > 0.5, src, 0.1, neighbor_distance=1)
    cluster_stats_cuda.cluster_stats(
        labels, torch.rand(6, 9, 3, device=cuda),
        torch.tensor([0, 54], dtype=torch.int32, device=cuda))
    sceneflow_cuda.scene_flow_fused_cuda(
        src, src, torch.zeros(6, 9, 2, device=cuda),
        torch.ones(sceneflow_cuda.NPAR, device=cuda))
    torch.cuda.synchronize()
    after = {**gather_cuda.LAUNCHES, **clustering_cuda.LAUNCHES,
             **cluster_stats_cuda.LAUNCHES, **sceneflow_cuda.LAUNCHES}
    assert after == {k: v + 1 for k, v in counts.items()}


def _fused_close(out, ref, scale):
    """NaN masks exact, values within 1e-5 relative (1e-5 of ``scale``
    for the static flow, a difference of pixel coordinates)."""
    for a, b, sc in zip(out, ref, (1.0, 1.0, scale)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert bool(((a - b).abs() <= 1e-5 * (b.abs() + sc)).all())


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_scene_flow_kernel_edge_cases_match_plain(cuda, case):
    """Every residue of W mod 4, odd pixel counts, 1 x 1, 1 x 5, 3 x 7
    (the scalar tail alone), matches on the window's edges, NaN and +-inf
    flow; also from an input that is not 16-byte aligned."""
    d_now, d_prev, flow, par, vr, hr = fused_case(case)
    args = [torch.from_numpy(x).to(cuda) for x in (d_now, d_prev, flow)]
    params = torch.from_numpy(par).to(cuda)
    ref = sceneflow_cuda.scene_flow_fused(*args, params, vr, hr)
    out = sceneflow_cuda.scene_flow_fused_cuda(*args, params, vr, hr)
    _fused_close(out, ref, float(max(d_now.shape)))
    shifted = torch.empty(d_now.size + 1, device=cuda)[1:].view(d_now.shape)
    shifted.copy_(args[0])
    out = sceneflow_cuda.scene_flow_fused_cuda(shifted, *args[1:], params,
                                               vr, hr)
    _fused_close(out, ref, float(max(d_now.shape)))


def _gn_args(cuda, shape):
    pts, uv, weights, iters = problem(shape)
    args = [torch.from_numpy(x).to(cuda) for x in (pts, uv, weights)]
    return args + [torch.tensor(CAM, device=cuda), iters], (pts, uv, weights)


@pytest.mark.parametrize("threads", gauss_newton_cuda.THREADS)
def test_gauss_newton_kernel_matches_plain_at_the_refine_shape(cuda,
                                                               threads):
    """4 candidates over 512 shared points, 8 iterations: within 1e-5
    (the sums over the points run in another order)."""
    args, _ = _gn_args(cuda, "refine")
    before = gauss_newton_cuda.LAUNCHES["gauss_newton"]
    out = gauss_newton_cuda.solve_pose(*args, threads=threads)
    torch.cuda.synchronize()
    assert gauss_newton_cuda.LAUNCHES["gauss_newton"] == before + 1
    ref = gauss_newton_cuda.solve_pose_plain(*args)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", ["hypothesis", "odd"])
def test_gauss_newton_kernel_matches_plain_per_problem_and_odd(cuda, shape):
    """64 hypotheses of 3 points each, 5 iterations: within 1e-4 on the
    sound triples (gauss_newton_cases.sound: an ill-conditioned or
    unconverged triple moves far on an ulp); 5 problems over 37 shared
    points within 1e-5."""
    args, (pts, uv, weights) = _gn_args(cuda, shape)
    out = gauss_newton_cuda.solve_pose(*args)
    ref = gauss_newton_cuda.solve_pose_plain(*args)
    err = (out - ref).abs().amax((1, 2)).cpu().numpy()
    if shape == "hypothesis":
        keep = sound(ref.cpu().numpy(), pts, uv, weights)
        assert keep.sum() >= 16
        assert err[keep].max() <= 1e-4
    else:
        assert err.max() <= 1e-5


def test_gauss_newton_kernel_does_zero_iterations_and_zero_weights(cuda):
    args, _ = _gn_args(cuda, "odd")
    eye = torch.eye(4, device=cuda).expand(5, 4, 4)
    assert torch.equal(gauss_newton_cuda.solve_pose(*args[:4], 0), eye)
    args[2] = torch.zeros_like(args[2])
    assert torch.equal(gauss_newton_cuda.solve_pose(*args), eye)


def test_ransac_on_the_kernel_equals_the_plain_run(cuda, monkeypatch):
    """``_ransac_gn_solve`` with injected hypothesis indices: the same
    success and inlier count, the motion within 1e-4."""
    from moving_object_detector_tpu_torch import egomotion
    from moving_object_detector_tpu_torch.config import EgoMotionConfig
    from moving_object_detector_tpu_torch.types import CameraModel

    pts, uv = (torch.from_numpy(x).to(cuda) for x in correspondences(512))
    valid = torch.ones(512, dtype=torch.bool, device=cuda)
    valid[-20:] = False
    cam = CameraModel.create(*CAM, device=cuda)
    cfg = EgoMotionConfig()
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(np.stack([rng.choice(492, 3, replace=False)
                                     for _ in range(64)])).to(cuda)
    before = gauss_newton_cuda.LAUNCHES["ransac_gn"]
    kernel = egomotion._ransac_gn_solve(pts, uv, valid, cam, None, cfg, idx)
    torch.cuda.synchronize()
    assert gauss_newton_cuda.LAUNCHES["ransac_gn"] == before + 1
    monkeypatch.setattr(gauss_newton_cuda, "ransac_solve",
                        lambda *a, **k: gauss_newton_cuda.ransac_solve_plain(
                            *a, **k))
    plain = egomotion._ransac_gn_solve(pts, uv, valid, cam, None, cfg, idx)
    assert bool(kernel[1]) == bool(plain[1]) and bool(kernel[1])
    assert int(kernel[2]) == int(plain[2])
    assert float((kernel[0] - plain[0]).abs().max()) <= 1e-4


def test_fast_division_and_root_are_the_cards_own(cuda):
    """The kernels' branch-free division and square root (``FastOps``,
    with the IEEE fallback its callers take) equal the card's ``a / b``
    and ``sqrtf`` bit for bit on 2^24 hashed inputs, most of them on the
    fast path."""
    counts = gauss_newton_cuda.ieee_ops_check(1 << 24, seed=7, device=cuda)
    assert counts["div_mismatches"] == 0 and counts["sqrt_mismatches"] == 0
    assert counts["div_fast"] > counts["n"] // 3
    assert counts["sqrt_fast"] > counts["n"] // 3


def _ransac_args(cuda, name, **kw):
    from moving_object_detector_tpu_torch.config import EgoMotionConfig

    pts, uv, valid, idx = ransac_case(name)
    _, h, k = RANSAC_CASES[name]
    args = [torch.from_numpy(x).to(cuda) for x in (pts, uv, valid)]
    args += [torch.tensor(CAM, device=cuda), torch.from_numpy(idx).to(cuda)]
    return args, EgoMotionConfig(ransac_hypotheses=h, refine_candidates=k,
                                 **kw)


@pytest.mark.parametrize("threads", gauss_newton_cuda.RANSAC_THREADS)
@pytest.mark.parametrize("name", sorted(RANSAC_CASES))
def test_ransac_kernel_matches_plain(cuda, name, threads):
    """The whole RANSAC in one launch of ``ransac_gn`` and none of
    ``gauss_newton``, with outliers and invalid features, one to sixteen
    candidates: the same success and inlier count as the plain version,
    the motion within 1e-4 (the sums over the points run in another
    order)."""
    args, cfg = _ransac_args(cuda, name)
    before = dict(gauss_newton_cuda.LAUNCHES)
    out = gauss_newton_cuda.ransac_solve(*args, cfg, threads=threads)
    torch.cuda.synchronize()
    assert gauss_newton_cuda.LAUNCHES == dict(
        before, ransac_gn=before["ransac_gn"] + 1)
    ref = gauss_newton_cuda.ransac_solve_plain(*args, cfg)
    assert bool(out[1]) == bool(ref[1]) and bool(out[1])
    assert int(out[2]) == int(ref[2])
    assert float((out[0] - ref[0]).abs().max()) <= 1e-4


def test_ransac_kernel_makes_no_host_sync(cuda):
    """Neither the wrapper nor ``_ransac_gn_solve`` with injected indices
    waits for the card: synchronizing calls are made errors."""
    from moving_object_detector_tpu_torch import egomotion
    from moving_object_detector_tpu_torch.types import CameraModel

    args, cfg = _ransac_args(cuda, "serving")
    cam = CameraModel.create(*CAM, device=cuda)
    gauss_newton_cuda.ransac_solve(*args, cfg)  # makes the stream's ticket
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gauss_newton_cuda.ransac_solve(*args, cfg)
        ego = egomotion._ransac_gn_solve(*args[:3], cam, None, cfg, args[4])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(out, ego):
        assert torch.equal(a, b)


def test_ransac_kernel_is_bit_identical_run_to_run(cuda):
    args, cfg = _ransac_args(cuda, "serving_k16")
    first = gauss_newton_cuda.ransac_solve(*args, cfg)
    for _ in range(3):
        again = gauss_newton_cuda.ransac_solve(*args, cfg)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("what", ["no_valid_feature", "too_few_inliers"])
def test_ransac_kernel_fails_to_the_identity(cuda, what):
    """With no valid feature, or a min_inliers above every count, the
    motion is the identity and success False, as in the plain version;
    the count is the best candidate's."""
    if what == "no_valid_feature":
        args, cfg = _ransac_args(cuda, "odd")
        args[2] = torch.zeros_like(args[2])
    else:
        args, cfg = _ransac_args(cuda, "serving", min_inliers=10_000)
    out = gauss_newton_cuda.ransac_solve(*args, cfg)
    ref = gauss_newton_cuda.ransac_solve_plain(*args, cfg)
    assert torch.equal(out[0], torch.eye(4, device=cuda))
    assert not bool(out[1]) and not bool(ref[1])
    assert int(out[2]) == int(ref[2])
    if what == "no_valid_feature":
        assert int(out[2]) == 0


def test_harvest_with_the_dashboard_launches_no_kernel(cuda):
    """The runner's harvest (results, and with a dashboard every wanted
    product) copies from the card and launches nothing: each harvest
    profiled alone, the device drained before it."""
    import urllib.error
    import urllib.request

    from torch.profiler import ProfilerActivity, profile

    from moving_object_detector_tpu_torch import config as tcfg
    from moving_object_detector_tpu_torch.io import scenes
    from moving_object_detector_tpu_torch.io.dashboard import LiveDashboard
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner
    from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
    from moving_object_detector_tpu_torch.types import StereoModel

    h, w, fx = 64, 128, 100.0
    config = tcfg.PipelineConfig(
        height=h, width=w,
        flownet=tcfg.FlowNetConfig(feature_channels=(8, 16, 32),
                                   search_range=2, use_context_net=False,
                                   dtype="float32"),
        sgm=tcfg.SGMConfig(max_disparity=32, backend="xla"))
    torch.manual_seed(0)
    model = PWCNet(config.flownet).to(cuda).eval()
    stereo = StereoModel.create(fx=fx, fy=fx, cx=w / 2, cy=h / 2,
                                baseline=0.5, device=cuda)

    class Profiled(PipelineRunner):
        def _harvest(self, *args):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                result = super()._harvest(*args)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            self.kernels.append(sum(not n.startswith(("Memcpy", "Memset"))
                                    for n in names))
            self.copies.append(len(names) - self.kernels[-1])
            return result

    def frames():
        return list(scenes.InteractiveSceneSequence(
            h, w, fx=fx, bg_depth=12.0, realtime=False, n_frames=4,
            objects=[scenes.PlaneObject(
                center0=(0.0, 0.0, 6.0), size=(1.0, 0.7),
                velocity=(0.5, 0.0, 0.0),
                texture=scenes._procedural_texture(
                    np.random.default_rng(5), 64, 96))]))

    copies = []
    for with_dash in (False, True):
        dash = LiveDashboard(0, host="127.0.0.1") if with_dash else None
        try:
            for name in (dash.PRODUCTS if dash else ()):  # a browser asks
                with pytest.raises(urllib.error.HTTPError):  # 404 for now
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{dash.port}/view/{name}.png",
                        timeout=5)
            runner = Profiled(config, stereo, model, dashboard=dash,
                              device=cuda)
            runner.kernels, runner.copies = [], []
            runner.run(frames())
            if dash is not None:
                page = urllib.request.urlopen(
                    f"http://127.0.0.1:{dash.port}/view/flow.png",
                    timeout=5).read()
                assert page.startswith(b"\x89PNG")
        finally:
            if dash is not None:
                dash.close()
        assert runner.kernels == [0] * 4, runner.kernels
        copies.append(runner.copies)
    assert all(b > a for a, b in zip(*copies)), copies


def _small_serving(cuda, h=192, w=640):
    """A random-weight flow net and the default backends at a small size:
    (model, config, stereo, frames) with a textured background at
    disparity 9 and a patch at 20 moving 6 px a frame."""
    from moving_object_detector_tpu_torch import config as tcfg
    from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
    from moving_object_detector_tpu_torch.types import StereoModel

    config = tcfg.PipelineConfig(height=h, width=w, flownet=tcfg.FlowNetConfig(
        feature_channels=(8, 16, 32), search_range=2, use_context_net=False,
        dtype="float32"))
    torch.manual_seed(0)
    model = PWCNet(config.flownet).to(cuda)
    stereo = StereoModel.create(300.0, 300.0, w / 2, h / 2, 0.5, device=cuda)
    rng = np.random.default_rng(7)
    bg = rng.uniform(0, 1, (h, w)).astype(np.float32)
    obj = rng.uniform(0, 1, (40, 60)).astype(np.float32)
    frames = []
    for k in range(3):
        left, right = bg.copy(), np.roll(bg, -9, axis=1)
        x = 200 + 6 * k
        left[60:100, x:x + 60] = obj
        right[60:100, x - 20:x + 40] = obj
        frames.append((torch.from_numpy(left).to(cuda),
                       torch.from_numpy(right).to(cuda)))
    return model, config, stereo, frames


def _launch_counts():
    counters = (sgm_cuda.LAUNCHES, sgm_v1_cuda.LAUNCHES,
                flow_corr_cuda.LAUNCHES, gather_cuda.LAUNCHES,
                clustering_cuda.LAUNCHES, cluster_stats_cuda.LAUNCHES,
                sceneflow_cuda.LAUNCHES, gauss_newton_cuda.LAUNCHES)
    return {k: v for c in counters for k, v in c.items()}


def test_streams_scan_launches_n_times_the_single_stream_kernels(cuda):
    """Two streams a frame: each stream bit for bit its single-stream run,
    the frame's launches the two single-stream frames' summed."""
    from moving_object_detector_tpu_torch.parallel import streams
    from moving_object_detector_tpu_torch.pipeline import (
        PipelineState,
        detect_step,
    )

    model, config, stereo, frames = _small_serving(cuda)
    flipped = [(torch.flip(a, (1,)), torch.flip(b, (1,)))
               for a, b in frames]  # the second stream's own frames
    per_stream = [frames, flipped]
    single = []
    for f in per_stream:
        state = PipelineState.create(config, device=cuda)
        outs = []
        for k, (left, right) in enumerate(f):
            before = _launch_counts()
            state, out = detect_step(model, state, left, right, 0.1 * k,
                                     stereo, config)
            after = _launch_counts()
            outs.append((out, {n: after[n] - before[n] for n in after}))
        single.append(outs)
    states = streams.create_stream_states(config, 2, device=cuda)
    for k in range(len(frames)):
        before = _launch_counts()
        states, out = streams.detect_step_streams_scan(
            model, states, torch.stack([f[k][0] for f in per_stream]),
            torch.stack([f[k][1] for f in per_stream]),
            torch.full((2,), 0.1 * k, device=cuda), stereo, config)
        after = _launch_counts()
        counts = {n: after[n] - before[n] for n in after}
        assert counts == {n: single[0][k][1][n] + single[1][k][1][n]
                          for n in counts}
        for name in ("sgm1_census", "sgm_vertical", "sgm_horizontal",
                     "sgm_wta", "gather"):
            assert counts[name] == 2, (name, counts)
        assert counts["corr"] == 2 * single[0][k][1]["corr"] > 0
        for i, o in enumerate(streams.unstack_states(out)):
            ref = single[i][k][0]
            for f in ("disparity", "flow", "label_image", "motion",
                      "odom_pose"):
                a, b = getattr(o, f), getattr(ref, f)
                a = a.disparity if f == "disparity" else a
                b = b.disparity if f == "disparity" else b
                assert torch.equal(a, b), (k, i, f)
    with pytest.raises(RuntimeError, match="detect_step_streams_scan"):
        streams.detect_step_batched(model, states, frames[0][0][None],
                                    frames[0][1][None],
                                    torch.zeros(1, device=cuda), stereo,
                                    config)


def test_spatial_step_on_one_nccl_rank_equals_the_unsharded_step(cuda):
    """``detect_step_streams_spatial`` over a world of one NCCL rank (device
    tensors through the all-gather) with no halo: bit for bit
    ``detect_step`` fed the unsharded SGM and flow."""
    import socket

    import torch.distributed as dist

    from moving_object_detector_tpu_torch.ops.sgm import compute_disparity
    from moving_object_detector_tpu_torch.parallel import multihost
    from moving_object_detector_tpu_torch.parallel.mesh import create_mesh
    from moving_object_detector_tpu_torch.parallel.spatial import (
        detect_step_streams_spatial,
    )
    from moving_object_detector_tpu_torch.parallel.streams import (
        create_stream_states,
        unstack_states,
    )
    from moving_object_detector_tpu_torch.pipeline import (
        PipelineState,
        _flow_forward,
        detect_step,
    )

    model, config, stereo, frames = _small_serving(cuda)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = create_mesh(1, model_parallel=1)
        states = create_stream_states(config, 1, device=cuda)
        ref_state = PipelineState.create(config, device=cuda)
        for k, (left, right) in enumerate(frames):
            states, out = detect_step_streams_spatial(
                model, states, left[None], right[None],
                torch.full((1,), 0.1 * k, device=cuda), stereo, config, mesh,
                sgm_halo=0, flow_halo=0)
            flow = _flow_forward(model, ref_state.prev_left, left)
            ref_state, ref = detect_step(
                model, ref_state, left, right, 0.1 * k, stereo, config,
                flow_override=flow,
                disparity_override=compute_disparity(left, right, stereo,
                                                     config.sgm))
            (out,) = unstack_states(out)
            assert torch.equal(out.disparity.disparity,
                               ref.disparity.disparity)
            for f in ("flow", "label_image", "motion", "odom_pose"):
                assert torch.equal(getattr(out, f), getattr(ref, f)), (k, f)
    finally:
        dist.destroy_process_group()


def _patch_frames(n, h=376, w=1242):
    """Pairs of known disparity strips (real textures) with two patches
    moving 12 px a frame, far apart, so the clusterer takes its
    two-window branch: busy pairs."""
    import os

    tex = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                               "real_textures.npz"))
    bg = np.concatenate([tex["china"][:h], tex["flower"][:h]],
                        axis=1)[:, :w].astype(np.float32) / 255.0
    right_bg = np.empty_like(bg)
    for x0, x1, d in ((0, 300, 24), (300, 640, 14), (640, 950, 30),
                      (950, w, 18)):
        right_bg[:, x0:x1] = np.roll(bg, -d, axis=1)[:, x0:x1]
    patches = [(tex["hopper"][100:220, 100:300], 360, 44),
               (tex["hopper"][240:360, 300:500], 990, 36)]
    frames = []
    for k in range(n):
        left, right = bg.copy(), right_bg.copy()
        for img, x0, d in patches:
            x = x0 + 12 * k - (12 * n if x0 > 900 else 0)
            img = img.astype(np.float32) / 255.0
            left[140:260, x:x + 200] = img
            right[140:260, x - d:x - d + 200] = img
        frames.append((left, right))
    return frames


def test_every_sync_of_a_busy_pair_is_named(cuda):
    """A busy serving pair (pwc_v7, 376 x 1242, flow and SGM at scale 2,
    two windows of detections) with the card's sync check set to raise
    everywhere but inside ``profiling.sync_point``: every host wait of
    the step is a named site, and the ``syncs`` counter counts them."""
    import os

    from moving_object_detector_tpu_torch import config as cfgmod
    from moving_object_detector_tpu_torch.pipeline import (
        PipelineState,
        detect_step,
    )
    from moving_object_detector_tpu_torch.types import StereoModel
    from moving_object_detector_tpu_torch.utils import profiling
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    h, w, fx = 376, 1242, 721.5
    config = cfgmod.PipelineConfig(height=h, width=w, flow_input_scale=2,
                                   sgm_input_scale=2)
    model, fcfg = load_flow_checkpoint(
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights",
                     "pwc_v7.fp16.npz"), cfgmod.FlowNetConfig(), device=cuda)
    config = config.replace(flownet=fcfg)
    stereo = StereoModel.create(fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
                                baseline=0.54, device=cuda)
    frames = [(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
              for a, b in _patch_frames(6)]
    state = PipelineState.create(config, device=cuda)
    for k, (left, right) in enumerate(frames[:-1]):
        state, _ = detect_step(model, state, left, right, 0.1 * k, stereo,
                               config)
    torch.cuda.synchronize()
    left, right = frames[-1]
    with profiling.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, out = detect_step(model, state, left, right, 0.5, stereo,
                                     config)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(out.detections.valid.sum()) >= 2
    syncs = [s.name for s in rec.spans()
             if s.name.startswith(profiling.SYNC_PREFIX)]
    assert rec.counters[("syncs", 5)] == len(syncs)
    assert "sync.clusterer_windows" in syncs
    # The tracker stage waits for nothing: a warm pair replays its graph.
    assert not [s for s in syncs if s.startswith("sync.tracker_")], syncs
    assert rec.counters[("tracker_graph_replays", 5)] == 1
    print(f"syncs of the busy pair: {len(syncs)}: "
          f"{sorted(collections.Counter(syncs).items())}")


def _pwc_v7(cuda):
    """A fresh pwc_v7 net on the card (so its flow graphs are this test's
    own) and the serving configuration: 376 x 1242, flow at scale 2."""
    import os

    from moving_object_detector_tpu_torch import config as cfgmod
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    model, fcfg = load_flow_checkpoint(
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights",
                     "pwc_v7.fp16.npz"), cfgmod.FlowNetConfig(), device=cuda)
    return model, fcfg.corr_backend


def test_flow_graph_is_bitwise_the_eager_flow_over_serving_pairs(
        cuda, monkeypatch):
    """8 consecutive 376 x 1242 pairs at scale 2 through ``_flow_forward``:
    the first captures the graph (unless an earlier test did) and returns
    its eager run, the others replay it; each flow bitwise the eager
    ``_flow_eager``, unchanged by the later replays, with 4 ``corr``
    launches a pair, each a call of the module's ``corr_forward`` (where a
    benchmark's wrapper reads the call's shapes)."""
    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.utils import profiling

    model, backend = _pwc_v7(cuda)
    imgs = [torch.from_numpy(a).to(cuda) for a, _ in _patch_frames(9)]
    key = pipeline._flow_key(model, imgs[0], imgs[1], 2, backend)
    fresh = int(key not in pipeline._flow_cache.graphs)
    flows, eager, corr, calls = [], [], [], []
    real = flow_corr_cuda.corr_forward

    def seen(f1, *args, **kwargs):
        calls[-1].append(tuple(f1.shape))
        return real(f1, *args, **kwargs)

    with profiling.recording() as rec:
        for k in range(8):
            profiling.set_unit(k)
            before = flow_corr_cuda.LAUNCHES["corr"]
            calls.append([])
            with monkeypatch.context() as m:
                m.setattr(flow_corr_cuda, "corr_forward", seen)
                flows.append(pipeline._flow_forward(
                    model, imgs[k], imgs[k + 1], input_scale=2,
                    corr_backend=backend))
            corr.append(flow_corr_cuda.LAUNCHES["corr"] - before)
            eager.append(pipeline._flow_eager(
                model, imgs[k], imgs[k + 1], 2, backend))
    assert corr == [4] * 8
    assert [len(c) for c in calls[1:]] == [4] * 7
    assert all(c == calls[1] for c in calls[2:])
    assert [rec.counters[("flow_graph_captures", k)] for k in range(8)] == [
        fresh] + [0] * 7
    assert [rec.counters[("flow_graph_replays", k)] for k in range(8)] == [
        1 - fresh] + [1] * 7
    for k, (a, b) in enumerate(zip(flows, eager)):
        assert a.shape == (376, 1242, 2) and torch.equal(a, b), k
    assert key in pipeline._flow_cache.graphs


def test_flow_graph_per_shape_and_the_callers_parameters(cuda):
    """A second shape captures a second graph; an update in place, a
    replaced parameter and a second net of the configuration are read by
    the replay of the same graph, bitwise the eager flow."""
    from moving_object_detector_tpu_torch import pipeline

    model, backend = _pwc_v7(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    a, b = torch.rand((2, 376, 1242), generator=gen, device=cuda)
    c, d = torch.rand((2, 192, 640), generator=gen, device=cuda)

    def flow(net, p, q, scale=2):
        out = pipeline._flow_forward(net, p, q, input_scale=scale,
                                     corr_backend=backend)
        assert torch.equal(out, pipeline._flow_eager(net, p, q, scale,
                                                     backend))

    def graphs():
        return {id(g) for g in pipeline._flow_cache.graphs.values()}

    flow(model, a, b)
    flow(model, b, a)
    one = graphs()
    flow(model, c, d, 1)
    flow(model, d, c, 1)
    two = graphs()
    assert one <= two and len(two - one) <= 1
    assert (pipeline._flow_key(model, c, d, 1, backend)
            in pipeline._flow_cache.graphs)
    with torch.no_grad():
        model.context.residual.bias.add_(0.25)
    flow(model, a, b)
    conv = model.context.residual
    conv.bias = torch.nn.Parameter(conv.bias.detach() - 0.5)
    flow(model, a, b)
    flow(model, b, a)
    other, _ = _pwc_v7(cuda)
    flow(other, a, b)
    flow(model, a, b)
    assert graphs() == two


def test_replayed_flow_makes_no_host_wait(cuda):
    """After its capture, a serving pair's flow stage runs with the card's
    sync check set to raise."""
    from moving_object_detector_tpu_torch import pipeline

    model, backend = _pwc_v7(cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    a, b = torch.rand((2, 376, 1242), generator=gen, device=cuda)
    pipeline._flow_forward(model, a, b, input_scale=2, corr_backend=backend)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipeline._flow_forward(model, b, a, input_scale=2,
                                     corr_backend=backend)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, pipeline._flow_eager(model, b, a, 2, backend))


# RAFT's flow graphs stay alive for the process: a graph destroyed and
# another captured after it can crash a later profiled replay.
_RAFT_GRAPHS = []


@pytest.mark.parametrize("b,h,w,levels,r,amp", [
    (1, 47, 156, 4, 4, 12.0), (1, 47, 156, 4, 4, 300.0),
    (2, 16, 24, 4, 4, 6.0), (1, 9, 13, 2, 3, 4.0), (3, 8, 8, 1, 1, 2.0)])
def test_raft_lookup_kernel_matches_plain(cuda, b, h, w, levels, r, amp):
    """The lookup kernel within 1e-4 of its plain version (of the samples'
    scale) at RAFT's KITTI grid and at edge shapes, matches on and far off
    the maps; one launch a call. The tolerance is the coordinates'
    rounding: the kernel normalises them with IEEE division, PyTorch on
    the card multiplies by the divisor's reciprocal, and a last-bit shift
    of a coordinate near 150 px moves a sample of a random map by up to
    about 2e-5 of its scale."""
    from moving_object_detector_tpu_torch.models.raft import (
        coords_grid, correlation_pyramid)
    from moving_object_detector_tpu_torch.ops import raft_lookup_cuda

    g = torch.Generator(device=cuda).manual_seed(b * 1000 + h + levels)
    f1, f2 = torch.randn((2, b, 256, h, w), generator=g, device=cuda)
    pyr = correlation_pyramid(f1, f2, levels)
    coords = coords_grid(b, h, w, cuda) + amp * (
        2 * torch.rand((b, 2, h, w), generator=g, device=cuda) - 1)
    before = raft_lookup_cuda.LAUNCHES["raft_lookup"]
    out = raft_lookup_cuda.raft_lookup(pyr, coords, r)
    assert raft_lookup_cuda.LAUNCHES["raft_lookup"] == before + 1
    ref = raft_lookup_cuda.raft_lookup_plain(pyr, coords, r)
    assert out.shape == (b, levels * (2 * r + 1) ** 2, h, w)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= 1e-4 * scale


def _raft_at_kitti(cuda, seed=3):
    """A bf16 RAFT of the published widths, drawn from ``seed``."""
    from moving_object_detector_tpu_torch.config import RAFTConfig
    from moving_object_detector_tpu_torch.utils.checkpoint import build_raft

    return build_raft(RAFTConfig(), seed, cuda)


def _kitti_pair(cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.rand((376, 1242), generator=gen, device=cuda)
    return a, torch.roll(a, (1, 3), (0, 1))


@pytest.fixture
def raft_graphs(monkeypatch):
    """A flow-graph table of the test's own, its graphs kept after it."""
    from moving_object_detector_tpu_torch import pipeline

    fresh = {}
    monkeypatch.setattr(pipeline._flow_cache, "graphs", fresh)
    yield fresh
    _RAFT_GRAPHS.extend(fresh.values())


def test_raft_replay_cuts_each_lookup_and_equals_the_eager_flow(
        cuda, raft_graphs):
    """RAFT at 376 x 1242 (padded to 1248): the first pair captures 25
    segments around 24 lookups, each later pair replays them with 24
    ``raft_lookup`` launches through the module's wrapper, bitwise the
    eager flow; counters 24 iterations and lookups a pair."""
    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.ops import raft_lookup_cuda
    from moving_object_detector_tpu_torch.utils import profiling

    model = _raft_at_kitti(cuda)
    pairs = [_kitti_pair(cuda, s) for s in range(3)]
    launches, flows = [], []
    with profiling.recording() as rec:
        for k, (a, b) in enumerate(pairs):
            profiling.set_unit(k)
            before = raft_lookup_cuda.LAUNCHES["raft_lookup"]
            flows.append(pipeline._flow_forward(model, a, b))
            launches.append(raft_lookup_cuda.LAUNCHES["raft_lookup"] - before)
    for k, ((a, b), flow) in enumerate(zip(pairs, flows)):
        assert flow.shape == (376, 1242, 2)
        assert torch.equal(flow, pipeline._flow_eager(model, a, b)), k
    (graph,) = raft_graphs.values()
    assert len(graph.segments) == 25 and len(graph.cuts) == 24
    assert launches == [24, 24, 24]
    for k in range(3):
        assert rec.counters[("raft_lookups", k)] == 24
        assert rec.counters[("raft_iterations", k)] == 24
    assert [rec.counters[("flow_graph_replays", k)] for k in range(3)] == [
        0, 1, 1]
    spans = {s.name for s in rec.spans() if s.unit == 2}
    assert {"raft_encode", "raft_update"} <= spans


def test_profiled_raft_replay_records_its_24_lookups(cuda, raft_graphs,
                                                      monkeypatch):
    """Under torch.profiler a replay shows 24 ``raft_lookup_kernel``
    launches, and a wrapper of the module's ``raft_lookup`` (as the
    benchmark's recorder wraps it) sees 24 calls."""
    from torch.profiler import ProfilerActivity, profile

    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.ops import raft_lookup_cuda

    model = _raft_at_kitti(cuda)
    a, b = _kitti_pair(cuda, 7)
    pipeline._flow_forward(model, a, b)
    calls = []
    real = raft_lookup_cuda.raft_lookup

    def seen(pyramid, coords, *args, **kwargs):
        calls.append(tuple(coords.shape))
        return real(pyramid, coords, *args, **kwargs)

    monkeypatch.setattr(raft_lookup_cuda, "raft_lookup", seen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipeline._flow_forward(model, b, a)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "raft_lookup_kernel" in e.name]
    assert len(calls) == 24 and set(calls) == {(1, 2, 47, 156)}
    assert len(kernels) == 24


def test_raft_replay_reads_a_changed_batch_norm_buffer(cuda, raft_graphs):
    """The context encoder's batch norm keeps running statistics, which a
    replay copies in with the parameters: a changed running mean moves
    the replayed flow, bitwise the eager flow of the changed net."""
    from moving_object_detector_tpu_torch import pipeline

    model = _raft_at_kitti(cuda)
    a, b = _kitti_pair(cuda, 9)
    pipeline._flow_forward(model, a, b)
    before = pipeline._flow_forward(model, a, b)
    with torch.no_grad():
        model.cnet.norm1.running_mean.add_(0.5)
        model.cnet.layer2[0].norm3.running_var.mul_(2.0)
    after = pipeline._flow_forward(model, a, b)
    assert not torch.equal(before, after)
    assert torch.equal(after, pipeline._flow_eager(model, a, b))


def _tracker_frames(cuda):
    """``tests/tracker_cases.py``'s serving sequence (64 tracks, 16
    detection slots; one pair with ``frame_valid`` false), then 3 quiet
    pairs (no detection) and the sequence's first 4 pairs again, later:
    busy, quiet and invalid pairs, each as (t, detections, frame_valid)
    on the card."""
    from tracker_cases import serving

    from moving_object_detector_tpu_torch.types import MovingObjects

    frames = serving()
    quiet = [(t + 1.0, c, v, b, np.zeros_like(valid), True)
             for t, c, v, b, valid, _ in frames[-3:]]
    again = [(t + 2.0, *rest) for t, *rest in frames[:4]]
    out = []
    for t, center, velocity, bbox, valid, frame_valid in (
            frames + quiet + again):
        ids = np.where(valid, np.arange(valid.shape[0]), -1)
        dets = MovingObjects(
            id=torch.tensor(ids, dtype=torch.int32, device=cuda),
            center=torch.tensor(center, device=cuda),
            velocity=torch.tensor(velocity, device=cuda),
            bounding_box=torch.tensor(bbox, device=cuda),
            valid=torch.tensor(valid, device=cuda))
        out.append((torch.tensor(float(t), device=cuda), dets,
                    torch.tensor(frame_valid, device=cuda)))
    return out


def _reference_track(state, t, dets, frame_valid, cfg):
    """The benchmark's plain reference tracker on the card, its branch on
    ``frame_valid`` as ``portbench/reference/step.py`` takes it."""
    from portbench.core import judge_serve
    from portbench.reference import tracker as rtr
    from portbench.reference import types as rtypes

    if bool(frame_valid):
        return rtr.track_step(judge_serve.as_reference(state), t,
                              judge_serve.as_reference(dets), cfg)
    k = state.capacity
    return state, rtypes.TrackedObjects(
        objects=rtypes.MovingObjects.empty(k, t.device),
        covariance=torch.zeros((k, 4, 4), dtype=torch.float32,
                               device=t.device))


def _same_bits(a, b):
    from moving_object_detector_tpu_torch.utils.trees import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
        for x, y in zip(la, lb))


def test_tracker_graph_is_bitwise_the_eager_stage_over_serving_pairs(cuda):
    """The serving shapes (64 tracks, 16 detections) over busy, quiet and
    ``frame_valid``-false pairs through ``track_frame``: the first pair
    captures the graph (unless an earlier test did) and returns its eager
    run, the others replay it; each pair's state and tracks bitwise the
    eager stage's and the benchmark's plain reference's on the card, each
    unchanged by the later replays; 1 replay a warm pair."""
    from moving_object_detector_tpu_torch import tracker
    from moving_object_detector_tpu_torch.config import (
        PipelineConfig,
        TrackerConfig,
    )
    from moving_object_detector_tpu_torch.tunables import Tunables
    from moving_object_detector_tpu_torch.utils import profiling, trees
    from portbench.reference.config import TrackerConfig as RefConfig

    cfg = TrackerConfig()
    tun = Tunables.from_config(PipelineConfig(), cuda)
    knobs = dict(object_radius=tun.object_radius,
                 covariance_trace_limit=tun.covariance_trace_limit,
                 correction_count_limit=tun.correction_count_limit)
    frames = _tracker_frames(cuda)
    key = (frames[0][0].device, 64, 16, cfg)
    fresh = int(key not in tracker._tracker_cache.graphs)
    state = eager = ref = tracker.TrackerState.create(64, cuda)
    kept = []
    with profiling.recording() as rec:
        for k, (t, dets, frame_valid) in enumerate(frames):
            profiling.set_unit(k)
            out = tracker.track_frame(state, t, dets, frame_valid, cfg,
                                      **knobs)
            want = tracker._track_frame_eager(
                cfg, eager, t, dets, frame_valid, knobs["object_radius"],
                knobs["covariance_trace_limit"],
                knobs["correction_count_limit"])
            plain = _reference_track(ref, t, dets, frame_valid, RefConfig())
            assert _same_bits(out, want), k
            assert _same_bits(out, plain), k
            kept.append(([x.clone() for x in trees.leaves(out)], out))
            state, eager, ref = out[0], want[0], plain[0]
    for k, (copies, out) in enumerate(kept):
        assert all(torch.equal(a, b)
                   for a, b in zip(copies, trees.leaves(out))), k
    n = len(frames)
    assert [rec.counters[("tracker_graph_captures", k)]
            for k in range(n)] == [fresh] + [0] * (n - 1)
    assert [rec.counters[("tracker_graph_replays", k)]
            for k in range(n)] == [1 - fresh] + [1] * (n - 1)
    assert int(state.next_id) >= 6 and key in tracker._tracker_cache.graphs
    assert any(bool(o[1].objects.valid.any()) for _, o in kept)


def test_replayed_tracker_makes_no_host_wait(cuda):
    """After its capture, the tracker stage at the serving shapes runs
    with the card's sync check set to raise, and a replay's result stays
    its own after the next replay."""
    from moving_object_detector_tpu_torch import tracker
    from moving_object_detector_tpu_torch.config import TrackerConfig
    from moving_object_detector_tpu_torch.utils import trees

    cfg = TrackerConfig()
    frames = _tracker_frames(cuda)
    state = tracker.TrackerState.create(64, cuda)
    t, dets, valid = frames[0]
    state, _ = tracker.track_frame(state, t, dets, valid, cfg)
    knobs = [torch.tensor(v, device=cuda) for v in (
        cfg.object_radius, cfg.covariance_trace_limit)] + [
        torch.tensor(cfg.correction_count_limit, dtype=torch.int32,
                     device=cuda)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = []
        for t, dets, valid in frames[1:6]:
            state, tracked = tracker.track_frame(state, t, dets, valid, cfg,
                                                 *knobs)
            outs.append((state, tracked))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    first = [x.clone() for x in trees.leaves(outs[0])]
    assert all(torch.equal(a, b)
               for a, b in zip(first, trees.leaves(outs[0])))
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
        trees.leaves(outs[0]), trees.leaves(outs[1])))


def _ego_pairs(cuda, net):
    """Ego-motion's inputs on 5 serving pairs of ``_patch_frames``: the
    previous left image, the current one, the previous pair's SGM
    disparity (scale 2) and the flow from ``net`` ("pwc": pwc_v7 at scale
    2, mostly dense pairs; "raft": a random RAFT at KITTI's full frame,
    whose flow sends every pair to the LK fallback), all 376 x 1242; for
    "pwc" a sixth pair with a flow of noise, a fallback pair. Returns
    (pairs, camera, configuration)."""
    from moving_object_detector_tpu_torch import config as cfgmod
    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.types import StereoModel

    h, w, fx = 376, 1242, 721.5
    config = cfgmod.PipelineConfig(height=h, width=w, sgm_input_scale=2)
    stereo = StereoModel.create(fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
                                baseline=0.54, device=cuda)
    if net == "pwc":
        model, backend = _pwc_v7(cuda)
        scale = 2
    else:
        model, backend, scale = _raft_at_kitti(cuda), None, 1
    frames = [(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
              for a, b in _patch_frames(6)]
    pairs = []
    for (pl, pr), (nl, _) in zip(frames, frames[1:]):
        disp = pipeline._sgm_forward(pl, pr, stereo, config)
        flow = pipeline._flow_eager(model, pl, nl, scale, backend)
        pairs.append((pl, nl, disp, flow))
    if net == "pwc":
        gen = torch.Generator(device=cuda).manual_seed(3)
        pl, nl, disp, flow = pairs[-1]
        pairs.append((pl, nl, disp, 40.0 * torch.randn(
            flow.shape, generator=gen, device=cuda)))
    return pairs, stereo.cam, config.egomotion


def _ego(pairs, cam, cfg, k, eager=False, monkeypatch=None):
    """``estimate_motion`` on pair ``k`` with the pipeline's generator of
    frame ``k``, eagerly where asked: (result, generator state after)."""
    from moving_object_detector_tpu_torch import egomotion, pipeline
    from moving_object_detector_tpu_torch.utils import cuda_graphs

    prev, now, disp, flow = pairs[k]
    gen = pipeline.ransac_generator(k, prev.device)
    with monkeypatch.context() as m:
        if eager:
            m.setattr(cuda_graphs, "graphable", lambda *ts: False)
        out = egomotion.estimate_motion(prev, now, disp, cam, gen, cfg,
                                        dense_flow=flow)
    return out, gen.get_state()


@pytest.mark.parametrize("net", ["pwc", "raft"])
def test_egomotion_graphs_are_bitwise_the_eager_stage(cuda, net,
                                                      monkeypatch):
    """Serving pairs through ``estimate_motion`` twice in a row (a pair's
    first call may capture, the second replays): each result and the
    caller's generator after it bitwise the eager stage's, dense pairs and
    fallback pairs both; the LK graph replayed on exactly the pairs that
    fall back."""
    from moving_object_detector_tpu_torch.utils import profiling

    pairs, cam, cfg = _ego_pairs(cuda, net)
    eager = [_ego(pairs, cam, cfg, k, True, monkeypatch)
             for k in range(len(pairs))]
    fallbacks, lk_replays = [], []
    with profiling.recording() as rec:
        for k, want in enumerate(eager):
            for rep in range(2):
                unit = 2 * k + rep
                profiling.set_unit(unit)
                assert _same_bits(_ego(pairs, cam, cfg, k,
                                       monkeypatch=monkeypatch), want), k
            assert rec.counters[("egomotion_graph_replays", unit)] == 1
            fallbacks.append(rec.counters[("egomotion_lk_fallbacks", unit)])
            lk_replays.append(rec.counters[("egomotion_lk_graph_replays",
                                            unit)])
    assert lk_replays == fallbacks
    assert all(fallbacks) if net == "raft" else 0 < sum(fallbacks) < len(
        fallbacks)
    print(f"{net}: fallbacks {fallbacks}")


def test_replayed_egomotion_waits_once_for_the_fallback_flag(
        cuda, monkeypatch):
    """After their captures, a dense pair and a fallback pair run with the
    card's sync check set to raise outside named sites: the one host wait
    of each is ``egomotion_lk_fallback``."""
    from moving_object_detector_tpu_torch.utils import profiling

    pairs, cam, cfg = _ego_pairs(cuda, "pwc")
    picks = (1, len(pairs) - 1)
    for k in picks:
        _ego(pairs, cam, cfg, k, monkeypatch=monkeypatch)
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for k in picks:
                profiling.set_unit(k)
                with profiling.span("egomotion"):
                    _ego(pairs, cam, cfg, k, monkeypatch=monkeypatch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for k in picks:
        syncs = [s.name for s in rec.spans() if s.unit == k
                 and s.name.startswith(profiling.SYNC_PREFIX)]
        assert syncs == ["sync.egomotion_lk_fallback"], (k, syncs)
    assert [rec.counters[("egomotion_lk_fallbacks", k)] for k in picks] == [
        0, 1]


def test_profiled_egomotion_replay_reaches_the_ransac_attribute(
        cuda, monkeypatch):
    """Under torch.profiler a replayed dense pair launches
    ``ransac_gn_kernel`` once, a fallback pair twice, each a call of the
    module's ``ransac_solve`` (where the benchmark's recorder wraps it)."""
    from torch.profiler import ProfilerActivity, profile

    pairs, cam, cfg = _ego_pairs(cuda, "pwc")
    real = gauss_newton_cuda.ransac_solve
    for k, want in ((1, 1), (len(pairs) - 1, 2)):
        _ego(pairs, cam, cfg, k, monkeypatch=monkeypatch)
        calls = []

        def seen(*args, **kwargs):
            calls.append(tuple(args[4].shape))
            return real(*args, **kwargs)

        monkeypatch.setattr(gauss_newton_cuda, "ransac_solve", seen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _ego(pairs, cam, cfg, k, monkeypatch=monkeypatch)
            torch.cuda.synchronize()
        monkeypatch.setattr(gauss_newton_cuda, "ransac_solve", real)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "ransac_gn_kernel" in e.name]
        assert len(calls) == want and set(calls) == {(64, 3)}, k
        assert len(kernels) == want, k


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 9, (7 << 32) + 40])
def test_the_capture_safe_draw_is_bitwise_multinomial_on_the_card(
        cuda, seed):
    """On the card ``egomotion._draw`` gives ``torch.multinomial``'s
    indices for the same seeded CUDA generator, two draws in a row, and
    leaves the generator where multinomial does."""
    from moving_object_detector_tpu_torch import egomotion

    rng = np.random.default_rng(seed % 2 ** 32)
    for n, valid in ((512, 0.7), (37, 0.3), (16, 0.0)):
        feat_valid = torch.from_numpy(rng.random(n) < valid).to(cuda)
        p = torch.clamp(feat_valid.float(), min=1e-20).expand(64, n)
        a = torch.Generator(device=cuda).manual_seed(seed)
        b = torch.Generator(device=cuda).manual_seed(seed)
        for _ in range(2):
            want = torch.multinomial(p, 3, replacement=False, generator=a)
            assert torch.equal(egomotion._draw(p, 3, b), want)
        assert torch.equal(a.get_state(), b.get_state())
