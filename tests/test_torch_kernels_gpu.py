"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. The file imports no JAX, so it runs on a GPU machine that has
none; the repository's conftest imports JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py
"""

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
    geometry,
    sceneflow_cuda,
    sgm,
    sgm_cuda,
    sgm_v1_cuda,
)
from dp_cc_cases import (
    CC_CASES,
    CENSUS_CASES,
    DP_CASES,
    VDP_CASES,
    census_pair,
)

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
    KB), at 19,000, at the widest staged row and at the first width past
    the shared-memory limit (the global-memory variant): bitwise equal to
    the plain version."""
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
                                               (True, False)])
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


@pytest.mark.parametrize("h,w", V1_SHAPES[:3])
def test_sgm_v1_path_equals_v2_path_bitwise(cuda, h, w):
    from moving_object_detector_tpu_torch.config import SGMConfig

    left, right = _v1_pair(cuda, h, w)
    v1 = sgm.sgm_disparity_raw(left, right, SGMConfig(backend="pallas_v1"))
    v2 = sgm.sgm_disparity_raw(left, right, SGMConfig(backend="pallas"))
    assert torch.equal(v1.view(torch.int32), v2.view(torch.int32))
    assert float((v1 >= 0).float().mean()) > 0.5


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
    for a, b, scale in zip(out, ref, (1.0, 1.0, float(max(h, w)))):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert bool(((a - b).abs() <= 1e-5 * (b.abs() + scale)).all())
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
