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
    flow_corr_cuda,
    flow_ops,
    sgm,
    sgm_cuda,
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


@pytest.mark.parametrize("r", [4, 2])
@pytest.mark.parametrize("c,h,w", [(196, 3, 10), (64, 24, 80), (7, 13, 37)])
def test_correlation_kernel_matches_plain(cuda, c, h, w, r):
    g = torch.Generator(device=cuda).manual_seed(c + h + w)
    f1 = torch.randn(1, c, h, w, device=cuda, generator=g)
    f2 = torch.randn(1, c, h, w, device=cuda, generator=g)
    out = flow_corr_cuda.correlation(f1, f2, r)
    ref = flow_ops.correlation(f1, f2, r)
    assert (out - ref).abs().max().item() <= 1e-5


def test_wrappers_count_launches(cuda):
    before = dict(sgm_cuda.LAUNCHES), dict(flow_corr_cuda.LAUNCHES)
    cl = torch.randint(0, 1 << 24, (8, 40), dtype=torch.int32, device=cuda)
    sgm_cuda.vertical_deltas(cl, cl, 10, 120)
    flow_corr_cuda.correlation(torch.randn(1, 3, 5, 7, device=cuda),
                               torch.randn(1, 3, 5, 7, device=cuda), 2)
    torch.cuda.synchronize()
    assert sgm_cuda.LAUNCHES["sgm_vertical"] == before[0]["sgm_vertical"] + 1
    assert flow_corr_cuda.LAUNCHES["corr"] == before[1]["corr"] + 1
