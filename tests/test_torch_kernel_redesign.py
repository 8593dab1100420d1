"""Edge cases the redesigned correlation and SGM v2 WTA kernels must honour,
on the CPU: the port's plain versions (what its wrappers run for CPU
tensors, and what the CUDA kernels are held against on the card) against
the JAX package's Pallas kernels in interpret mode, on the same seeded
numpy inputs.

The WTA is integer code with an IEEE float tail: every comparison there is
bitwise. The correlation sums C products in another order: 1e-5. The same
cases run kernel against plain version on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.ops import sgm as jsgm
from moving_object_detector_tpu.ops import sgm_pallas2 as jv2
from moving_object_detector_tpu.ops.flow_corr_pallas import correlation_pallas
from moving_object_detector_tpu_torch.config import SGMConfig
from moving_object_detector_tpu_torch.ops import (
    flow_corr_cuda,
    sgm,
    sgm_cuda,
    sgm_v1_cuda,
)

torch.set_num_threads(2)

# name: (h, w, constant pair, subpixel, lr_check, uniqueness_ratio)
WTA_CASES = {
    "constant_ties_over_d": (6, 37, True, True, True, 0.0),
    "width_37_below_d": (6, 37, False, True, True, 0.0),
    "width_350": (5, 350, False, True, True, 0.0),
    "width_351_not_multiple_of_4": (5, 351, False, True, True, 0.0),
    "lr_check_off": (6, 150, False, True, False, 0.0),
    "subpixel_off": (6, 150, False, False, True, 0.0),
    "uniqueness_0.95": (6, 150, False, True, True, 0.95),
}


def wta_pair(h, w, constant, seed=0):
    """A (left, right) f32 pair: the right one shifted by 7 px with a
    little noise, or both constant (every candidate ties)."""
    if constant:
        flat = np.full((h, w), 0.5, np.float32)
        return flat, flat.copy()
    rng = np.random.default_rng(seed + w)
    left = rng.uniform(0, 1, (h, w)).astype(np.float32)
    right = np.roll(left, -7, axis=1) + rng.normal(0, 0.02, (h, w))
    return left, right.astype(np.float32)


@pytest.mark.parametrize("case", sorted(WTA_CASES))
def test_wta_edge_cases_bitwise_equal_pallas_interpret(case):
    h, w, constant, subpixel, lr_check, uniq = WTA_CASES[case]
    left, right = wta_pair(h, w, constant)
    jcl = jsgm.census_transform(jnp.asarray(left))
    jcr = jsgm.census_transform(jnp.asarray(right))
    ref = np.asarray(jv2.sgm_disparity_v2(
        jcl, jcr, p1=10, p2=120, subpixel=subpixel, lr_check=lr_check,
        lr_max_diff=1.0, interpret=True, uniqueness_ratio=uniq))
    cl = torch.from_numpy(np.array(jcl))
    cr = torch.from_numpy(np.array(jcr))
    vf, vb = sgm_cuda.vertical_deltas(cl, cr, 10, 120)
    hf, hb = sgm_cuda.horizontal_deltas(cl, cr, 10, 120)
    out = sgm_cuda.wta(hf, hb, vf, vb, cl, cr, subpixel=subpixel,
                       lr_check=lr_check, lr_max_diff=1.0,
                       uniqueness_ratio=uniq).numpy()
    assert out.shape == (h, w) and out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    if constant:  # lowest d wins every tie: disparity 0 everywhere
        assert (out == 0).all()
    elif uniq == 0:
        assert (out >= 0).mean() > 0.3
    if not subpixel:
        assert (out == np.round(out)).all()


def test_wta_width_limit_fits_the_shared_memory_of_a_block():
    """The widest row the WTA stages in shared memory (wider rows take its
    global-memory variant, on the card) needs less than the 227 KB a
    block can have, and the limit lies well above a full KITTI row. The
    kernel keeps two padded lines (4 pad words every 16) and two plain
    ones, a word a pixel each."""
    w = sgm_cuda.WTA_SMEM_WIDTH
    padded = (w - 1) + ((w - 1) // 16) * 4 + 1
    assert (2 * padded + 2 * w) * 4 <= 232448
    assert w >= 4 * 1242


# (b, c, h, w): few and many channels, H or W below one tile of the
# kernel (4 pixels) or of the Pallas kernel (8 rows, 128 lanes), B = 2.
CORR_CASES = [(2, 7, 5, 3, 1), (2, 7, 5, 3, 4), (1, 7, 2, 21, 2),
              (1, 7, 2, 21, 3), (1, 196, 3, 10, 4), (2, 196, 3, 10, 2)]


@pytest.mark.parametrize("b,c,h,w,r", CORR_CASES)
def test_correlation_edge_cases_match_pallas_interpret(b, c, h, w, r):
    rng = np.random.default_rng(c * h + w + r)
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ref = np.asarray(correlation_pallas(jnp.asarray(f1), jnp.asarray(f2), r,
                                        True))
    out = flow_corr_cuda.correlation(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(f1, -1, 1))),
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(f2, -1, 1))), r)
    assert tuple(out.shape) == (b, (2 * r + 1) ** 2, h, w)
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref, rtol=0,
                               atol=1e-5)
    assert np.abs(ref).max() > 0.1


@pytest.mark.parametrize("backend", ["pallas", "pallas_v1"])
def test_kernel_backends_take_their_census_from_the_census_wrapper(
        monkeypatch, backend):
    """Both kernel branches of ``sgm_disparity_raw`` call
    ``sgm_v1_cuda.census_pair`` once a pair (one launch for both views)
    and the plain transform only through it; the CPU result stays bitwise
    what the plain form gives."""
    left, right = (torch.from_numpy(x) for x in wta_pair(12, 140, False, 3))
    plain = sgm.sgm_disparity_raw(left, right, SGMConfig(backend="xla"))
    calls, direct = [], []
    census_pair = sgm_v1_cuda.census_pair
    transform = sgm.census_transform

    def counted_census_pair(left, right, window=(5, 5)):
        calls.append(1)
        direct.append(-2)  # the transform calls below are the wrapper's own
        return census_pair(left, right, window)

    def counted_transform(img, window=(5, 5)):
        direct.append(1)
        return transform(img, window)

    monkeypatch.setattr(sgm_v1_cuda, "census_pair", counted_census_pair)
    monkeypatch.setattr(sgm, "census_transform", counted_transform)
    out = sgm.sgm_disparity_raw(left, right, SGMConfig(backend=backend))
    assert len(calls) == 1
    assert sum(direct) == 0  # no call of the transform but the wrapper's
    assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
    assert float((out >= 0).float().mean()) > 0.3
