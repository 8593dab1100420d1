"""Edge cases the redesigned v1 SGM cost and WTA kernels must honour, on
the CPU: the port's plain versions (what their wrappers run for CPU
tensors, and what the CUDA kernels are held against on the card) against
the JAX package's Pallas kernels in interpret mode, on the same seeded
numpy inputs.

The cost kernel takes a segment of COST_TX pixels of a row a block, its
census words staged once, a lane a pixel; so its cases are widths 1,
below D, around a segment and over several, a height of 1, and census
words whose 32 bits all differ (a real popcount of 32 beside the 32 of
x < d). The WTA kernel takes four pixels a warp, eight lanes a pixel,
with the right view in a padded shared row; so its cases are ties over d
and in the right view, minima at d = 0, 1, 126, 127, an offset of exactly
+0.5 (x - disp at .5), x < best, negative totals and the int16 extremes,
for all four (subpixel, lr_check) pairs with lr_max_diff 0 and 1. The
sizes come from the wrapper module (tests/dp_cc_cases.py), so that they
follow the kernels. Integer code with an IEEE float tail: every
comparison is exact. The same cases run kernel against plain version on
the card in tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.config import SGMConfig as JSGMConfig
from moving_object_detector_tpu.ops import sgm as jsgm
from moving_object_detector_tpu.ops.sgm_pallas import (
    census_cost_volume_pallas,
    wta_disparity_pallas,
)
from moving_object_detector_tpu_torch.ops import sgm_cuda, sgm_v1_cuda
from dp_cc_cases import (
    COST_CASES,
    WTA_V1_CASES,
    WTA_V1_FLAGS,
    cost_pair,
    wta_total,
)

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "moving_object_detector_tpu_torch", "csrc")


def _int(name: str) -> int:
    with open(os.path.join(CSRC, "sgm_v1.cu")) as f:
        text = f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wrapper_constants_are_the_kernels():
    """The cost kernel's segment and block and the shared-memory limit the
    cases are sized from are the ones the kernels are built with."""
    assert sgm_v1_cuda.COST_TX == _int("kCostTX")
    assert sgm_v1_cuda.COST_THREADS == _int("kCostThreads")
    assert sgm_cuda.SMEM_PER_BLOCK == _int("kSmemPerBlock")


def test_wta_width_limit_follows_the_padded_layout():
    """A staged WTA block keeps the right view's row padded by ``sw`` (4
    words every 16) and the disparity: the widest staged row fits the 227
    KB a block can have, one pixel more does not, and a full KITTI row
    lies well below."""
    w = sgm_v1_cuda.WTA_SMEM_WIDTH
    lim = sgm_cuda.SMEM_PER_BLOCK
    assert sgm_v1_cuda.wta_smem_bytes(w) <= lim
    assert sgm_v1_cuda.wta_smem_bytes(w + 1) > lim
    assert sgm_v1_cuda.wta_smem_bytes(w) == 4 * (sgm_v1_cuda.sw(w - 1) + 1
                                                 + w)
    assert w >= 16 * 1242


@pytest.mark.parametrize("base", range(0, 48, 5))
def test_padded_lines_put_a_warps_accesses_in_32_banks(base):
    """Lane (p, l) = (lane >> 3, lane & 7) of a WTA warp pushes candidate
    16 l + i of its pixel a + p to right pixel a + p - 16 l - i, one i at
    a time (a = the first of the warp's four pixels). ``sw`` puts the 32
    cells of the padded row in 32 banks for every a and i."""
    for i in range(16):
        words = [sgm_v1_cuda.sw(base + 200 + (lane >> 3) - 16 * (lane & 7)
                                - i) for lane in range(32)]
        assert len({w % 32 for w in words}) == 32


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_edge_cases_equal_pallas_interpret(case):
    """``cost_volume`` of the census pair (on CPU tensors the plain
    versions) against the Pallas census + cost kernels, whose (D, HP, WP)
    bf16 output is cut to (h, w) and transposed: exactly."""
    h, w, window, kind = COST_CASES[case]
    left, right = cost_pair(case)
    cl, cr = sgm_v1_cuda.census_pair(torch.from_numpy(left),
                                     torch.from_numpy(right), window)
    cost = sgm_v1_cuda.cost_volume(cl, cr).numpy()
    ref = np.asarray(census_cost_volume_pallas(
        jnp.asarray(left), jnp.asarray(right), window=window,
        interpret=True))
    ref = np.transpose(ref[:, :h, :w].astype(np.float32), (1, 2, 0))
    assert cost.dtype == np.int8 and cost.shape == (h, w, 128)
    np.testing.assert_array_equal(cost.astype(np.float32), ref)
    x_below_d = np.arange(w)[:, None] < np.arange(128)[None, :]
    assert (cost[:, x_below_d] == 32).all()
    if kind == "complement":  # both windows inside: x - 5 >= 16, x < w - 16
        assert (cost[:, 21:w - 16, 5] == 32).all()


def test_cost_of_complementary_words_equals_the_jax_volume():
    """Census words whose 32 bits all differ at d = 3, given as words (not
    images), against the JAX package's XLA cost volume: a popcount of 32
    where x >= d beside the 32 of x < d."""
    rng = np.random.default_rng(8)
    h, w = 5, sgm_v1_cuda.COST_TX + 9
    cl = rng.integers(-2 ** 31, 2 ** 31, (h, w), dtype=np.int64).astype(
        np.int32)
    cr = ~np.roll(cl, -3, axis=1)
    cost = sgm_v1_cuda.cost_volume(torch.from_numpy(cl),
                                   torch.from_numpy(cr)).numpy()
    ref = np.asarray(jsgm.hamming_cost_volume(jnp.asarray(cl),
                                              jnp.asarray(cr), 128))
    np.testing.assert_array_equal(cost.astype(np.float32), ref)
    assert (cost[:, 3:w - 3, 3] == 32).all()


@pytest.mark.parametrize("subpixel,lr_check,lr_max_diff", WTA_V1_FLAGS)
@pytest.mark.parametrize("case", sorted(WTA_V1_CASES))
def test_wta_edge_cases_bitwise_equal_pallas_interpret(case, subpixel,
                                                       lr_check,
                                                       lr_max_diff):
    """``wta`` (on CPU tensors the plain version) against the Pallas
    ``_wta_kernel``, bits of the f32 disparity compared."""
    tot = wta_total(case)
    out = sgm_v1_cuda.wta(torch.from_numpy(tot), subpixel, lr_check,
                          lr_max_diff).numpy()
    ref = np.asarray(wta_disparity_pallas(
        jnp.asarray(tot), subpixel=subpixel, lr_check=lr_check,
        lr_max_diff=lr_max_diff, interpret=True))
    assert out.shape == tot.shape[:2] and out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    if case == "right_flat" and subpixel and not lr_check:
        valid = out >= 0
        assert valid.mean() > 0.2
        assert (out[valid] % 1 == 0.5).all()


@pytest.mark.parametrize("case", sorted(WTA_V1_CASES))
def test_wta_edge_cases_bitwise_equal_the_jax_paths(case):
    """The same cases against the JAX package's XLA WTA (``wta_disparity``),
    which pads the right view with the int16 maximum: exact at every
    width, the int16 extremes included. (The Pallas kernel pads its
    columns to a multiple of 128 with a total of 20000, which wins a right
    pixel's minimum where every candidate in the image is larger: with
    these extremes at a width of 150 it differs from both in one pixel.)"""
    tot = wta_total(case)
    if case == "int16_extremes":  # also at a width the Pallas pad reaches
        tot = np.concatenate([tot, tot[:, :22]], axis=1)
    for subpixel, lr_check in ((True, True), (False, False)):
        out = sgm_v1_cuda.wta(torch.from_numpy(tot), subpixel, lr_check,
                              1.0).numpy()
        ref = np.asarray(jsgm.wta_disparity(
            jnp.asarray(tot), JSGMConfig(subpixel=subpixel,
                                         lr_check=lr_check)))
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
