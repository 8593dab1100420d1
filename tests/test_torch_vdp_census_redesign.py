"""Edge cases the redesigned vertical SGM DP and census kernels, and the
wide-row variants of the SGM kernels, must honour, on the CPU: the port's
plain versions (what their wrappers run for CPU tensors, and what the CUDA
kernels are held against on the card) against the JAX package, on the same
seeded numpy inputs.

The vertical DP stages row blocks of a strip of columns sized to the
card, so its cases are heights at and around the row block and widths
below D and with a partial last strip; the census kernel stages tiles
with the window's halo as +inf, so its cases are images smaller than the
halo, partial tiles, ties, non-finite pixels and other windows. The sizes come from the
wrapper modules (tests/dp_cc_cases.py), so that they follow the kernels.
Everything here is integer or selection code: every comparison is exact.
The same cases run kernel against plain version on the card in
tests/test_torch_kernels_gpu.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.ops import sgm as jsgm
from moving_object_detector_tpu.ops import sgm_pallas2 as jv2
from moving_object_detector_tpu_torch.config import SGMConfig
from moving_object_detector_tpu_torch.ops import sgm, sgm_cuda, sgm_v1_cuda
from dp_cc_cases import CENSUS_CASES, H100_SMS, VDP_CASES, census_pair

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "moving_object_detector_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _int(source: str, pattern: str) -> int:
    return int(re.search(pattern, _source(source)).group(1))


def test_wrapper_constants_are_the_kernels():
    """The strip, row block, census tile and shared-memory limit the tests
    are sized from are the ones the kernels are built with."""
    assert sgm_cuda.V_ROWS == _int("sgm_v2.cu",
                                   r"constexpr int kVRows = (\d+);")
    assert sgm_cuda.V_MAX_STRIP == _int(
        "sgm_v2.cu", r"constexpr int kVMaxStrip = (\d+);")
    assert sgm_cuda.SMEM_PER_BLOCK == _int(
        "sgm_v2.cu", r"constexpr int kSmemPerBlock = (\d+);")
    assert sgm_v1_cuda.CENSUS_TILE_H == _int(
        "sgm_v1.cu", r"constexpr int kCensusTileH = (\d+);")
    assert sgm_v1_cuda.CENSUS_TILE_W == _int(
        "sgm_v1.cu", r"constexpr int kCensusTileW = (\d+);")


def test_vertical_strip_fills_the_card_once():
    """The strip is the fewest columns a block for which the 2 ceil(W /
    strip) blocks fit the SMs at once, up to V_MAX_STRIP; the edge cases'
    last strips are partial on an H100."""
    for w in (1, 37, 133, 621, 1000, 1242, 4500):
        strip = sgm_cuda.v_strip(w, H100_SMS)
        blocks = 2 * -(-w // strip)
        if strip < sgm_cuda.V_MAX_STRIP:
            assert blocks <= H100_SMS
        if strip > 1:
            assert 2 * -(-w // (strip - 1)) > H100_SMS
    assert sgm_cuda.v_strip(621, H100_SMS) == 10  # the serving point
    assert sgm_cuda.v_strip(4500, H100_SMS) == sgm_cuda.V_MAX_STRIP
    assert all(w % sgm_cuda.v_strip(w, H100_SMS)
               for _, w, _, _ in VDP_CASES if w > 128)


def test_wide_row_limits_fit_the_shared_memory_of_a_block():
    """Up to WTA_SMEM_WIDTH the WTAs stage a row in shared memory, beyond
    it they take their global-memory variant (on the card:
    test_torch_kernels_gpu.py). The v1 WTA holds its right view's row,
    padded by 4 words every 16, and the disparity."""
    lim, w = sgm_cuda.SMEM_PER_BLOCK, sgm_cuda.WTA_SMEM_WIDTH
    assert sgm_cuda.wta_smem_bytes(w) <= lim < sgm_cuda.wta_smem_bytes(w + 1)
    assert w > 8192  # the old ceiling, now staged
    w1 = sgm_v1_cuda.WTA_SMEM_WIDTH
    assert (sgm_v1_cuda.wta_smem_bytes(w1) <= lim
            < sgm_v1_cuda.wta_smem_bytes(w1 + 1))
    assert w1 > 19000


_NEGATIVE_P1 = {
    "config": lambda cl: SGMConfig(p1=-1),
    "plain vertical": lambda cl: sgm.vertical_deltas(cl, cl, -1, 120),
    "plain horizontal": lambda cl: sgm.horizontal_deltas(cl, cl, -1, 120),
    "vertical wrapper": lambda cl: sgm_cuda.vertical_deltas(cl, cl, -1, 120),
}


@pytest.mark.parametrize("where", sorted(_NEGATIVE_P1))
def test_every_sgm_path_refuses_a_negative_p1(where):
    """The vertical DP kernel's 16-bit recurrence needs costs >= 0, so
    P1 < 0 is refused on every backend alike: by the config and by the
    plain DP functions the wrappers run on the CPU and check on the card."""
    cl = torch.zeros((4, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="P1=-1"):
        _NEGATIVE_P1[where](cl)


def _jax_census(left, right):
    return (jsgm.census_transform(jnp.asarray(left)),
            jsgm.census_transform(jnp.asarray(right)))


def _vertical_pair(h, w, seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 1, (h, w)).astype(np.float32)
    right = (np.roll(left, -7, axis=1)
             + rng.normal(0, 0.02, (h, w))).astype(np.float32)
    return _jax_census(left, right)


@pytest.mark.parametrize("h,w,p1,p2", VDP_CASES)
def test_vertical_deltas_equal_jax_paths(h, w, p1, p2):
    """Each direction's deltas are the JAX package's path cost L minus the
    matching cost C (its XLA ``aggregate_path`` down the columns),
    exactly."""
    jcl, jcr = _vertical_pair(h, w, seed=h * w + p1)
    cost = jsgm.hamming_cost_volume(jcl, jcr, 128)
    vf, vb = sgm_cuda.vertical_deltas(
        torch.from_numpy(np.array(jcl)), torch.from_numpy(np.array(jcr)),
        p1, p2)
    for out, reverse in ((vf, False), (vb, True)):
        ref = np.asarray(jsgm.aggregate_path(cost, 0, reverse, p1, p2)
                         - cost)
        assert out.dtype == torch.int8 and tuple(out.shape) == (h, w, 128)
        np.testing.assert_array_equal(out.numpy().astype(np.float32), ref)
        assert int(out.min()) >= 0 and int(out.max()) <= p2
    if h == 1 or p1 == p2 == 0:  # a lone row starts from a zero carry
        assert not vf.any() and not vb.any()
    else:
        assert vf.any() and vb.any()


@pytest.mark.parametrize("h,w,p1,p2", [VDP_CASES[1], VDP_CASES[3]])
def test_vertical_deltas_equal_pallas_interpret(h, w, p1, p2):
    """The Pallas kernel itself (``_v_kernel``), on the census padded as
    it requires (rows to its block of 8, columns to 128): bitwise."""
    jcl, jcr = _vertical_pair(h, w, seed=w)
    cl, cr = jv2._pad_to(jcl, 8, 128), jv2._pad_to(jcr, 8, 128)
    jf, jb = jv2.vertical_deltas(cl, cr, p1, p2, h, True)
    vf, vb = sgm_cuda.vertical_deltas(
        torch.from_numpy(np.array(jcl)), torch.from_numpy(np.array(jcr)),
        p1, p2)
    for out, ref in ((vf, jf), (vb, jb)):
        ref = np.asarray(ref).transpose(0, 2, 1)[:h, :w]
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("case", sorted(CENSUS_CASES))
def test_census_equals_jax(case):
    """``census_pair`` (on CPU tensors the plain transform) against the
    JAX package's census transform, both views, bit for bit."""
    _, _, window, kind = CENSUS_CASES[case]
    left, right = census_pair(case)
    cl, cr = sgm_v1_cuda.census_pair(torch.from_numpy(left),
                                     torch.from_numpy(right), window)
    for out, img in ((cl, left), (cr, right)):
        ref = np.asarray(jsgm.census_transform(jnp.asarray(img), window))
        assert out.dtype == torch.int32 and out.shape == img.shape
        np.testing.assert_array_equal(out.numpy(), ref)
        assert torch.equal(out, sgm_v1_cuda.census(torch.from_numpy(img),
                                                   window))
    if kind == "constant":  # ties: nothing is darker than the centre
        assert not cl.any() and not cr.any()
    if kind == "nonfinite":  # a NaN or -inf centre has no darker neighbour
        for out, img in ((cl, left), (cr, right)):
            blank = np.isnan(img) | (img == -np.inf)
            assert blank.any() and not out.numpy()[blank].any()


def test_census_pair_refuses_views_on_two_devices():
    img = torch.zeros((4, 6))
    with pytest.raises(ValueError):
        sgm_v1_cuda.census_pair(img, img.to("meta"))
