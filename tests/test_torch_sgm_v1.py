"""The port's v1 SGM path (stored-volume census / cost / aggregation / WTA)
against the JAX package's v1 Pallas kernels in interpret mode.

Inputs come from numpy seeds and go through both packages. On CPU tensors
the port's wrappers (``ops/sgm_v1_cuda.py``) run their plain versions, which
are what the CUDA kernels are held against on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``). Integer stages
must agree exactly; the disparity is compared bitwise.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import config as jcfg
from moving_object_detector_tpu.ops import sgm as jsgm
from moving_object_detector_tpu.ops.sgm_pallas import (
    aggregate_cost_volume_pallas,
    census_cost_volume_pallas,
    wta_disparity_pallas,
)
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch import ops as tops
from moving_object_detector_tpu_torch.ops import sgm, sgm_v1_cuda

torch.set_num_threads(2)
D = 128


def _smooth_pair(seed, h, w, shift=5):
    """A textured pair with a constant disparity, smooth enough that no two
    census neighbours tie."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.1, 0.9, (h, w + shift)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    img = img.astype(np.float32)
    return img[:, :w].copy(), img[:, shift:].copy()


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_census_and_cost_equal_the_pallas_kernels():
    h, w = 16, 96
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 1, (h, w)).astype(np.float32)
    right = rng.uniform(0, 1, (h, w)).astype(np.float32)
    vol = census_cost_volume_pallas(jnp.asarray(left), jnp.asarray(right), D,
                                    (5, 5), interpret=True)
    ref = np.asarray(vol.astype(jnp.float32))[:, :h, :w].transpose(1, 2, 0)
    cl = sgm_v1_cuda.census(torch.from_numpy(left))
    cr = sgm_v1_cuda.census(torch.from_numpy(right))
    np.testing.assert_array_equal(
        cl.numpy(), np.asarray(jsgm.census_transform(jnp.asarray(left))))
    cost = sgm_v1_cuda.cost_volume(cl, cr)
    assert cost.dtype == torch.int8 and tuple(cost.shape) == (h, w, D)
    np.testing.assert_array_equal(cost.numpy().astype(np.float32), ref)


@pytest.mark.parametrize("h,w", [(16, 64), (8, 32), (16, 50)])
def test_aggregate_equals_the_pallas_kernel(h, w):
    rng = np.random.default_rng(h + w)
    cost = rng.integers(0, 25, (h, w, D)).astype(np.int8)
    ref = np.asarray(aggregate_cost_volume_pallas(
        jnp.asarray(cost.astype(np.float32)), p1=10, p2=120, interpret=True))
    out = sgm_v1_cuda.aggregate(torch.from_numpy(cost), 10, 120)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


def test_aggregate_clips_the_cost_on_read_like_the_pallas_kernel():
    h, w = 8, 32
    rng = np.random.default_rng(11)
    cost = rng.integers(-20, 200, (h, w, D)).astype(np.int32)
    ref = np.asarray(aggregate_cost_volume_pallas(
        jnp.asarray(cost.astype(np.float32)), p1=7, p2=90, interpret=True))
    out = sgm.aggregate_cost_volume(torch.from_numpy(cost), 7, 90)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_aggregate_refuses_a_p2_that_overflows_int16():
    cost = torch.zeros((4, 8, D), dtype=torch.int8)
    with pytest.raises(ValueError, match="int16"):
        sgm_v1_cuda.aggregate(cost, 10, 9000)


def _total(seed, h, w):
    left, right = _smooth_pair(seed, h, w)
    cl = sgm.census_transform(torch.from_numpy(left))
    cr = sgm.census_transform(torch.from_numpy(right))
    return sgm.aggregate_cost_volume(sgm.hamming_cost(cl, cr, D), 10, 120)


@pytest.mark.parametrize("h,w", [(16, 64), (16, 50), (8, 200)])
@pytest.mark.parametrize("subpixel,lr_check", [(True, True), (False, True),
                                               (True, False)])
def test_wta_equals_the_pallas_kernel_bitwise(h, w, subpixel, lr_check):
    """Invalid pixels at the same places, every other pixel bit for bit:
    the totals are integers, so both sides do the same float operations on
    the same exact values."""
    total = _total(h * w, h, w)
    ref = np.asarray(wta_disparity_pallas(
        jnp.asarray(total.numpy()), subpixel=subpixel, lr_check=lr_check,
        lr_max_diff=1.0, interpret=True))
    out = sgm_v1_cuda.wta(total, subpixel, lr_check, 1.0).numpy()
    np.testing.assert_array_equal(out == -1.0, ref == -1.0)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert 0 < (out >= 0).sum() < out.size or not lr_check


def test_wta_equals_the_pallas_kernel_on_random_totals():
    rng = np.random.default_rng(9)
    total = rng.integers(0, 600, (8, 70, D)).astype(np.int16)
    ref = np.asarray(wta_disparity_pallas(jnp.asarray(total),
                                          interpret=True))
    out = sgm_v1_cuda.wta(torch.from_numpy(total)).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("h,w", [(16, 96), (12, 70)])
def test_sgm_disparity_v1_matches_the_jax_v1_backend(h, w):
    left, right = _smooth_pair(h, h, w)
    ref = np.asarray(jsgm.sgm_disparity_raw(
        jnp.asarray(left), jnp.asarray(right),
        jcfg.SGMConfig(backend="pallas_v1_interpret")))
    out = sgm.sgm_disparity_raw(
        torch.from_numpy(left), torch.from_numpy(right),
        tcfg.SGMConfig(backend="pallas_v1")).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    valid = out >= 0
    assert valid.mean() > 0.5
    assert abs(np.median(out[valid]) - 5.0) < 0.5


def test_v1_v2_and_plain_backends_agree_bitwise():
    left, right = _smooth_pair(21, 14, 150)
    outs = [sgm.sgm_disparity_raw(torch.from_numpy(left),
                                  torch.from_numpy(right),
                                  tcfg.SGMConfig(backend=b)).numpy()
            for b in ("pallas_v1", "pallas", "xla")]
    np.testing.assert_array_equal(_bits(outs[0]), _bits(outs[1]))
    np.testing.assert_array_equal(_bits(outs[0]), _bits(outs[2]))


@pytest.mark.parametrize("num_paths", [4, 8])
def test_plain_form_matches_the_jax_xla_backend(num_paths):
    left, right = _smooth_pair(31, 14, 60)
    kw = dict(max_disparity=32, num_paths=num_paths, backend="xla")
    ref = np.asarray(jsgm.sgm_disparity_raw(
        jnp.asarray(left), jnp.asarray(right), jcfg.SGMConfig(**kw)))
    out = sgm.sgm_disparity_raw(torch.from_numpy(left),
                                torch.from_numpy(right),
                                tcfg.SGMConfig(**kw)).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_eight_path_total_matches_the_jax_aggregation():
    rng = np.random.default_rng(2)
    cost = rng.integers(0, 33, (9, 21, 16)).astype(np.int32)
    ref = np.asarray(jsgm.aggregate_cost_volume(
        jnp.asarray(cost.astype(np.float32)), jcfg.SGMConfig(num_paths=8)))
    out = sgm.aggregate_cost_volume(torch.from_numpy(cost), 10, 120,
                                    num_paths=8)
    np.testing.assert_array_equal(out.numpy().astype(np.float32), ref)
    one = np.asarray(jsgm.aggregate_diagonal(
        jnp.asarray(cost.astype(np.float32)), 1, True, 10.0, 120.0))
    np.testing.assert_array_equal(
        sgm.aggregate_diagonal(torch.from_numpy(cost), 1, True, 10,
                               120).numpy().astype(np.float32), one)


def test_v1_refuses_the_uniqueness_test():
    img = torch.rand(8, 40)
    with pytest.raises(ValueError, match="uniqueness_ratio"):
        sgm.sgm_disparity_raw(
            img, img, tcfg.SGMConfig(backend="pallas_v1",
                                     uniqueness_ratio=0.95))


@pytest.mark.parametrize("backend", ["pallas", "pallas_v1"])
def test_kernel_backends_refuse_eight_paths(backend):
    img = torch.rand(8, 40)
    with pytest.raises(ValueError, match="4 paths"):
        sgm.sgm_disparity_raw(img, img, tcfg.SGMConfig(backend=backend,
                                                       num_paths=8))


@pytest.mark.parametrize("kw,why", [
    (dict(num_paths=8), "num_paths=8"),
    (dict(max_disparity=32), "max_disparity=32"),
])
def test_auto_warns_and_takes_the_plain_form(monkeypatch, kw, why):
    """Where "auto" would pick the kernels (a CUDA tensor) but the
    configuration is beyond them, it warns and runs the plain form."""
    left, right = _smooth_pair(4, 10, 48)
    args = (torch.from_numpy(left), torch.from_numpy(right))
    plain = sgm.sgm_disparity_raw(*args, tcfg.SGMConfig(backend="xla", **kw))
    monkeypatch.setattr(
        tops, "resolve_backend",
        lambda backend, device: "pallas" if backend == "auto" else backend)
    with pytest.warns(UserWarning, match=why):
        out = sgm.sgm_disparity_raw(*args, tcfg.SGMConfig(**kw))
    assert torch.equal(out, plain)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sgm.sgm_disparity_raw(*args, tcfg.SGMConfig())  # 4 paths, D = 128


@pytest.mark.parametrize("backend", ["pallas_v1_interpret",
                                     "pallas_interpret"])
def test_config_refuses_the_interpret_names(backend):
    with pytest.raises(ValueError, match="unknown SGM backend"):
        tcfg.SGMConfig(backend=backend)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = dict(sgm_v1_cuda.LAUNCHES)
    img = torch.rand(6, 40)
    cl = sgm_v1_cuda.census(img)
    total = sgm_v1_cuda.aggregate(sgm_v1_cuda.cost_volume(cl, cl), 10, 120)
    assert tuple(sgm_v1_cuda.wta(total).shape) == (6, 40)
    assert sgm_v1_cuda.LAUNCHES == before
