"""The PyTorch port's SGM against the JAX package's XLA form.

The port's plain versions of the three SGM kernels (ops/sgm.py) run on
the CPU; the CUDA kernels themselves are checked against them on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py). D = 128, P1 = 10,
P2 = 120.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import config as jcfg
from moving_object_detector_tpu.ops import sgm as jsgm
from moving_object_detector_tpu.pipeline import _sgm_forward as j_sgm_forward
from moving_object_detector_tpu.types import StereoModel as JStereo
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch.ops import sgm as tsgm
from moving_object_detector_tpu_torch.ops import sgm_cuda
from moving_object_detector_tpu_torch.ops.resize import resize_image
from moving_object_detector_tpu_torch.pipeline import (
    _sgm_forward as t_sgm_forward,
)
from moving_object_detector_tpu_torch.types import StereoModel as TStereo

torch.set_num_threads(2)

SHAPES = [(24, 200), (37, 171)]


def _pair(h, w, shift=7, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 1, (h, w)).astype(np.float32)
    right = np.roll(left, -shift, axis=1) + rng.normal(
        0, 0.02, (h, w)).astype(np.float32)
    return left, right.astype(np.float32)


@pytest.mark.parametrize("h,w", SHAPES)
def test_census_bitwise(h, w):
    left, _ = _pair(h, w)
    np.testing.assert_array_equal(
        tsgm.census_transform(torch.from_numpy(left)).numpy(),
        np.asarray(jsgm.census_transform(jnp.asarray(left))))


@pytest.mark.parametrize("h,w", SHAPES)
def test_delta_total_matches_aggregate_exactly(h, w):
    left, right = _pair(h, w, seed=h)
    jcl = jsgm.census_transform(jnp.asarray(left))
    jcr = jsgm.census_transform(jnp.asarray(right))
    cost = jnp.transpose(jsgm.hamming_cost_volume_dhw(jcl, jcr, 128),
                         (1, 2, 0)).astype(jnp.float32)
    ref = np.asarray(jsgm.aggregate_cost_volume(
        cost, jcfg.SGMConfig(p1=10, p2=120)))
    cl = torch.tensor(np.asarray(jcl))
    cr = torch.tensor(np.asarray(jcr))
    vf, vb = sgm_cuda.vertical_deltas(cl, cr, 10, 120)
    hf, hb = sgm_cuda.horizontal_deltas(cl, cr, 10, 120)
    for v in (vf, vb, hf, hb):
        assert v.dtype == torch.int8 and tuple(v.shape) == (h, w, 128)
        assert int(v.min()) >= 0 and int(v.max()) <= 120
    total = tsgm.total_from_deltas(hf, hb, vf, vb, cl, cr)
    np.testing.assert_array_equal(total.numpy().astype(np.float32), ref)


@pytest.mark.parametrize("uniqueness", [0.0, 0.95])
@pytest.mark.parametrize("h,w", SHAPES)
def test_disparity_bitwise(h, w, uniqueness):
    left, right = _pair(h, w, seed=w)
    kw = dict(p1=10, p2=120, subpixel=True, lr_check=True,
              uniqueness_ratio=uniqueness)
    jstereo = JStereo.create(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2,
                             baseline=0.5)
    tstereo = TStereo.create(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2,
                             baseline=0.5, device="cpu")
    ref = jsgm.compute_disparity(jnp.asarray(left), jnp.asarray(right),
                                 jstereo, jcfg.SGMConfig(backend="xla", **kw))
    out = tsgm.compute_disparity(torch.from_numpy(left),
                                 torch.from_numpy(right), tstereo,
                                 tcfg.SGMConfig(backend="pallas", **kw))
    a, b = out.disparity.numpy(), np.asarray(ref.disparity)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(out.valid_mask().numpy(),
                                  np.asarray(ref.valid_mask()))
    assert (b >= 0).mean() > 0.5


def test_resize_matches_jax_image_resize():
    """The antialiased bilinear resize agrees with jax.image.resize to the
    last bits of f32: measured max |diff| 1.8e-7 (summation order)."""
    import jax

    rng = np.random.default_rng(4)
    for (h, w), size in [((376, 1242), (188, 621)), ((37, 171), (18, 85)),
                         ((25, 33), (50, 66)), ((11, 7), (44, 29))]:
        x = rng.uniform(0, 1, (h, w)).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), size, "bilinear"))
        out = resize_image(torch.from_numpy(x), size).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_sgm_forward_scale2():
    """_sgm_forward at scale 2 (antialiased half-res SGM, nearest upsample,
    valid-weighted smoothing): -1 pixels exact, |diff| <= 1e-5 elsewhere.
    The smooth random input keeps census comparisons away from the 1-ulp
    resize differences."""
    h, w = 64, 300
    left, right = _pair(h, w, shift=12, seed=9)
    jc = jcfg.PipelineConfig(height=h, width=w, sgm_input_scale=2,
                             sgm=jcfg.SGMConfig(backend="xla"))
    tc = tcfg.PipelineConfig(height=h, width=w, sgm_input_scale=2)
    jstereo = JStereo.create(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2,
                             baseline=0.5)
    tstereo = TStereo.create(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2,
                             baseline=0.5, device="cpu")
    ref = j_sgm_forward(jnp.asarray(left), jnp.asarray(right), jstereo, jc)
    out = t_sgm_forward(torch.from_numpy(left), torch.from_numpy(right),
                        tstereo, tc)
    a, b = out.disparity.numpy(), np.asarray(ref.disparity)
    np.testing.assert_array_equal(a < 0, b < 0)
    np.testing.assert_array_equal(a[a < 0], b[b < 0])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert float(out.max_disparity) == float(ref.max_disparity)
    assert (b >= 0).mean() > 0.5
