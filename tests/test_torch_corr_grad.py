"""The correlation's backward: the port's plain ``correlation_backward``
(the oracle of the CUDA kernel ``corr_backward``) against
``torch.autograd`` through the plain correlation and against the JAX
package's VJPs of both its forms, the XLA ``flow_ops.correlation`` and
``correlation_pallas`` in interpret mode; ``gradcheck`` in f64; the
autograd Function's CPU routing and its refusals; the warp's gradient at
its clip bounds, where JAX's tie rule applies; and the kernel's launch
plan (``flow_corr_cuda.backward_plan``, the mirror of ``plan`` in
``csrc/corr_bwd.cu``): its constants are the source's, and at the four
training levels it fills the card and fits its shared memory.

Tolerance of the comparisons in f32: 1e-5 relative to the gradients'
scale (``corr_grad_cases.grad_error``): the sums of (2r+1)^2 products per
element are taken in other orders by XLA and by PyTorch.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.ops import flow_ops as jflow
from moving_object_detector_tpu.ops.flow_corr_pallas import (
    correlation_pallas,
)
from moving_object_detector_tpu_torch.ops import flow_corr_cuda, flow_ops

from corr_grad_cases import (
    ODD_CASES,
    PLAN_CASES,
    TRAIN_LEVELS,
    grad_case,
    grad_error,
)

TOL = 1e-5


def _nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def _jax_vjp(fn, f1, f2, g):
    """JAX's gradients of ``fn`` at (f1, f2) for the cotangent g, NCHW in
    and out; one compiled program (eager dispatch of the 81 slices of
    r = 4 takes seconds)."""
    grads = jax.jit(lambda a, b, c: jax.vjp(fn, a, b)[1](c))(
        *(jnp.asarray(_nhwc(x)) for x in (f1, f2, g)))
    return [_nchw(x) for x in grads]


@pytest.mark.parametrize("b,c,h,w,r", ODD_CASES + PLAN_CASES)
def test_plain_backward_matches_autograd_and_the_jax_vjp(b, c, h, w, r):
    f1, f2, g = grad_case(b, c, h, w, r)
    out = flow_ops.correlation_backward(*map(torch.from_numpy, (f1, f2, g)),
                                        r)
    a1, a2 = (torch.from_numpy(x).requires_grad_() for x in (f1, f2))
    flow_ops.correlation(a1, a2, r).backward(torch.from_numpy(g))
    assert grad_error(out, [a1.grad, a2.grad]) <= TOL
    ref = _jax_vjp(lambda x, y: jflow.correlation(x, y, r), f1, f2, g)
    assert grad_error(out, ref) <= TOL


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_plain_backward_matches_the_pallas_vjp(r):
    """``correlation_pallas`` is a ``custom_vjp``: its backward
    differentiates the XLA form. Held at one odd shape per r."""
    f1, f2, g = grad_case(2, 7, 9, 11, r)
    out = flow_ops.correlation_backward(*map(torch.from_numpy, (f1, f2, g)),
                                        r)
    ref = _jax_vjp(lambda x, y: correlation_pallas(x, y, r, True), f1, f2, g)
    assert grad_error(out, ref) <= TOL


@pytest.mark.parametrize("b,c,h,w,r", [(1, 2, 4, 5, 1), (2, 3, 3, 6, 2),
                                       (1, 1, 1, 1, 3)])
def test_function_passes_gradcheck_in_f64(b, c, h, w, r):
    f1, f2 = (torch.from_numpy(x).double().requires_grad_()
              for x in grad_case(b, c, h, w, r)[:2])
    assert torch.autograd.gradcheck(
        lambda x, y: flow_corr_cuda.correlation(x, y, r), (f1, f2))


def test_function_routes_cpu_tensors_to_the_plain_versions():
    """On CPU tensors both directions are the plain forms, bit for bit,
    and no kernel is counted."""
    f1, f2, g = map(torch.from_numpy, grad_case(2, 7, 9, 11, 3))
    before = dict(flow_corr_cuda.LAUNCHES)
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    out = flow_corr_cuda.correlation(a1, a2, 3)
    out.backward(g)
    assert torch.equal(out, flow_ops.correlation(f1, f2, 3))
    ref = flow_ops.correlation_backward(f1, f2, g, 3)
    assert torch.equal(a1.grad, ref[0]) and torch.equal(a2.grad, ref[1])
    assert all(torch.equal(x, y) for x, y in zip(
        flow_corr_cuda.corr_backward(f1, f2, g, 3), ref))
    assert flow_corr_cuda.LAUNCHES == before


@pytest.mark.parametrize("make,error,match", [
    (lambda m: (m.double(), m.double(), 3), TypeError, "f32"),
    (lambda m: (m, m, 5), ValueError, "search_range"),
    (lambda m: (m, m[:, :, :4], 3), ValueError, "must be equal"),
    (lambda m: (m, m, 3), ValueError, "CUDA"),
], ids=["f64", "r5", "shapes", "not_cuda"])
def test_function_refuses_what_the_kernels_do_not_take(make, error, match):
    """Every tensor that is not on the CPU goes to the kernels, whose
    refusals are checked before the device: meta tensors reach them here
    without a card. Neither direction falls back to a plain form."""
    meta = torch.empty((2, 7, 9, 11), device="meta")
    f1, f2, r = make(meta)
    with pytest.raises(error, match=match):
        flow_corr_cuda.correlation(f1, f2, r)
    g = torch.empty((2, (2 * r + 1) ** 2, 9, 11), device="meta",
                    dtype=f1.dtype)
    with pytest.raises(error, match=match):
        flow_corr_cuda.corr_backward(f1, f2, g, r)
    g3 = torch.empty((2, 49, 9, 11), device="meta")
    with pytest.raises(ValueError, match="gradient shape"):
        flow_corr_cuda.corr_backward(meta, meta, g3[:, :9], 3)


@pytest.mark.parametrize("bound", ["zero_flow", "last_column"])
def test_warp_gradient_at_the_clip_bounds_equals_jax(bound):
    """``jnp.clip`` splits its gradient at a bound (a max, then a min);
    the port's warp keeps that rule, so under zero flow (column 0 and row
    0 sit on the bound) and at a flow reaching the last column the
    gradients with respect to features and flow equal JAX's."""
    rng = np.random.default_rng(3)
    h, w = 5, 7
    feat = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    flow = np.zeros((1, h, w, 2), np.float32)
    if bound == "last_column":
        flow[..., 0] = (w - 1) - np.arange(w, dtype=np.float32)
        flow[..., 1] = 0.25
    cot = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    _, vjp = jax.vjp(jflow.warp, jnp.asarray(feat), jnp.asarray(flow))
    jf, jfl = vjp(jnp.asarray(cot))
    tf = torch.from_numpy(_nchw(feat).copy()).requires_grad_()
    tfl = torch.from_numpy(_nchw(flow).copy()).requires_grad_()
    flow_ops.warp(tf, tfl).backward(torch.from_numpy(_nchw(cot).copy()))
    np.testing.assert_allclose(tf.grad.numpy(), _nchw(jf), atol=1e-6)
    np.testing.assert_allclose(tfl.grad.numpy(), _nchw(jfl), atol=1e-6)
    if bound == "zero_flow":  # a half-gradient on the bound, as in JAX
        assert np.abs(_nchw(jfl)[0, 0, :, 0]).max() > 0


CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "moving_object_detector_tpu_torch", "csrc")
SMEM_PER_BLOCK = 232448  # bytes a block can have on an H100 (227 KB)
SMEM_PER_SM = 233472  # bytes of shared memory an SM can hold (228 KB)
SMS = 132


def test_backward_plan_constants_are_the_kernels():
    with open(os.path.join(CSRC, "corr_bwd.cu")) as f:
        text = f.read()
    for name, value in (
            ("kP", flow_corr_cuda.BWD_PIXELS),
            ("kCh", flow_corr_cuda.BWD_CHANNELS),
            ("kHalo", flow_corr_cuda.BWD_HALO),
            ("kStages", flow_corr_cuda.BWD_STAGES),
            ("kMaxTX", flow_corr_cuda.BWD_MAX_TX),
            ("kRows", flow_corr_cuda.BWD_ROWS),
            ("kMaxTY", flow_corr_cuda.BWD_MAX_TY),
            ("kShortH", flow_corr_cuda.BWD_SHORT_H),
            ("kMaxSlots", flow_corr_cuda.BWD_MAX_SLOTS),
            ("kMaxThreads", flow_corr_cuda.BWD_MAX_THREADS),
            ("kMinBlocks", flow_corr_cuda.BWD_MIN_BLOCKS),
            ("kTargetBlocks", flow_corr_cuda.BWD_TARGET_BLOCKS),
            ("kSmemTarget", flow_corr_cuda.BWD_SMEM_TARGET)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert found and int(found.group(1)) == value, name


@pytest.mark.parametrize("level", TRAIN_LEVELS)
def test_backward_plan_fills_the_card_at_the_training_levels(level):
    """At least 100 blocks, all of them on the card at once (two or more
    blocks an SM by shared memory), every thread a job, every pixel, row
    and channel covered once, and at most four rounds a block."""
    b, c, h, w = level
    p = flow_corr_cuda.backward_plan(b, c, h, w, 4, w % 4 == 0)
    assert p["blocks"] >= 100
    assert 2 * (p["smem"] + 1024) <= SMEM_PER_SM  # 1 KB kept a block
    assert p["threads"] <= flow_corr_cuda.BWD_MAX_THREADS
    assert p["threads"] >= max(p["tx"], (p["tx"] + 8) // (4 if w % 4 == 0
                                                          else 1))
    assert p["tiles"] * p["tx"] >= w > (p["tiles"] - 1) * p["tx"]
    assert p["groups"] * p["ty"] >= h > (p["groups"] - 1) * p["ty"]
    cc = flow_corr_cuda.BWD_CHANNELS * p["slots"]
    assert p["chunks"] * p["rounds"] * cc >= c > (
        (p["chunks"] - 1) * p["rounds"] * cc)
    per_sm = min(SMEM_PER_SM // (p["smem"] + 1024), 2048 // p["threads"])
    assert per_sm >= 2 and p["blocks"] <= SMS * per_sm
    assert p["rounds"] <= 4


@pytest.mark.parametrize("b,c,h,w,r", ODD_CASES + PLAN_CASES
                         + [(2, 64, 125, 350, 3)])
@pytest.mark.parametrize("vec", [True, False])
def test_backward_plan_launches_what_the_card_takes(b, c, h, w, r, vec):
    """Any shape: a block of 1 to 1024 threads, enough of them for the
    copies, in the 227 KB a block can have; a channel's window padded so
    that the slots of a quarter warp read 8 banks apart."""
    p = flow_corr_cuda.backward_plan(b, c, h, w, r, vec)
    assert 1 <= p["threads"] <= 1024
    assert p["threads"] >= max(p["tx"], (p["tx"] + 8) // (4 if vec else 1))
    assert p["smem"] <= SMEM_PER_BLOCK
    words = p["chs"] // 4
    assert p["chs"] % 4 == 0 and words * 4 >= (p["ty"] + 2 * r) * (
        p["tx"] + 8)
    if p["slots"] >= 8:
        assert words % 2 == 1
    else:
        assert words % 8 == 8 // p["slots"] % 8
