"""Edge cases the redesigned horizontal SGM DP and connected-components
kernels must honour, on the CPU: the port's plain versions (what their
wrappers run for CPU tensors, and what the CUDA kernels are held against
on the card) against the JAX package, on the same seeded numpy inputs.

The CC kernel unites the edges inside a TILE_H x TILE_W tile in shared
memory and the rest across tile borders, so the cases put edges exactly on
those borders; the sizes come from ``clustering_cuda`` so that they follow
the kernel. The horizontal DP stages one census row in shared memory with a
pad word every 32 pixels and slides a 4-pixel window a lane, so its cases
are widths below D, widths not a multiple of 32 or 4, and the P1 / P2
extremes. Everything here is integer code: every comparison is exact. The
same cases run kernel against plain version on the card in
tests/test_torch_kernels_gpu.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.ops import clustering as jclustering
from moving_object_detector_tpu.ops import sgm as jsgm
from moving_object_detector_tpu.ops import sgm_pallas2 as jv2
from moving_object_detector_tpu.ops.clustering_pallas import (
    connected_components_pallas,
)
from moving_object_detector_tpu_torch.ops import clustering_cuda, sgm_cuda
from dp_cc_cases import CC_CASES, DP_CASES, STENCIL, TH, TW

torch.set_num_threads(2)

MAX_ITERS = 256
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "moving_object_detector_tpu_torch", "csrc")


def _constant(source: str, name: str) -> int:
    with open(os.path.join(CSRC, source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def test_wrapper_tile_is_the_kernels_tile():
    assert (TH, TW) == (_constant("cc.cu", "kTileH"),
                        _constant("cc.cu", "kTileW"))
    assert clustering_cuda.MAX_STENCIL == _constant("cc.cu", "kMaxStencil")


@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_cc_tile_border_cases_equal_jax(case):
    """Against the Pallas kernel in interpret mode at the stencil of 4; at
    a stencil of 6 against the JAX package's XLA form, since the Pallas
    kernel there gives other labels than that form (848 of the 3,811
    pixels of this input differ; the port's plain version equals the XLA
    form)."""
    make, radius, stencil, n_comp = CC_CASES[case]
    dynamic, depth = make()
    if stencil == STENCIL:
        ref, iters = connected_components_pallas(
            jnp.asarray(dynamic), jnp.asarray(depth), jnp.float32(0.15),
            jnp.int32(radius), MAX_ITERS, interpret=True, return_iters=True,
            stencil_radius=stencil)
        assert int(iters) < MAX_ITERS  # converged: the labelling is final
    else:
        ref = jclustering.connected_components(
            jnp.asarray(dynamic), jnp.asarray(depth), 0.15,
            neighbor_distance=radius, max_iters=MAX_ITERS)
    out = clustering_cuda.connected_components(
        torch.from_numpy(dynamic), torch.from_numpy(depth), 0.15,
        neighbor_distance=torch.tensor(radius, dtype=torch.int32),
        max_iters=MAX_ITERS, stencil_radius=stencil)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    n = dynamic.size
    found = len(np.unique(out.numpy()[out.numpy() < n]))
    if n_comp is not None:
        assert found == n_comp
    if radius == 0:  # no edges: every dynamic pixel its own component
        assert found == int(dynamic.sum())
    if case == "radius_above_stencil_clamped":
        at_stencil = clustering_cuda.connected_components(
            torch.from_numpy(dynamic), torch.from_numpy(depth), 0.15,
            neighbor_distance=stencil, max_iters=MAX_ITERS)
        assert torch.equal(out, at_stencil)


def test_dp_width_limit_fits_the_shared_memory_of_a_block():
    """The widest row the horizontal DP stages (wider rows take its
    global-memory variant, on the card) is the widest whose two staged
    census lines fit the 227 KB a block can have, and it lies above the
    WTA's."""
    w = sgm_cuda.DP_SMEM_WIDTH
    assert sgm_cuda.h_dp_smem_bytes(w) <= sgm_cuda.SMEM_PER_BLOCK
    assert sgm_cuda.h_dp_smem_bytes(w + 1) > sgm_cuda.SMEM_PER_BLOCK
    assert w >= sgm_cuda.WTA_SMEM_WIDTH


def _census_pair(h, w, seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 1, (h, w)).astype(np.float32)
    right = (np.roll(left, -7, axis=1)
             + rng.normal(0, 0.02, (h, w))).astype(np.float32)
    return (jsgm.census_transform(jnp.asarray(left)),
            jsgm.census_transform(jnp.asarray(right)))


@pytest.mark.parametrize("h,w,p1,p2", DP_CASES)
def test_horizontal_deltas_equal_jax_paths(h, w, p1, p2):
    """Each direction's deltas are the JAX package's path cost L minus the
    matching cost C (its XLA ``aggregate_path``), exactly."""
    jcl, jcr = _census_pair(h, w, seed=w + p1)
    cost = jsgm.hamming_cost_volume(jcl, jcr, 128)
    hf, hb = sgm_cuda.horizontal_deltas(
        torch.from_numpy(np.array(jcl)), torch.from_numpy(np.array(jcr)),
        p1, p2)
    for out, reverse in ((hf, False), (hb, True)):
        ref = np.asarray(jsgm.aggregate_path(cost, 1, reverse, p1, p2)
                         - cost)
        assert out.dtype == torch.int8 and tuple(out.shape) == (h, w, 128)
        np.testing.assert_array_equal(out.numpy().astype(np.float32), ref)
        assert int(out.min()) >= 0 and int(out.max()) <= p2
    if p1 == p2 == 0:
        assert not hf.any() and not hb.any()
    else:
        assert hf.any() and hb.any()


@pytest.mark.parametrize("h,w,p1,p2", [DP_CASES[0], DP_CASES[3]])
def test_horizontal_deltas_equal_pallas_interpret(h, w, p1, p2):
    """The Pallas kernel itself (``_h_kernel``), where its (128, 128)
    padding allows: bitwise."""
    jcl, jcr = _census_pair(h, w, seed=w)
    cl, cr = jv2._pad_to(jcl, 128, 128), jv2._pad_to(jcr, 128, 128)
    jf, jb = jv2.horizontal_deltas(cl.T, cr.T[::-1], p1, p2, w, True)
    hf, hb = sgm_cuda.horizontal_deltas(
        torch.from_numpy(np.array(jcl)), torch.from_numpy(np.array(jcr)),
        p1, p2)
    for out, ref in ((hf, jf), (hb, jb)):
        ref = np.asarray(ref).transpose(2, 0, 1)[:h, :w]
        np.testing.assert_array_equal(out.numpy(), ref)
