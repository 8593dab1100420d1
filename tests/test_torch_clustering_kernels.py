"""The port's connected components and cluster stats against the JAX
package's Pallas kernels in interpret mode.

Both are integer / selection code, so every comparison is exact
(tolerance 0). The plain versions tested here are what the CUDA kernels
(``csrc/cc.cu``, ``csrc/cluster_stats.cu``) are held against on the card.
The CUDA connected components always converge where the Pallas kernel
stops after ``max_iters`` rounds, so every CC input here is one on which
the Pallas kernel reports fewer rounds than ``max_iters``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import clusterer as jclu
from moving_object_detector_tpu.config import ClustererConfig as JCluCfg
from moving_object_detector_tpu.ops.cluster_stats_pallas import (
    cluster_stats_pallas,
)
from moving_object_detector_tpu.ops.clustering_pallas import (
    connected_components_pallas,
)
from moving_object_detector_tpu.types import SceneFlowCloud as JCloud
from moving_object_detector_tpu_torch import clusterer as tclu
from moving_object_detector_tpu_torch.config import (
    ClustererConfig as TCluCfg,
)
from moving_object_detector_tpu_torch.ops import (
    cluster_stats_cuda,
    clustering,
    clustering_cuda,
)
from moving_object_detector_tpu_torch.types import SceneFlowCloud as TCloud
from test_torch_detect import CASES as CLUSTER_CASES, _blocks as _blocks_cloud

torch.set_num_threads(2)
MAX_ITERS = 64


def _random_scene(seed, h, w, p_dyn=0.3, n_planes=3):
    rng = np.random.default_rng(seed)
    dynamic = rng.random((h, w)) < p_dyn
    depth = (np.round(rng.random((h, w)) * n_planes) + 2.0).astype(np.float32)
    return dynamic, depth


def _blocks():
    h, w = 32, 140
    dynamic = np.zeros((h, w), bool)
    depth = np.full((h, w), np.nan, np.float32)
    dynamic[5:15, 10:30] = True  # two blocks adjacent in pixels,
    depth[5:15, 10:30] = 2.0
    dynamic[5:15, 30:50] = True  # split by depth
    depth[5:15, 30:50] = 3.0
    dynamic[20:30, 100:120] = True
    depth[20:30, 100:120] = 2.0
    dynamic[2, 3] = True  # dynamic with a depth that is not finite
    dynamic[2, 4] = True
    depth[2, 4] = np.inf
    return dynamic, depth


def _gaps():
    h, w = 24, 130
    dynamic = np.zeros((h, w), bool)
    dynamic[10, 10:20] = True
    dynamic[10, 23:33] = True  # 3 px gap: inside the radius-4 window
    dynamic[10, 40:50] = True  # 7 px gap: outside
    depth = np.where(dynamic, 5.0, np.nan).astype(np.float32)
    return dynamic, depth


def _snake():
    h, w = 40, 150
    dynamic = np.zeros((h, w), bool)
    depth = np.full((h, w), np.nan, np.float32)
    for sl in ((slice(4, 8), slice(None)), (slice(8, 20), slice(140, 148)),
               (slice(18, 22), slice(5, 148))):
        dynamic[sl] = True
        depth[sl] = 2.0
    dyn2, dep2 = _random_scene(3, h, w)
    dynamic |= dyn2 & (np.arange(h)[:, None] > 24)
    depth = np.where(np.isnan(depth), dep2, depth)
    return dynamic, depth


CC_CASES = {
    "random0": (lambda: _random_scene(0, 40, 150), 2, 0),
    "random1": (lambda: _random_scene(1, 40, 150), 2, 8),
    "random2": (lambda: _random_scene(2, 40, 150), 2, 32),
    "odd_shape": (lambda: _random_scene(4, 37, 171), 3, 0),
    "blocks": (_blocks, 4, 0),
    "gaps": (_gaps, 4, 0),
    "snake_span8": (_snake, 2, 8),
    "snake_span32": (_snake, 2, 32),
}


@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_connected_components_equal_pallas_interpret(case):
    make, radius, span = CC_CASES[case]
    dynamic, depth = make()
    ref, iters = connected_components_pallas(
        jnp.asarray(dynamic), jnp.asarray(depth), jnp.float32(0.15), radius,
        MAX_ITERS, interpret=True, max_span=span, return_iters=True)
    assert int(iters) < MAX_ITERS  # converged: the labelling is final
    out = clustering_cuda.connected_components(
        torch.from_numpy(dynamic), torch.from_numpy(depth), 0.15,
        neighbor_distance=radius, max_iters=MAX_ITERS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if case == "blocks":
        assert len(np.unique(out.numpy())) == 6  # 3 blocks, 2 singles, bg
    if case == "gaps":
        o = out.numpy()
        assert o[10, 10] == o[10, 25] != o[10, 45]


def test_connected_components_radius_scalar_under_the_stencil():
    """A 0-d tensor radius of 2 under a stencil of 4 gives the radius-2
    edge set of the Pallas kernel."""
    dynamic, depth = _random_scene(5, 30, 140, p_dyn=0.25)
    ref = connected_components_pallas(
        jnp.asarray(dynamic), jnp.asarray(depth), jnp.float32(0.15),
        jnp.int32(2), MAX_ITERS, interpret=True, stencil_radius=4)
    out, iters = clustering.connected_components(
        torch.from_numpy(dynamic), torch.from_numpy(depth),
        torch.tensor(0.15), neighbor_distance=torch.tensor(2),
        max_iters=MAX_ITERS, stencil_radius=4, return_iters=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 1 <= iters < MAX_ITERS
    wide = clustering.connected_components(
        torch.from_numpy(dynamic), torch.from_numpy(depth), 0.15,
        neighbor_distance=4)
    assert not torch.equal(wide, out)


def test_max_iters_cuts_the_fixpoint_short():
    """The fixpoint forms (the Pallas kernel and the port's plain version)
    return the same unconverged labelling when ``max_iters`` runs out; the
    CUDA union-find has no rounds and always gives the converged one (held
    on the card in test_torch_kernels_gpu.py)."""
    dynamic, depth = _snake()
    args = (torch.from_numpy(dynamic), torch.from_numpy(depth), 0.15)
    ref, iters = connected_components_pallas(
        jnp.asarray(dynamic), jnp.asarray(depth), jnp.float32(0.15), 2, 2,
        interpret=True, max_span=8, return_iters=True)
    assert int(iters) == 2
    cut = clustering_cuda.connected_components(
        *args, neighbor_distance=2, max_iters=2)
    final = clustering_cuda.connected_components(
        *args, neighbor_distance=2, max_iters=MAX_ITERS)
    assert not torch.equal(cut, final)
    # Span 8 propagates less per round than the plain version's full
    # scans, so only the partition's coarsening is compared, not labels.
    assert len(np.unique(np.asarray(ref))) > len(np.unique(final.numpy()))


def _stats_case(h, w, cap, n_comp, n_sel, seed):
    """Labels in the style of the CC output (a component's label is a
    member's flat index), NaN points outside the selected clusters and
    unused root slots."""
    n = h * w
    rng = np.random.default_rng(seed)
    comp_roots = np.sort(rng.choice(n, n_comp, replace=False)).astype(
        np.int32)
    flat = np.full((n,), n, np.int32)
    assign = rng.integers(0, n_comp + 1, n)  # n_comp = background
    for i, r in enumerate(comp_roots):
        flat[assign == i] = r
        flat[r] = r
    roots = np.full((cap,), n, np.int32)
    roots[:n_sel] = comp_roots[:n_sel]
    pts = rng.normal(0, 3, (h, w, 3)).astype(np.float32)
    pts[~np.isin(flat, roots[:n_sel]).reshape(h, w)] = np.nan
    return flat.reshape(h, w), pts, roots


@pytest.mark.parametrize("h,w,cap,n_comp,n_sel", [
    (36, 150, 8, 5, 3),
    (37, 171, 16, 20, 16),
    (16, 128, 4, 3, 0),  # nothing selected: every slot empty
])
def test_cluster_stats_equal_pallas_interpret(h, w, cap, n_comp, n_sel):
    lab, pts, roots = _stats_case(h, w, cap, n_comp, n_sel, seed=h)
    # Member pixels are finite here, as on the detector's path; a NaN
    # member has its own test below.
    ref = cluster_stats_pallas(jnp.asarray(lab), jnp.asarray(pts),
                               jnp.asarray(roots), interpret=True)
    out = cluster_stats_cuda.cluster_stats(
        torch.from_numpy(lab), torch.from_numpy(pts), torch.from_numpy(roots))
    for a, b, name in zip(out, ref, ("cid", "mins", "maxs", "csize")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(out[3].sum()) == int((out[0].numpy() < cap).sum())
    assert (out[3].numpy()[:n_sel] > 0).all()
    assert np.isinf(out[1].numpy()[n_sel:]).all()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cluster_stats_nan_member_equal_pallas_interpret(axis):
    """A NaN coordinate on a member pixel makes that slot's min and max on
    that axis NaN, in the Pallas kernel and in the port's plain version
    (which the CUDA kernel is held against on the card): exact, NaN
    positions included."""
    h, w, cap, n_sel = 37, 171, 16, 6
    lab, pts, roots = _stats_case(h, w, cap, 9, n_sel, seed=7)
    slot = 2
    i, j = np.argwhere(lab == roots[slot])[3]
    assert np.isfinite(pts[i, j]).all()
    pts[i, j, axis] = np.nan
    ref = cluster_stats_pallas(jnp.asarray(lab), jnp.asarray(pts),
                               jnp.asarray(roots), interpret=True)
    out = cluster_stats_cuda.cluster_stats(
        torch.from_numpy(lab), torch.from_numpy(pts), torch.from_numpy(roots))
    for a, b, name in zip(out, ref, ("cid", "mins", "maxs", "csize")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for corner in (out[1].numpy(), out[2].numpy()):
        nan = np.isnan(corner)
        assert nan[slot, axis] and nan.sum() == 1
        assert np.isfinite(corner[:n_sel][~nan[:n_sel]]).all()


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_clusterer_kernel_backend_matches_jax(case):
    """``cc_backend="pallas"`` on CPU tensors (the wrappers' plain
    versions) against the JAX package with ``"pallas_interpret"``, on the
    clouds of test_torch_detect.py (one window, two windows, full frame
    with overflow): labels, validity, ids and overflow exact, boxes and
    velocities within 1e-5."""
    h, w, blocks, kw = CLUSTER_CASES[case]
    pts, vel = _blocks_cloud(h, w, blocks)
    base = dict(cluster_size=12, max_objects=8)
    base.update(kw)
    jo, jl, jov = jclu.cluster_scene_flow(
        JCloud(points=jnp.asarray(pts), velocity=jnp.asarray(vel)),
        JCluCfg(cc_backend="pallas_interpret", **base), return_overflow=True)
    to, tl, tov = tclu.cluster_scene_flow(
        TCloud(points=torch.from_numpy(pts), velocity=torch.from_numpy(vel)),
        TCluCfg(cc_backend="pallas", **base), return_overflow=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_array_equal(to.id.numpy(), np.asarray(jo.id))
    assert int(tov) == int(jov)
    for f in ("center", "bounding_box", "velocity"):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   np.asarray(getattr(jo, f)), rtol=0,
                                   atol=1e-5)
    assert to.valid.numpy().sum() >= 2
