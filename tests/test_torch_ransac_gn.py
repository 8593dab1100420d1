"""Ego-motion's RANSAC in one call (``ops/gauss_newton_cuda.py``
``ransac_solve`` / ``ransac_solve_plain``) against the JAX package's
``_ransac_gn_solve``, its wrapper on CPU tensors, and the kernel's
constants against ``csrc/gauss_newton.cu``.

The plain version is fed the JAX package's own hypothesis indices (drawn
from its key as its RANSAC draws them) and must give the same success,
the same inlier count and the motion within 1e-4 (the sums over the
points run in another order: XLA on the CPU contracts multiply-adds), at
the serving shape and at an odd N and H, with outliers and invalid
features, for one, four and sixteen refinement candidates.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import egomotion as jego
from moving_object_detector_tpu.config import EgoMotionConfig as JCfg
from moving_object_detector_tpu.types import CameraModel as JCam
from moving_object_detector_tpu_torch import egomotion as tego
from moving_object_detector_tpu_torch.config import EgoMotionConfig as TCfg
from moving_object_detector_tpu_torch.ops import gauss_newton_cuda as gn
from moving_object_detector_tpu_torch.types import CameraModel as TCam
from gauss_newton_cases import CAM, RANSAC_CASES, ransac_case

torch.set_num_threads(2)

JCAM = JCam.create(*CAM)
TCAM_VEC = torch.tensor(CAM, dtype=torch.float32)
SOURCE = os.path.join(os.path.dirname(gn.__file__), os.pardir, "csrc",
                      "gauss_newton.cu")
_jax_ransac = jax.jit(jego._ransac_gn_solve, static_argnames=("cfg",))


def _jax_indices(key, n, valid, cfg):
    """The hypothesis indices the JAX package's RANSAC draws from ``key``
    (its ``one_hypothesis``'s ``random.choice``)."""
    p = jnp.asarray(valid.astype(np.float32) / max(valid.sum(), 1))
    keys = jax.random.split(key, cfg.ransac_hypotheses)
    return np.array(jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(cfg.ransac_sample,), replace=False, p=p))(keys))


@pytest.mark.parametrize("refine", [1, 4, 16])
@pytest.mark.parametrize("shape", ["serving", "odd"])
def test_plain_ransac_matches_jax(shape, refine):
    pts, uv, valid, _ = ransac_case(shape)
    n, h, _ = RANSAC_CASES[shape]
    kw = dict(ransac_hypotheses=h, refine_candidates=refine)
    cfg_j, cfg_t = JCfg(**kw), TCfg(**kw)
    key = jax.random.PRNGKey(11)
    idx = _jax_indices(key, n, valid, cfg_j)
    jm, js, jc = _jax_ransac(jnp.asarray(pts), jnp.asarray(uv),
                             jnp.asarray(valid), JCAM, key, cfg=cfg_j)
    tm, ts, tc = gn.ransac_solve_plain(
        torch.from_numpy(pts), torch.from_numpy(uv), torch.from_numpy(valid),
        TCAM_VEC, torch.from_numpy(idx), cfg_t)
    assert bool(ts) == bool(js) and bool(ts)
    assert int(tc) == int(jc)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)


def _args(name="serving"):
    pts, uv, valid, idx = ransac_case(name)
    return [torch.from_numpy(pts), torch.from_numpy(uv),
            torch.from_numpy(valid), TCAM_VEC, torch.from_numpy(idx)]


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    before = dict(gn.LAUNCHES)
    args, cfg = _args(), TCfg()
    out = gn.ransac_solve(*args, cfg)
    plain = gn.ransac_solve_plain(*args, cfg)
    via_ego = tego._ransac_gn_solve(*args[:3], TCam.create(*CAM, device="cpu"),
                                    None, cfg, args[4])
    for a, b, c in zip(out, plain, via_ego):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert out[0].dtype == torch.float32 and out[0].shape == (4, 4)
    assert out[1].dtype == torch.bool and out[1].dim() == 0
    assert out[2].dtype == torch.int32 and out[2].dim() == 0
    assert gn.LAUNCHES == before


def _ransac_refusals():
    pts, uv, valid, cam, idx = _args("odd")
    return {
        "f64_points": (pts.double(), uv, valid, cam, idx, 256),
        "f64_observations": (pts, uv.double(), valid, cam, idx, 256),
        "float_valid": (pts, uv, valid.float(), cam, idx, 256),
        "int32_indices": (pts, uv, valid, cam, idx.int(), 256),
        "indices_1d": (pts, uv, valid, cam, idx[:, 0], 256),
        "no_hypothesis": (pts, uv, valid, cam, idx[:0], 256),
        "observations_of_another_n": (pts, uv[:-1], valid, cam, idx, 256),
        "valid_of_another_n": (pts, uv, valid[:-1], cam, idx, 256),
        "points_of_two": (pts[:, :2], uv, valid, cam, idx, 256),
        "no_feature": (pts[:0], uv[:0], valid[:0], cam, idx, 256),
        "camera_of_three": (pts, uv, valid, cam[:3], idx, 256),
        "threads_96": (pts, uv, valid, cam, idx, 96),
        "two_devices": (pts, uv, valid, cam, idx.to("meta"), 256),
    }


@pytest.mark.parametrize("case", sorted(_ransac_refusals()))
def test_ransac_refuses_what_the_kernel_does_not_take(case):
    *args, threads = _ransac_refusals()[case]
    with pytest.raises((ValueError, TypeError)):
        gn.ransac_solve(*args, TCfg(), threads=threads)


def _meta(n, h=64):
    return [torch.empty((n, 3), device="meta"),
            torch.empty((n, 2), device="meta"),
            torch.empty((n,), dtype=torch.bool, device="meta"),
            torch.empty((4,), device="meta"),
            torch.empty((h, 3), dtype=torch.int64, device="meta")]


@pytest.mark.parametrize("threads", gn.RANSAC_THREADS)
def test_ransac_takes_n_up_to_its_shared_memory_and_names_the_limit(threads):
    """Meta tensors reach the checks a CUDA tensor meets without a card:
    the most features that fit pass them (and are then refused only for
    not being on the card), one more is refused with the limit named. The
    serving N fits every block size with room to spare."""
    most = (gn.SMEM_LIMIT - gn.ransac_smem_bytes(0, threads)) // (
        gn.POINT_BYTES + 1)
    assert gn.ransac_smem_bytes(most, threads) <= gn.SMEM_LIMIT
    assert most >= 8 * TCfg().max_features
    with pytest.raises(ValueError, match="CUDA tensors"):
        gn.ransac_solve(*_meta(most), TCfg(), threads=threads)
    with pytest.raises(ValueError, match=f"limit of {gn.SMEM_LIMIT}.*"
                                         f"at most {most}"):
        gn.ransac_solve(*_meta(most + 1), TCfg(), threads=threads)


def test_solve_pose_takes_n_up_to_its_shared_memory_and_names_the_limit():
    most = (gn.SMEM_LIMIT - gn.block_smem_bytes(0)) // gn.POINT_BYTES
    for n, match in ((most, "CUDA tensors"), (most + 1, f"at most {most}")):
        args = [torch.empty(shape, device="meta")
                for shape in ((n, 3), (n, 2), (4, n), (4,))]
        with pytest.raises(ValueError, match=match):
            gn.solve_pose(*args, 3)


def test_ieee_ops_check_runs_on_the_card_only():
    with pytest.raises(ValueError, match="CUDA device"):
        gn.ieee_ops_check(16, device="cpu")


def _source():
    with open(SOURCE) as f:
        return f.read()


def _int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def test_wrapper_constants_are_the_kernels():
    """The block sizes, the shared-memory layout and limit and the
    thread-a-problem switch the wrapper sizes its checks by are the ones
    the kernels are built with."""
    assert gn.MAX_WARPS == _int("kMaxWarps")
    assert gn.CLUSTER == _int("kCluster")
    assert gn.THREAD_POINTS == _int("kThreadPoints")
    assert gn.SMEM_LIMIT == _int("kSmemLimit")
    assert gn.MISC_BYTES == _int("kMiscBytes")
    assert gn.POINT_BYTES == _int("kPointBytes")
    assert gn.HYP_BYTES == _int("kHypBytes")
    assert re.search(r"constexpr int kPartBytes = \(kMaxWarps \* 32 \+ 16\) "
                     r"\* 4;", _source())
    assert max(gn.RANSAC_THREADS + gn.THREADS) <= 32 * gn.MAX_WARPS
    assert gn.RANSAC_DEFAULT_THREADS in gn.RANSAC_THREADS
    # The shared memory formulas of the source, term by term.
    assert re.search(r"return kPartBytes \+ kPointBytes \* n;", _source())
    assert re.search(r"return kPartBytes \+ kMiscBytes \+ kHypBytes \* "
                     r"threads \+\s+\(kPointBytes \+ 1\) \* n;", _source())


@pytest.mark.parametrize("entry", ["gauss_newton", "ransac_gn",
                                   "ieee_ops_check"])
def test_argtypes_follow_the_c_signatures(entry):
    """ctypes passes each argument as the C entry declares it: a pointer
    (or the stream) as a pointer, an int as an int, a float as a float."""
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', _source(),
                    re.S).group(1)
    kinds = []
    for param in sig.split(","):
        param = " ".join(param.split())
        if "*" in param or param.startswith("cudaStream_t"):
            kinds.append(ctypes.c_void_p)
        elif param.startswith("unsigned "):
            kinds.append(ctypes.c_uint)
        elif param.startswith("int "):
            kinds.append(ctypes.c_int)
        else:
            assert param.startswith("float "), param
            kinds.append(ctypes.c_float)
    want = {"gauss_newton": gn.SOLVE_ARGTYPES, "ransac_gn": gn.RANSAC_ARGTYPES,
            "ieee_ops_check": gn.CHECK_ARGTYPES}[entry]
    assert tuple(kinds) == want
