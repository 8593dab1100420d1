"""The PyTorch port stands alone: it imports no JAX, Flax, Optax, Orbax or
the JAX package, never falls back to the CPU on its own, and takes the
configuration values the JAX package takes."""

import os
import re
import subprocess
import sys

import pytest
import torch

from moving_object_detector_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "moving_object_detector_tpu_torch")
FORBIDDEN = re.compile(
    r"\b(jax|flax|optax|orbax)\b|moving_object_detector_tpu(?!_)")
MODULES = ("config", "types", "tunables", "_build", "ops.geometry",
           "ops.resize", "ops.sgm", "ops.sgm_cuda", "ops.sgm_v1_cuda",
           "ops.flow_ops", "ops.flow_corr_cuda", "ops.clustering",
           "ops.clustering_cuda", "ops.cluster_stats",
           "ops.cluster_stats_cuda", "ops.gather_cuda", "ops.sceneflow_cuda",
           "ops.gauss_newton_cuda", "ops.raft_lookup_cuda", "models.raft",
           "ops.image", "ops.assignment", "models.pwc_net",
           "utils.checkpoint", "utils.profiling", "utils.frames",
           "utils.cuda_graphs", "utils.trees",
           "egomotion", "sceneflow", "clusterer", "tracker", "pipeline",
           "eval", "io", "io.readers", "io.viz", "io.frame_ring",
           "io.scenes", "io.dashboard", "io.runner", "run", "parallel",
           "parallel.mesh", "parallel.streams", "parallel.spatial",
           "parallel.multihost", "alg", "alg.gaussian", "alg.classifiers",
           "alg.boosting", "alg.icf", "train", "train.data_synth",
           "train.flow_trainer", "train.train_flow")


def test_import_leaves_jax_out():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module('moving_object_detector_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', "
        "'moving_object_detector_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_module_list_covers_the_package():
    """Every module of the port is in the import scan."""
    found = set()
    for base, _, files in os.walk(PORT):
        if "_build" in base or "__pycache__" in base:
            continue
        rel = os.path.relpath(base, PORT)
        prefix = "" if rel == "." else rel.replace(os.sep, ".") + "."
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                found.add(prefix + f[:-3])
    assert found <= set(MODULES), sorted(found - set(MODULES))


def _sources():
    for base, _, files in os.walk(PORT):
        if "_build" in base or "__pycache__" in base:
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # Inputs chip_smoke.py takes from the tests.
    for name in ("dp_cc_cases.py", "sceneflow_cases.py",
                 "gauss_newton_cases.py", "corr_grad_cases.py",
                 "scene_gates.py"):
        yield os.path.join(ROOT, "tests", name)


def test_no_source_names_jax():
    found = []
    for path in _sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if FORBIDDEN.search(line):
                    found.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                                 f"{line.strip()}")
    assert not found, "\n".join(found)


def test_entry_points_raise_without_cuda(monkeypatch):
    from moving_object_detector_tpu_torch.pipeline import PipelineState
    from moving_object_detector_tpu_torch.types import StereoModel
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        load_flow_checkpoint,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PipelineState.create(tcfg.PipelineConfig(height=64, width=128))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_flow_checkpoint(os.path.join(ROOT, "weights",
                                          "pwc_v7.fp16.npz"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoModel.create(fx=1.0, fy=1.0, cx=0.0, cy=0.0, baseline=0.5)
    stereo = StereoModel.create(fx=1.0, fy=1.0, cx=0.0, cy=0.0,
                                baseline=0.5, device="cpu")
    assert stereo.base_from_camera.device.type == "cpu"
    state = PipelineState.create(tcfg.PipelineConfig(height=64, width=128),
                                 device="cpu")
    assert state.pose.device.type == "cpu"


def test_host_loop_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The runner, the CLI and the state loaders resolve their device like
    the other entry points: cuda, or raise; the CPU only when asked."""
    from moving_object_detector_tpu_torch import run
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner
    from moving_object_detector_tpu_torch.pipeline import PipelineState
    from moving_object_detector_tpu_torch.types import StereoModel
    from moving_object_detector_tpu_torch.utils import checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = tcfg.PipelineConfig(height=32, width=64)
    stereo = StereoModel.create(fx=1.0, fy=1.0, cx=0.0, cy=0.0, baseline=0.5,
                                device="cpu")
    state = PipelineState.create(config, device="cpu")
    snap = str(tmp_path / "s.npz")
    checkpoint.save_pipeline_state(snap, state)
    tree = {"pose": state.pose.numpy(), "prev_left": state.prev_left.numpy(),
            "prev_disparity": {k: v.numpy() for k, v in
                               vars(state.prev_disparity).items()},
            "prev_time": 0.0, "has_prev": False,
            "tracker": {k: v.numpy() for k, v in
                        vars(state.tracker).items()},
            "frame_index": 0}
    for call in (lambda: PipelineRunner(config, stereo),
                 lambda: run.main(["--frames", "1", "--preset", "tiny"]),
                 lambda: checkpoint.restore_pipeline_state(snap),
                 lambda: checkpoint.pipeline_state_from_numpy(tree)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert PipelineRunner(config, stereo, device="cpu").device.type == "cpu"
    back = checkpoint.restore_pipeline_state(snap, device="cpu")
    assert back.pose.device.type == "cpu" and back.frame_index == 0
    assert checkpoint.pipeline_state_from_numpy(
        tree, device="cpu").tracker.cov.shape == state.tracker.cov.shape
    assert "--device" not in run.build_parser().format_help()


@pytest.mark.parametrize("make", [
    lambda: tcfg.FlowNetConfig(warp_backend="two_pass"),
], ids=["warp_two_pass"])
def test_config_raises_for_unported_values(make):
    """``warp_backend="two_pass"`` once raised naming ROADMAP.md; it is
    ported now (``flow_ops.warp_two_pass``, held against the JAX form in
    tests/test_torch_train.py), and the port refuses no configuration
    value the JAX package takes. A value neither package knows raises."""
    assert make().warp_backend == "two_pass"
    with pytest.raises(ValueError, match="warp_backend"):
        tcfg.FlowNetConfig(warp_backend="bogus")


@pytest.mark.parametrize("make,field,value", [
    (lambda: tcfg.SGMConfig(backend="pallas_v1"), "backend", "pallas_v1"),
    (lambda: tcfg.TrackerConfig(association="gnn"), "association", "gnn"),
    (lambda: tcfg.SGMConfig(num_paths=8), "num_paths", 8),
], ids=["sgm_pallas_v1", "association_gnn", "sgm_eight_paths"])
def test_config_constructs_what_this_slice_ported(make, field, value):
    assert getattr(make(), field) == value


@pytest.mark.parametrize("cls,field,value", [
    (tcfg.SceneFlowConfig, "gather_backend", "pallas"),
    (tcfg.SceneFlowConfig, "gather_backend", "fused"),
    (tcfg.ClustererConfig, "cc_backend", "pallas"),
], ids=["gather_pallas", "gather_fused", "cc_pallas"])
def test_config_constructs_the_kernel_backends(cls, field, value):
    assert getattr(cls(**{field: value}), field) == value


@pytest.mark.parametrize("cls,field,value", [
    (tcfg.SceneFlowConfig, "gather_backend", "pallas_interpret"),
    (tcfg.SceneFlowConfig, "gather_backend", "fused_interpret"),
    (tcfg.ClustererConfig, "cc_backend", "pallas_interpret"),
], ids=["gather_pallas_interpret", "gather_fused_interpret",
        "cc_pallas_interpret"])
def test_config_refuses_the_interpret_names(cls, field, value):
    """Interpreter mode belongs to the reference package's kernels."""
    with pytest.raises(ValueError, match="unknown"):
        cls(**{field: value})


def test_config_defaults_match_the_jax_package():
    from moving_object_detector_tpu import config as jcfg

    assert repr(tcfg.PipelineConfig()) == repr(jcfg.PipelineConfig())


def test_cpu_tensors_take_the_plain_versions():
    """Kernel wrappers on CPU tensors run their plain versions and count
    no launch."""
    from moving_object_detector_tpu_torch.ops import (
        cluster_stats_cuda,
        clustering_cuda,
        flow_corr_cuda,
        gather_cuda,
        sceneflow_cuda,
        sgm_cuda,
        sgm_v1_cuda,
    )

    counters = (sgm_cuda.LAUNCHES, sgm_v1_cuda.LAUNCHES,
                flow_corr_cuda.LAUNCHES,
                gather_cuda.LAUNCHES, clustering_cuda.LAUNCHES,
                cluster_stats_cuda.LAUNCHES, sceneflow_cuda.LAUNCHES)
    before = [dict(c) for c in counters]
    cl = torch.randint(0, 1 << 24, (6, 40), dtype=torch.int32)
    sgm_cuda.vertical_deltas(cl, cl, 10, 120)
    total = sgm_v1_cuda.aggregate(sgm_v1_cuda.cost_volume(
        sgm_v1_cuda.census(torch.rand(6, 40)), cl), 10, 120)
    assert sgm_v1_cuda.wta(total).shape == (6, 40)
    flow_corr_cuda.correlation(torch.randn(1, 3, 5, 7),
                               torch.randn(1, 3, 5, 7), 2)
    h, w = 6, 9
    src = torch.rand(h, w)
    idx = torch.zeros((h, w), dtype=torch.int32)
    assert torch.equal(gather_cuda.window_gather(src, idx, idx),
                       src[0, 0].expand(h, w))
    dyn = torch.ones((h, w), dtype=torch.bool)
    labels = clustering_cuda.connected_components(
        dyn, torch.ones(h, w), 0.1, neighbor_distance=1)
    assert torch.equal(labels, torch.zeros((h, w), dtype=torch.int32))
    roots = torch.tensor([0, h * w], dtype=torch.int32)
    cid, mins, maxs, csize = cluster_stats_cuda.cluster_stats(
        labels, torch.rand(h, w, 3), roots)
    assert csize.tolist() == [h * w, 0] and int(cid.max()) == 0
    params = torch.ones(sceneflow_cuda.NPAR)
    points, vel, static = sceneflow_cuda.scene_flow_fused_cuda(
        src, src, torch.zeros(h, w, 2), params)
    assert points.shape == vel.shape == (h, w, 3)
    assert static.shape == (h, w, 2)
    assert [dict(c) for c in counters] == before
