"""The PyTorch port stands alone: it imports no JAX, Flax, Orbax or the
JAX package, never falls back to the CPU on its own, and refuses the
configuration values it does not implement yet."""

import os
import re
import subprocess
import sys

import pytest
import torch

from moving_object_detector_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "moving_object_detector_tpu_torch")
FORBIDDEN = re.compile(r"\b(jax|flax|orbax)\b|moving_object_detector_tpu(?!_)")
MODULES = ("config", "types", "tunables", "_build", "ops.geometry",
           "ops.resize", "ops.sgm", "ops.sgm_cuda", "ops.flow_ops",
           "ops.flow_corr_cuda", "ops.clustering", "models.pwc_net",
           "utils.checkpoint", "egomotion", "sceneflow", "clusterer",
           "tracker", "pipeline")


def test_import_leaves_jax_out():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module('moving_object_detector_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'moving_object_detector_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _sources():
    for base, _, files in os.walk(PORT):
        if "_build" in base or "__pycache__" in base:
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


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


@pytest.mark.parametrize("make", [
    lambda: tcfg.SceneFlowConfig(gather_backend="pallas"),
    lambda: tcfg.SceneFlowConfig(gather_backend="fused"),
    lambda: tcfg.ClustererConfig(cc_backend="pallas"),
    lambda: tcfg.SGMConfig(backend="pallas_v1"),
    lambda: tcfg.TrackerConfig(association="gnn"),
], ids=["gather_pallas", "gather_fused", "cc_pallas", "sgm_pallas_v1",
        "association_gnn"])
def test_config_raises_for_unported_values(make):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make()


def test_config_defaults_match_the_jax_package():
    from moving_object_detector_tpu import config as jcfg

    assert repr(tcfg.PipelineConfig()) == repr(jcfg.PipelineConfig())


def test_cpu_tensors_take_the_plain_versions():
    """Kernel wrappers on CPU tensors run their plain versions and count
    no launch."""
    from moving_object_detector_tpu_torch.ops import flow_corr_cuda, sgm_cuda

    before = (dict(sgm_cuda.LAUNCHES), dict(flow_corr_cuda.LAUNCHES))
    cl = torch.randint(0, 1 << 24, (6, 40), dtype=torch.int32)
    sgm_cuda.vertical_deltas(cl, cl, 10, 120)
    flow_corr_cuda.correlation(torch.randn(1, 3, 5, 7),
                               torch.randn(1, 3, 5, 7), 2)
    assert (sgm_cuda.LAUNCHES, flow_corr_cuda.LAUNCHES) == before
