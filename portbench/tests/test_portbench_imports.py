"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import glob
import os

import pytest

from portbench.core import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "moving_object_detector_tpu"}
PORT = "moving_object_detector_tpu_torch"


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(glob.glob(os.path.join(bench.BENCH_DIR, "**", "*.py"),
                         recursive=True))


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, bench.BENCH_DIR)
                              for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN
    # Nor a path to the JAX package's benchmark script at the root.
    script = "bench" + ".py"
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert os.path.basename(node.value.strip()) != script


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    bench.BENCH_DIR, "reference", "*.py"))))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    assert PORT not in open(path).read().split('"""', 2)[-1]


def test_bounds_name_the_port_only_by_their_targets():
    for b in bench.bound_modules():
        assert b.TARGET.split(".")[0] == PORT


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, PORT + "_fake", types.ModuleType("x"))
    assert bench.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert bench.forbidden_loaded() == ["jax"]
