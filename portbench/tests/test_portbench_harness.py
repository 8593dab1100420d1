"""The harness finds what a cell needs by name, from files alone, and
``BENCHMARK.json`` keeps to the contract's shape."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.core import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def spec():
    return bench.benchmark()


def test_added_config_traffic_and_metric_are_found_by_name(tmp_path,
                                                          monkeypatch):
    """A later change adds a configuration, a traffic mix and a metric as
    new files and entries; nothing else is edited."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(bench.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "*.npz"))
    spec = bench.benchmark()
    (bench_dir / "configs" / "new_cfg.json").write_text(
        json.dumps({"height": 8, "width": 16}))
    (bench_dir / "traffic" / "new_mix.json").write_text(
        json.dumps({"driver": "stream", "rate": 3.0}))
    (bench_dir / "metrics" / "new_quantity.py").write_text(
        "def read(run, name):\n    return 41.0 + len(name.split('.'))\n")
    spec["configs"].append({"name": "new_cfg", "source": "x",
                            "file": "portbench/configs/new_cfg.json",
                            "reduced": [], "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(bench, "BENCH_DIR", str(bench_dir))
    monkeypatch.setattr(bench, "ROOT", str(tmp_path))
    spec2 = bench.benchmark()
    assert bench.config_file(spec2, "new_cfg") == {"height": 8, "width": 16}
    assert bench.traffic_file("new_mix")["rate"] == 3.0
    reader = bench.metric_reader("new_quantity.live")
    assert reader.read(None, "new_quantity.live") == 43.0
    # A metric's own file wins over its quantity's.
    (bench_dir / "metrics" / "new_quantity.live.py").write_text(
        "def read(run, name):\n    return 7.0\n")
    assert bench.metric_reader("new_quantity.live").read(None, "") == 7.0
    with pytest.raises(bench.BenchError):
        bench.traffic_file("no_such_mix")
    with pytest.raises(bench.BenchError):
        bench.metric_reader("no_such_metric.max")


def test_every_listed_metric_and_file_exists(spec):
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(bench.ROOT, c["file"]))
    for w in spec["workloads"]:
        bench.traffic_file(w["traffic"])
        for m in bench.metrics_of(spec, "per_layer", w["name"]):
            assert hasattr(bench.metric_reader(m["name"]), "read")
    names = [b.NAME for b in bench.bound_modules()]
    assert len(names) == len(set(names))
    assert {"sgm_vertical", "sgm_horizontal", "sgm_wta", "sgm1_census",
            "corr", "corr_backward", "gather", "cc", "cluster_stats",
            "ransac_gn"} <= set(names)


def test_benchmark_json_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in spec[group]:
            assert NAME.match(item["name"]), item["name"]
            seen.add((group, item["name"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    perf = open(os.path.join(bench.ROOT, "PERF.md")).read()
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["layer"] in perf, m["layer"]
        for w in m["workloads"]:  # each cell it names reports what it moves
            assert e2e[m["moves"]] in bench.metrics_of(spec, "end_to_end", w)
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = bench.metrics_of(spec, "end_to_end", w["name"])
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert bench.metrics_of(spec, "per_layer", w["name"])
    for m in spec["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(bench.BENCH_DIR, "run.py"),
         "--workload", "kitti_s2.max_busy", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        env=env, cwd=bench.ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_outside_a_checkout_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no program."""
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(bench.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kitti_s2.live_busy", "--seed", "3", "--seconds", "1", "--trace",
         "1"], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
