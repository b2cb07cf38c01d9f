"""What the benchmark may import, and how it refuses to run."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core import harness as H

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
JAX_SIDE = {"jax", "jaxlib", "flax", "spark_rapids_jni_tpu"}
PORT = "spark_rapids_jni_tpu_torch"


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(*dirs):
    return [p for d in dirs for p in sorted((BENCH / d).glob("*.py"))]


YARDSTICK = [p for p in _sources("reference", "configs", "core", "metrics")
             if p.name != "harness.py"]  # the harness checks for the port


@pytest.mark.parametrize("path", YARDSTICK,
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_yardstick_imports_nothing_of_either_program(path):
    assert not _imports(path) & (JAX_SIDE | {PORT})


@pytest.mark.parametrize("path", _sources("drivers") + [
    BENCH / "run.py", BENCH / "control.py", BENCH / "core" / "harness.py"],
    ids=lambda p: p.name)
def test_harness_never_imports_the_jax_side(path):
    assert not _imports(path) & JAX_SIDE


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".x", sys)
    assert PORT not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spark_rapids_jni_tpu.ops", sys)
    assert H.forbidden_modules() == ["spark_rapids_jni_tpu"]


def test_a_run_loads_no_jax_in_its_process(tmp_path):
    """Every driver, configuration and metric of the manifest, and a tiny
    run of each cell, in a fresh process: no JAX, no JAX package."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(BENCH / 'tests')!r})
from benchmark.core import harness as H
from conftest import shrink
from spark_rapids_jni_tpu_torch.utils.config import config
config.device_decode = True
H.BENCH = __import__("pathlib").Path({str(tmp_path)!r})
man = H.manifest()
for w in man["workloads"]:
    plan = shrink(H.cell_plan(man, w["name"]))
    for trace in (False, True):
        res = H.run_cell(plan, 9, 1.0, trace, "cpu", time.perf_counter())
        assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded
    assert not loaded & JAX_SIDE


def _run(cwd: Path, script: Path):
    return subprocess.run(
        [sys.executable, str(script), "--workload", "ss_agg_partition",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT, BENCH / "run.py")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path, tmp_path / "benchmark" / "run.py")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
