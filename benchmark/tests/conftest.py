"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q``.

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which decides whether there is one and skips otherwise; nothing
here asks while a module is imported.  ``small_plan`` gives a cell's plan
(of ``BENCHMARK.json`` or ``pending/``) at a size the CPU runs in seconds:
the configuration's shapes, fewer rows.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped on a host without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def shrink(plan: dict) -> dict:
    """The cell's plan with its configuration cut to a CPU-sized run."""
    cfg = plan["config"]
    if "tables" in cfg:
        t = cfg["tables"]["store_sales"]
        t["rows"], t["row_group_rows"] = 1 << 15, 1 << 11
    else:
        cfg["batch_rows"] = 1 << 13
    return plan


@pytest.fixture
def small_plan(tmp_path, monkeypatch):
    """``small_plan(cell)``: the plan of ``cell`` at a CPU size, its file
    cache under ``tmp_path``, the program pinned to its device-decode
    route (the kernels' plain versions on the CPU)."""
    import torch

    from benchmark.core import harness as H
    from spark_rapids_jni_tpu_torch.utils.config import config
    torch.set_num_threads(1)
    monkeypatch.setattr(config, "device_decode", True)
    monkeypatch.setattr(H, "BENCH", tmp_path / "bench")

    def make(cell: str) -> dict:
        return shrink(H.cell_plan(H.with_pending(H.manifest()), cell))
    return make


@pytest.fixture
def run_small():
    """``run_small(plan, seed, seconds, trace)``: one run on the CPU, the
    harness's look for a card skipped."""
    import time

    from benchmark.core import harness as H

    def run(plan: dict, seed: int = 2**31 + 7, seconds: float = 1.0,
            trace: bool = False) -> dict:
        return H.run_cell(plan, seed, seconds, trace, "cpu",
                          time.perf_counter())
    return run
