"""On a CUDA card: a short run of each cell through ``run.py`` is correct.

The window is 10 s: long enough to reach the tasks a cell keeps for its
check (drawn among the first 16) after the copies of the earlier ones,
which take up to ~2 s each in ``ss_rows_roundtrip``.

    python -m pytest benchmark/tests -m card -q

Skipped on a host without a card (the ``card`` fixture decides).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, trace, card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 17), "--seconds", "10", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == card
    assert res["metrics"]
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
