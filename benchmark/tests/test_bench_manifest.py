"""``BENCHMARK.json`` against the benchmark's contract, and the
harness's way of finding a cell's files by name."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.core import harness as H
from benchmark.core.harness import reader_path, with_pending

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
FULL = with_pending(MAN)  # the cells of pending/ added
BOTH = pytest.mark.parametrize("man", [MAN, FULL], ids=["bench", "pending"])
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_text_ok(w) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    files = [w for w in MAN["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in MAN["paths"])
               for f in files)


def test_run_seconds_fits_a_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("conf", FULL["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _text_ok(conf["why"])
    assert _text_ok(conf["source"]) and conf["source"].startswith("https://")
    assert any(conf["file"].startswith(p + "/") for p in MAN["paths"])
    body = json.loads((ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"]
    assert sorted(conf["reduced"]) == sorted(body["reduced"])
    assert len(conf["reduced"]) <= 16
    assert all(NAME.match(k) for k in conf["reduced"])
    assert (ROOT / "benchmark" / "configs" / f"{conf['name']}.py").exists()
    man = MAN if conf in MAN["configs"] else FULL
    assert any(w["config"] == conf["name"] for w in man["workloads"])


@BOTH
def test_names_unique(man):
    for group in ("configs", "workloads"):
        names = [x["name"] for x in man[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", FULL["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and _text_ok(cell["why"])
    traffic = json.loads((ROOT / "benchmark" / "workloads"
                          / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers"
            / f"{traffic['driver']}.py").exists()
    plan = H.cell_plan(FULL, cell["name"])
    reported = {m["name"] for m in plan["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert plan["per_layer"]


@BOTH
def test_at_most_a_quarter_of_cells_on_four_chips(man):
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


@BOTH
def test_end_to_end_metrics(man):
    cells = {w["name"] for w in man["workloads"]}
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells


@BOTH
def test_per_layer_metrics_move_what_their_cells_report(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    layers = {}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text_ok(m["layer"])
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert reader_path(ROOT / "benchmark", m["name"]).exists()
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_split_metric_shares_its_quantitys_reader(tmp_path):
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "idle.py").write_text("")
    assert reader_path(tmp_path, "idle.query") == metrics / "idle.py"
    (metrics / "idle.query.py").write_text("")
    assert reader_path(tmp_path, "idle.query") == metrics / "idle.query.py"
    assert reader_path(tmp_path, "other") == metrics / "other.py"


def test_manifest_size():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_a_new_metric_is_new_files_only(tmp_path, small_plan, run_small):
    """A per-layer metric added as a file and a manifest entry, in a copy,
    with no file of the benchmark edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    man = json.loads(json.dumps(MAN))
    man["per_layer"].append({
        "name": "tasks_per_window", "unit": "tasks", "better": "higher",
        "source": "host_clock", "layer": "engine", "moves": "rows_per_s",
        "workloads": ["ss_agg_partition"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (bench / "metrics" / "tasks_per_window.py").write_text(
        "def read(run):\n    return float(run['queries'])\n")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    plan = H.cell_plan(H.manifest(tmp_path), "ss_agg_partition", bench)
    assert "tasks_per_window" in {m["name"] for m in plan["per_layer"]}
    from conftest import shrink
    plan = shrink(plan)
    import time
    res = H.run_cell(plan, 12345, 0.5, True, "cpu", time.perf_counter(),
                     bench)
    assert res["correct"]
    assert res["metrics"]["tasks_per_window"]["value"] >= 1
    after = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts and ".cache" not in p.parts}
    assert all(before[p] == b for p, b in after.items() if p in before)
