"""The readers of the program's phase spans (``rowconv_planes_ms``,
``groupby_sort_ms``, ``groupby_reduce_ms``) on synthetic run records, and
the ranges the harness asks the profiler for in each cell."""

from __future__ import annotations

from pathlib import Path

import pytest

from benchmark.core import harness as H

BENCH = Path(__file__).resolve().parents[1]
#: device seconds under each range in a synthetic window of 4 tasks
SECONDS = {"row_conversion.planes": 0.012, "row_conversion.columns": 0.004,
           "groupby.sort": 0.010, "groupby.reduce": 0.014,
           "convert_from_rows": 0.030}
WANT = {"rowconv_planes_ms": 4.0, "groupby_sort_ms": 2.5,
        "groupby_reduce_ms": 3.5}


def _reader(name: str):
    return H.load_module(H.reader_path(BENCH, name), f"bench_metric_{name}")


def _run(seconds: dict, queries: int = 4, trace: bool = True) -> dict:
    """A run record as the readers receive it; the trace's reduction gives
    0.0 for every range asked for and opened nowhere."""
    ranges = dict.fromkeys((r for n in WANT for r in _reader(n).RANGES),
                           0.0)
    ranges.update(seconds)
    return {"tasks_ms": [5.0] * queries, "queries": queries, "bytes": {},
            "trace": {"range_device_s": ranges} if trace else None}


@pytest.mark.parametrize("name", sorted(WANT))
def test_ms_a_task(name):
    assert _reader(name).read(_run(SECONDS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read(name):
    read = _reader(name).read
    assert read(_run(SECONDS, trace=False)) is None
    assert read(_run(SECONDS, queries=0)) is None
    # a program without the spans: the profiler attributes nothing to them
    assert read(_run({"convert_from_rows": 0.030})) is None
    assert read({"tasks_ms": [], "queries": 0, "bytes": {}}) is None


@pytest.mark.parametrize("cell,names", [
    ("ss_agg_partition", set(WANT)),
    ("ss_rows_roundtrip", {"rowconv_planes_ms"})])
def test_cells_report_the_span_metrics(cell, names):
    plan = H.cell_plan(H.manifest(), cell)
    got = {m["name"] for m in plan["per_layer"]}
    assert names <= got
    assert not (set(WANT) - names) & got
    ranges = {r for m in plan["per_layer"]
              for r in getattr(_reader(m["name"]), "RANGES", ())}
    assert {r for n in names for r in _reader(n).RANGES} <= ranges
