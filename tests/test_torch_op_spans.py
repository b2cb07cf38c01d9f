"""The phase spans and sync-site counters inside row conversion and groupby
(``utils/tracing.py``: ``span``, ``traced``, ``sync_point``), on the CPU.

Each op runs under ``torch.profiler`` (CPU activity).  Every phase span
must appear on the op's thread inside the op's own range, the phases of
one op must not overlap (so their device times add up to the op's), and
each call must move the ``ops.host_sync.<site>`` counters by exactly its
read sites.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.dtypes import FLOAT64, INT32, INT64, \
    STRING, UINT8
from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
from spark_rapids_jni_tpu_torch.ops.row_conversion import (
    MAX_BATCH_BYTES, convert_from_rows, convert_to_rows)
from spark_rapids_jni_tpu_torch.utils import tracing

torch.set_num_threads(1)

N = 200  # not a multiple of 32: the wire's pad and cut run
ROW_PHASES = ("row_conversion.check", "row_conversion.planes",
              "row_conversion.wire", "row_conversion.columns")
GROUPBY_PHASES = ("groupby.sort", "groupby.reduce", "groupby.compact")
SYNCS = "ops.host_sync."


def _profiled(fn):
    """``fn()`` under the profiler: (its result, [(name, thread, start,
    end)] of every recorded CPU range, the ``ops.host_sync.*`` deltas)."""
    before = tracing.counters_snapshot(SYNCS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = tracing.counters_snapshot(SYNCS)
    deltas = {k[len(SYNCS):]: v - before.get(k, 0)
              for k, v in after.items() if v != before.get(k, 0)}
    events = [(e.name, e.thread, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    return out, events, deltas


def _spans(events, name):
    return [e for e in events if e[0] == name]


def _inside(events, inner: str, outer: str) -> None:
    """``inner`` was recorded, and each of its ranges lies within an
    ``outer`` range of the same thread."""
    got = _spans(events, inner)
    assert got, f"no {inner} range"
    for _, tid, s, t in got:
        assert any(otid == tid and os <= s and t <= ot
                   for _, otid, os, ot in _spans(events, outer)), \
            f"{inner} outside {outer}"


def _disjoint(events, names) -> None:
    ranges = sorted((s, t, n) for n in names
                    for _, _, s, t in _spans(events, n))
    for (_, t0, n0), (s1, _, n1) in zip(ranges, ranges[1:]):
        assert t0 <= s1, f"{n0} overlaps {n1}"


def _fixed_table() -> Table:
    rng = np.random.default_rng(3)
    cols = [
        Column.fixed(INT32, rng.integers(-9, 9, N).astype(np.int32),
                     rng.random(N) > 0.2, device="cpu"),
        Column.fixed(INT64, rng.integers(-9, 9, N).astype(np.int64),
                     device="cpu"),
        Column.fixed(FLOAT64, rng.random(N), rng.random(N) > 0.1,
                     device="cpu"),
    ]
    return Table(cols, ["a", "b", "c"])


def _string_table() -> Table:
    rng = np.random.default_rng(4)
    words = [None if rng.random() < 0.2 else "x" * int(rng.integers(0, 20))
             for _ in range(N)]
    return Table([Column.fixed(INT32, np.arange(N, dtype=np.int32),
                               device="cpu"),
                  Column.from_pylist(words, dtype=STRING, device="cpu"),
                  Column.from_pylist(words[::-1], dtype=STRING,
                                     device="cpu")], ["k", "s", "t"])


@pytest.mark.parametrize("blob", ["words", "bytes"])
def test_fixed_width_round_trip_spans_and_syncs(blob):
    table = _fixed_table()
    schema = table.dtypes()
    rows, ev, deltas = _profiled(
        lambda: convert_to_rows(table, device="cpu"))
    assert deltas == {}
    for phase in ("row_conversion.planes", "row_conversion.wire"):
        _inside(ev, phase, "convert_to_rows")
    _disjoint(ev, ROW_PHASES)

    col = rows[0]
    if blob == "bytes":  # a byte blob, as a CPU operator hands it over
        col = Column.list_(Column(UINT8, data=col.children[0].data
                                  .view(torch.uint8)), col.offsets,
                           device="cpu")
    back, ev, deltas = _profiled(
        lambda: convert_from_rows(col, schema, device="cpu"))
    assert deltas == {"row_conversion.row_width": 1}
    for phase in ("row_conversion.check", "row_conversion.wire",
                  "row_conversion.columns"):
        _inside(ev, phase, "convert_from_rows")
    _inside(ev, "sync.row_conversion.row_width", "row_conversion.check")
    _disjoint(ev, ROW_PHASES)
    for got, want in zip(back.columns, table.columns):
        assert torch.equal(got.data, want.data)


@pytest.mark.parametrize("several", [False, True])
def test_string_round_trip_spans_and_syncs(several):
    table = _string_table()
    rows, ev, deltas = _profiled(lambda: convert_to_rows(
        table, max_batch_bytes=4096 if several else MAX_BATCH_BYTES,
        device="cpu"))
    assert (len(rows) > 1) == several
    want = {"row_conversion.var_sizes.total": 1}
    if several:  # the batches are planned on the host
        want["row_conversion.var_sizes.batches"] = 1
    assert deltas == want
    _inside(ev, "row_conversion.planes", "convert_to_rows")
    _inside(ev, "sync.row_conversion.var_sizes.total", "convert_to_rows")

    schema = table.dtypes()
    back, ev, deltas = _profiled(
        lambda: convert_from_rows(rows[0], schema, device="cpu"))
    assert deltas == {"row_conversion.var_sizes.check": 1,
                      "row_conversion.var_sizes.chars": 2}
    _inside(ev, "row_conversion.check", "convert_from_rows")
    _inside(ev, "sync.row_conversion.var_sizes.check",
            "row_conversion.check")
    _inside(ev, "sync.row_conversion.var_sizes.chars", "convert_from_rows")
    assert back.columns[1].to_pylist()[:5] == \
        table.columns[1].to_pylist()[:5]


@pytest.mark.parametrize("keys", [["k"], ["k", "j"]])
def test_groupby_spans_and_syncs(keys):
    rng = np.random.default_rng(5)
    table = Table([
        Column.fixed(INT32, rng.integers(0, 7, N).astype(np.int32),
                     device="cpu"),
        Column.fixed(INT32, rng.integers(0, 3, N).astype(np.int32),
                     rng.random(N) > 0.3, device="cpu"),
        Column.fixed(FLOAT64, rng.random(N), device="cpu"),
    ], ["k", "j", "v"])
    out, ev, deltas = _profiled(lambda: groupby(
        table, keys, [("v", "sum"), ("k", "count_all")], device="cpu"))
    assert deltas == {"groupby.ngroups": 1, "groupby.key_nulls": len(keys)}
    for phase in GROUPBY_PHASES:
        _inside(ev, phase, "groupby")
    _inside(ev, "groupby.sort", "groupby_padded")
    _inside(ev, "groupby.reduce", "groupby_padded")
    _inside(ev, "sync.groupby.ngroups", "groupby.compact")
    assert len(_spans(ev, "sync.groupby.key_nulls")) == len(keys)
    _inside(ev, "sync.groupby.key_nulls", "groupby.compact")
    _disjoint(ev, GROUPBY_PHASES)
    assert out.num_rows == len({tuple(r) for r in zip(
        *(table.column(k).to_pylist() for k in keys))})


def test_collect_list_and_nunique_syncs():
    table = Table([
        Column.fixed(INT32, np.arange(N, dtype=np.int32) % 5, device="cpu"),
        Column.fixed(INT64, np.arange(N, dtype=np.int64) % 7,
                     np.arange(N) % 4 > 0, device="cpu"),
    ], ["k", "v"])
    _, _, deltas = _profiled(lambda: groupby(
        table, ["k"], [("v", "collect_list"), ("v", "sum")], device="cpu"))
    # the base groupby's two, the key segments, the one collected column
    assert deltas == {"groupby.ngroups": 1, "groupby.key_nulls": 1,
                      "groupby.collect_host": 2}
    _, _, deltas = _profiled(lambda: groupby(
        table, ["k"], [("v", "nunique")], device="cpu"))
    assert deltas == {"groupby.ngroups": 1, "groupby.key_nulls": 1}


def test_traced_and_span_give_the_same_range():
    @tracing.traced("test.same")
    def decorated(x):
        return x + 1

    def spanned(x):
        with tracing.span("test.same"):
            return x + 1

    shapes = []
    for fn in (decorated, spanned):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn(torch.ones(4))
        (e,) = [e for e in prof.events() if e.name == "test.same"]
        shapes.append((e.thread, e.is_user_annotation,
                       [c.name for c in e.cpu_children]))
    assert shapes[0] == shapes[1]
    assert shapes[0][1] and shapes[0][2] == ["aten::add"]


def test_sync_point_counts_without_the_profiler():
    before = tracing.counter_value("ops.host_sync.test.site")
    with tracing.sync_point("test.site"):
        pass
    assert tracing.counter_value("ops.host_sync.test.site") == before + 1
