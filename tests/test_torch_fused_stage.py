"""Whole-stage fusion across the exchange (``config.fuse_exchange``): the
port with ``config.shards = 8`` against the JAX package on its 8-device
CPU mesh (tests/conftest.py).

The ``partial-agg -> hash Exchange -> final-agg`` sandwich runs as one
device pass over every shard.  The cases of ``tests/test_fused_stage.py``,
with the JAX package's answer beside the port's:

- results equal the host-orchestrated path positionally (the fused output
  restores the one-groupby key order) and JAX's fused stage (quarter-grid
  float sums: exact);
- ``verify.sync_budget`` equals the runtime ``engine.host_sync`` counter,
  one boundary sync a fused stage, empty input included, and its site
  lists equal JAX's;
- the in-pass attribution: the send matrix equals JAX's, and the wire
  matrix sums to the counted wire bytes; EXPLAIN ANALYZE marks
  ``in_program=yes``;
- the AQE probe routes a placement-hot stage to the host path, where the
  split fires, and a balanced one to the fused pass, with the ledger equal
  to JAX's;
- overflow of the static capacity or of the per-shard group prefix, and a
  STRING key, give way to the host path (counted, ledgered), never an
  error.

Not ported: ``test_lint_fused_stage_artifact`` (a jaxpr lint; the card
counts its synchronising calls instead, chip_smoke.py).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import adaptive as jad
from spark_rapids_jni_tpu.engine import segment as jsg
from spark_rapids_jni_tpu.engine.verify import sync_budget as j_budget
from spark_rapids_jni_tpu.parallel.mesh import make_mesh as j_make_mesh
from test_fused_stage import N_KEYS, _sandwich
from test_fused_stage import skewed_warehouse, warehouse  # noqa: F401
from test_torch_engine_dist import flags, rows, to_port

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.engine import adaptive
from spark_rapids_jni_tpu_torch.engine import segment as sg
from spark_rapids_jni_tpu_torch.engine.verify import (SYNC_WHITELIST,
                                                      check_sync_budget,
                                                      plan_exchanges,
                                                      plan_segments,
                                                      sync_budget)
from spark_rapids_jni_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_jni_tpu_torch.utils import tracing
from spark_rapids_jni_tpu_torch.utils.config import config

torch.set_num_threads(1)
CPU = "cpu"
NDEV = 8


@pytest.fixture(autouse=True)
def eight_shards():
    with flags(shards=NDEV):
        yield


def _counter(name):
    return tracing.counter_value(name)


def _optimized(plan):
    return pe.optimize(to_port(plan), distribute=True)


def _frame(table):
    """Positional column values (nulls as None)."""
    return [c.to_pylist() for c in table.columns], list(table.names)


def _jax_fused(plan):
    """JAX's fused-stage result and its ledger's runtime entries."""
    opt = je.optimize(plan, distribute=True)
    out = je.execute(opt, je.new_stats())
    return out, jad.runtime_entries(opt)


# -- one pass, exact budget, parity -------------------------------------------

def test_fused_stage_bit_exact_parity(warehouse):  # noqa: F811
    with flags(fuse_exchange=True):
        opt = _optimized(_sandwich(warehouse))
        stats = pe.new_stats()
        before = _counter("engine.fused_stage.dispatches")
        out = pe.execute(opt, stats, device=CPU)
        assert _counter("engine.fused_stage.dispatches") == before + 1
        # the lowered exchange still counts in the executed census
        assert stats["exchanges"] == len(plan_exchanges(opt)) == 1
        jout, _ = _jax_fused(_sandwich(warehouse))
    with flags(fuse_exchange=False):
        ref = pe.execute(_optimized(_sandwich(warehouse)), pe.new_stats(),
                         device=CPU)
    # positional parity with the host path, not just multiset
    assert _frame(out) == _frame(ref)
    assert rows(out) == rows(jout)


def test_static_budget_equals_runtime_sync_counter(warehouse):  # noqa: F811
    """``sync_budget`` is exact for the fused path: the static charge
    equals the runtime ``engine.host_sync`` counter, and JAX charges the
    same sites."""
    with flags(fuse_exchange=True):
        opt = _optimized(_sandwich(warehouse))
        budget = sync_budget(opt, cfg=config, ndev=NDEV)
        assert [e["site"] for e in budget] == ["groupby-compaction"]
        assert all(e["site"] in SYNC_WHITELIST for e in budget)
        jopt = je.optimize(_sandwich(warehouse), distribute=True)
        assert budget == j_budget(jopt, ndev=NDEV)
        before = _counter("engine.host_sync")
        pe.execute(opt, pe.new_stats(), device=CPU)
        assert _counter("engine.host_sync") - before == \
            sum(e["count"] for e in budget) == 1


@pytest.mark.parametrize("fuse_x", [True, False])
def test_empty_input_budget_still_exact(warehouse, fuse_x):  # noqa: F811
    """An empty input pays exactly the charged syncs on the fused path
    (the dead-row synthesis keeps the one-sync pass running) and both
    exchange syncs on the host path."""
    with flags(fuse_exchange=fuse_x):
        opt = _optimized(_sandwich(warehouse, "empty.parquet"))
        budget = sync_budget(opt, cfg=config, ndev=NDEV)
        jopt = je.optimize(_sandwich(warehouse, "empty.parquet"),
                           distribute=True)
        assert budget == j_budget(jopt, ndev=NDEV)
        charged = sum(e["count"] for e in budget
                      if e["site"] in ("groupby-compaction",
                                       "exchange-counts-sizing",
                                       "exchange-compaction"))
        before = _counter("engine.host_sync")
        out = pe.execute(opt, pe.new_stats(), device=CPU)
        paid = _counter("engine.host_sync") - before
    assert out.num_rows == 0
    if fuse_x:
        assert paid == charged == 1
    else:
        assert paid >= 2  # both exchange syncs paid


def test_plan_segments_reports_fused_stage(warehouse):  # noqa: F811
    with flags(fuse_exchange=True):
        opt = _optimized(_sandwich(warehouse))
        segs = plan_segments(opt, ndev=NDEV)
        assert "fused-stage" in [s["kind"] for s in segs]
        st = next(s["stage"] for s in segs if s["kind"] == "fused-stage")
        assert isinstance(st, sg.FusedStage)
        assert st.fingerprint() == jsg.fused_sandwich(
            je.optimize(_sandwich(warehouse), distribute=True)).fingerprint()
        # on one shard the fusion is moot and the entry disappears
        assert "fused-stage" not in [s["kind"]
                                     for s in plan_segments(opt, ndev=1)]
        entries, bad = check_sync_budget([opt], ndev=NDEV)
        assert entries and not bad


def test_compiled_once_then_replayed(warehouse):  # noqa: F811
    sg.FUSED_STAGE_CACHE.clear()
    with flags(fuse_exchange=True):
        opt = _optimized(_sandwich(warehouse))
        pe.execute(opt, pe.new_stats(), device=CPU)
        (entry,) = sg.FUSED_STAGE_CACHE._entries.values()
        assert entry.traces == 1 and entry.calls == 1
        hits = sg.FUSED_STAGE_CACHE.stats()["hits"]
        before = _counter("engine.fused_stage.compile")
        pe.execute(opt, pe.new_stats(), device=CPU)
        assert sg.FUSED_STAGE_CACHE.stats()["hits"] == hits + 1
        assert _counter("engine.fused_stage.compile") == before  # replay
        assert entry.traces == 1 and entry.calls == 2


# -- in-pass attribution ------------------------------------------------------

def test_wire_and_rows_matrices_sum_to_counters(warehouse):  # noqa: F811
    with flags(fuse_exchange=True):
        opt = _optimized(_sandwich(warehouse))
        stage = sg.fused_sandwich(opt)
        assert stage is not None
        inp = pe.execute(stage.partial.child, pe.new_stats(), device=CPU)
        out, info = sg.run_fused_stage(stage, inp,
                                       make_mesh(NDEV, device=CPU))
        # every padded slot crosses: the wire matrix tiles to the bytes
        assert int(info["wire_matrix"].sum()) == info["wire_bytes"] \
            == NDEV * NDEV * info["capacity"] * info["row_size"]
        # the send matrix: live partial groups a (src, dest), JAX's own
        jopt = je.optimize(_sandwich(warehouse), distribute=True)
        jstage = jsg.fused_sandwich(jopt)
        jinp = je.execute(jstage.partial.child, je.new_stats())
        jres = jsg.run_fused_stage(jstage, jinp, j_make_mesh(NDEV), "shard")
        _, jinfo = jres
        assert info["rows_matrix"].shape == (NDEV, NDEV)
        np.testing.assert_array_equal(info["rows_matrix"],
                                      jinfo["rows_matrix"])
        assert info["capacity"] == jinfo["capacity"]
        assert info["wire_bytes"] == jinfo["wire_bytes"]
        assert int(info["rows_matrix"].sum()) >= N_KEYS
        assert out.num_rows == N_KEYS
        # the executor counts the same wire bytes for the cached entry
        before = _counter("engine.exchange.wire_bytes")
        pe.execute(opt, pe.new_stats(), device=CPU)
        assert _counter("engine.exchange.wire_bytes") - before \
            == info["wire_bytes"]


def test_explain_analyze_marks_in_program(warehouse):  # noqa: F811
    with flags(fuse_exchange=True):
        rep = pe.explain_analyze(to_port(_sandwich(warehouse)),
                                 distribute=True, device=CPU)
    assert rep.summary
    assert "in_program=yes" in rep.text
    assert "Exchange(hash" in rep.text


# -- the AQE escape hatch -----------------------------------------------------

def test_aqe_probe_routes_hot_stage_to_host_and_split_fires(
        skewed_warehouse):  # noqa: F811
    """The skew split fires at the boundary the fusion erases, so the
    counts probe routes the hot stage to the host path, where the split
    still runs; the ledger equals JAX's and the result the AQE-off one."""
    with flags(fuse_exchange=True, aqe=True):
        opt = _optimized(_sandwich(skewed_warehouse))
        stats = pe.new_stats()
        before = _counter("engine.fused_stage.aqe_fallbacks")
        out = pe.execute(opt, stats, device=CPU)
        assert _counter("engine.fused_stage.aqe_fallbacks") == before + 1
        rt = adaptive.runtime_entries(opt)
        probes = [d for d in rt if d["kind"] == "fused_stage"]
        assert probes and probes[0]["dispatch"] == "host"
        assert probes[0]["measured_skew"] > probes[0]["threshold"]
        splits = [d for d in rt if d["kind"] == "adaptive:skew_split"
                  and d.get("triggered")]
        assert splits, "skew split did not fire on the routed-to-host stage"
        assert stats["aqe_splits"] == len(splits)
        jout, jrt = _jax_fused(_sandwich(skewed_warehouse))
        assert rt == jrt
    with flags(fuse_exchange=False, aqe=False):
        ref = pe.execute(_optimized(_sandwich(skewed_warehouse)),
                         pe.new_stats(), device=CPU)
    assert rows(out) == rows(ref) == rows(jout)


def test_aqe_probe_dispatches_balanced_stage_fused(warehouse):  # noqa: F811
    """A balanced stage: the probe dispatches the fused pass, and the
    probe's counts fetch is itself a budgeted sync."""
    with flags(fuse_exchange=True, aqe=True):
        opt = _optimized(_sandwich(warehouse))
        budget = sync_budget(opt, cfg=config, ndev=NDEV)
        assert sorted(e["site"] for e in budget) == \
            ["exchange-counts-sizing", "groupby-compaction"]
        stats = pe.new_stats()
        before = _counter("engine.host_sync")
        out = pe.execute(opt, stats, device=CPU)
        assert _counter("engine.host_sync") - before == \
            sum(e["count"] for e in budget) == 2
        rt = adaptive.runtime_entries(opt)
        probes = [d for d in rt if d["kind"] == "fused_stage"]
        assert probes and probes[0]["dispatch"] == "fused"
        assert stats["aqe_splits"] == 0
        jout, jrt = _jax_fused(_sandwich(warehouse))
        assert rt == jrt
    with flags(fuse_exchange=False, aqe=False):
        ref = pe.execute(_optimized(_sandwich(warehouse)), pe.new_stats(),
                         device=CPU)
    assert _frame(out) == _frame(ref)
    assert rows(out) == rows(jout)


# -- fallback rules -----------------------------------------------------------

def _fallback_case(plan, reason):
    """Run ``plan`` fused; assert one counted, ledgered give-way for
    ``reason`` and a result equal to the unfused plan's."""
    with flags(fuse_exchange=True):
        opt = _optimized(plan)
        before = _counter("engine.fused_stage.fallbacks")
        out = pe.execute(opt, pe.new_stats(), device=CPU)
        assert _counter("engine.fused_stage.fallbacks") == before + 1
        (entry,) = [d for d in adaptive.runtime_entries(opt)
                    if d["kind"] == "fused_stage"]
        assert (entry["dispatch"], entry["reason"]) == ("host", reason)
    with flags(fuse_exchange=False):
        ref = pe.execute(_optimized(plan), pe.new_stats(), device=CPU)
    assert rows(out) == rows(ref)
    return out


def test_capacity_overflow_falls_back_to_host_path(
        warehouse, monkeypatch):  # noqa: F811
    """An input overflowing the static capacity re-plans on the host path
    (the overflow count read at the one boundary sync), never an error."""
    sg.FUSED_STAGE_CACHE.clear()
    monkeypatch.setattr(sg, "fused_capacity", lambda prefix, ndev: 2)
    before = _counter("engine.fused_stage.overflow_fallbacks")
    try:
        _fallback_case(_sandwich(warehouse), "overflow")
    finally:
        sg.FUSED_STAGE_CACHE.clear()
    assert _counter("engine.fused_stage.overflow_fallbacks") == before + 1


def test_group_prefix_overflow_falls_back_to_host_path(
        warehouse):  # noqa: F811
    """A shard holding more partial groups than ``fuse_groups`` overflows
    its static prefix (each shard here holds about 500 groups, over the
    smallest bucket of 32): the host path re-plans."""
    with flags(fuse_groups=32):
        _fallback_case(_sandwich(warehouse), "overflow")
    stage = sg.fused_sandwich(_optimized(_sandwich(warehouse)))
    assert stage is not None
    with flags(fuse_groups=32):
        assert sg.fused_prefix(20_000 // NDEV) == 32
    with flags(fuse_groups=4096):
        assert sg.fused_prefix(20_000 // NDEV) == 2500   # the row bound
        assert sg.fused_capacity(2500, NDEV) == 1024


def test_string_keys_fall_back_to_host_path(tmp_path):
    """Variable-width columns cannot cross as word planes: the runtime
    eligibility veto gives way, and the result is still right."""
    n = 800
    rng = np.random.default_rng(3)
    words = np.array(["ab", "cd", "ef", "gh"], dtype=object)
    pq.write_table(pa.table({"k": pa.array(words[rng.integers(0, 4, n)]),
                             "v": pa.array(rng.integers(0, 100, n) * 0.5)}),
                   tmp_path / "s.parquet")
    plan = je.Aggregate(je.Scan(tmp_path / "s.parquet"), ("k",),
                        (("v", "sum"),), ("total",))
    before = _counter("engine.fused_stage.dispatches")
    out = _fallback_case(plan, "schema")
    assert _counter("engine.fused_stage.dispatches") == before
    with flags(fuse_exchange=True):
        jout, _ = _jax_fused(plan)
    assert rows(out) == rows(jout)
