"""The engine's distributed half: the port with ``config.shards = 8``
against the JAX package on its 8-device CPU mesh (tests/conftest.py).

The cases of ``tests/test_engine_dist.py``: where exchanges land (broadcast
threshold, partial aggregation below the exchange, non-decomposable aggs,
order-sensitive aggs, shuffle elimination on co-partitioned input), the
same serialized plan and decision ledger in both packages,
``check_partitioning``, and execution: broadcast and hash plans equal the
single-device result and JAX's, the executed exchange count equals
``verify.plan_exchanges``, a multi-chunk exchange survives a skewed chunk
boundary, string keys place Spark-exactly, and the degradation ladder's
spilled rung equals the one-shot shuffle.  Tolerance: group keys and
counts exact, float sums within rel 1e-9 (the JAX test's atol 1e-6 on
values of ~1e5).
"""

import contextlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.utils import config as jconfig_mod
from test_engine_dist import _join_agg, warehouse  # noqa: F401

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.engine import executor as pex
from spark_rapids_jni_tpu_torch.engine.plan import Exchange, topo_nodes
from spark_rapids_jni_tpu_torch.engine.verify import (PlanVerificationError,
                                                      check_partitioning,
                                                      plan_exchanges)
from spark_rapids_jni_tpu_torch.utils import metrics, tracing
from spark_rapids_jni_tpu_torch.utils.config import config as pconfig

torch.set_num_threads(1)
CPU = "cpu"


@contextlib.contextmanager
def flags(**kw):
    """The same config fields in both packages (``shards`` port-only)."""
    jc = jconfig_mod.config
    saved = [(c, k, getattr(c, k)) for c in (jc, pconfig) for k in kw
             if hasattr(c, k)]
    try:
        for c, k, _ in saved:
            setattr(c, k, kw[k])
        yield
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


@pytest.fixture(autouse=True)
def eight_shards():
    with flags(shards=8):
        yield


def to_port(plan):
    return pe.deserialize(plan.serialize())


def rows(table):
    cols = [c.to_pylist() for c in table.columns]
    return sorted(zip(*cols), key=lambda r: tuple((v is not None, v)
                                                  for v in r))


def assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def both_optimized(plan):
    jopt = je.optimize(plan, distribute=True)
    popt = pe.optimize(to_port(plan), distribute=True)
    assert popt.serialize() == jopt.serialize()
    assert popt._decisions == jopt._decisions
    return jopt, popt


def _exchanges(plan):
    return [n for n in topo_nodes(plan) if isinstance(n, Exchange)]


@pytest.mark.parametrize("threshold,kinds", [
    (100_000, ["broadcast", "hash"]), (0, ["hash", "hash", "hash"])])
def test_broadcast_threshold_picks_join_strategy(warehouse, threshold,
                                                 kinds):
    root, _, _ = warehouse
    with flags(broadcast_rows=threshold):
        _, popt = both_optimized(_join_agg(root))
    assert sorted(e.kind for e in _exchanges(popt)) == kinds


def test_partial_aggregation_and_non_decomposable(warehouse):
    root, _, _ = warehouse
    _, popt = both_optimized(_join_agg(root))
    assert isinstance(popt.child, Exchange)
    partial = popt.child.child
    assert isinstance(partial, pe.Aggregate)
    assert popt.aggs == (("total", "sum"), ("n", "sum"))
    j = pe.Join(pe.Scan(root / "fact.parquet"), pe.Scan(root / "dim.parquet"),
                ("k",), ("dk",), "inner")
    plan = pe.Aggregate(j, ("grp",), (("v", "mean"),), ("avg_v",))
    opt = pe.optimize(plan, distribute=True)
    assert isinstance(opt.child, Exchange) and opt.child.kind == "hash"
    assert not isinstance(opt.child.child, pe.Aggregate)


def test_shuffle_elimination_and_order_sensitive(warehouse):
    root, _, _ = warehouse
    j = je.Join(je.Scan(root / "fact.parquet", partitioned_by=("k",)),
                je.Scan(root / "dim.parquet", partitioned_by=("dk",)),
                ("k",), ("dk",), "inner")
    _, popt = both_optimized(je.Aggregate(j, ("k",), (("v", "sum"),),
                                          ("total",)))
    assert _exchanges(popt) == [] and plan_exchanges(popt) == []
    check_partitioning(popt)
    j = je.Join(je.Scan(root / "fact.parquet"), je.Scan(root / "dim.parquet"),
                ("k",), ("dk",), "inner")
    for op in ("first", "last"):
        _, popt = both_optimized(je.Aggregate(j, ("grp",), (("v", op),),
                                              ("x",)))
        assert _exchanges(popt) == [], op
    plan = je.Aggregate(j, ("grp",), (("v", "first"),), ("f",))
    base = pe.execute(pe.optimize(to_port(plan)), device=CPU)
    out = pe.execute(pe.optimize(to_port(plan), distribute=True), device=CPU)
    assert rows(out) == rows(base)


def test_redundant_exchange_eliminated(warehouse):
    root, _, _ = warehouse
    s = pe.Scan(root / "fact.parquet", partitioned_by=("k",))
    assert _exchanges(pe.optimize(Exchange(s, ("k",), "hash"))) == []
    stacked = Exchange(Exchange(pe.Scan(root / "fact.parquet"), ("v",),
                                "hash"), ("k",), "hash")
    ex = _exchanges(pe.optimize(stacked))
    assert len(ex) == 1 and ex[0].keys == ("k",)


def test_check_partitioning(warehouse):
    root, _, _ = warehouse
    bad = pe.Join(Exchange(pe.Scan(root / "fact.parquet"), ("v",), "hash"),
                  Exchange(pe.Scan(root / "dim.parquet"), ("dk",), "hash"),
                  ("k",), ("dk",), "inner")
    with pytest.raises(PlanVerificationError, match="partitioning-mismatch"):
        check_partitioning(bad)
    bad = pe.Aggregate(Exchange(pe.Scan(root / "fact.parquet"), ("v",),
                                "hash"), ("k",), (("v", "sum"),), ("t",))
    with pytest.raises(PlanVerificationError, match="partitioning-mismatch"):
        check_partitioning(bad)
    check_partitioning(pe.optimize(to_port(_join_agg(root)), distribute=True))


@pytest.mark.parametrize("threshold,nex", [(100_000, 2), (0, 3)])
def test_distributed_results_match_single_device(warehouse, threshold, nex):
    root, _, _ = warehouse
    plan = _join_agg(root)
    base = pe.execute(pe.optimize(to_port(plan)), device=CPU)
    with flags(broadcast_rows=threshold):
        jt = je.execute(je.optimize(plan, distribute=True), je.new_stats())
        opt = pe.optimize(to_port(plan), distribute=True)
        st = pe.new_stats()
        out = pe.execute(opt, stats=st, device=CPU)
    assert st["exchanges"] == len(plan_exchanges(opt)) == nex
    assert_rows_close(rows(out), rows(base))
    assert_rows_close(rows(out), rows(jt))


def test_multi_chunk_exchange_survives_boundary_skew(tmp_path, monkeypatch):
    """128 same-destination rows split 64/64 by the first table-shard
    boundary all land in one chunk shard: the chunk grid must hold their
    sum (tests/test_engine_dist.py's case)."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import INT64
    from spark_rapids_jni_tpu_torch.parallel.shuffle import partition_ids
    n, chunk_rows = 1536, 1024
    pool = np.arange(4096, dtype=np.int64)
    dests = partition_ids(Table([Column.fixed(INT64, pool, device=CPU)],
                                ["k"]), 8).numpy()
    hot, cold = pool[dests == dests[0]], pool[dests != dests[0]]
    k = cold[np.arange(n) % len(cold)]
    k[128:256] = hot[np.arange(128) % len(hot)]
    v = np.arange(n, dtype=np.int64)
    pq.write_table(pa.table({"k": pa.array(k), "v": pa.array(v)}),
                   tmp_path / "skew.parquet")
    monkeypatch.setattr(pex, "_EXCHANGE_CHUNK_ROWS", chunk_rows)
    plan = pe.Aggregate(Exchange(pe.Scan(tmp_path / "skew.parquet"), ("k",),
                                 "hash"), ("k",), (("v", "sum"),), ("t",))
    st = pe.new_stats()
    out = pe.execute(pe.optimize(plan), stats=st, device=CPU)
    assert st["exchanges"] == 1
    want = {}
    for kk, vv in zip(k.tolist(), v.tolist()):
        want[kk] = want.get(kk, 0) + vv
    assert dict(zip(out["k"].to_pylist(), out["t"].to_pylist())) == want


def test_string_key_exchange_places_spark_exact(tmp_path):
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.parallel import shuffle as sh
    from spark_rapids_jni_tpu_torch.parallel.stringplane import \
        explode_strings
    from spark_rapids_jni_tpu.columnar import Column as JColumn
    from spark_rapids_jni_tpu.ops.hash import murmur3_hash as jmurmur
    vals = ["a", "bb", "ccc", "", "delta", "echo-echo",
            "a-much-longer-string-key"] * 3
    t = Table([Column.from_pylist(vals, device=CPU)], ["s"])
    h = np.asarray(jmurmur(JColumn.from_pylist(vals)).data).astype(np.int64)
    want = np.mod(h, 8)
    for overrides in (None, {"s": 64}):
        exploded, plan = explode_strings(t, width_overrides=overrides)
        specs = sh.key_specs_for(exploded, ["s"], plan)
        got = sh.partition_ids_specs(exploded.columns, specs, 8).numpy()
        np.testing.assert_array_equal(got, want)
    words = np.array(["alpha", "bravo", "charlie", "delta", "echo"])
    s = words[np.arange(400) % 5]
    v = np.arange(400, dtype=np.int64)
    pq.write_table(pa.table({"s": pa.array(s), "v": pa.array(v)}),
                   tmp_path / "s.parquet")
    plan = pe.Aggregate(Exchange(pe.Scan(tmp_path / "s.parquet"), ("s",),
                                 "hash"), ("s",), (("v", "sum"),), ("t",))
    st = pe.new_stats()
    out = pe.execute(pe.optimize(plan), stats=st, device=CPU)
    assert st["exchanges"] == 1
    want = {w: int(v[s == w].sum()) for w in words}
    assert dict(zip(out["s"].to_pylist(), out["t"].to_pylist())) == want


def test_exchange_census_and_wire_matrix(warehouse):
    """Executed exchanges equal the static census; the exchange's wire
    bytes counter equals every padded slot of its grids, and its row
    matrix sums to the rows it moved."""
    root, _, _ = warehouse
    tracing.reset_counters("engine.exchange")
    with flags(broadcast_rows=0):
        opt = pe.optimize(to_port(_join_agg(root)), distribute=True)
        st = pe.new_stats()
        pe.execute(opt, stats=st, device=CPU)
    assert st["exchanges"] == len(plan_exchanges(opt))
    assert tracing.counter_value("engine.exchange.shuffles") == 3
    assert tracing.counter_value("engine.exchange.wire_bytes") > 0
    nodes = [v for v in metrics.recent_summaries()[-1]["nodes"]
             if "rows_matrix" in v]
    assert len(nodes) == 3
    for nd in nodes:
        assert sum(map(sum, nd["rows_matrix"])) == sum(nd["dev_rows"])


@pytest.mark.parametrize("rung", ["exchange-halved", "exchange-spilled"])
def test_degraded_exchange_equals_one_shot(warehouse, monkeypatch, rung,
                                           tmp_path):
    """Out of memory at full capacity steps down the ladder; the halved and
    spilled rungs give the one-shot result (spill buffers under
    ``config.spill_dir``)."""
    root, _, _ = warehouse
    plan = _join_agg(root)
    with flags(broadcast_rows=0):
        opt = pe.optimize(to_port(plan), distribute=True)
        want = rows(pe.execute(opt, device=CPU))
        real = pex._hash_exchange

        def flaky(node, table, ctx, chunk_rows=pex._EXCHANGE_CHUNK_ROWS):
            if chunk_rows == pex._EXCHANGE_CHUNK_ROWS or \
                    rung == "exchange-spilled":
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return real(node, table, ctx, chunk_rows)

        monkeypatch.setattr(pex, "_hash_exchange", flaky)
        st = pe.new_stats()
        with flags(spill_dir=str(tmp_path)):
            got = rows(pe.execute(opt, stats=st, device=CPU))
    steps = [d["step"] for d in st["degradations"]]
    assert rung in steps
    assert "exchange-passthrough" not in steps
    assert_rows_close(got, want)
