"""The port's query engine against the JAX package's, on the CPU.

Plans cross between the packages as bytes (``deserialize(plan.serialize())``).
The port runs with ``device="cpu"``, so the decode kernels K3, W1 and W2
take their plain versions.  Covered:

- ``optimize(q5_plan)``: the same serialized plan, decision ledger, fact
  scan predicate and pruned columns (tests/test_engine_e2e.py's warehouse).
- ``execute`` of q5 by the host route and the device route
  (``config.device_decode``), fused and interpreted, and of the unoptimized
  plan: the result equals JAX's and the pandas oracle (group keys and
  counts exact, sums within rel 1e-9, the JAX test's own tolerance: the
  port's groupby sums in scatter order), and the stats agree on the
  pruning, chunk and fusion counts.
- ``Limit(Sort(Project))`` becoming TopK, and a streamed TopK (against
  pandas).
- ``PlanCache``: a plan rebuilt from its bytes returns the same
  ``CompiledPlan``, with the same counter deltas as JAX.
- The streamed probe joins, the build cache and every ``Join.how``:
  tests/test_torch_engine_joins.py.
- ``explain_analyze``: the same tree, no roofline fraction without a
  measured ceiling.
"""

import contextlib
import os

import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import plan as jplan
from spark_rapids_jni_tpu.utils import config as jconfig_mod
from spark_rapids_jni_tpu.utils import tracing as jtracing
from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.utils import tracing as ptracing
from spark_rapids_jni_tpu_torch.utils.config import config as pconfig
from test_engine_e2e import (DATE_HI, DATE_LO, as_dict, oracle,  # noqa
                             q5_plan, warehouse)

torch.set_num_threads(1)
CPU = "cpu"
STAT_KEYS = ("row_groups_pruned", "row_groups_read", "chunks", "streamed",
             "fused_segments")


@contextlib.contextmanager
def flags(**kw):
    """Set the same config fields in both packages for the body."""
    jc = jconfig_mod.config
    saved = [(c, k, getattr(c, k)) for c in (jc, pconfig) for k in kw]
    try:
        for c in (jc, pconfig):
            for k, v in kw.items():
                setattr(c, k, v)
        yield
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


def to_port(plan):
    return pe.deserialize(plan.serialize())


def run_both(plan, optimize=True, fused=None):
    """(JAX table, JAX stats, port table, port stats) for ``plan``."""
    jst, pst = je.new_stats(), pe.new_stats()
    jp = je.optimize(plan) if optimize else plan
    pp = pe.optimize(to_port(plan)) if optimize else to_port(plan)
    jt = je.execute(jp, stats=jst, fused=fused)
    pt = pe.execute(pp, stats=pst, fused=fused, device=CPU)
    return jt, jst, pt, pst


def rows(table):
    """The table's rows as a sorted multiset (nulls sort first)."""
    cols = [c.to_pylist() for c in table.columns]
    return sorted(zip(*cols),
                  key=lambda r: tuple((v is not None, v) for v in r))


def assert_rows_close(got: list, want: list):
    """Sorted row multisets equal; floats within rel 1e-9 (sums of values
    that are not exact in binary, taken in another order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-9), (g, w)


def assert_q5(got: dict, want: dict):
    assert set(got) == set(want)
    for name, (ws, wp, wn) in want.items():
        gs, gp, gn = got[name]
        assert gn == wn, name
        assert gs == pytest.approx(ws, rel=1e-9), name
        assert gp == pytest.approx(wp, rel=1e-9), name


# -- optimize ----------------------------------------------------------------

def test_optimize_q5_matches_jax(warehouse):
    root, *_ = warehouse
    plan = q5_plan(root)
    jopt = je.optimize(plan)
    popt = pe.optimize(to_port(plan))
    assert popt.serialize() == jopt.serialize()
    assert popt.fingerprint() == jopt.fingerprint()
    assert popt._decisions == jopt._decisions
    assert [n._est_rows for n in pe.plan.topo_nodes(popt)] == \
        [n._est_rows for n in jplan.topo_nodes(jopt)]
    fact = [n for n in pe.plan.topo_nodes(popt) if isinstance(n, pe.Scan)
            and n.path.endswith("store_sales.parquet")][0]
    assert fact.predicate == ("ss_sold_date_sk", DATE_LO, DATE_HI)
    dim = [n for n in pe.plan.topo_nodes(popt) if isinstance(n, pe.Scan)
           and n.path.endswith("date_dim.parquet")][0]
    assert dim.columns == ("d_date_sk",)


def test_distributed_planning_raises(warehouse):
    """Distributed planning is ported: q5 plans as the JAX package plans it,
    and what raises now is the partitioning check on a plan whose join
    sides are placed on different keys."""
    from spark_rapids_jni_tpu_torch.engine.plan import Exchange, Join, Scan
    from spark_rapids_jni_tpu_torch.engine.verify import check_partitioning
    root = warehouse[0]
    popt = pe.optimize(to_port(q5_plan(root)), distribute=True)
    jopt = je.optimize(q5_plan(root), distribute=True)
    assert popt.serialize() == jopt.serialize()
    bad = Join(Exchange(Scan(root / "store_sales.parquet"),
                        ("ss_store_sk",), "hash"),
               Exchange(Scan(root / "date_dim.parquet"), ("d_date_sk",),
                        "hash"),
               ("ss_sold_date_sk",), ("d_date_sk",), "inner")
    with pytest.raises(pe.PlanVerificationError,
                       match="partitioning-mismatch"):
        check_partitioning(bad)


# -- execute -----------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "interp"])
@pytest.mark.parametrize("route", ["host", "device"])
def test_q5_execute_matches_jax_and_pandas(warehouse, route, fused):
    root, sales_df, dates_df, stores_df = warehouse
    with flags(device_decode=route == "device"):
        jt, jst, pt, pst = run_both(q5_plan(root), fused=fused)
    assert_q5(as_dict(pt), as_dict(jt))
    assert_q5(as_dict(pt), oracle(sales_df, dates_df, stores_df))
    assert {k: pst[k] for k in STAT_KEYS} == {k: jst[k] for k in STAT_KEYS}
    assert pst["row_groups_pruned"] >= 1 and pst["chunks"] > 1
    assert pst["fused_segments"] == (1 if fused else 0)


def test_q5_device_route_decodes_on_the_device(warehouse):
    """Every fact chunk takes the device-decode segment (no host fallback)
    and the ledger entry equals JAX's."""
    root, *_ = warehouse
    with flags(device_decode=True):
        jopt = je.optimize(q5_plan(root))
        popt = pe.optimize(to_port(q5_plan(root)))
        je.execute(jopt)
        f0 = ptracing.counter_value("io.device_decode.fallbacks")
        pe.execute(popt, device=CPU)
    assert ptracing.counter_value("io.device_decode.fallbacks") == f0
    (pdd,) = [d for d in popt._decisions
              if d["kind"] == "scan:device_decode"]
    (jdd,) = [d for d in jopt._decisions
              if d["kind"] == "scan:device_decode"]
    assert pdd == jdd
    assert pdd["choice"] == "device" and pdd["host_chunks"] == 0


def test_decode_route_follows_the_target():
    """By default a card target takes the device-decode route and the CPU
    the host route; ``config.device_decode`` pins either."""
    from spark_rapids_jni_tpu_torch.engine.executor import _decode_on_device
    assert pconfig.device_decode is None
    assert _decode_on_device(torch.device("cuda"))
    assert not _decode_on_device(torch.device("cpu"))
    with flags(device_decode=True):
        assert _decode_on_device(torch.device("cpu"))
    with flags(device_decode=False):
        assert not _decode_on_device(torch.device("cuda"))


@pytest.mark.parametrize("way", ["oom", "veto", "interp"])
def test_device_route_never_decodes_on_the_host(warehouse, monkeypatch,
                                                way):
    """Once a stream is on the device-decode route, the out-of-memory step
    down to the interpreted loop (``oom``: planted in the fused decode
    segment), a schema veto (``veto``) and a fused=False run (``interp``)
    still decode every fact chunk with ``decode_table``; the host decoder
    never reads the fact file."""
    from spark_rapids_jni_tpu_torch.engine import segment as psg
    from spark_rapids_jni_tpu_torch.io import parquet as ppq
    from spark_rapids_jni_tpu_torch.ops import parquet_decode as pqd
    root, sales_df, dates_df, stores_df = warehouse
    decoded, host_reads = [], []
    real_decode, real_group = pqd.decode_table, ppq.ParquetFile._decode_group

    def decode_table(planes, geom):
        # fact chunks only: the pruned date_dim scan decodes on the device
        # route too (a materialized chunked scan takes it on a card)
        if any(g.name.startswith("ss_") for g in geom.columns):
            decoded.append(geom.rb)
        return real_decode(planes, geom)

    def decode_group(self, gi, columns=None):
        host_reads.append(os.path.basename(self.path))
        return real_group(self, gi, columns)

    def oom(self, *a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (planted)")

    monkeypatch.setattr(pqd, "decode_table", decode_table)
    monkeypatch.setattr(ppq.ParquetFile, "_decode_group", decode_group)
    if way == "oom":
        monkeypatch.setattr(psg.CompiledDecodeSegment, "__call__", oom)
    elif way == "veto":
        monkeypatch.setattr(psg, "stream_runtime_eligible",
                            lambda *a, **k: False)
    st = pe.new_stats()
    with flags(device_decode=True):
        pt = pe.execute(pe.optimize(to_port(q5_plan(root))), stats=st,
                        fused=way != "interp", device=CPU)
    assert_q5(as_dict(pt), oracle(sales_df, dates_df, stores_df))
    assert st["streamed"]
    assert [d["step"] for d in st.get("degradations", [])] == \
        (["stream-interpreted"] if way == "oom" else [])
    assert len(decoded) == st["chunks"] > 1
    assert "store_sales.parquet" not in host_reads


def test_unoptimized_plan_same_answer(warehouse):
    root, sales_df, dates_df, stores_df = warehouse
    jt, jst, pt, pst = run_both(q5_plan(root), optimize=False)
    assert_q5(as_dict(pt), as_dict(jt))
    assert_q5(as_dict(pt), oracle(sales_df, dates_df, stores_df))
    assert pst["row_groups_pruned"] == 0 == jst["row_groups_pruned"]
    assert {k: pst[k] for k in STAT_KEYS} == {k: jst[k] for k in STAT_KEYS}


def test_limit_sort_becomes_topk(warehouse):
    root, *_ = warehouse
    plan = je.Limit(je.Sort(je.Project(je.Scan(root / "store.parquet"),
                                       ("s_store_sk",)),
                            (("s_store_sk", False),)), 3)
    popt = pe.optimize(to_port(plan))
    assert isinstance(popt, pe.TopK)
    assert popt.serialize() == je.optimize(plan).serialize()
    jt, _, pt, _ = run_both(plan)
    assert list(pt.names) == ["s_store_sk"]
    assert pt["s_store_sk"].to_pylist() == [12, 11, 10] == \
        jt["s_store_sk"].to_pylist()


def test_streamed_topk_matches_pandas(warehouse):
    """TopK over a chunked scan runs the per-chunk partial top-k; ties
    break by arrival order, as a stable sort of the filtered rows does."""
    root, sales_df, *_ = warehouse
    scan = je.Scan(root / "store_sales.parquet", chunk_bytes=96_000)
    plan = je.Limit(je.Sort(je.Filter(scan, (">", je.col("ss_net_profit"),
                                             je.lit(100.0))),
                            (("ss_store_sk", True),
                             ("ss_net_profit", False))), 25)
    st = pe.new_stats()
    popt = pe.optimize(to_port(plan))
    assert isinstance(popt, pe.TopK)
    pt = pe.execute(popt, stats=st, device=CPU)
    assert st["topk"] and st["streamed"] and st["chunks"] > 1
    want = sales_df[sales_df.ss_net_profit > 100.0].sort_values(
        ["ss_store_sk", "ss_net_profit"], ascending=[True, False],
        kind="mergesort").head(25)
    got = pt.to_pydict()
    assert list(got) == list(want.columns)
    for name in want.columns:
        assert got[name] == [None if v != v else v
                             for v in want[name].tolist()], name


# -- plan cache --------------------------------------------------------------

def test_plan_cache_identity_and_counters(warehouse):
    root, *_ = warehouse
    jpc, ppc = je.PlanCache(), pe.PlanCache()
    before = [t.counters_snapshot("engine.plan_cache")
              for t in (jtracing, ptracing)]
    jfirst, pfirst = jpc.get(q5_plan(root)), ppc.get(to_port(q5_plan(root)))
    r1 = as_dict(pfirst.execute(device=CPU))
    wire = q5_plan(root).serialize()
    assert jpc.get(je.deserialize(wire)) is jfirst
    psecond = ppc.get(pe.deserialize(wire))
    assert psecond is pfirst
    assert ppc.stats() == jpc.stats() == {"hits": 1, "misses": 1, "size": 1,
                                          "maxsize": 128, "evictions": 0}
    deltas = [{k: v - b.get(k, 0)
               for k, v in t.counters_snapshot("engine.plan_cache").items()}
              for t, b in zip((jtracing, ptracing), before)]
    assert deltas[1] == deltas[0] == {"engine.plan_cache.hit": 1,
                                      "engine.plan_cache.miss": 1}
    assert as_dict(psecond.execute(device=CPU)) == r1
    assert pfirst.executions == 2


# -- explain ------------------------------------------------------------------

def _tree(text: str) -> list:
    """The rendered DAG without the measured annotations."""
    return [ln.split("  [")[0] for ln in text.splitlines()
            if not ln.startswith("--")]


def test_explain_analyze_renders_the_same_tree(warehouse):
    root, *_ = warehouse
    jrep = je.explain_analyze(q5_plan(root))
    prep = pe.explain_analyze(to_port(q5_plan(root)), device=CPU)
    assert _tree(prep.text) == _tree(jrep.text)
    assert [n["metrics"]["rows_out"] if n["metrics"] else None
            for n in prep.nodes] == \
        [n["metrics"]["rows_out"] if n["metrics"] else None
         for n in jrep.nodes]
    assert "roofline_frac" not in prep.text  # no measured ceiling set
    with flags(roofline_gbps=1000.0):
        assert "roofline_frac=" in pe.explain_analyze(
            to_port(q5_plan(root)), device=CPU).text


def test_explain_result_cache_serves_a_repeat(warehouse):
    root, sales_df, dates_df, stores_df = warehouse
    pe.RESULT_CACHE.clear()
    with flags(result_cache=4):
        first = pe.explain_analyze(to_port(q5_plan(root)), result_cache=True,
                                   device=CPU)
        again = pe.explain_analyze(to_port(q5_plan(root)), result_cache=True,
                                   device=CPU)
    assert again.result is first.result
    assert [d["kind"] for d in again.decisions][-1] == "serving:result_cache"
    assert "serving:result_cache choice=served_from_cache" in again.text
    assert_q5(as_dict(again.result), oracle(sales_df, dates_df, stores_df))
    assert pe.data_version(to_port(q5_plan(root))) is not None


def test_metrics_attribute_export_and_isolate(warehouse):
    """A query's counters and spans land in its QueryMetrics (a helper
    thread bound to it included); snapshot/reset/restore isolate a
    prefix; prometheus_text renders the registry."""
    import threading

    from spark_rapids_jni_tpu_torch.utils import metrics
    root, *_ = warehouse
    saved = (metrics.histograms_snapshot("engine."),
             metrics.gauges_snapshot("engine."))
    metrics.reset("engine.")
    try:
        def helper():
            with metrics.bind(qm):
                metrics.count("engine.test.helper")

        with metrics.query("t") as qm:
            pe.execute(pe.optimize(to_port(q5_plan(root))), device=CPU)
            t = threading.Thread(target=helper)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
        summ = qm.summary()
        assert summ["counters"]["engine.test.helper"] == 1
        assert summ["outcome"] == {"status": "ok"}
        assert any(n["label"] == "aggregate" and n["chunks"] > 1
                   for n in summ["nodes"])
        hist = metrics.histograms_snapshot("engine.stream.")
        assert hist["engine.stream.chunk_rows"]["count"] > 1
        text = metrics.prometheus_text(prefix="engine.")
        assert "# TYPE srjt_engine_stream_chunk_rows histogram" in text
        assert metrics.snapshot("engine.")["queries"][-1]["name"] == "t"
    finally:
        metrics.restore(*saved, prefix="engine.")
