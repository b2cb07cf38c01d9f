"""The query-profile store (utils/profile.py) and the event timeline
(utils/timeline.py) of the port, against the JAX package's.

The cases of ``tests/test_profile_store.py`` and ``tests/test_timeline.py``,
with the JAX package's answer beside the port's where the two compare:

- profiles: the compact document equals JAX's for the same summary; write
  -> read is lossless; ``metrics.query()`` writes one profile a query into
  a ring bounded by ``config.profile_cap``; ``store_summary``, ``latest``
  and ``diff``; the query carries its plan and source fingerprints; a
  failed write is logged and the query still succeeds; and files cross
  between the two stores in both directions, AQE's warmed planning
  included;
- timeline: valid Chrome trace-event JSON, the same events as JAX's for the
  same calls; per-thread disjoint, well-nested spans; the ring drops the
  oldest finished events and counts them; one overflow warning a query;
  shard lanes; host-sync instants and producer -> consumer flows of a
  streamed query; and the exchange's spans, flows and per-shard receipt
  lanes on 8 shards, host path and fused stage.

Not ported: ``test_cli_list_show_diff`` (``tools/``, the profile CLI, is
not a port target).
"""

import json
import logging
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu.utils import profile as jprofile
from spark_rapids_jni_tpu.utils import timeline as jtimeline
from test_adaptive import N_DIM, warehouse  # noqa: F401
from test_torch_adaptive import warm_plan, warm_run
from test_torch_engine_dist import flags, rows, to_port

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.utils import metrics, profile, timeline

torch.set_num_threads(1)
CPU = "cpu"
FP = "deadbeefcafe" + "0" * 52
SFP = "5" * 64

# every ph code the module may emit; X carries dur, M is metadata
_PH_ALLOWED = {"X", "i", "C", "s", "f", "M"}


def _make_summary(mets, name="q", wall_scale=1.0, skew=1.25, hits=8):
    """One synthetic query summary shaped like a real engine run, made by
    ``mets`` (either package's metrics module)."""
    with mets.query(name) as qm:
        qm.fingerprint = FP
        qm.source_fingerprint = SFP
        qm.node_add(1, "Scan[fact]", wall_s=0.004 * wall_scale,
                    rows_out=4_000, chunks=4, bytes_out=64_000)
        qm.node_add(2, "Exchange(hash)", wall_s=0.006 * wall_scale,
                    rows_in=4_000, rows_out=4_000, wire_bytes=131_072)
        qm.node_set(2, "Exchange(hash)", skew=skew,
                    straggler_share=round(1 - 1 / skew, 6),
                    max_dev_rows=int(500 * skew), dev_rows=[500] * 8,
                    path="root.child")
        qm.set_decisions([{"kind": "shuffle", "side": "right",
                           "path": "root.child", "est_rows": 400}])
        qm.count("engine.exchange.wire_bytes", 131_072)
        if hits:
            qm.count("engine.build_cache.hit", hits)
        qm.count("engine.host_sync", 3)
        for v in (0.001, 0.002, 0.004, 0.032 * wall_scale):
            qm.observe("engine.stream.chunk_latency_s", v)
    return mets.recent_summaries()[-1]


def _strip(prof):
    """A compact profile without the per-process fields (qid, wall)."""
    return {k: v for k, v in prof.items() if k not in ("qid", "wall_s")}


# -- the profile store --------------------------------------------------------

def test_profile_round_trip_lossless(tmp_path):
    """write -> read keeps every gated key, and the compact document
    equals the JAX package's for the same summary."""
    summ = _make_summary(metrics, "rt")
    path = profile.write(summ, dir_path=str(tmp_path))
    prof = profile.read(path)
    assert prof["version"] == profile.VERSION == jprofile.VERSION
    assert prof["fingerprint"] == FP and prof["source_fingerprint"] == SFP
    (e,) = [x for x in prof["exchanges"] if x["label"] == "Exchange(hash)"]
    assert e["skew"] == 1.25 and e["wire_bytes"] == 131_072
    assert e["straggler_share"] == round(1 - 1 / 1.25, 6)
    assert e["max_dev_rows"] == 625 and e["dev_rows"] == [500] * 8
    live = summ["histograms"]["engine.stream.chunk_latency_s"]
    h = prof["histograms"]["engine.stream.chunk_latency_s"]
    for f in ("count", "sum", "mean", "min", "max", "p50", "p90", "p99"):
        assert h[f] == live[f], f
    assert prof["counters"]["engine.exchange.wire_bytes"] == 131_072
    assert prof["counters"]["engine.build_cache.hit"] == 8
    assert prof["counters"]["engine.host_sync"] == 3
    # the scored decision: the node at its path supplies actual_rows
    (d,) = prof["decisions"]
    assert d["actual_rows"] == 4_000 and d["misestimate"] is True
    base = os.path.basename(path)
    assert base.startswith("profile-") and base.endswith(f"-{FP[:12]}.json")
    # the same document as JAX's, under one roofline ceiling
    jsumm = _make_summary(jmetrics, "rt")
    with flags(roofline_gbps=100.0):
        assert _strip(profile.compact(summ)) == \
            _strip(jprofile.compact(jsumm))


def test_query_auto_writes_bounded_ring(tmp_path):
    """metrics.query() writes one profile a query when the store is on;
    the ring keeps only the ``profile_cap`` newest."""
    with flags(profile_dir=str(tmp_path), profile_cap=4):
        assert profile.enabled()
        for i in range(7):
            _make_summary(metrics, f"q{i}")
        paths = profile.list_profiles()
        assert len(paths) == 4
        assert [profile.read(p)["name"] for p in paths] == \
            ["q3", "q4", "q5", "q6"]           # oldest pruned
    assert not profile.enabled()


def test_store_summary_and_latest(tmp_path):
    profile.write(_make_summary(metrics, "a", skew=1.1),
                  dir_path=str(tmp_path))
    profile.write(_make_summary(metrics, "b", skew=2.5),
                  dir_path=str(tmp_path))
    s = profile.store_summary(str(tmp_path))
    assert s["profiles"] == 2
    assert s["top_exchange_skew"] == 2.5       # worst across the store
    assert s["chunk_latency_p99_s"] is not None
    assert profile.latest(FP, dir_path=str(tmp_path))["name"] == "b"
    assert profile.latest("0" * 64, dir_path=str(tmp_path)) is None
    hist = profile.history(SFP, dir_path=str(tmp_path))
    assert hist["runs"] == 2 and hist["fingerprint"] == FP
    assert hist == jprofile.history(SFP, dir_path=str(tmp_path))
    assert profile.history("", dir_path=str(tmp_path)) is None


def test_diff_flags_regression_attribution(tmp_path):
    """cand ran 3x slower with a skewed exchange, a cold cache and a
    fatter latency tail: the diff names all four causes, as JAX's does."""
    base = profile.write(_make_summary(metrics, "base"),
                         dir_path=str(tmp_path))
    cand = profile.write(_make_summary(metrics, "cand", wall_scale=3.0,
                                       skew=2.0, hits=0),
                         dir_path=str(tmp_path))
    d = profile.diff(base, cand)
    assert d["fingerprint_match"]
    kinds = {f.split(":")[0] for f in d["flags"]}
    assert {"node-slowed", "cache-hits-dropped", "exchange-skew-up",
            "p99-up"} <= kinds
    assert d == jprofile.diff(base, cand)
    text = profile.render_diff(d)
    assert "flags:" in text and "Exchange(hash)" in text
    assert text == jprofile.render_diff(d)
    clean = profile.diff(base, base)
    assert clean["flags"] == []
    assert "flags: none" in profile.render_diff(clean)


def test_profiles_cross_between_the_two_stores(tmp_path):
    """A profile the JAX store writes reads back through the port's store,
    and the reverse: same keys, same file names, same history lookup."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jpath = jprofile.write(_make_summary(jmetrics, "from-jax"),
                           dir_path=str(jdir))
    ppath = profile.write(_make_summary(metrics, "from-port"),
                          dir_path=str(pdir))
    assert profile.read(jpath) == jprofile.read(jpath)
    assert jprofile.read(ppath) == profile.read(ppath)
    assert set(profile.read(jpath)) == set(jprofile.read(ppath))
    assert profile.latest(FP, dir_path=str(jdir))["name"] == "from-jax"
    assert jprofile.latest(FP, dir_path=str(pdir))["name"] == "from-port"
    assert profile.history(SFP, dir_path=str(jdir))["runs"] == 1
    assert jprofile.history(SFP, dir_path=str(pdir))["runs"] == 1


@pytest.mark.parametrize("first", ["jax", "port"])
def test_warmed_planning_reads_the_other_store(
        warehouse, tmp_path, first):  # noqa: F811
    """Run 1 in one package writes its profile; run 2 of the same source
    plan in the other package reads it and plans the broadcast."""
    runs = {"jax": (je, jmetrics, {}), "port": (pe, metrics,
                                                {"device": CPU})}
    second = "port" if first == "jax" else "jax"
    with flags(aqe=True, metrics=True, profile_dir=str(tmp_path),
               broadcast_rows=100, shards=8):
        mod, mets, kw = runs[first]
        opt1, out1, kinds1 = warm_run(mod, mets, warehouse, "cross-1", **kw)
        mod, mets, kw = runs[second]
        opt2, out2, kinds2 = warm_run(mod, mets, warehouse, "cross-2", **kw)
    assert "broadcast" not in kinds1 and "broadcast" in kinds2
    (warm,) = [d for d in opt2._decisions
               if d.get("kind") == "adaptive:history_warmed"]
    assert (warm["est_before"], warm["est_rows"], warm["choice"]) == \
        (N_DIM, 50, "broadcast")
    assert opt1._source_fingerprint == opt2._source_fingerprint \
        == warm_plan(je, warehouse).fingerprint()
    assert rows(out1) == rows(out2)


def test_query_stamps_fingerprints_and_survives_a_failed_write(
        warehouse, tmp_path, caplog):  # noqa: F811
    """execute() stamps the plan and source fingerprints on its query; a
    profile write that fails (the store path is a file) is logged and the
    query still returns its result."""
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("x")
    plan = to_port(warm_plan(je, warehouse))
    with flags(profile_dir=str(blocker), metrics=True):
        opt = pe.optimize(plan)
        with caplog.at_level(logging.WARNING,
                             logger="spark_rapids_jni_tpu_torch"):
            out = pe.execute(opt, pe.new_stats(), device=CPU)
    assert out.num_rows == 7
    assert any("profile write failed" in r.getMessage()
               for r in caplog.records)
    summ = metrics.recent_summaries()[-1]
    assert summ["fingerprint"] == opt.fingerprint()
    assert summ["source_fingerprint"] == plan.fingerprint()


# -- the timeline -------------------------------------------------------------

@pytest.fixture
def timeline_on():
    """The timeline on, with a clean buffer, in both packages."""
    with flags(timeline=True):
        timeline.reset()
        jtimeline.reset()
        yield
    timeline.reset()
    jtimeline.reset()


def _check_trace_schema(doc):
    """Assert ``doc`` is a loadable Chrome trace-event document."""
    assert set(doc) >= {"traceEvents"}
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and evs
    for e in evs:
        assert {"name", "ph", "pid"} <= set(e), e
        assert e["ph"] in _PH_ALLOWED, e
        if e["ph"] == "M":
            continue
        assert isinstance(e["ts"], (int, float)), e
        assert "tid" in e, e
        if e["ph"] == "X":
            assert e["dur"] >= 0, e
        if e["ph"] in ("s", "f"):
            assert "id" in e, e
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)


def _shape(events):
    """Events without clocks and thread ids: what both packages record."""
    return [(e["name"], e["ph"], e.get("args"), e.get("id") is not None)
            for e in events]


def test_disabled_records_nothing():
    assert not timeline.enabled()
    timeline.reset()
    with timeline.span("off.region"):
        timeline.instant("off.mark")
        timeline.counter("off.gauge", 1.0)
    timeline.flow_start("off.flow", 1)
    timeline.flow_finish("off.flow", 1)
    assert timeline.events_snapshot() == []


def _drive(tl):
    with tl.span("outer", {"k": 1}):
        with tl.span("inner"):
            tl.instant("mark")
        tl.counter("bytes", 42.0)
    fid = tl.new_flow_base()
    tl.flow_start("hand", fid)
    tl.flow_finish("hand", fid)


def test_export_is_valid_chrome_trace(timeline_on, tmp_path):
    _drive(timeline)
    _drive(jtimeline)
    path = timeline.dump(str(tmp_path / "sub" / "trace.json"))
    with open(path) as f:
        doc = json.load(f)   # byte for byte what a trace viewer loads
    _check_trace_schema(doc)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert {"outer", "inner", "mark", "bytes", "hand"} <= set(names)
    by = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert by["outer"]["ts"] <= by["inner"]["ts"]
    assert (by["inner"]["ts"] + by["inner"]["dur"]
            <= by["outer"]["ts"] + by["outer"]["dur"] + 1e-6)
    assert _shape(timeline.events_snapshot()) == \
        _shape(jtimeline.events_snapshot())


def test_two_threads_disjoint_well_nested(timeline_on):
    """Two helper threads, each bound to its own query, record disjoint,
    well-nested event sets attributed to the right query."""
    qa = metrics.QueryMetrics("qa")
    qb = metrics.QueryMetrics("qb")
    barrier = threading.Barrier(2)

    def body(qm, label):
        with metrics.bind(qm):
            barrier.wait()
            for i in range(3):
                with timeline.span(f"{label}.outer"):
                    with timeline.span(f"{label}.inner", {"i": i}):
                        pass

    ta = threading.Thread(target=body, args=(qa, "a"), name="worker-a")
    tb = threading.Thread(target=body, args=(qb, "b"), name="worker-b")
    ta.start()
    tb.start()
    ta.join()
    tb.join()
    qa.finish()
    qb.finish()

    evs = timeline.events_snapshot()
    tids = {e["tid"] for e in evs}
    assert len(tids) == 2
    for tid in tids:
        mine = [e for e in evs if e["tid"] == tid]
        labels = {e["name"].split(".")[0] for e in mine}
        assert len(labels) == 1
        label = labels.pop()
        want_q = {"a": "qa", "b": "qb"}[label]
        assert all(e["args"]["query"] == want_q for e in mine)
        inners = [e for e in mine if e["name"].endswith(".inner")]
        outers = [e for e in mine if e["name"].endswith(".outer")]
        assert len(inners) == len(outers) == 3
        for i, o in zip(inners, outers):
            assert o["ts"] <= i["ts"]
            assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-6
    meta = {e["tid"]: e["args"]["name"]
            for e in timeline.export()["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"worker-a", "worker-b"} <= set(meta.values())


def test_ring_overflow_drops_oldest_keeps_open_span(timeline_on):
    """At the cap the ring drops the oldest events; a span open across the
    overflow closes intact (it holds no slot while open)."""
    with flags(timeline_cap=16):
        for tl in (timeline, jtimeline):
            tl.reset()
            with tl.span("survivor"):
                for i in range(40):
                    tl.instant(f"tick.{i}")
        evs = timeline.events_snapshot()
        assert len(evs) == 16
        names = [e["name"] for e in evs]
        assert names[-1] == "survivor"
        assert names[:-1] == [f"tick.{i}" for i in range(25, 40)]
        assert evs[-1]["ph"] == "X" and evs[-1]["dur"] >= 0
        assert _shape(evs) == _shape(jtimeline.events_snapshot())


def test_cap_shrink_keeps_newest_tail(timeline_on):
    for i in range(8):
        timeline.instant(f"e{i}")
    with flags(timeline_cap=16):  # the smallest cap is 16
        for i in range(8, 20):
            timeline.instant(f"e{i}")
        names = [e["name"] for e in timeline.events_snapshot()]
    assert names == [f"e{i}" for i in range(4, 20)]


def test_dropped_events_accounting(timeline_on):
    """Ring overflow is counted: dropped_events(), the metrics gauge and
    the export metadata agree, and reset() clears the tally."""
    with flags(timeline_cap=16):
        timeline.reset()
        assert timeline.dropped_events() == 0
        for i in range(16):
            timeline.instant(f"fill.{i}")
        assert timeline.dropped_events() == 0
        for i in range(5):
            timeline.instant(f"spill.{i}")
        assert timeline.dropped_events() == 5
        assert timeline.export()["otherData"]["dropped_events"] == 5
        assert metrics.gauges_snapshot("timeline")[
            "timeline.dropped_events"] == 5.0
        timeline.reset()
        assert timeline.dropped_events() == 0


def test_overflow_warns_once_per_query(timeline_on, caplog):
    """One overflow warning a query, not one an evicted event."""
    with flags(timeline_cap=16):
        timeline.reset()
        with caplog.at_level("WARNING", logger="spark_rapids_jni_tpu_torch"):
            with metrics.query("ovf"):
                for i in range(40):
                    timeline.instant(f"t.{i}")
        msgs = [r for r in caplog.records if "overflow" in r.getMessage()]
        assert len(msgs) == 1
        assert timeline.dropped_events() == 24


def test_device_lanes_and_thread_names(timeline_on):
    """``dev=`` routes events onto synthetic shard lanes named device:N."""
    timeline.complete("engine.exchange.recv", 0.0, 0.001, {"rows": 5},
                      dev=3)
    timeline.counter("engine.exchange.dev_rows", 5.0, dev=3)
    timeline.instant("host.mark")
    lane = timeline.device_lane(3)
    assert lane == jtimeline.device_lane(3) >= (1 << 48)
    evs = timeline.events_snapshot()
    assert {e["ph"] for e in evs if e["tid"] == lane} == {"X", "C"}
    host = [e for e in evs if e["name"] == "host.mark"]
    assert host and all(e["tid"] != lane for e in host)
    meta = {e["tid"]: e["args"]["name"]
            for e in timeline.export()["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert meta[lane] == "device:3"
    _check_trace_schema(timeline.export())


def _streamed_fact(path, seed, n, hi):
    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, hi, n).astype(np.int64)),
        "v": pa.array(np.round(rng.uniform(-5.0, 50.0, n), 3)),
    }), path, row_group_size=500)
    return pe.optimize(pe.Aggregate(pe.Scan(str(path), chunk_bytes=12_000),
                                    ["k"], [("v", "sum")], names=["s"]))


def test_engine_query_emits_sync_instants_and_flows(timeline_on, tmp_path):
    """A streamed, prefetched aggregate records host-sync instants and
    producer -> consumer flow arrows whose ids match across two threads."""
    plan = _streamed_fact(tmp_path / "fact.parquet", 11, 4_000, 40)
    stats = pe.new_stats()
    with metrics.query("tl-flow"):
        pe.execute(plan, stats, fused=True, prefetch=2, device=CPU)
    assert stats["chunks"] > 1
    evs = timeline.events_snapshot()
    assert any(e["name"] == "engine.host_sync" and e["ph"] == "i"
               for e in evs)
    starts = {e["id"]: e for e in evs
              if e["ph"] == "s" and e["name"] == "io.parquet.chunk"}
    finishes = {e["id"]: e for e in evs
                if e["ph"] == "f" and e["name"] == "io.parquet.chunk"}
    linked = set(starts) & set(finishes)
    assert linked
    assert all(starts[i]["tid"] != finishes[i]["tid"] for i in linked)
    assert all(starts[i]["ts"] <= finishes[i]["ts"] for i in linked)
    assert any(e["name"].startswith("engine.") for e in evs
               if e["ph"] == "X")
    _check_trace_schema(timeline.export())


def test_timeline_off_leaves_streaming_paths_clean(tmp_path):
    """Timeline and metrics off: the same streamed query runs with an
    empty timeline buffer."""
    plan = _streamed_fact(tmp_path / "f.parquet", 12, 2_000, 8)
    timeline.reset()
    with flags(metrics=False):
        pe.execute(plan, pe.new_stats(), fused=True, prefetch=2, device=CPU)
    assert timeline.events_snapshot() == []


def _exchange_events(evs):
    return sorted({(e["name"], e["ph"]) for e in evs
                   if e["name"].startswith(("engine.exchange",
                                            "engine.fused_stage"))})


@pytest.mark.parametrize("fuse_x", [False, True])
def test_exchange_spans_flows_and_shard_lanes(timeline_on, tmp_path,
                                              fuse_x):
    """A distributed group-by on 8 shards: the host path records its
    exchange span, one flow a (chunk, shard) from dispatch to that shard's
    lane, receipts and cumulative row counters on the lanes; the fused
    stage records its dispatch and compile spans.  The JAX package records
    the same kinds of exchange events for the same plan."""
    path = tmp_path / "x.parquet"
    rng = np.random.default_rng(5)
    pq.write_table(pa.table({"k": pa.array(rng.integers(0, 300, 3_000)),
                             "v": pa.array(rng.integers(0, 9, 3_000))}),
                   path)
    plan = je.Aggregate(je.Scan(path), ("k",), (("v", "sum"),), ("s",))
    with flags(shards=8, fuse_exchange=fuse_x):
        out = pe.execute(pe.optimize(to_port(plan), distribute=True),
                         pe.new_stats(), device=CPU)
        jout = je.execute(je.optimize(plan, distribute=True),
                          je.new_stats())
    assert rows(out) == rows(jout)
    evs = timeline.events_snapshot()
    _check_trace_schema(timeline.export())
    assert _exchange_events(evs) == _exchange_events(
        jtimeline.events_snapshot())
    if fuse_x:
        assert ("engine.fused_stage.dispatch", "X") in _exchange_events(evs)
        return
    starts = {e["id"] for e in evs if e["ph"] == "s"
              and e["name"] == "engine.exchange.chunk"}
    finishes = {e["id"]: e for e in evs if e["ph"] == "f"
                and e["name"] == "engine.exchange.chunk"}
    assert len(starts) == 8 and set(finishes) == starts
    lanes = {timeline.device_lane(d) for d in range(8)}
    assert {e["tid"] for e in finishes.values()} == lanes
    recv = [e for e in evs if e["name"] == "engine.exchange.recv"]
    assert {e["tid"] for e in recv} == lanes
    # the partial aggregate sends one row a group, all received
    assert sum(e["args"]["rows"] for e in recv) == out.num_rows
    total = [e for e in evs if e["name"] == "engine.exchange.dev_rows"]
    assert sum(e["args"]["value"] for e in total) == \
        sum(e["args"]["rows"] for e in recv)
