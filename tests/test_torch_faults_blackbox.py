"""Fault seams and the flight recorder of the port, against the JAX package.

Modelled on tests/test_recovery.py and tests/test_blackbox.py:

- ``faults.parse`` gives the JAX package's rules on the same specs and
  rejects the same bad ones; the sites are the same seven;
- each seam fires at its site in the port, and the run recovers (retry or
  degradation rung) to the clean run's result, with the same retry count
  and the same rungs as the JAX package on the same plan and spec;
- the ring, the post-mortem bundles and the SLO burn report hold the same
  contents as the JAX package's on the same events and profile history;
- over a bridge connection (the port's server in a thread, ``device="cpu"``)
  a failing plan returns the typed error with the client's trace id and a
  bundle that names it, and the timeline's events carry trace ids.
"""

import json
import os
import socket
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.utils import blackbox as jbb
from spark_rapids_jni_tpu.utils import config as jcfg
from spark_rapids_jni_tpu.utils import errors as jerrors
from spark_rapids_jni_tpu.utils import faults as jfaults
from spark_rapids_jni_tpu.utils import tracing as jtracing
from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.bridge import protocol as P
from spark_rapids_jni_tpu_torch.utils import blackbox as pbb
from spark_rapids_jni_tpu_torch.utils import errors as perrors
from spark_rapids_jni_tpu_torch.utils import faults as pfaults
from spark_rapids_jni_tpu_torch.utils import metrics as pmetrics
from spark_rapids_jni_tpu_torch.utils import timeline as ptimeline
from spark_rapids_jni_tpu_torch.utils import tracing as ptracing
from spark_rapids_jni_tpu_torch.utils.config import config as pcfg

torch.set_num_threads(1)

_ENV = {"faults": "SRJT_FAULTS", "retry_backoff_s": "SRJT_RETRY_BACKOFF_S",
        "device_decode": "SRJT_DEVICE_DECODE", "blackbox_cap":
        "SRJT_BLACKBOX_CAP", "slo_ms": "SRJT_SLO_MS",
        "blackbox_dir": "SRJT_BLACKBOX_DIR", "profile_dir":
        "SRJT_PROFILE_DIR", "timeline": "SRJT_TIMELINE"}


@pytest.fixture
def both(monkeypatch):
    """Set the same knobs on the port's ``config`` and the JAX package's
    environment (booleans as 1/0); restored after, rings emptied."""
    saved = {k: getattr(pcfg, k) for k in (*_ENV, "shards")}
    pbb.reset()
    jbb.reset()

    def _set(**kw):
        for k, v in kw.items():
            setattr(pcfg, k, v)
            if k in _ENV:
                monkeypatch.setenv(_ENV[k], str(int(v) if isinstance(v, bool)
                                                 else v))
        jcfg.refresh()
        jfaults.reset()
        pfaults.reset()
    yield _set
    for k, v in saved.items():
        setattr(pcfg, k, v)
    for var in _ENV.values():
        monkeypatch.delenv(var, raising=False)
    jcfg.refresh()
    jfaults.reset()
    pfaults.reset()
    pbb.reset()
    jbb.reset()


@pytest.fixture
def warehouse(tmp_path):
    n = 40_000
    path = str(tmp_path / "fact.parquet")
    pq.write_table(pa.table({
        "k": pa.array((np.arange(n) % 13).astype(np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    }), path, row_group_size=4096, compression="snappy",
        use_dictionary=False)
    return path


# -- the spec grammar ---------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "parquet.chunk:3:io_error,exchange.dispatch:1:oom",
    "spill.write:2",
    "bridge.op:*:timeout",
    "parquet.chunk:1,parquet.chunk:4:oom",
    " staging.transfer:1:oom , parquet.prefetch:*:io_error ,",
    "parquet.device_decode:2:timeout",
    "",
])
def test_parse_matches_jax(spec):
    assert pfaults.parse(spec) == jfaults.parse(spec)


@pytest.mark.parametrize("bad", [
    "nosuch.site:1", "parquet.chunk:0", "parquet.chunk:x",
    "parquet.chunk:1:nosuchkind", "parquet.chunk", ":::",
])
def test_parse_rejects_as_jax(bad):
    with pytest.raises(pfaults.FaultSpecError):
        pfaults.parse(bad)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.parse(bad)


def test_sites_and_inert_seams():
    assert pfaults.SITES == jfaults.SITES and len(pfaults.SITES) == 7
    assert not pcfg.faults
    before = ptracing.counters_snapshot("faults.")
    for site in pfaults.SITES:
        pfaults.check(site)
    assert ptracing.counters_snapshot("faults.") == before


def test_injected_oom_is_resource_like_a_card_oom():
    e = pfaults.InjectedResourceExhausted("x")
    assert perrors.classify(e) == ("resource", False)
    assert perrors.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == \
        ("resource", False)
    assert perrors.classify(pfaults.InjectedIOError("x")) == \
        ("transient", True)


# -- each seam at its site ----------------------------------------------------

def _agg_plan(mod, path, exchange=False):
    scan = mod.Scan(path, chunk_bytes=1 << 16)
    child = mod.plan.Exchange(scan, ["k"]) if exchange else scan
    return mod.Aggregate(child, ["k"], [("v", "sum")], names=["s"])


def _groups(t) -> dict:
    return dict(zip(t.columns[0].to_pylist(), t.columns[1].to_pylist()))


SEAMS = [
    # (spec, settings, exchange, retry site or None, rungs)
    ("parquet.chunk:2:io_error", {}, False, "parquet.chunk", []),
    ("parquet.prefetch:2:oom", {}, False, None, ["stream-interpreted"]),
    ("parquet.device_decode:1:io_error", {"device_decode": True}, False,
     "parquet.device_decode", []),
    ("staging.transfer:1:oom", {}, False, None, ["stream-interpreted"]),
    ("exchange.dispatch:1:io_error", {"shards": 2}, True,
     "exchange.dispatch", []),
    ("exchange.dispatch:1:oom", {"shards": 2}, True, None,
     ["exchange-halved"]),
    ("exchange.dispatch:*:oom,spill.write:1:io_error", {"shards": 2}, True,
     "spill.write", ["exchange-halved", "exchange-spilled"]),
]


@pytest.mark.parametrize("spec,settings,exchange,site,rungs", SEAMS,
                         ids=[s[0] for s in SEAMS])
def test_seam_fires_and_recovers_as_jax(warehouse, both, spec, settings,
                                        exchange, site, rungs):
    seam = spec.split(",")[-1].split(":")[0]
    both(retry_backoff_s=0.001, **settings)
    runs = {"port": (_agg_plan(pe, warehouse, exchange),
                     lambda p, **kw: pe.execute(p, device="cpu", **kw),
                     ptracing),
            "jax": (_agg_plan(je, warehouse, exchange), je.execute,
                    jtracing)}
    for name, (plan, run, tr) in runs.items():
        both(faults="")
        base = _groups(run(plan))
        both(faults=spec)
        fired = tr.counters_snapshot(f"faults.injected.{seam}")
        retried = tr.counter_value(f"engine.retries.{site}") if site else 0
        stats: dict = {}
        got = _groups(run(plan, stats=stats))
        assert got == base, name
        assert sum(tr.counters_snapshot(
            f"faults.injected.{seam}").values()) > sum(fired.values()), name
        assert [d["step"] for d in stats.get("degradations", [])] == \
            rungs, name
        if site:
            assert tr.counter_value(f"engine.retries.{site}") == \
                retried + 1, name


def test_bridge_op_seam_errors_one_op(tmp_path, both):
    """``bridge.op:2:io_error``: the second op of the server comes back as
    the typed transient error; the ops around it succeed."""
    both(faults="bridge.op:2:io_error")
    sock, st = _serve(tmp_path, "op.sock")
    from spark_rapids_jni_tpu_torch.bridge import BridgeClient
    c = BridgeClient(sock, device="cpu")
    try:
        c.ping()
        with pytest.raises(perrors.TransientError, match="bridge.op#2"):
            c.ping()
        c.ping()
        assert c.live_count() == 0
    finally:
        c.shutdown_server()
        st.join(timeout=10)
    assert not st.is_alive()


# -- the flight recorder ------------------------------------------------------

def _plain(evs):
    return [{k: v for k, v in e.items() if k not in ("seq", "t", "thread")}
            for e in evs]


def _record_same(bb, tid):
    with bb.query_scope(tid, label="parity"):
        bb.record("exchange", kind="hash", rows=7)
        bb.record("retry", site="parquet.chunk", attempt=1,
                  kind="transient")
        with bb.query_scope("f" * 32, label="inner"):
            bb.record("degrade", step="exchange-halved", kind="resource")


def test_ring_matches_jax(both):
    both(blackbox_cap=16)
    tid = "ab" * 16
    for bb in (pbb, jbb):
        _record_same(bb, tid)
        for i in range(40):
            bb.record("tick", i=i)
    assert _plain(pbb.tail()) == _plain(jbb.tail())
    assert [e["i"] for e in pbb.tail()] == list(range(24, 40))
    assert pbb.ring_stats() == jbb.ring_stats() == \
        {"events": 16, "cap": 16, "drops": 29}
    both(blackbox_cap=512)
    pbb.reset()
    jbb.reset()
    for bb in (pbb, jbb):
        _record_same(bb, tid)
    assert _plain(pbb.tail()) == _plain(jbb.tail())
    assert [e["ev"] for e in pbb.tail()] == [
        "query.begin", "exchange", "retry", "degrade", "query.end"]
    assert all(e["trace"] == tid for e in pbb.tail())


def test_bundles_match_jax(tmp_path, both):
    docs = {}
    for name, bb, errs in (("port", pbb, perrors), ("jax", jbb, jerrors)):
        d = str(tmp_path / name)
        with bb.query_scope("cd" * 16, label="pm") as s:
            bb.record("retry", site="parquet.chunk", attempt=1,
                      kind="transient")
            p1 = bb.post_mortem("degrade:exchange-halved", dir_path=d)
            e = errs.TransientError("boom")
            p2 = bb.post_mortem("engine.execute:transient", exc=e,
                                dir_path=d)
        assert p1 and p2 == p1 and bb.list_bundles(d) == [p1]
        assert e.trace_id == s.trace_id and e.bundle_path == p1
        assert bb.last_bundle(s.trace_id) == p1
        docs[name] = bb.read_bundle(p1)
    a, b = docs["port"], docs["jax"]
    assert set(a) == set(b)
    for k in ("version", "reason", "trace_id", "faults", "progress"):
        assert a[k] == b[k], k
    assert _plain(a["ring"]) == _plain(b["ring"])
    assert a["ring_stats"] == b["ring_stats"]


def _put_profile(d, seq, fp, wall_s, err=False):
    doc = {"fingerprint": fp, "source_fingerprint": fp, "wall_s": wall_s}
    if err:
        doc["outcome"] = {"status": "error"}
    with open(os.path.join(d, f"profile-{seq:020d}-{fp[:12]}.json"),
              "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("slo", ["500,eeeeffff=200", "eeeeffff=200",
                                 " 500 , ab12cd=200 , bogus=x , 250 ", ""])
def test_slo_burn_matches_jax(tmp_path, both, slo):
    d = str(tmp_path / "prof")
    os.makedirs(d)
    fp_a, fp_e = "aaaabbbbccccdddd", "eeeeffff00001111"
    _put_profile(d, 1, fp_a, 0.1)
    _put_profile(d, 2, fp_a, 0.9)
    _put_profile(d, 3, fp_a, 0.2, err=True)
    _put_profile(d, 4, fp_e, 0.3)
    both(slo_ms=slo, profile_dir=d)
    assert pbb.slo_targets() == jbb.slo_targets()
    assert pbb.slo_report(d) == jbb.slo_report(d)
    for fp in (fp_a, fp_e, "0" * 16):
        assert pbb.slo_burn_for(fp, d) == jbb.slo_burn_for(fp, d)
        assert pbb.slo_objective_for(fp) == jbb.slo_objective_for(fp)
    text = pmetrics.prometheus_text()
    if slo.startswith("500,"):
        assert "srjt_slo_default_objective_ms 500" in text
        assert 'srjt_slo_burn_rate{fingerprint="aaaabbbbcccc"} 0.6667' in text


# -- over a bridge connection -------------------------------------------------

def _serve(tmp_path, name):
    from spark_rapids_jni_tpu_torch.bridge.server import BridgeServer
    sock = str(tmp_path / name)
    ready = threading.Event()
    st = threading.Thread(target=BridgeServer(sock, "cpu").serve_forever,
                          args=(ready,), daemon=True)
    st.start()
    assert ready.wait(10)
    return sock, st


def test_failing_plan_execute_joins_bundle(tmp_path, warehouse, both):
    """Typed exception, post-mortem bundle and profile entry all carry the
    client's trace id."""
    from spark_rapids_jni_tpu_torch.bridge import BridgeClient
    from spark_rapids_jni_tpu_torch.utils import profile
    bb, prof = str(tmp_path / "bb"), str(tmp_path / "profiles")
    both(faults="parquet.chunk:*:io_error", retry_backoff_s=0.001,
         blackbox_dir=bb, profile_dir=prof)
    sock, st = _serve(tmp_path, "fail.sock")
    c = BridgeClient(sock, device="cpu")
    try:
        with pytest.raises(perrors.TransientError) as ei:
            c.execute_plan(_agg_plan(pe, warehouse))
        err = ei.value
        assert err.trace_id == c.trace_id
        bundles = pbb.list_bundles(bb)
        assert len(bundles) == 1
        doc = pbb.read_bundle(bundles[0])
        assert doc["trace_id"] == c.trace_id
        assert doc["error"]["type"] == "InjectedIOError"
        assert doc["error"]["kind"] == "transient"
        assert "traceback" in doc["error"]
        assert os.path.basename(err.bundle_path) == \
            os.path.basename(bundles[0])
        profs = [profile.read(p) for p in profile.list_profiles(prof)]
        hit = [p for p in profs if p.get("trace_id") == c.trace_id]
        assert hit and hit[0]["outcome"]["status"] == "error"
        assert c.live_count() == 0
    finally:
        c.shutdown_server()
        st.join(timeout=10)


def test_server_answers_v1_with_v1_and_mirrors_v2(tmp_path, both):
    sock_path, st = _serve(tmp_path, "compat.sock")
    raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    raw.connect(sock_path)
    try:
        P.send_msg(raw, P.OP_PING)
        assert P.recv_frame(raw) == (P.STATUS_OK, b"pong", "", "")
        tid, sid = pbb.new_trace_id(), pbb.new_span_id()
        P.send_msg(raw, P.OP_PING, trace=(tid, sid))
        status, _, rtid, rsid = P.recv_frame(raw)
        assert (status, rtid, rsid) == (P.STATUS_OK, tid, sid)
    finally:
        raw.close()
        from spark_rapids_jni_tpu_torch.bridge import BridgeClient
        BridgeClient(sock_path, device="cpu").shutdown_server()
        st.join(timeout=10)


def test_timeline_carries_trace_ids(tmp_path, warehouse, both):
    """Timeline events recorded inside a query's trace scope carry its
    trace id: a plan run over the bridge (the client's id) and a direct
    ``execute`` (the minted id of its scope)."""
    from spark_rapids_jni_tpu_torch.bridge import BridgeClient
    both(timeline=True)
    ptimeline.reset()
    sock, st = _serve(tmp_path, "tl.sock")
    c = BridgeClient(sock, device="cpu")
    try:
        for h in c.execute_plan(_agg_plan(pe, warehouse)):
            c.release(h)
        traced = [e for e in ptimeline.events_snapshot()
                  if (e.get("args") or {}).get("trace") == c.trace_id]
        assert traced, ptimeline.events_snapshot()[:3]
    finally:
        c.shutdown_server()
        st.join(timeout=10)
    ptimeline.reset()
    with pbb.query_scope("12" * 16):
        pe.execute(_agg_plan(pe, warehouse), device="cpu")
    evs = ptimeline.events_snapshot()
    assert evs and all((e.get("args") or {}).get("trace") == "12" * 16
                       for e in evs if e.get("ph") != "M")
    ptimeline.reset()
