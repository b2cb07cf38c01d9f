"""Multi-tenant serving in the port: admission, fair share, budgets.

Modelled on tests/test_engine_serving.py.  The scheduler's decisions are
held against the JAX package's ``Scheduler`` on the same scenario
(admitted / queued / shed counts, the typed ``AdmissionRejectedError``,
``weight_for_objective``); the OOM ladder's session rules against the JAX
executor's on the same plan and injected fault; and over the wire, the
port's server (``--device cpu``, one slot, ``--set result_cache=8``) sheds
with the typed error carrying its trace id and bundle, answers the
sessions it admits bit for bit, and serves a repeat from the result cache.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import scheduler as jsched
from spark_rapids_jni_tpu.utils import config as jcfg
from spark_rapids_jni_tpu.utils import errors as jerrors
from spark_rapids_jni_tpu.utils import faults as jfaults
from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.engine import scheduler as psched
from spark_rapids_jni_tpu_torch.engine.recovery import RecoveryPolicy
from spark_rapids_jni_tpu_torch.utils import blackbox as pbb
from spark_rapids_jni_tpu_torch.utils import faults as pfaults
from spark_rapids_jni_tpu_torch.utils import tracing as ptracing
from spark_rapids_jni_tpu_torch.utils.config import config as pcfg
from spark_rapids_jni_tpu_torch.utils.errors import AdmissionRejectedError

torch.set_num_threads(1)

_ENV = {"max_sessions": "SRJT_MAX_SESSIONS",
        "admission_queue_s": "SRJT_ADMISSION_QUEUE_S",
        "admission_burn": "SRJT_ADMISSION_BURN",
        "session_budget_bytes": "SRJT_SESSION_BUDGET_BYTES",
        "faults": "SRJT_FAULTS", "slo_ms": "SRJT_SLO_MS"}


@pytest.fixture
def both(monkeypatch):
    """Set the same serving knobs on both packages: the port's ``config``
    fields and the JAX package's environment; restored after."""
    saved = {k: getattr(pcfg, k) for k in (*_ENV, "shards")}

    def _set(**kw):
        for k, v in kw.items():
            setattr(pcfg, k, v)
            if k in _ENV:
                monkeypatch.setenv(_ENV[k], str(v))
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


@pytest.fixture
def warehouse(tmp_path):
    n = 40_000
    path = str(tmp_path / "fact.parquet")
    pq.write_table(pa.table({
        "k": pa.array((np.arange(n) % 13).astype(np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    }), path, row_group_size=4096)
    return path


def _counts(stats: dict) -> tuple:
    return (stats["admitted"], stats["queued"], stats["shed"],
            stats["live"], stats["max_sessions"])


# -- admission ----------------------------------------------------------------

def _queue_then_admit(mod):
    sched = mod.Scheduler()
    first = sched.admit(fingerprint="a" * 16, trace_id="t-hold")
    got = {}

    def queued():
        s = sched.admit(fingerprint="b" * 16, trace_id="t-wait")
        got["s"] = s
        s.release()

    t = threading.Thread(target=queued)
    t.start()
    time.sleep(0.15)
    parked = "s" not in got
    first.release()
    t.join(timeout=10)
    assert not t.is_alive()
    return parked, got["s"].queued_s, sched.stats()


def test_admission_queue_then_admit_matches_jax(both):
    both(max_sessions=1, admission_queue_s=10)
    for mod in (psched, jsched):
        parked, queued_s, st = _queue_then_admit(mod)
        assert parked and queued_s > 0.05
        assert _counts(st) == (2, 1, 0, 0, 1), mod.__name__


def test_admission_shed_on_queue_timeout_matches_jax(both):
    both(max_sessions=1, admission_queue_s=0.15)
    pbb.reset()
    for mod, exc_type in ((psched, AdmissionRejectedError),
                          (jsched, jerrors.AdmissionRejectedError)):
        sched = mod.Scheduler()
        hold = sched.admit(fingerprint="a" * 16, trace_id="t-hold")
        t0 = time.monotonic()
        with pytest.raises(exc_type, match="queue-timeout") as ei:
            sched.admit(fingerprint="b" * 16, trace_id="t-shed")
        assert time.monotonic() - t0 >= 0.1
        assert ei.value.kind == "resource" and ei.value.retryable is False
        hold.release()
        assert _counts(sched.stats()) == (1, 1, 1, 0, 1)
    shed = [e for e in pbb.tail() if e["ev"] == "admission.shed"]
    assert shed and shed[-1]["trace_id"] == "t-shed"
    assert shed[-1]["reason"] == "queue-timeout"


def test_admission_shed_immediately_on_slo_burn_matches_jax(both,
                                                            monkeypatch):
    both(max_sessions=1, admission_queue_s=30, admission_burn=0.9)
    for mod in (psched, jsched):
        monkeypatch.setattr(mod.blackbox, "slo_burn_for",
                            lambda fp, dir_path=None: 1.0)
        sched = mod.Scheduler()
        hold = sched.admit(fingerprint="a" * 16, trace_id="t-hold")
        t0 = time.monotonic()
        with pytest.raises(Exception, match="slo-burn 1.00") as ei:
            sched.admit(fingerprint="b" * 16, trace_id="t-burn")
        assert type(ei.value).__name__ == "AdmissionRejectedError"
        assert time.monotonic() - t0 < 5.0
        hold.release()
        assert _counts(sched.stats()) == (1, 0, 1, 0, 1)


def test_weight_for_objective_matches_jax():
    for ms in (None, 0, -5, 1.0, 99.0, 250.0, 251.0, 999.0, 1000.0,
               2000.0, 2001.0, 1e9):
        assert psched.weight_for_objective(ms) == \
            jsched.weight_for_objective(ms), ms


# -- fair share ---------------------------------------------------------------

def test_fair_share_rounds_and_no_deadlock(both):
    both(max_sessions=4)
    sched = psched.Scheduler()
    sessions = [sched.admit(fingerprint=f"{i}" * 16, trace_id=f"t{i}")
                for i in range(3)]
    done = []

    def spin(s, n):
        for _ in range(n):
            s.gate()
        done.append(s.sid)
        s.release()

    ts = [threading.Thread(target=spin, args=(s, n))
          for s, n in zip(sessions, (5, 60, 120))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert sorted(done) == [s.sid for s in sessions]
    st = sched.stats()
    assert st["live"] == 0 and st["rounds"] >= 1


def test_point_query_not_starved_by_scan(both):
    """Deficit round robin: a point query with a tight objective (weight 8)
    beside a bulk scan (weight 1) finishes its chunks while the scan still
    has most of its own left; the scan cannot hold the device in between."""
    point_fp, scan_fp = "p" * 16, "s" * 16
    both(max_sessions=4, slo_ms=f"2000,{point_fp[:12]}=250")
    sched = psched.Scheduler()
    scan = sched.admit(fingerprint=scan_fp, trace_id="t-scan")
    point = sched.admit(fingerprint=point_fp, trace_id="t-point")
    assert (point.weight, scan.weight) == (8, 1)
    scan_done = [0]
    left_at_point_end = []
    stop = threading.Event()

    def run_scan():
        for _ in range(400):
            scan.gate()
            scan_done[0] += 1
            time.sleep(0.0005)  # a chunk's work
        stop.set()

    def run_point():
        for _ in range(40):
            point.gate()
            time.sleep(0.0005)
        left_at_point_end.append(400 - scan_done[0])
        point.release()

    ts = [threading.Thread(target=run_scan),
          threading.Thread(target=run_point)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts) and stop.is_set()
    # 40 point chunks at 32 a round (quantum 4 x weight 8) take two
    # rounds, in which the scan gets 4 chunks a round
    assert left_at_point_end[0] >= 300, left_at_point_end
    scan.release()
    assert sched.stats()["rounds"] >= 1


def test_single_session_gate_is_free(both):
    both(max_sessions=4)
    sched = psched.Scheduler()
    s = sched.admit(fingerprint="a" * 16, trace_id="t-solo")
    t0 = time.perf_counter()
    for _ in range(10_000):
        s.gate()
    assert time.perf_counter() - t0 < 2.0
    assert sched.stats()["rounds"] == 0
    s.release()


# -- session budgets ----------------------------------------------------------

def test_session_budget_ledger_matches_jax(both):
    both(session_budget_bytes=8 << 20)
    out = []
    for mod in (psched, jsched):
        sched = mod.Scheduler()
        sess = sched.admit(fingerprint="clamp" * 3 + "x", trace_id="t-b")
        sess.charge(5 << 20)
        sess.charge(1 << 20)   # the peak chunk is what the budget bounds
        row = (sess.budget_remaining(), sess.over_budget(),
               sess.charged_chunks, sess.peak_chunk_bytes)
        sess.charge(9 << 20)
        out.append(row + (sess.over_budget(), sess.budget_remaining()))
        sess.release()
    assert out[0] == out[1] == (3 << 20, False, 2, 5 << 20, True, 0)
    sched = psched.Scheduler()
    sess = sched.admit(fingerprint="c" * 16, trace_id="t-c")
    sess.charge(5 << 20)
    assert RecoveryPolicy(session=sess).session_budget_remaining() == 3 << 20
    assert RecoveryPolicy().session_budget_remaining() is None
    sess.release()


def _exchange_plan(mod, path):
    return mod.Aggregate(mod.plan.Exchange(mod.Scan(path, chunk_bytes=1 << 16),
                                           ["k"]),
                         ["k"], [("v", "sum")], names=["s"])


def _groups(t) -> dict:
    """key -> aggregate of a two-column result (named or exported)."""
    return dict(zip(t.columns[0].to_pylist(), t.columns[1].to_pylist()))


def test_spilled_exchange_rung_clamps_to_session_budget(tmp_path, both,
                                                        monkeypatch):
    """Every dispatch of the hash exchange runs out of memory, so the
    ladder reaches the spilled rung: an unscheduled query sizes the spill
    passes at half the table (over 3 MiB), a session with 2 MiB of budget
    left at 2 MiB; both answers equal the clean run."""
    from spark_rapids_jni_tpu_torch.parallel import spill
    n = 400_000
    path = str(tmp_path / "big.parquet")
    pq.write_table(pa.table({
        "k": pa.array((np.arange(n) % 13).astype(np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    }), path, row_group_size=1 << 16)
    seen = []
    real = spill.shuffle_table_spilled

    def spy(*a, **kw):
        seen.append(kw["hbm_budget_bytes"])
        return real(*a, **kw)

    monkeypatch.setattr(spill, "shuffle_table_spilled", spy)
    plan = _exchange_plan(pe, path)
    both(shards=2)
    want = _groups(pe.execute(plan, device="cpu"))
    both(shards=2, faults="exchange.dispatch:*:oom",
         session_budget_bytes=8 << 20)
    s0: dict = {}
    assert _groups(pe.execute(plan, stats=s0, device="cpu")) == want
    sched = psched.Scheduler()
    sess = sched.admit(fingerprint="sp" * 8, trace_id="t-spill")
    sess.charge(6 << 20)
    s1: dict = {}
    got = pe.execute(plan, stats=s1, session=sess, device="cpu")
    sess.release()
    assert _groups(got) == want
    for st in (s0, s1):
        assert [d["step"] for d in st["degradations"]][:2] == \
            ["exchange-halved", "exchange-spilled"]
    assert len(seen) == 2 and seen[0] > 3 << 20 and seen[1] == 2 << 20


def test_neighbour_pressure_retry_matches_jax(warehouse, both):
    """One injected OOM at the first exchange dispatch: a session within
    its own budget retries the rung once (no degradation), an over-budget
    session and an unscheduled query step down to the halved rung, in
    both packages; every result equals the clean run."""
    both(shards=2)
    plans = {"port": _exchange_plan(pe, warehouse),
             "jax": _exchange_plan(je, warehouse)}
    run = {"port": lambda p, **kw: pe.execute(p, device="cpu", **kw),
           "jax": je.execute}
    scheds = {"port": psched.Scheduler(), "jax": jsched.Scheduler()}
    base = {k: _groups(run[k](plans[k])) for k in run}
    assert base["port"] == base["jax"]
    steps = {}
    for k in run:
        before = ptracing.counter_value("engine.sched.neighbor_pressure")
        both(shards=2, faults="exchange.dispatch:1:oom",
             session_budget_bytes=1 << 30)
        sess = scheds[k].admit(fingerprint="bgt" * 5 + "a",
                               trace_id="t-budget")
        s1: dict = {}
        out = run[k](plans[k], stats=s1, session=sess)
        sess.release()
        assert _groups(out) == base[k]
        if k == "port":
            assert ptracing.counter_value(
                "engine.sched.neighbor_pressure") == before + 1
        both(shards=2, faults="exchange.dispatch:1:oom",
             session_budget_bytes=1024)
        sess2 = scheds[k].admit(fingerprint="bgt" * 5 + "b",
                                trace_id="t-over")
        sess2.charge(1 << 20)
        assert sess2.over_budget()
        s2: dict = {}
        assert _groups(run[k](plans[k], stats=s2, session=sess2)) == base[k]
        sess2.release()
        both(shards=2, faults="exchange.dispatch:1:oom",
             session_budget_bytes=0)
        s3: dict = {}
        assert _groups(run[k](plans[k], stats=s3)) == base[k]
        steps[k] = [[d["step"] for d in s.get("degradations", [])]
                    for s in (s1, s2, s3)]
    assert steps["port"] == steps["jax"] == \
        [[], ["exchange-halved"], ["exchange-halved"]]


# -- over the wire ------------------------------------------------------------

@pytest.fixture(scope="module")
def one_slot_server(tmp_path_factory):
    from spark_rapids_jni_tpu.bridge import BridgeClient
    from spark_rapids_jni_tpu_torch.bridge import spawn_server
    root = tmp_path_factory.mktemp("torch_serving")
    sock = str(root / "tpub.sock")
    proc = spawn_server(sock, device="cpu", settings={
        "max_sessions": 1, "admission_queue_s": 0.05, "result_cache": 8,
        "blackbox_dir": str(root / "bb"),
        "faults": "parquet.chunk:*:timeout"})
    n = 30_000
    pq.write_table(pa.table({
        "k": pa.array((np.arange(n) % 5).astype(np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    }), root / "fact.parquet", row_group_size=2048)
    yield sock, proc, root
    try:
        BridgeClient(sock).shutdown_server()
    except (OSError, RuntimeError):
        proc.kill()
    proc.wait(timeout=30)


def test_bridge_shed_carries_trace_and_bundle(one_slot_server):
    """Six clients at a one-slot server with a 50 ms queue: some run, the
    rest are shed with the typed error (kind resource, not retryable)
    carrying the trace id and a post-mortem bundle; every answer is the
    JAX package's in-process result."""
    from spark_rapids_jni_tpu.bridge import BridgeClient
    from spark_rapids_jni_tpu.engine import (Aggregate, Filter, Scan, col,
                                             lit)
    from spark_rapids_jni_tpu.utils import blackbox as jbb
    sock, proc, root = one_slot_server
    plan = Aggregate(Scan(root / "fact.parquet", chunk_bytes=1 << 14),
                     ["k"], [("v", "sum")], names=["s"])
    plans = [plan if i == 0 else Filter(plan, (">", col("s"), lit(i)))
             for i in range(6)]
    sheds, oks = [], {}

    def run(i):
        c = BridgeClient(sock)
        try:
            hs = c.execute_plan(plans[i])
            oks[i] = c.export_table(hs[0])
            for h in hs:
                c.release(h)
        except jerrors.AdmissionRejectedError as e:
            sheds.append((c.trace_id, e))
        finally:
            c.close()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert oks and sheds
    for tid, e in sheds:
        assert e.kind == "resource" and e.retryable is False
        assert e.trace_id == tid
        doc = jbb.read_bundle(e.bundle_path)
        assert doc["trace_id"] == tid
        assert doc["error"]["type"] == "AdmissionRejectedError"
    for i, got in oks.items():
        want = je.execute(je.optimize(plans[i]))
        assert _groups(got) == _groups(want)
    assert proc.poll() is None


def test_bridge_result_cache_from_setting(one_slot_server):
    """``--set result_cache=8``: a repeat of a finished plan over the same
    file is served from the cache, equal to the first answer."""
    from spark_rapids_jni_tpu.bridge import BridgeClient
    from spark_rapids_jni_tpu.engine import Aggregate, Scan
    sock, _, root = one_slot_server
    c = BridgeClient(sock)
    plan = Aggregate(Scan(root / "fact.parquet"), ["k"], [("v", "count")],
                     names=["s"])
    h1 = c.execute_plan(plan)
    before = c.serving_stats()["result_cache"]
    assert before["size"] >= 1
    h2 = c.execute_plan(plan)
    after = c.serving_stats()
    assert after["result_cache"]["hits"] == before["hits"] + 1
    assert c.metrics()["last_plan"].get("served_from_cache") is True
    t1, t2 = (c.export_table(h) for h in (h1[0], h2[0]))
    assert _groups(t1) == _groups(t2) == {k: 6000 for k in range(5)}
    for h in h1 + h2:
        c.release(h)
    c.close()


def test_memory_scope_budget_and_census(tmp_path, both, capsys):
    """The memory census: a session's budget is the scheduler's (the
    tests above), and ``MemoryScope`` only keeps marks: a CPU scope reads
    no allocator, and the chunked reader under ``config.mem_debug`` yields
    the same chunks and reports its scope's marks."""
    from spark_rapids_jni_tpu_torch.io import ParquetChunkedReader
    from spark_rapids_jni_tpu_torch.utils import memory
    assert memory.device_memory_stats("cpu") == {}
    assert memory.live_bytes("cpu") == 0
    with memory.MemoryScope("cpu", device="cpu") as scope:
        assert scope.checkpoint() == 0
    assert (scope.stats.start_bytes, scope.stats.high_water_bytes,
            scope.stats.delta_bytes) == (0, 0, 0)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": pa.array(np.arange(5000, dtype=np.int64))}),
                   path, row_group_size=1000)
    plain = [c.columns[0].to_pylist() for c in
             ParquetChunkedReader(path, pass_read_limit=4096, device="cpu")]
    saved = pcfg.mem_debug
    pcfg.mem_debug = True
    try:
        traced = [c.columns[0].to_pylist() for c in
                  ParquetChunkedReader(path, pass_read_limit=4096,
                                       device="cpu")]
    finally:
        pcfg.mem_debug = saved
    assert traced == plain and len(plain) >= 5
    assert "[mem] parquet_chunked: start=0 high=0 end=0" in \
        capsys.readouterr().err
