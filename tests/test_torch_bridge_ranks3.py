"""Concurrent plans over the ranked server: 2 gloo ranks on the CPU.

One server for the file (``--ranks 2 --backend gloo --devices cpu,cpu
--set distribute=true --set shards=8 --set result_cache=8``), started in
the background while the JAX side works.  Plans in flight share the
group's turn, which rank 0 passes at the votes of chunk boundaries and at
each plan's closing report (bridge/ranked.py):

- five distinct plans over five concurrent connections give their serial
  answers and the JAX server's, bit for bit (the counterpart of
  tests/test_engine_serving.py::test_bridge_concurrent_sessions_bit_exact),
  and each one's report (launches, row groups read, exchanges) is the one
  it gave alone;
- a point query submitted during a scan of 64 KiB chunks returns before
  the scan does, and the turn passed to it and back (``handoffs``);
- rank 0's pick gives a weight-8 session 8 times the turns of a weight-1
  session in a round and never stalls (the counterpart of
  tests/test_torch_serving.py::test_fair_share_rounds_and_no_deadlock),
  rank 0's decisions apply in its order whichever thread receives them,
  and a seat counts the launches made while its plan held the turn;
- OP_CANCEL of one of two plans in flight stops it on every rank, the
  other's answer is exact and the group serves on;
- a resubmission during another plan hits the plan cache on every rank;
- the fuzzer's plans at random arrival times give JAX's answers;
- last, SIGKILL of rank 1 with two plans in flight: both get
  ``RankGroupLostError``, the small ops and the result cache serve on,
  and shutdown leaves no rank process.
"""

import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import fuzz
from test_torch_engine_fuzz import frame

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.bridge import BridgeClient, ranked, \
    spawn_server
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.engine import scheduler as psched
from spark_rapids_jni_tpu_torch.engine.plan import Filter, Scan, col, lit
from spark_rapids_jni_tpu_torch.parallel import ranks as pranks
from spark_rapids_jni_tpu_torch.utils import errors, tracing

torch.set_num_threads(1)
SETTINGS = {"distribute": "true", "shards": 8, "result_cache": 8}
SCAN_CHUNK = 1 << 16     # the scan a point query interleaves with
FUZZ_CASES = (0, 3, 9, 10)   # the JAX side compiles these in seconds


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The serving test's fact (20,000 rows in 4,096-row groups), a fact
    of 40 row groups that 64 KiB chunks read in a few hundred chunks, and
    a small table for point queries."""
    root = tmp_path_factory.mktemp("ranks3_files")
    n = 20_000
    pq.write_table(pa.table({
        "k": pa.array((np.arange(n) % 7).astype(np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64))}),
        root / "fact.parquet", row_group_size=4096)
    rng = np.random.default_rng(11)
    n = 1_600_000
    pq.write_table(pa.table({"k": pa.array(rng.integers(0, 50, n)),
                             "v": pa.array(rng.integers(0, 100, n))}),
                   root / "big.parquet", row_group_size=40_000)
    pq.write_table(pa.table({"id": pa.array(np.arange(64, dtype=np.int64)),
                             "w": pa.array(np.arange(64, dtype=np.int64)
                                           * 3)}),
                   root / "small.parquet")
    return root


@pytest.fixture(scope="module")
def server(tmp_path_factory, files):
    """The port's ranked server and the JAX server, started together in
    the background."""
    from spark_rapids_jni_tpu.bridge import spawn_server as jax_spawn
    d = tmp_path_factory.mktemp("ranks3_server")
    pool = ThreadPoolExecutor(2)
    sock, jsock = str(d / "s.sock"), str(d / "jax.sock")
    # one intra-op thread a rank: two ranks' thread pools on one host's
    # cores slow a chunk's sort tenfold
    fut = pool.submit(spawn_server, sock, device="cpu", settings=SETTINGS,
                      ranks=2, backend="gloo", devices=["cpu", "cpu"],
                      env={"OMP_NUM_THREADS": "1"})
    jfut = pool.submit(jax_spawn, jsock)
    yield {"sock": sock, "fut": fut, "jsock": jsock, "jfut": jfut}
    pool.shutdown()
    from spark_rapids_jni_tpu.bridge import BridgeClient as JaxClient
    for s, f, cls in ((sock, fut, BridgeClient), (jsock, jfut, JaxClient)):
        proc = f.result()
        if proc.poll() is None:
            try:
                (cls(s, device="cpu") if cls is BridgeClient
                 else cls(s)).shutdown_server()
            except (OSError, RuntimeError):
                proc.kill()
            proc.wait(timeout=60)


def client(server) -> BridgeClient:
    server["fut"].result()
    return BridgeClient(server["sock"], device="cpu")


def total(path, chunk_bytes=None, key="k"):
    return pe.Aggregate(pe.Scan(path, chunk_bytes=chunk_bytes), (key,),
                        (("v", "sum"),), ("s",))


def point(files, i: int):
    """A point lookup of the small table."""
    return Filter(Scan(files / "small.parquet"), ("==", col("id"), lit(i)))


def touch(path) -> None:
    """A new modification time: the result cache misses, the plan cache
    still holds the plan."""
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))


def reports_of(c: BridgeClient, trace_id: str) -> list:
    """Every rank's report of the last plan of ``trace_id``."""
    recent = c.metrics()["ranks"]["recent"]
    return [r for r in recent if r["trace_id"] == trace_id][-1]["reports"]


def submit(sock, plan, out: dict, key, delay_s: float = 0.0):
    """A thread that runs ``plan`` on a connection of its own and leaves
    ``(table or error, seconds, end time)`` in ``out[key]``; the
    connection's trace id is the thread's ``trace_id``."""
    c = BridgeClient(sock, device="cpu")

    def go():
        time.sleep(delay_s)
        t0 = time.monotonic()
        try:
            (h,) = c.execute_plan(plan)
            got = c.export_table(h)
            c.release(h)
        except Exception as e:  # noqa: BLE001 -- checked by the caller
            got = e
        end = time.monotonic()
        out[key] = (got, end - t0, end)
        c.close()
    t = threading.Thread(target=go, daemon=True)
    t.trace_id = c.trace_id
    t.start()
    return t


def wait_running(c: BridgeClient, trace_id: str) -> None:
    for _ in range(2000):
        if c.query_status(trace_id=trace_id):
            return
        time.sleep(0.005)
    raise AssertionError(f"{trace_id} never showed as running")


def same_bits(a, b) -> None:
    assert a.num_rows == b.num_rows
    for ca, cb in zip(a.columns, b.columns):
        np.testing.assert_array_equal(np.asarray(ca.to_pylist()),
                                      np.asarray(cb.to_pylist()))


# -- rank 0's choice, the decisions' order, the seat's counts ----------------

def _rounds(sched, sessions, chunks):
    """Rank 0's picks at every vote and report of plans that want
    ``chunks`` chunks each, until every one has run them; the picks of
    each session in each round, and the holders in order."""
    left = dict(zip((s.sid for s in sessions), chunks))
    holder, order = None, []
    rounds: list = []
    for _ in range(10 * sum(chunks)):
        live = [s for s in sessions if left[s.sid] > 0]
        if not live:
            break
        if holder is not None and left[holder.sid] == 0:
            holder = None  # its report: the turn passes on
        waiting = [s for s in live if s is not holder]
        before = sched._rounds
        holder = sched.pick(holder, waiting)
        if sched._rounds != before or not rounds:
            rounds.append({})
        rounds[-1][holder.sid] = rounds[-1].get(holder.sid, 0) + 1
        left[holder.sid] -= 1
        order.append(holder.sid)
    return rounds, order, left


def test_pick_gives_weight_8_eight_times_the_turns():
    sched = psched.Scheduler()
    scan = psched.QuerySession(1, sched)
    pt = psched.QuerySession(2, sched, objective_ms=250)
    assert (scan.weight, pt.weight) == (1, 8)
    rounds, order, left = _rounds(sched, [scan, pt], [400, 400])
    assert not any(left.values())
    full = [r for r in rounds if len(r) == 2]
    assert len(full) >= 5
    for r in full[1:-1]:  # whole rounds, both sessions wanting turns
        assert r == {1: psched._QUANTUM, 2: 8 * psched._QUANTUM}
    assert tracing.counters_snapshot("engine.sched.handoffs")


def test_pick_never_stalls_with_uneven_chunk_counts():
    """Early finishers leave mid-round; the stragglers still drain, and
    one live session is the fast path (no credit spent)."""
    sched = psched.Scheduler()
    sessions = [psched.QuerySession(i + 1, sched) for i in range(3)]
    rounds, order, left = _rounds(sched, sessions, [5, 60, 120])
    assert not any(left.values())
    assert [order.count(s.sid) for s in sessions] == [5, 60, 120]
    assert len(order) == 185 and sched._rounds >= 1
    # the first to finish had its turns early: no session waits a round
    assert max(i for i, s in enumerate(order) if s == 1) < 3 * 4 * 3
    solo = psched.QuerySession(9, sched)
    credits = solo.credits
    assert sched.pick(solo, []) is solo and solo.credits == credits
    assert sched.pick(None, [solo]) is solo and sched.pick(None, []) is None


def test_decisions_apply_in_rank_0_order():
    """A decision that arrives before an earlier one (a record on the
    control channel racing a vote) waits for it; a repeat is dropped."""
    applied = []
    d = pranks.Decisions(applied.append)
    first, second, third = d.issue(1, 0, 1), d.issue(0, 0, -1), \
        d.issue(2, 0, 0)
    d.deliver(third)
    d.deliver(None)
    assert applied == []
    d.deliver(first)
    assert applied == [first]
    d.deliver(second)
    d.deliver(first)
    assert applied == [first, second, third]


def test_decisions_apply_once_in_order_under_many_threads():
    """Sixteen threads deliver 800 decisions, each twice, in a shuffled
    order with a short switch interval: each applies once, in order."""
    applied = []
    d = pranks.Decisions(applied.append)
    made = [d.issue(i, 0, -1) for i in range(800)]
    order = [made[i] for i in np.random.default_rng(5).permutation(
        np.arange(1600) % 800)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda part=order[i::16]: [
            d.deliver(x) for x in part]) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert applied == made


def test_seat_counts_the_launches_of_its_own_turns():
    """Two plans' threads take turns on one table; each counts only the
    launches made while it held the turn, not the other's."""
    table = ranked.TurnTable()
    seats = {p: ranked.Seat(table, None, p, None) for p in (1, 2)}
    key = "kernel.ranks3_probe"
    seq = [(1, 3), (2, 5), (1, 2), (2, 1)]   # (holder, its launches)
    done = []

    def run(pid):
        for who, n in seq:
            if who != pid:
                continue
            seats[pid].acquire()
            for _ in range(n):
                tracing.count(key)
            seats[pid].tally_launches()
            done.append(pid)
            nxt = [p for p, _ in seq[len(done):len(done) + 1]]
            table.decisions.deliver(table.decisions.issue(
                nxt[0] if nxt else 0, 0, -1))

    ts = [threading.Thread(target=run, args=(p,)) for p in (1, 2)]
    for t in ts:
        t.start()
    table.decisions.deliver(table.decisions.issue(1, 0, 1))
    for t in ts:
        t.join(timeout=10)
    assert done == [1, 2, 1, 2]
    assert seats[1].tally[key] == 5 and seats[2].tally[key] == 6
    assert table.handoffs == 3 and table.holder == 0


def test_oom_retry_first_is_rank_0s_choice_over_ranks(monkeypatch):
    """Only rank 0 holds the session, so every rank in the OOM ladder
    takes rank 0's same-rung retry (one host gather, faked here): a fault
    every rank sees steps every rank alike, with two sessions live."""
    from spark_rapids_jni_tpu_torch.engine.recovery import RecoveryPolicy
    said = []

    def gather(values, ranks):
        if ranks.rank == 0:
            said.append(values[0])
        return [[said[-1]], [0]]

    monkeypatch.setattr(pranks, "host_gather_ints", gather)
    sched = psched.Scheduler()
    sessions = [psched.QuerySession(i, sched, budget_bytes=1 << 30)
                for i in (1, 2)]
    cpu = torch.device("cpu")
    r0 = RecoveryPolicy(session=sessions[0],
                        ranks=pranks.Ranks(0, 2, "gloo", cpu, None, None))
    r1 = RecoveryPolicy(ranks=pranks.Ranks(1, 2, "gloo", cpu, None, None))
    oom = errors.ResourceExhaustedError("out of memory")
    site = "exchange.dispatch"
    assert r0.oom_retry_first(site, oom) and r1.oom_retry_first(site, oom)
    # one retry a site: then every rank degrades
    assert not r0.oom_retry_first(site, oom)
    assert not r1.oom_retry_first(site, oom)
    assert said == [1, 0]


# -- the server --------------------------------------------------------------

@pytest.fixture(scope="module")
def concurrent(server, files):
    """Five distinct plans run alone, then at once on five connections
    (the fact's mtime moved in between: the result cache misses); the
    JAX server's answers."""
    from spark_rapids_jni_tpu.bridge import BridgeClient as JaxClient
    plans = [Filter(Scan(files / "fact.parquet"),
                    ("<", col("v"), lit(1000 * (i + 1)))) for i in range(5)]
    serial, alone = {}, {}
    for i, p in enumerate(plans):
        c = client(server)
        (h,) = c.execute_plan(p)
        serial[i] = c.export_table(h)
        c.release(h)
        alone[i] = c.metrics()["ranks"]["last_plan"]
        c.close()
    touch(files / "fact.parquet")
    got: dict = {}
    ts = [submit(server["sock"], p, got, i) for i, p in enumerate(plans)]
    for t in ts:
        t.join(timeout=120)
    c = client(server)
    reports = {i: reports_of(c, t.trace_id) for i, t in enumerate(ts)}
    c.close()
    server["jfut"].result()
    jc = JaxClient(server["jsock"])
    jax = {}
    for i, p in enumerate(plans):
        hs = jc.execute_plan(je.deserialize(p.serialize()))
        jax[i] = jc.export_table(hs[0])
        for h in hs:
            jc.release(h)
    jc.close()
    return {"serial": serial, "alone": alone, "got": got,
            "reports": reports, "jax": jax}


def test_concurrent_sessions_bit_exact(concurrent):
    got = concurrent["got"]
    assert sorted(got) == list(range(5))
    for i in range(5):
        table = got[i][0]
        assert not isinstance(table, Exception), table
        assert table.num_rows == 1000 * (i + 1)
        same_bits(table, concurrent["serial"][i])
        same_bits(table, concurrent["jax"][i])


def test_concurrent_reports_count_their_own(concurrent):
    for i in range(5):
        for a, b in zip(concurrent["alone"][i], concurrent["reports"][i]):
            assert b["ok"] and a["rank"] == b["rank"]
            for k in ("launches", "launch_devices", "row_groups_read",
                      "exchanges"):
                assert a[k] == b[k], (i, k, a[k], b[k])


def test_point_query_interleaves_with_a_scan(server, files):
    c = client(server)
    (h,) = c.execute_plan(point(files, 7))  # planned and cached alone
    assert c.export_table(h).num_rows == 1
    c.release(h)
    before = c.metrics()["ranks"]["handoffs"]
    out: dict = {}
    scan = submit(server["sock"], total(files / "big.parquet", SCAN_CHUNK),
                  out, "scan")
    wait_running(c, scan.trace_id)
    touch(files / "small.parquet")
    pt = submit(server["sock"], point(files, 7), out, "point")
    pt.join(timeout=60)
    mid = c.metrics()["ranks"]
    scan.join(timeout=120)
    c.close()
    (ptab, _, p_end), (stab, _, s_end) = out["point"], out["scan"]
    assert ptab.num_rows == 1 and stab.num_rows == 50
    assert p_end < s_end
    assert mid["handoffs"] - before >= 2  # to the point query and back


def test_resubmission_during_a_plan_hits_the_plan_cache(server, files):
    c = client(server)
    (h,) = c.execute_plan(point(files, 11))
    c.release(h)
    alone = c.metrics()["ranks"]["last_plan"]
    out: dict = {}
    scan = submit(server["sock"], total(files / "big.parquet", 1 << 15,
                                        key="v"), out, "scan")
    wait_running(c, scan.trace_id)
    touch(files / "small.parquet")
    again = submit(server["sock"], point(files, 11), out, "again")
    again.join(timeout=60)
    beside = reports_of(c, again.trace_id)
    scan.join(timeout=120)
    c.close()
    assert out["again"][0].num_rows == 1 and out["scan"][0].num_rows == 100
    assert out["again"][2] < out["scan"][2]
    for a, b in zip(alone, beside):
        # the scan between them missed, the resubmission hit
        assert b["plan_cache"]["hits"] == a["plan_cache"]["hits"] + 1
        assert b["plan_cache"]["misses"] == a["plan_cache"]["misses"] + 1


def test_cancel_one_of_two_plans_in_flight(server, files):
    c = client(server)
    keep = total(files / "big.parquet", 1 << 18, key="v")
    (h,) = c.execute_plan(keep)
    want = c.export_table(h)
    c.release(h)
    touch(files / "big.parquet")
    out: dict = {}
    victim = submit(server["sock"], total(files / "big.parquet", 1 << 12),
                    out, "victim")
    wait_running(c, victim.trace_id)
    other = submit(server["sock"], keep, out, "keep")
    for _ in range(2000):
        if c.metrics()["ranks"]["in_flight"] == 2:
            break
        time.sleep(0.005)
    assert c.cancel(victim.trace_id) == 1
    victim.join(timeout=60)
    other.join(timeout=60)
    err = out["victim"][0]
    assert errors.classify(err)[0] == "cancelled", err
    assert getattr(err, "trace_id", "") == victim.trace_id
    assert [r["error"] for r in reports_of(c, victim.trace_id)] == \
        ["QueryCancelledError"] * 2
    same_bits(out["keep"][0], want)
    assert [r["ok"] for r in reports_of(c, other.trace_id)] == [True, True]
    (h,) = c.execute_plan(point(files, 5))
    assert c.export_table(h).num_rows == 1
    c.release(h)
    assert c.metrics()["ranks"]["live"]
    c.close()


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks3_fuzz_wh")
    return fuzz.gen_warehouse(root, np.random.default_rng([7, 0]))


def test_fuzz_plans_at_random_arrivals_match_jax(server, catalog):
    plans = [fuzz.gen_plan(np.random.default_rng([7, case]), catalog)
             for case in FUZZ_CASES]
    delays = np.random.default_rng(3).uniform(0.0, 0.3, len(plans))
    server["fut"].result()
    out: dict = {}
    ts = [submit(server["sock"], pe.deserialize(p.serialize()), out, i,
                 float(d)) for i, (p, d) in enumerate(zip(plans, delays))]
    with fuzz._flags(verify=True):
        want = [frame(je.execute(je.optimize(p, distribute=True)))
                for p in plans]
    for t in ts:
        t.join(timeout=120)
    for i, w in enumerate(want):
        table = out[i][0]
        assert not isinstance(table, Exception), (FUZZ_CASES[i], table)
        got = frame(Table(list(table.columns), list(w.columns)))
        assert fuzz._frames_match(got, w, exact=True) is None, FUZZ_CASES[i]


def _alive(pid: int) -> bool:
    """True for a process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_killed_rank_with_two_plans_in_flight(server, files):
    """Last in the file: it loses the server's group."""
    c = client(server)
    cached = point(files, 3)
    (h,) = c.execute_plan(cached)  # now in rank 0's result cache
    c.release(h)
    pids = c.metrics()["ranks"]["pids"]
    touch(files / "big.parquet")
    out: dict = {}
    ts = [submit(server["sock"], total(files / "big.parquet", 1 << 12),
                 out, "a")]
    wait_running(c, ts[0].trace_id)
    ts.append(submit(server["sock"], total(files / "big.parquet", 1 << 13,
                                           key="v"), out, "b"))
    for _ in range(2000):
        if c.metrics()["ranks"]["in_flight"] == 2:
            break
        time.sleep(0.005)
    t0 = time.monotonic()
    os.kill(pids[1], signal.SIGKILL)
    for t in ts:
        t.join(timeout=60)
    assert time.monotonic() - t0 < 15.0
    for k in ("a", "b"):
        assert isinstance(out[k][0], errors.RankGroupLostError), out[k][0]
        assert errors.classify(out[k][0])[0] == "ranks_lost"
    c.ping()
    ranks = c.metrics()["ranks"]
    assert not ranks["live"] and "rank 1" in ranks["lost"]
    assert ranks["in_flight"] == 0
    (h,) = c.execute_plan(cached)
    got = c.export_table(h)
    assert got.num_rows == 1
    assert c.metrics()["last_plan"].get("served_from_cache")
    back = c.export_table(c.import_table(got))  # the small ops serve on
    same_bits(back, got)
    t0 = time.monotonic()
    with pytest.raises(errors.RankGroupLostError):
        c.execute_plan(total(files / "big.parquet"))
    assert time.monotonic() - t0 < 5.0
    c.shutdown_server()
    assert server["fut"].result().wait(timeout=60) == 0
    assert not any(_alive(p) for p in pids)
