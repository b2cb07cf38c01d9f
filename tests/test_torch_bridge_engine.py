"""Whole-plan dispatch (``OP_PLAN_EXECUTE``) against the port's server.

The port's server runs as its own process with ``--device cpu`` and every
chunk decode of a chunked scan slowed by the ``parquet.chunk:*:timeout``
fault seam (50 ms a row group), so a scan over many row groups is reliably
in flight when a second connection polls or cancels it.  The JAX package's
unchanged ``BridgeClient`` submits the plans.  Results equal the JAX
package's ``execute(optimize(plan))`` in process (INT64 sums exact, float
sums within rel 1e-9); the plan cache counts a hit on resubmission; bad
plans come back as errors (the structured ``PlanVerificationError`` keeps
its code and node path) and the server survives.  The JAX server exits
during tests/test_engine_bridge.py's sequence; that sequence is replayed
here with the server process checked alive after every step.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.bridge import BridgeClient
from spark_rapids_jni_tpu.engine import (Aggregate, Filter, Join,
                                         PlanVerificationError, Scan, Sort,
                                         col, execute, lit, optimize)
from spark_rapids_jni_tpu.utils import errors
from spark_rapids_jni_tpu_torch.bridge import spawn_server

from test_engine_bridge import multi_op_plan, run_per_op
from test_torch_bridge import assert_same_table

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("torch_engine_bridge") / "tpub.sock")
    proc = spawn_server(sock, device="cpu",
                        settings={"faults": "parquet.chunk:*:timeout"})
    yield sock, proc
    try:
        BridgeClient(sock).shutdown_server()
    except (OSError, RuntimeError):
        proc.kill()
    proc.wait(timeout=30)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_planio")
    rng = np.random.default_rng(3)
    k = rng.integers(0, 20, 400).astype(np.int64)
    v = rng.integers(-50, 50, 400).astype(np.int64)
    pq.write_table(pa.table({"k": pa.array(k), "v": pa.array(v)}),
                   root / "fact.parquet")
    pq.write_table(pa.table({
        "k": pa.array(k), "v": pa.array(v),
        "f": pa.array(rng.standard_normal(400)),
    }), root / "ffact.parquet")
    dk = np.arange(20, dtype=np.int64)
    pq.write_table(pa.table({
        "k": pa.array(dk),
        "w": pa.array(dk * 10),
    }), root / "dim.parquet")
    n = 40_000
    pq.write_table(pa.table({
        "k": pa.array((np.arange(n) % 13).astype(np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    }), root / "big.parquet", row_group_size=1000)
    return root


def _jax_result(plan):
    return execute(optimize(plan))


def _fetch(c, handles):
    out = [c.export_table(h) for h in handles]
    for h in handles:
        c.release(h)
    return out


def test_plan_execute_one_round_trip(server, files):
    sock, proc = server
    c = BridgeClient(sock)
    plan = multi_op_plan(files)
    before = c.round_trips
    handles = c.execute_plan(plan)
    plan_trips = c.round_trips - before
    assert plan_trips == 1 and len(handles) == 1
    before = c.round_trips
    sh, temps = run_per_op(c, files)
    assert plan_trips < c.round_trips - before
    (got,) = _fetch(c, handles)
    (per_op,) = _fetch(c, [sh])
    for h in temps:
        c.release(h)
    want = _jax_result(plan)
    assert got.num_rows == 20
    assert_same_table(got, want)
    assert_same_table(per_op, want)
    assert c.live_count() == 0
    c.close()
    assert proc.poll() is None


def test_plan_float_sums_match_jax(server, files):
    """A join-aggregate with FLOAT64 sums: counts and INT64 sums exact,
    float sums within rel 1e-9 of the JAX package (the port sums in
    scatter order)."""
    sock, _ = server
    c = BridgeClient(sock)
    j = Join(Filter(Scan(files / "ffact.parquet"),
                    (">", col("v"), lit(-40))),
             Scan(files / "dim.parquet"), ["k"], ["k"], how="inner")
    plan = Sort(Aggregate(j, ["k"], [("f", "sum"), ("v", "sum"),
                                     ("w", "count")],
                          names=["sf", "sv", "n"]), (("k", True),))
    (got,) = _fetch(c, c.execute_plan(plan))
    want = _jax_result(plan)
    assert got.num_rows == want.num_rows
    for name in ("k", "sv", "n"):
        i = list(want.names).index(name)
        np.testing.assert_array_equal(np.asarray(got.columns[i].data),
                                      np.asarray(want.columns[i].data))
    i = list(want.names).index("sf")
    np.testing.assert_allclose(got.columns[i].to_pylist(),
                               want.columns[i].to_pylist(), rtol=1e-9)
    c.close()


def test_plan_cache_hit_on_resubmission(server, files):
    sock, _ = server
    c = BridgeClient(sock)
    plan = multi_op_plan(files)
    h1 = c.execute_plan(plan)
    m1 = c.metrics()
    assert m1["plan_cache"]["size"] >= 1
    assert m1["last_plan"]["nodes"] >= 4
    h2 = c.execute_plan(plan.serialize())
    m2 = c.metrics()
    assert m2["plan_cache"]["hits"] == m1["plan_cache"]["hits"] + 1
    assert m2["plan_cache"]["misses"] == m1["plan_cache"]["misses"]
    t1, t2 = _fetch(c, h1 + h2)
    assert_same_table(t1, t2)
    c.close()


def test_plan_execute_error_discipline(server):
    sock, proc = server
    c = BridgeClient(sock)
    with pytest.raises(RuntimeError):
        c.execute_plan(b'{"version":1,"root":0,"nodes":[{"op":"Nope"}]}')
    c.ping()
    with pytest.raises(RuntimeError):  # scan of a missing file
        c.execute_plan(Scan("/nonexistent/q.parquet"))
    c.ping()
    c.close()
    assert proc.poll() is None


def test_plan_execute_structured_verification_error(server, files):
    sock, proc = server
    c = BridgeClient(sock)
    bad = Sort(Filter(Scan(files / "fact.parquet"),
                      (">", col("nope"), lit(1))), (("k", True),))
    with pytest.raises(PlanVerificationError) as ei:
        c.execute_plan(bad)
    assert ei.value.code == "unknown-column"
    assert ei.value.node_path == "root.child"
    assert "nope" in ei.value.message
    c.ping()
    pq.write_table(pa.table({"w": pa.array(np.zeros(4))}),
                   files / "floatdim.parquet")
    mismatch = Join(Scan(files / "fact.parquet"),
                    Scan(files / "floatdim.parquet"), ["k"], ["w"],
                    how="inner")
    with pytest.raises(PlanVerificationError) as ei:
        c.execute_plan(mismatch)
    assert ei.value.code == "join-key-dtype-mismatch"
    assert ei.value.node_path == "root"
    c.ping()
    c.close()
    assert proc.poll() is None


def test_replayed_engine_bridge_sequence_keeps_server_alive(tmp_path_factory):
    """tests/test_engine_bridge.py's exact sequence (per-op query, then the
    plan; the same plan resubmitted; the error plans; the verification
    errors) against a fresh server of the port, alive after every step."""
    sock = str(tmp_path_factory.mktemp("torch_replay") / "tpub.sock")
    proc = spawn_server(sock, device="cpu")
    root = tmp_path_factory.mktemp("torch_replay_io")
    rng = np.random.default_rng(3)
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 20, 400).astype(np.int64)),
        "v": pa.array(rng.integers(-50, 50, 400).astype(np.int64)),
    }), root / "fact.parquet")
    dk = np.arange(20, dtype=np.int64)
    pq.write_table(pa.table({"k": pa.array(dk), "w": pa.array(dk * 10)}),
                   root / "dim.parquet")
    try:
        c = BridgeClient(sock)
        # test_plan_execute_one_round_trip
        handles = c.execute_plan(multi_op_plan(root))
        assert proc.poll() is None
        sh, temps = run_per_op(c, root)
        assert proc.poll() is None
        got, want = _fetch(c, handles + [sh])
        assert_same_table(got, want)
        for h in temps:
            c.release(h)
        assert c.live_count() == 0
        c.close()
        assert proc.poll() is None
        # test_plan_cache_hit_on_resubmission
        c = BridgeClient(sock)
        plan = multi_op_plan(root)
        h1 = c.execute_plan(plan)
        assert proc.poll() is None
        m1 = c.metrics()
        h2 = c.execute_plan(plan.serialize())
        assert proc.poll() is None
        assert c.metrics()["plan_cache"]["hits"] == \
            m1["plan_cache"]["hits"] + 1
        t1, t2 = _fetch(c, h1 + h2)
        assert_same_table(t1, t2)
        c.close()
        assert proc.poll() is None
        # test_plan_execute_error_discipline
        c = BridgeClient(sock)
        with pytest.raises(RuntimeError):
            c.execute_plan(b'{"version":1,"root":0,"nodes":[{"op":"Nope"}]}')
        assert proc.poll() is None
        with pytest.raises(RuntimeError):
            c.execute_plan(Scan("/nonexistent/q.parquet"))
        assert proc.poll() is None
        c.ping()
        c.close()
        # test_plan_execute_structured_verification_error
        c = BridgeClient(sock)
        with pytest.raises(PlanVerificationError):
            c.execute_plan(Sort(Filter(Scan(root / "fact.parquet"),
                                       (">", col("nope"), lit(1))),
                                (("k", True),)))
        assert proc.poll() is None
        c.ping()
        c.close()
        assert proc.poll() is None
    finally:
        try:
            BridgeClient(sock).shutdown_server()
        except (OSError, RuntimeError):
            proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == 0


def test_cancel_status_and_metrics_by_trace(server, files):
    """OP_QUERY_STATUS and OP_CANCEL keyed by the submitter's trace id from
    a second connection while the plan runs; the cancelled query comes back
    typed (kind ``cancelled``) with its trace id, the server stays up and
    its handle count returns to its base; OP_METRICS carries the
    scheduler, plan cache, last plan, recent queries and flight
    recorder."""
    sock, proc = server
    plan = Aggregate(Scan(files / "big.parquet", chunk_bytes=1 << 12),
                     ["k"], [("v", "sum")], names=["s"])
    c2 = BridgeClient(sock)
    base = c2.live_count()
    c1 = BridgeClient(sock)
    result: list = []

    def submit():
        try:
            result.append(("ok", c1.execute_plan(plan)))
        except Exception as e:  # noqa: BLE001 -- classified below
            result.append(("err", e))

    worker = threading.Thread(target=submit, daemon=True)
    worker.start()
    mine = []
    for _ in range(100):  # the plan is mid-stream within a few polls
        mine = c2.query_status(trace_id=c1.trace_id)
        if mine:
            break
        time.sleep(0.05)
    assert mine and all(q["key"] == c1.trace_id for q in mine)
    assert c2.query_status(trace_id="0" * 32) == []
    assert c2.cancel("0" * 32) == 0
    assert c2.cancel(c1.trace_id) == 1
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert result and result[0][0] == "err", result
    err = result[0][1]
    assert errors.classify(err)[0] == "cancelled", err
    assert getattr(err, "trace_id", "") == c1.trace_id
    assert proc.poll() is None
    assert c2.live_count() == base
    m = c2.metrics()
    assert m["scheduler"]["admitted"] >= 1 and m["scheduler"]["live"] == 0
    assert {"size", "hits", "misses"} <= set(m["plan_cache"])
    assert "nodes" in m["last_plan"]
    assert any(q.get("trace_id") for q in m["queries"])
    assert m["blackbox"]["cap"] >= 16 and m["blackbox"]["events"] > 0
    assert m["device"] == "cpu"
    c1.close()
    c2.close()
