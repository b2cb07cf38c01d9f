"""The device server over ranks: 2 gloo ranks on the CPU behind one socket.

One server for the file (``--ranks 2 --backend gloo --devices cpu,cpu
--set distribute=true --set shards=8 --set result_cache=8``): rank 0
serves the socket, both ranks execute every ``PLAN_EXECUTE``, 4 shards a
rank.  Its start overlaps the JAX side's compiles.

- Engine q5 (tests/test_engine_e2e.py's warehouse and plan) sent as
  ``PLAN_EXECUTE``, against the JAX engine with ``distribute=True`` on its
  8 virtual devices: group keys and counts exact, sums within rel 1e-9
  (the port sums in scatter order).  Both ranks execute rank 0's plan,
  each over its own row groups.  (Fuzz plans over ranks, and
  ``config.distribute`` itself: tests/test_torch_bridge_ranks2.py.)
- A resubmission over a rewritten file hits the plan cache on both ranks;
  a result-cache hit runs nothing on rank 1.
- A verification error and rank 0's planning error reach the client
  structured, both ranks report the planning error, and the group keeps
  serving.
- ``OP_CANCEL`` of a running plan: kind ``cancelled`` with its trace id on
  the client, both ranks stopped at the same boundary, and the next plan
  succeeds.
- Neither rank's process loads JAX.
- SIGKILL of rank 1: the next ``PLAN_EXECUTE`` replies the typed
  ``RankGroupLostError`` at once while ``PING`` answers; ``OP_SHUTDOWN``
  then leaves no rank process alive.
"""

import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from test_engine_e2e import q5_plan, warehouse  # noqa: F401
from test_torch_engine_dist import flags

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.bridge import BridgeClient, spawn_server
from spark_rapids_jni_tpu_torch.engine.verify import PlanVerificationError
from spark_rapids_jni_tpu_torch.utils import errors

torch.set_num_threads(1)
SETTINGS = {"distribute": "true", "shards": 8, "result_cache": 8}
REL = 1e-9  # q5's float sums: the JAX tests' tolerance


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A fact of 40 row groups that a 4 KiB chunk reads in hundreds of
    chunks (the plan OP_CANCEL stops), and a file that is not Parquet."""
    root = tmp_path_factory.mktemp("ranks_files")
    rng = np.random.default_rng(11)
    n = 400_000
    pq.write_table(pa.table({"k": pa.array(rng.integers(0, 50, n)),
                             "v": pa.array(rng.integers(0, 100, n))}),
                   root / "big.parquet", row_group_size=10_000)
    (root / "bad.parquet").write_bytes(b"not a parquet file" * 16)
    return root


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The ranked server, started in the background: ``client`` waits."""
    sock = str(tmp_path_factory.mktemp("ranked_server") / "s.sock")
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(spawn_server, sock, device="cpu", settings=SETTINGS,
                      ranks=2, backend="gloo", devices=["cpu", "cpu"])
    yield sock, fut
    pool.shutdown()
    proc = fut.result()
    if proc.poll() is None:
        try:
            BridgeClient(sock, device="cpu").shutdown_server()
        except (OSError, RuntimeError):
            proc.kill()
        proc.wait(timeout=60)


@pytest.fixture(scope="module")
def client(server):
    sock, fut = server
    fut.result()
    c = BridgeClient(sock, device="cpu")
    yield c
    c.close()


def total(files, chunk_bytes=None):
    """The big fact's 50 groups (``chunk_bytes``: streamed in chunks)."""
    return pe.Aggregate(pe.Scan(files / "big.parquet",
                                chunk_bytes=chunk_bytes),
                        ("k",), (("v", "sum"),), ("s",))


def run(c, plan):
    """One PLAN_EXECUTE; its answer and the group's ``ranks`` block."""
    (h,) = c.execute_plan(plan)
    table = c.export_table(h)
    c.release(h)
    return table, c.metrics()["ranks"]


@pytest.fixture(scope="module")
def jax_q5(server, warehouse):  # noqa: F811
    with flags(shards=8):
        return je.execute(je.optimize(q5_plan(warehouse[0]),
                                      distribute=True), je.new_stats(),
                          prefetch=0)


def assert_q5(table, want):
    got = {nm: (s, p, int(n)) for nm, s, p, n in zip(
        *[c.to_pylist() for c in table.columns])}
    want = {nm: (s, p, int(n)) for nm, s, p, n in zip(
        *[want[c].to_pylist() for c in want.names])}
    assert sorted(got) == sorted(want)
    for k, (s, p, n) in want.items():
        assert got[k][2] == n
        assert got[k][0] == pytest.approx(s, rel=REL)
        assert got[k][1] == pytest.approx(p, rel=REL)


def test_q5_over_ranks_matches_jax(jax_q5, client, warehouse):  # noqa: F811
    table, ranks = run(client, q5_plan(warehouse[0]))
    assert_q5(table, jax_q5)
    assert ranks["world"] == 2 and ranks["backend"] == "gloo"
    assert ranks["devices"] == ["cpu", "cpu"] and ranks["live"]
    a, b = ranks["last_plan"]
    assert a["ok"] and b["ok"]
    # both ranks ran rank 0's physical plan, each over its own row groups
    assert a["exchanges"] == b["exchanges"] >= 1
    assert a["row_groups_read"] > 0 and b["row_groups_read"] > 0


def test_resubmission_hits_the_plan_cache_on_every_rank(
        client, warehouse):  # noqa: F811
    """Over a rewritten fact file the result cache misses and the plan
    cache hits, on both ranks."""
    fact = warehouse[0] / "store_sales.parquet"
    before = client.metrics()["ranks"]["last_plan"]
    st = os.stat(fact)
    os.utime(fact, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    _, ranks = run(client, q5_plan(warehouse[0]))
    for b, a in zip(before, ranks["last_plan"]):
        assert a["plan_cache"]["hits"] == b["plan_cache"]["hits"] + 1
        assert a["plan_cache"]["misses"] == b["plan_cache"]["misses"]


def test_result_cache_hit_runs_nothing_on_rank_1(client,
                                                warehouse):  # noqa: F811
    before = client.metrics()["ranks"]
    table, ranks = run(client, q5_plan(warehouse[0]))
    assert client.metrics()["last_plan"].get("served_from_cache")
    assert ranks["plans"] == before["plans"]
    assert ranks["last_plan"] == before["last_plan"]
    assert table.num_rows > 0


def test_errors_reach_the_client_and_the_group_serves_on(client, files):
    """A verification error (refused on rank 0 before the group sees the
    plan) and rank 0's planning error (an unreadable file: verification
    resolves no schema, so optimize raises), which every rank raises."""
    plans = client.metrics()["ranks"]["plans"]
    with pytest.raises(PlanVerificationError) as ei:
        client.execute_plan(pe.Aggregate(pe.Scan(files / "big.parquet"),
                                         ("nope",), (("v", "sum"),), ("s",)))
    assert ei.value.code == "unknown-column"
    assert client.metrics()["ranks"]["plans"] == plans
    with pytest.raises(RuntimeError, match="not a parquet file") as ei:
        client.execute_plan(pe.Aggregate(pe.Scan(files / "bad.parquet"),
                                         ("k",), (("v", "sum"),), ("s",)))
    assert errors.classify(ei.value)[0] == "fatal"
    ranks = client.metrics()["ranks"]
    assert ranks["plans"] == plans + 1 and ranks["live"]
    assert [r["error"] for r in ranks["last_plan"]] == ["ValueError"] * 2
    table, ranks = run(client, total(files))
    assert table.num_rows == 50
    assert [r["ok"] for r in ranks["last_plan"]] == [True, True]


def test_cancel_stops_every_rank_and_the_next_plan_runs(server, client,
                                                        files):
    plan = total(files, chunk_bytes=1 << 12)
    c1 = BridgeClient(server[0], device="cpu")
    result = []

    def submit():
        try:
            result.append(c1.execute_plan(plan))
        except Exception as e:  # noqa: BLE001 -- classified below
            result.append(e)

    worker = threading.Thread(target=submit, daemon=True)
    worker.start()
    mine = []
    for _ in range(500):  # mid-stream within a few polls
        mine = client.query_status(trace_id=c1.trace_id)
        if mine:
            break
        time.sleep(0.01)
    assert mine
    assert client.cancel(c1.trace_id) == 1
    worker.join(timeout=60)
    assert not worker.is_alive()
    err = result[0]
    assert errors.classify(err)[0] == "cancelled", err
    assert getattr(err, "trace_id", "") == c1.trace_id
    ranks = client.metrics()["ranks"]
    assert [r["error"] for r in ranks["last_plan"]] == \
        ["QueryCancelledError"] * 2
    # both stopped at the same boundary, well before the end of the scan
    a, b = ranks["last_plan"]
    assert a["row_groups_read"] < 20 and b["row_groups_read"] < 20
    table, ranks = run(c1, total(files, chunk_bytes=1 << 20))
    assert table.num_rows == 50 and ranks["live"]
    assert [r["ok"] for r in ranks["last_plan"]] == [True, True]
    c1.close()


def _loads_jax(pid: int) -> bool:
    """Whether a process has mapped jaxlib's shared objects."""
    with open(f"/proc/{pid}/maps") as f:
        return "jaxlib" in f.read()


def test_no_rank_loads_jax(client):
    pids = client.metrics()["ranks"]["pids"]
    assert len(pids) == 2 and not any(_loads_jax(p) for p in pids)


def _alive(pid: int) -> bool:
    """True for a process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_killed_rank_gives_group_lost_at_once(client, files):
    """(A plan the result cache holds would still be served: it needs no
    rank but 0.)"""
    pids = client.metrics()["ranks"]["pids"]
    os.kill(pids[1], signal.SIGKILL)
    for _ in range(200):
        if not _alive(pids[1]):
            break
        time.sleep(0.01)
    t0 = time.monotonic()
    with pytest.raises(errors.RankGroupLostError) as ei:
        client.execute_plan(total(files, chunk_bytes=1 << 16))
    assert time.monotonic() - t0 < 5.0
    assert errors.classify(ei.value)[0] == "ranks_lost"
    client.ping()
    ranks = client.metrics()["ranks"]
    assert not ranks["live"] and "rank 1" in ranks["lost"]
    with pytest.raises(errors.RankGroupLostError):
        client.execute_plan(total(files, chunk_bytes=1 << 16))


def test_shutdown_leaves_no_rank_process(server, client):
    pids = client.metrics()["ranks"]["pids"]
    client.shutdown_server()
    proc = server[1].result()
    assert proc.wait(timeout=60) == 0
    assert not any(_alive(p) for p in pids)
