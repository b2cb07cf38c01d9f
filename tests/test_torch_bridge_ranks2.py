"""``config.distribute`` and the fuzzer's plans over the ranked server.

``config.distribute`` is the port's counterpart of the JAX package's
``SRJT_DIST``: ``optimize`` and ``explain_analyze`` plan exchanges when
their caller leaves ``distribute`` unset and it is on.  Set through
``parse_setting("distribute=true")``, as the server's ``--set`` sets it:

- the port's optimized plan serializes as JAX's under ``SRJT_DIST=1``
  (tests/test_engine_dist.py's join-aggregate), and neither plans an
  exchange with the setting off;
- the counterpart of tests/test_engine_dist.py::
  test_explain_analyze_renders_exchanges;
- a one-rank server started with ``--set distribute=true --set shards=8``
  runs q5 with its exchanges (the executed count in ``last_plan``), its
  ``OP_METRICS`` carries the per-shard ``devices`` block, and its answer
  is the in-process distributed run's (group keys and counts exact, sums
  within rel 1e-9).

Then a server of 2 gloo ranks (``--ranks 2 --backend gloo --devices
cpu,cpu --set distribute=true --set shards=8 --set result_cache=8``) runs
the fuzzer's plans 6 and 9 (``gen_plan`` rng [7, i]: a broadcast and a
hash exchange, and a hash exchange) against the JAX engine with
``distribute=True`` on its 8 virtual devices, exactly (the fuzz
warehouse's floats are quarter-valued, so every sum is exact in any
order).  Both servers start in the background while the JAX side runs.

The lost-group policy with a plan running, last, on the same server:
SIGKILL of rank 1 in the middle of a scan of hundreds of chunks gives the
client ``RankGroupLostError`` within seconds; rank 0 then answers PING,
serves a result its cache holds, refuses a new plan at once, and shuts
down leaving no rank process.  Without a server: rank 0's watcher loses
the group (and aborts it) as soon as a rank's process ends, with no plan
running; connection threads and the Parquet prefetch thread bind their
card (``device.bind``: CUDA's current device belongs to each host thread),
and a card the host does not have is refused, checked with ``torch.cuda``
stubbed, since this host has none.
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
from spark_rapids_jni_tpu.engine import fuzz
from spark_rapids_jni_tpu.utils import config as jcfg
from test_engine_dist import _join_agg
from test_engine_dist import warehouse as dist_warehouse  # noqa: F401
from test_engine_e2e import q5_plan, warehouse  # noqa: F401
from test_torch_engine_dist import assert_rows_close, flags, rows
from test_torch_engine_fuzz import frame

from spark_rapids_jni_tpu_torch import device as pdevice
from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.bridge import BridgeClient, ranked, \
    spawn_server
from spark_rapids_jni_tpu_torch.bridge.server import BridgeServer
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.engine.explain import explain_analyze
from spark_rapids_jni_tpu_torch.engine.plan import Exchange, topo_nodes
from spark_rapids_jni_tpu_torch.io import parquet as pparquet
from spark_rapids_jni_tpu_torch.parallel import ranks as pranks
from spark_rapids_jni_tpu_torch.utils import errors
from spark_rapids_jni_tpu_torch.utils.config import (Config, config,
                                                     parse_setting)

torch.set_num_threads(1)
FUZZ_CASES = (6, 9)
SETTINGS = {"distribute": "true", "shards": 8}


@pytest.fixture
def distribute():
    """``config.distribute`` on through ``parse_setting``, and the JAX
    package's ``SRJT_DIST``; both restored after."""
    name, value = parse_setting("distribute=true")
    saved = getattr(config, name)
    setattr(config, name, value)
    os.environ["SRJT_DIST"] = "1"
    jcfg.refresh()
    try:
        yield
    finally:
        setattr(config, name, saved)
        del os.environ["SRJT_DIST"]
        jcfg.refresh()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A one-rank server and a server of 2 gloo ranks, both with
    distribute on, started in the background."""
    d = tmp_path_factory.mktemp("dist_servers")
    pool = ThreadPoolExecutor(2)
    futs = {
        "one": (str(d / "one.sock"), pool.submit(
            spawn_server, str(d / "one.sock"), device="cpu",
            settings=SETTINGS)),
        "ranks": (str(d / "ranks.sock"), pool.submit(
            spawn_server, str(d / "ranks.sock"), device="cpu",
            settings={**SETTINGS, "result_cache": 8}, ranks=2,
            backend="gloo",
            devices=["cpu", "cpu"]))}
    yield futs
    pool.shutdown()
    for sock, fut in futs.values():
        proc = fut.result()
        try:
            BridgeClient(sock, device="cpu").shutdown_server()
        except (OSError, RuntimeError):
            proc.kill()
        proc.wait(timeout=60)


def client(servers, name):
    sock, fut = servers[name]
    fut.result()
    return BridgeClient(sock, device="cpu")


def test_distribute_is_a_setting():
    assert Config().distribute is False
    assert parse_setting("distribute=true") == ("distribute", True)
    assert parse_setting("distribute=0") == ("distribute", False)


def test_optimize_follows_config_distribute(
        servers, dist_warehouse, distribute):  # noqa: F811
    plan = _join_agg(dist_warehouse[0])
    popt = pe.optimize(pe.deserialize(plan.serialize()))
    assert popt.serialize() == je.optimize(plan).serialize()
    assert {n.kind for n in topo_nodes(popt) if isinstance(n, Exchange)} \
        == {"broadcast", "hash"}
    # an explicit argument still wins
    off = pe.optimize(pe.deserialize(plan.serialize()), distribute=False)
    assert not any(isinstance(n, Exchange) for n in topo_nodes(off))


def test_explain_analyze_renders_exchanges(dist_warehouse):  # noqa: F811
    root = dist_warehouse[0]
    plan = pe.deserialize(_join_agg(root).serialize())
    with flags(shards=8):
        rep = explain_analyze(plan, device="cpu")
        assert "Exchange" not in rep.text  # distribution off by default
        name, value = parse_setting("distribute=true")
        setattr(config, name, value)
        try:
            rep = explain_analyze(plan, device="cpu")
        finally:
            config.distribute = False
    assert "Exchange(broadcast)" in rep.text
    assert "Exchange(hash, keys=['grp'])" in rep.text
    if rep.summary:  # metrics enabled in this session
        assert "wire_bytes=" in rep.text
        assert "exchanges=2" in rep.text
        # the per-shard breakdown (tests/test_engine_dist.py::
        # test_explain_analyze_renders_device_columns)
        assert "dev_rows=[" in rep.text


def test_one_rank_server_runs_distributed_plans(servers,
                                                warehouse):  # noqa: F811
    plan = q5_plan(warehouse[0])
    with flags(shards=8):
        want = pe.execute(pe.optimize(pe.deserialize(plan.serialize()),
                                      distribute=True), device="cpu")
    c = client(servers, "one")
    (h,) = c.execute_plan(plan)
    got = c.export_table(h)
    m = c.metrics()
    c.close()
    assert "ranks" not in m  # the one-rank server
    assert m["last_plan"]["exchanges"] >= 1
    assert m["devices"]["exchange_rows"]
    assert_rows_close(rows(got), rows(want))


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks_fuzz_wh")
    return fuzz.gen_warehouse(root, np.random.default_rng([7, 0]))


@pytest.mark.parametrize("case", FUZZ_CASES)
def test_fuzz_plan_over_ranks_matches_jax(servers, catalog, case):
    plan = fuzz.gen_plan(np.random.default_rng([7, case]), catalog)
    with fuzz._flags(verify=True):
        want = frame(je.execute(je.optimize(plan, distribute=True)))
    c = client(servers, "ranks")
    (h,) = c.execute_plan(plan)
    table = c.export_table(h)
    reports = c.metrics()["ranks"]["last_plan"]
    c.close()
    got = frame(Table(list(table.columns), list(want.columns)))
    assert fuzz._frames_match(got, want, exact=True) is None
    assert [r["ok"] for r in reports] == [True, True]
    assert reports[0]["exchanges"] == reports[1]["exchanges"] >= 1


# -- the lost-group policy and the card each thread binds --------------------

@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """A fact of 40 row groups that a 4 KiB chunk reads in hundreds of
    chunks (tests/test_torch_bridge_ranks.py's)."""
    root = tmp_path_factory.mktemp("drill_files")
    rng = np.random.default_rng(11)
    n = 400_000
    pq.write_table(pa.table({"k": pa.array(rng.integers(0, 50, n)),
                             "v": pa.array(rng.integers(0, 100, n))}),
                   root / "big.parquet", row_group_size=10_000)
    return root / "big.parquet"


def total(path, chunk_bytes=None, key="k"):
    return pe.Aggregate(pe.Scan(path, chunk_bytes=chunk_bytes), (key,),
                        (("v", "sum"),), ("s",))


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_rank_killed_mid_plan_loses_the_group(servers, big):
    c = client(servers, "ranks")
    cached = total(big, key="v")
    (h,) = c.execute_plan(cached)  # now in rank 0's result cache
    c.release(h)
    pids = c.metrics()["ranks"]["pids"]
    c1 = BridgeClient(servers["ranks"][0], device="cpu")
    result = []

    def submit():
        try:
            result.append(c1.execute_plan(total(big, chunk_bytes=1 << 12)))
        except Exception as e:  # noqa: BLE001 -- classified below
            result.append(e)

    worker = threading.Thread(target=submit, daemon=True)
    worker.start()
    for _ in range(500):  # mid-stream within a few polls
        if c.query_status(trace_id=c1.trace_id):
            break
        time.sleep(0.01)
    t0 = time.monotonic()
    os.kill(pids[1], signal.SIGKILL)
    worker.join(timeout=60)
    seconds = time.monotonic() - t0
    c1.close()
    assert not worker.is_alive()
    err = result[0]
    assert isinstance(err, errors.RankGroupLostError), err
    assert errors.classify(err)[0] == "ranks_lost"
    assert seconds < 15.0
    c.ping()
    ranks = c.metrics()["ranks"]
    assert not ranks["live"] and "rank 1" in ranks["lost"]
    (h,) = c.execute_plan(cached)
    assert c.export_table(h).num_rows == 100
    assert c.metrics()["last_plan"].get("served_from_cache")
    t0 = time.monotonic()
    with pytest.raises(errors.RankGroupLostError):
        c.execute_plan(total(big))
    assert time.monotonic() - t0 < 5.0
    c.shutdown_server()
    assert servers["ranks"][1].result().wait(timeout=60) == 0
    assert not any(_alive(p) for p in pids)


class _Launched:
    """A rank launcher whose rank 1 runs until the test ends it."""

    def __init__(self):
        self.codes = {1: None}
        self.procs = {}
        self.closed = False

    def exitcodes(self):
        return dict(self.codes)

    def close(self):
        self.closed = True


def test_watcher_loses_the_group_when_a_rank_process_ends(monkeypatch):
    aborted = []
    monkeypatch.setattr(ranked._ranks, "abort", aborted.append)
    me = pranks.Ranks(0, 2, "nccl", torch.device("cpu"), None, None)
    launched = _Launched()
    group = ranked.RankGroup(me, me, launched, ["cuda:0", "cuda:1"])
    time.sleep(5 * ranked.WATCH_S)
    assert not group.lost and not aborted and not launched.closed
    launched.codes[1] = -9
    for _ in range(200):
        if group.lost:
            break
        time.sleep(ranked.WATCH_S)
    assert group.lost == "rank 1 exited (-9)"
    assert aborted == [me] and launched.closed
    with pytest.raises(errors.RankGroupLostError, match="rank 1 exited"):
        group.run(b"", None, "", None, None, {})


@pytest.fixture
def four_cards(monkeypatch):
    """``torch.cuda`` as a host of four cards shows it; every
    ``set_device`` is recorded with its thread."""
    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: bound.append(
        (threading.get_ident(), torch.device(d))))
    return bound


def test_cards_resolve_with_their_index(four_cards, tmp_path):
    assert pdevice.resolve("cuda") == torch.device("cuda", 0)
    assert pdevice.resolve("cuda:3") == torch.device("cuda", 3)
    assert pdevice.bind("cpu") == torch.device("cpu") and not four_cards
    with pytest.raises(RuntimeError, match="has 4 CUDA card"):
        pdevice.resolve("cuda:4")
    with pytest.raises(RuntimeError, match="has 4 CUDA card"):
        pranks.init_ranks("gloo", 0, 1, f"file://{tmp_path / 'store'}",
                          device="cuda:4")
    assert not four_cards and not torch.distributed.is_initialized()


def test_connection_threads_bind_the_server_card(four_cards, tmp_path):
    srv = BridgeServer(str(tmp_path / "s.sock"), "cuda:3")
    assert srv.device == torch.device("cuda", 3)
    ready = threading.Event()
    main = threading.Thread(target=srv.serve_forever, args=(ready,),
                            daemon=True)
    main.start()
    assert ready.wait(30)
    clients = [BridgeClient(srv.sock_path, device="cpu") for _ in range(2)]
    for c in clients:
        c.ping()
    clients[0].shutdown_server()
    for c in clients:
        c.close()
    main.join(timeout=30)
    assert not main.is_alive()
    # one binding a connection: the two clients' (and the accept loop's
    # own wake-up connection at shutdown, when it is served)
    me = {threading.get_ident(), main.ident}
    assert len(four_cards) >= 2 and not {t for t, _ in four_cards} & me
    assert {d for _, d in four_cards} == {torch.device("cuda", 3)}


def test_prefetch_thread_binds_the_reader_card(four_cards):
    items = list(pparquet._prefetched(iter(range(5)), 2, None,
                                      torch.device("cuda", 2)))
    assert items == list(range(5))
    ((tid, dev),) = four_cards
    assert tid != threading.get_ident() and dev == torch.device("cuda", 2)
