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
cpu,cpu --set distribute=true --set shards=8``) runs the fuzzer's plans 6
and 9 (``gen_plan`` rng [7, i]: a broadcast and a hash exchange, and a hash
exchange) against the JAX engine with ``distribute=True`` on its 8 virtual
devices, exactly (the fuzz warehouse's floats are quarter-valued, so every
sum is exact in any order).  Both servers start in the background while
the JAX side runs.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
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

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.bridge import BridgeClient, spawn_server
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.engine.explain import explain_analyze
from spark_rapids_jni_tpu_torch.engine.plan import Exchange, topo_nodes
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
            settings=SETTINGS, ranks=2, backend="gloo",
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
