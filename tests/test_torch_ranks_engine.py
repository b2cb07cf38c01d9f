"""The engine's distributed plans across processes: 2 gloo ranks of 4
shards on the CPU, spawned once for the file (``tests/torch_rank_cases.py``
imports the port only).  Rank 0 optimizes each plan with
``distribute=True`` and broadcasts it; both ranks execute it over their
split of the scans (rank r reads the row groups r, r + 2, ...) and both
return the gathered answer.

- q5 (tests/test_engine_e2e.py's warehouse and plan), by the host and the
  device-decode route, against the JAX package's engine on its 8 virtual
  devices: group keys and counts exact, sums within rel 1e-9 (the port
  sums in scatter order, as tests/test_torch_engine.py holds it).
- Adaptive execution over a hot-key fact (tests/test_adaptive.py's shape):
  the flip and the skew split fire on both ranks with the same ledger,
  and the answer is the one-process port's (INT64 sums, exact).
- The fused stage over quarter-valued floats (tests/test_fused_stage.py's
  shape): one fused dispatch on each rank, the answer bit for bit the
  one-process port's.
- Aggregates over split rows that no combine above finishes, each
  feeding a join's hash exchange, against the one-process port: one over
  a scan whose ``partitioned_by`` let the optimizer drop its exchange (a
  rank reads row groups, not hash buckets), and a final aggregate over an
  exchange the skew split spreads.
Both ranks run the same physical plan, bytes for bytes.  When rank 0's
planning raises, rank 1 raises its error at once.  A rank that raises
makes ``spawn`` raise within the timeout.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import torch_rank_cases as C
from spark_rapids_jni_tpu import engine as je
from test_engine_e2e import as_dict, q5_plan, warehouse  # noqa: F401
from test_torch_engine_dist import assert_rows_close, flags, rows

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.parallel import ranks as pranks

torch.set_num_threads(1)
WORLD = 2
AQE_ON = dict(shards=8, aqe=True, aqe_skew=1.5, broadcast_rows=0,
              aqe_broadcast_rows=1_000_000)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A hot-key star (half the fact on one key) and a quarter-valued
    fact, each in several row groups."""
    aqe = tmp_path_factory.mktemp("ranks_aqe")
    rng = np.random.default_rng(7)
    k = rng.integers(0, 400, 8_000)
    k[:4_000] = 3
    pq.write_table(pa.table({"k": pa.array(k, pa.int64()),
                             "v": pa.array(np.arange(8_000, dtype=np.int64)),
                             "g": pa.array(k % 5, pa.int64())}),
                   aqe / "fact.parquet", row_group_size=2_000)
    dk = np.arange(400, dtype=np.int64)
    pq.write_table(pa.table({"dk": pa.array(dk), "grp": pa.array(dk % 7)}),
                   aqe / "dim.parquet")
    fused = tmp_path_factory.mktemp("ranks_fused")
    rng = np.random.default_rng(42)
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 500, 20_000), pa.int64()),
        "v": pa.array((rng.integers(0, 400, 20_000) * 0.25))}),
        fused / "fact.parquet", row_group_size=4_000)
    return aqe, fused


def join_agg(root):
    j = pe.Join(pe.Scan(root / "fact.parquet", chunk_bytes=100_000),
                pe.Scan(root / "dim.parquet"), ("k",), ("dk",), "inner")
    return pe.Aggregate(j, ("grp",), (("v", "sum"),), ("total",))


def sandwich(root):
    return pe.Aggregate(pe.Scan(root / "fact.parquet"), ("k",),
                        (("v", "sum"), ("v", "count")), ("total", "n"))


def partitioned_join(root):
    """An aggregate with no exchange below it (the scan claims placement
    by ``k``) joined on ``g``: each rank's groups of it must be combined
    before the join's exchange moves them."""
    agg = pe.Aggregate(pe.Scan(root / "fact.parquet", chunk_bytes=100_000,
                               partitioned_by=("k",)),
                       ("k", "g"), (("v", "sum"), ("v", "count")),
                       ("total", "n"))
    return pe.Join(agg, pe.Scan(root / "dim.parquet"), ("g",), ("dk",),
                   "inner")


def hot_final_join(root):
    """A final (not decomposable) aggregate over an exchange the skew split
    spreads, feeding a join's exchange on one of its two keys: the hot
    group's rows sit on both ranks."""
    agg = pe.Aggregate(pe.Scan(root / "fact.parquet", chunk_bytes=100_000),
                       ("k", "g"), (("v", "mean"), ("v", "count")),
                       ("m", "n"))
    return pe.Join(agg, pe.Scan(root / "dim.parquet"), ("k",), ("dk",),
                   "inner")


def unplannable(root):
    return pe.Aggregate(pe.Scan(root / "fact.parquet"), ("nope",),
                        (("v", "sum"),), ("total",))


PLANS = {
    "q5-host": dict(shards=8, device_decode=False),
    "q5-device": dict(shards=8, device_decode=True),
    "aqe": AQE_ON,
    "fused": dict(shards=8, fuse_exchange=True),
    "partitioned-join": dict(shards=8, broadcast_rows=0),
    "hot-final-join": AQE_ON,
}
COMBINED = {"partitioned-join": partitioned_join,
            "hot-final-join": hot_final_join}


@pytest.fixture(scope="module")
def ranks_run(warehouse, roots):  # noqa: F811
    """The ranks' run, started in the background: the JAX side compiles
    meanwhile."""
    aqe, fused = roots
    q5 = q5_plan(warehouse[0]).serialize()
    blobs = {"q5-host": q5, "q5-device": q5,
             "aqe": join_agg(aqe).serialize(),
             "fused": sandwich(fused).serialize(),
             "unplannable": unplannable(aqe).serialize()}
    blobs.update({k: f(aqe).serialize() for k, f in COMBINED.items()})
    pool = ThreadPoolExecutor(1)
    yield pool.submit(pranks.spawn, C.run_engine, WORLD, "gloo",
                      ["cpu"] * WORLD, 90.0,
                      args=(blobs, dict(PLANS, unplannable={})))
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_q5(ranks_run, warehouse):  # noqa: F811
    with flags(shards=8):
        return as_dict(je.execute(je.optimize(q5_plan(warehouse[0]),
                                              distribute=True),
                                  je.new_stats()))


@pytest.fixture(scope="module")
def ranked(ranks_run, jax_q5):
    return ranks_run.result()


def one_process(plan, **kw):
    with flags(**kw):
        return pe.execute(pe.optimize(plan, distribute=True),
                          device="cpu")


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_run_one_plan_and_get_one_answer(ranked, name):
    a, b = ranked[0][name], ranked[1][name]
    assert a["plan"] == b["plan"]
    assert a["result"] == b["result"]
    assert a["runtime"] == b["runtime"]
    # every rank read its own row groups, none twice
    assert a["stats"]["row_groups_read"] > 0 \
        and b["stats"]["row_groups_read"] > 0


@pytest.mark.parametrize("route", ["host", "device"])
def test_q5_across_ranks_matches_jax(jax_q5, ranked, route):
    names, cols = ranked[0][f"q5-{route}"]["result"]
    got = {nm: (s, p, int(n)) for nm, s, p, n in zip(*cols)}
    want = jax_q5
    assert sorted(got) == sorted(want)
    for k, (s, p, n) in want.items():
        assert got[k][2] == n
        assert got[k][0] == pytest.approx(s, rel=1e-9)
        assert got[k][1] == pytest.approx(p, rel=1e-9)


def test_aqe_flip_and_split_across_ranks(ranked, roots):
    res = ranked[0]["aqe"]
    assert res["stats"]["aqe_flips"] >= 1 and res["stats"]["aqe_splits"] >= 1
    kinds = {(e["kind"], e["triggered"]) for e in res["runtime"]}
    assert ("adaptive:broadcast_flip", True) in kinds
    assert ("adaptive:skew_split", True) in kinds
    want = one_process(join_agg(roots[0]), **AQE_ON)
    assert sorted(zip(*res["result"][1])) == rows(want)


def test_fused_stage_across_ranks_is_bit_exact(ranked, roots):
    res = ranked[0]["fused"]
    assert res["counters"]["engine.fused_stage.dispatches"] == 1
    want = one_process(sandwich(roots[1]), shards=8, fuse_exchange=False)
    assert sorted(zip(*res["result"][1])) == rows(want)
    assert_rows_close(sorted(zip(*ranked[1]["fused"]["result"][1])),
                      rows(want))


@pytest.mark.parametrize("name", sorted(COMBINED))
def test_split_aggregate_without_combine_above(ranked, roots, name):
    """Neither aggregate is a partial the optimizer split off, so each is
    finished across the ranks before its rows move on."""
    want = rows(one_process(COMBINED[name](roots[0]), **PLANS[name]))
    for res in ranked:
        assert sorted(zip(*res[name]["result"][1])) == want
    if name == "hot-final-join":
        assert ranked[0][name]["stats"]["aqe_splits"] >= 1


def test_rank_0_planning_error_reaches_every_rank(ranked):
    """Rank 0's PlanVerificationError is raised on rank 1 too, at once
    rather than at the group's timeout."""
    a, b = ranked[0]["unplannable"], ranked[1]["unplannable"]
    assert a["error"] == b["error"] == "PlanVerificationError"
    assert b["notes"] == ["raised on rank 0"] and b["s"] < 10.0


def test_raising_rank_makes_spawn_raise():
    """A rank that raises fails the run well within the group's timeout,
    its traceback in the error (a dying rank: tests/test_torch_ranks.py)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        pranks.spawn(C.run_raising, WORLD, "gloo", ["cpu"] * WORLD,
                     timeout=20.0)
    assert time.monotonic() - t0 < 20.0
