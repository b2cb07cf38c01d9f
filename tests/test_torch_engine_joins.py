"""The port's engine on joins, against the JAX package, on the CPU.

- ``BUILD_CACHE`` on tests/test_engine_join_stream.py's warehouse:
  ``chunks - 1`` hits on a cold stream, an empty build side, a fully
  filtered probe chunk, duplicate build hashes vetoed to the interpreter
  (its measures have three decimals, so their sums are held within rel
  1e-9).
- All seven ``Join.how`` through the engine, as sorted multisets against
  JAX (tests/test_torch_join_outer.py holds the new joins at the op level,
  in JAX's row order).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import test_engine_join_stream as tjs
from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import plan as jplan
from spark_rapids_jni_tpu_torch import engine as pe
from test_torch_engine import CPU, assert_rows_close, rows, run_both, \
    to_port

torch.set_num_threads(1)


# -- streamed probe joins and the build cache ---------------------------------

@pytest.fixture(scope="module")
def jwh(tmp_path_factory):
    """tests/test_engine_join_stream.py's warehouse."""
    return tjs.warehouse.__wrapped__(tmp_path_factory)


def _build_cache_deltas(fn):
    """Run ``fn`` once per package; the (hits, misses) it caused in each
    package's BUILD_CACHE."""
    out = []
    for eng in (je, pe):
        h0, m0 = eng.BUILD_CACHE.hits, eng.BUILD_CACHE.misses
        fn(eng)
        out.append((eng.BUILD_CACHE.hits - h0, eng.BUILD_CACHE.misses - m0))
    return out


def _exec(eng, plan, stats=None, fused=True):
    kw = {"device": CPU} if eng is pe else {}
    p = plan if eng is je else to_port(plan)
    return eng.execute(eng.optimize(p), stats=stats, fused=fused, **kw)


def test_build_cache_cold_stream_hits_chunks_minus_one(jwh):
    plan = tjs.join_agg_plan(jwh / "fact.parquet", jwh / "dim.parquet",
                             24 * 1_024)
    stats, res = {}, {}
    for eng in (je, pe):
        eng.BUILD_CACHE.clear()

    def run(eng):
        stats[eng] = eng.new_stats()
        res[eng] = _exec(eng, plan, stats[eng])

    (jh, jm), (ph, pm) = _build_cache_deltas(run)
    n = stats[pe]["chunks"]
    assert n > 1 and stats[pe]["fused_segments"] == 1
    assert (ph, pm) == (jh, jm) == (n - 1, 1)
    assert_rows_close(rows(res[pe]), rows(res[je]))
    # a repeat hits on every chunk
    assert _build_cache_deltas(run) == [(n, 0), (n, 0)]


@pytest.mark.parametrize("how", ["inner", "semi"])
def test_empty_build_side(jwh, tmp_path, how):
    pq.write_table(pa.table({
        "dk": pa.array(np.zeros(0, np.int64)),
        "dv": pa.array(np.zeros(0, np.int64)),
    }), tmp_path / "empty_dim.parquet")
    plan = tjs.join_agg_plan(jwh / "fact.parquet",
                             tmp_path / "empty_dim.parquet", 24 * 1_024,
                             how=how)
    st = pe.new_stats()
    pt = _exec(pe, plan, st)
    jt = _exec(je, plan)
    assert st["streamed"]
    assert pt.num_rows == 0 == jt.num_rows
    assert list(pt.names) == list(jt.names)


def test_fully_filtered_probe_chunk(jwh):
    plan = tjs.join_agg_plan(jwh / "deadfirst.parquet", jwh / "dim.parquet",
                             4_000)
    st = pe.new_stats()
    pt = _exec(pe, plan, st)
    assert st["chunks"] >= 2 and st["fused_segments"] == 1
    assert_rows_close(rows(pt), rows(_exec(je, plan)))
    assert_rows_close(rows(pt), rows(_exec(pe, plan, fused=False)))


def test_duplicate_build_hashes_fall_back(jwh):
    chunked = tjs.join_agg_plan(jwh / "fact.parquet", jwh / "dupdim.parquet",
                                24 * 1_024)
    whole = tjs.join_agg_plan(jwh / "fact.parquet", jwh / "dupdim.parquet")
    st = pe.new_stats()
    pt = _exec(pe, chunked, st)
    assert st["streamed"] and st["fused_segments"] == 0
    # against JAX's whole-table run (its chunked run compiles per chunk
    # shape; tests/test_engine_join_stream.py holds the two equal)
    assert_rows_close(rows(pt), rows(_exec(je, whole, fused=False)))


# -- joins -------------------------------------------------------------------

@pytest.fixture(scope="module")
def join_files(tmp_path_factory):
    """Two small tables with null and duplicate keys on both sides and a
    STRING payload."""
    root = tmp_path_factory.mktemp("joins")
    rng = np.random.default_rng(41)
    n = 60
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 15, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "v": pa.array(rng.integers(-9, 9, n) / 4.0),
        "s": pa.array([f"s{i % 7}" for i in range(n)]),
    }), root / "l.parquet")
    pq.write_table(pa.table({
        "rk": pa.array(rng.integers(5, 25, 30), pa.int64(),
                       mask=rng.random(30) < 0.1),
        "v": pa.array(rng.integers(0, 50, 30), pa.int64()),
    }), root / "r.parquet")
    return root


@pytest.mark.parametrize("how", jplan.JOIN_HOWS)
def test_every_join_how_matches_jax(join_files, how):
    keys = ((), ()) if how == "cross" else (("k",), ("rk",))
    plan = je.Join(je.Scan(join_files / "l.parquet"),
                   je.Scan(join_files / "r.parquet"), *keys, how=how)
    jt, _, pt, _ = run_both(plan)
    assert list(pt.names) == list(jt.names)
    assert rows(pt) == rows(jt)
