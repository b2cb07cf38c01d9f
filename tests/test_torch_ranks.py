"""The mesh across processes: the exchange layer on 2 ranks of 4 shards.

``parallel.ranks.spawn`` starts 2 gloo ranks on the CPU (a ``FileStore``,
no TCP port) once for the file; every case runs in that pair
(``tests/torch_rank_cases.py``, which imports the port only) and the tests
read its results.  The JAX package runs in this process on its 8 virtual
devices (tests/conftest.py), over the same seeded inputs.

Pinned bit for bit (tolerance: none): each rank's received shuffle slots
(data, validity) and live mask against its half of JAX's 8-device
``shuffle_table_padded`` (INT32 key, two keys, a hot key over an explicit
capacity whose overflow is summed over the ranks, STRING key and payload,
padded rows with a live mask); ``partition_counts`` equal on both ranks
and to JAX's; the distributed groupby (sum/count/min/max/count_all exact;
float mean, var and std within rel 1e-9, as tests/test_torch_distributed.py
holds them), the inner and semi joins, cross join and window as sorted
rows against JAX and every join kind against the plain sort-merge join of
the whole tables (as test_torch_distributed.py holds the outer and anti
joins, where JAX sends its padding row); the spilled shuffle against the
one-process port.  Then: a group of one rank gives what no
group gives; NCCL on the CPU or for two ranks of one card raises; a rank
that dies makes ``spawn`` raise within the timeout.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_rank_cases as C
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import shuffle as jsh
from test_torch_distributed import assert_rows_close
from test_torch_exchange import jnp_live, same_column

from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel import ranks as pranks
from spark_rapids_jni_tpu_torch.parallel.spill import shuffle_table_spilled

torch.set_num_threads(1)
WORLD = 2
TIMEOUT = 60.0


def _timed_failure(fn):
    """(the exception ``spawn`` raised, its seconds) for ranks that fail."""
    t0 = time.monotonic()
    try:
        pranks.spawn(fn, WORLD, "gloo", ["cpu"] * WORLD, timeout=20.0)
    except RuntimeError as e:
        return e, time.monotonic() - t0
    return None, time.monotonic() - t0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the file, started at once in the background: the
    exchange cases on 2 ranks, one rank alone, and a rank that dies; the
    JAX side compiles meanwhile."""
    spill = tmp_path_factory.mktemp("spill")
    pool = ThreadPoolExecutor(3)
    yield {"ranked": pool.submit(pranks.spawn, C.run_parallel, WORLD,
                                 "gloo", ["cpu"] * WORLD, TIMEOUT,
                                 args=(str(spill),)),
           "one": pool.submit(pranks.spawn, C.run_one_rank, 1, "gloo",
                              ["cpu"], TIMEOUT),
           "dying": pool.submit(_timed_failure, C.run_dying)}
    pool.shutdown()


@pytest.fixture
def ranked(runs, jm):
    return runs["ranked"].result()


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_mesh(C.NDEV)


def jtable(arrays, lo=0, hi=None):
    cols = []
    for val in arrays.values():
        if isinstance(val, list):
            cols.append(JColumn.from_pylist(val[lo:hi]))
        else:
            data, valid = val
            cols.append(JColumn.from_numpy(
                data[lo:hi], validity=None if valid is None
                else valid[lo:hi]))
    return JTable(cols, list(arrays))


def rows_of(names_cols):
    _, cols = names_cols
    return sorted(zip(*cols), key=lambda r: tuple((v is not None, v)
                                                  for v in r))


def joined(results, key):
    """The ranks' results of one case put together in rank order."""
    names = results[0][key][0]
    assert all(r[key][0] == names for r in results)
    return names, [sum((r[key][1][i] for r in results), [])
                   for i in range(len(names))]


def assert_rank_slices(jout, results, key):
    """Each rank's slots are its half of JAX's (dst-major) grid."""
    jt, jok, jovf = jout
    jok = np.asarray(jok)
    half = jok.shape[0] // WORLD
    for r, res in enumerate(results):
        cols, ok, ovf = res[key]
        sl = slice(r * half, (r + 1) * half)
        np.testing.assert_array_equal(ok, jok[sl])
        assert ovf == int(jovf)
        assert [nm for nm, _ in cols] == list(jt.names)
        for (_, got), want in zip(cols, jt.columns):
            if got.chars is not None:
                assert column_from_numpy(got, device="cpu").to_pylist() \
                    == want.to_pylist()[sl]
            else:
                hw = HostColumn.of(want)
                np.testing.assert_array_equal(
                    np.ascontiguousarray(got.data).view(np.uint8),
                    np.ascontiguousarray(hw.data[sl]).view(np.uint8))
                gv = np.ones(half, bool) if got.validity is None \
                    else got.validity
                wv = np.ones(half, bool) if hw.validity is None \
                    else hw.validity[sl]
                np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("name", sorted(C.SHUFFLES))
def test_shuffle_slots_match_jax(ranked, jm, name):
    make, keys, cap = C.SHUFFLES[name]
    arrays = make()
    jt = jtable(arrays)
    if not any(isinstance(v, list) for v in arrays.values()):
        jt = jmesh.shard_table(jt, jm)
    jout = jsh.shuffle_table_padded(jt, jm, keys, capacity=cap)
    assert_rank_slices(jout, ranked, f"shuffle/{name}")
    if cap is not None:
        assert ranked[0][f"shuffle/{name}"][2] == 512 - C.NDEV * cap


def test_padded_live_shuffle_matches_jax(ranked, jm):
    jp, n = jmesh.pad_to_multiple(jtable(C.fixed_arrays(1001, 4)), C.NDEV)
    live = np.arange(jp.num_rows) < n
    jout = jsh.shuffle_table_padded(jmesh.shard_table(jp, jm), jm, ["k"],
                                    live=jnp_live(live, jm))
    assert_rank_slices(jout, ranked, "shuffle/padded-live")
    assert sum(int(r["shuffle/padded-live"][1].sum()) for r in ranked) \
        == 1001


def test_partition_counts_equal_on_every_rank_and_jax(ranked, jm):
    jt = jtable(C.fixed_arrays(2048, 7, 50))
    want = np.asarray(jsh.partition_counts(jmesh.shard_table(jt, jm), jm,
                                           ["k"]))
    for res in ranked:
        np.testing.assert_array_equal(res["counts"], want)


def test_groupby_matches_jax(ranked, jm):
    """2043 rows: the ranks pad their blocks as JAX pads the table."""
    jt = jtable(C.kv_arrays(2043, 30, 3))
    jgot = jdist.distributed_groupby(jt, jm, ["k"], C.AGGS)
    got = joined(ranked, "groupby/2043")
    assert got[0] == list(jgot.names)
    assert_rows_close(rows_of(got), rows_of(
        (None, [c.to_pylist() for c in jgot.columns])))


def test_groupby_string_keys_matches_jax(ranked, jm):
    words = ["alpha", "b", "charlie-delta-echo", "", "δδ"]
    jt = JTable([JColumn.from_pylist([None if i % 13 == 0 else words[i % 5]
                                      for i in range(776)]),
                 JColumn.from_numpy(np.arange(776, dtype=np.int64))],
                ["s", "v"])
    jgot = jdist.distributed_groupby(jt, jm, ["s"], [("v", "sum"),
                                                     ("s", "count"),
                                                     ("v", "max")])
    assert rows_of(joined(ranked, "groupby/string-keys")) == rows_of(
        (None, [c.to_pylist() for c in jgot.columns]))


@pytest.mark.parametrize("how", ["inner", "left", "full", "semi", "anti"])
def test_join_matches_jax_and_sort_merge_join(ranked, jm, how):
    """Every kind against the plain sort-merge join of the whole tables;
    inner and semi against JAX's as well."""
    la, ra = C.join_arrays(11)
    got = joined(ranked, f"join/{how}")
    want = pjoin.sort_merge_join(C.port_table(la), C.port_table(ra), ["k"],
                                 how=how, device="cpu")
    assert got[0] == list(want.names)
    assert rows_of(got) == rows_of(C.pylists(want))
    if how in ("inner", "semi"):
        jgot = jdist.distributed_join(jtable(la), jtable(ra), jm, ["k"],
                                      how=how)
        assert rows_of(got) == rows_of((None, [c.to_pylist()
                                               for c in jgot.columns]))


def test_cross_join_matches_jax(ranked, jm):
    la, ra = C.join_arrays(12, 37, 11)
    jgot = jdist.distributed_cross_join(jtable(la).select(["lv"]),
                                        jtable(ra), jm)
    assert rows_of(joined(ranked, "cross_join")) == rows_of(
        (None, [c.to_pylist() for c in jgot.columns]))


def test_window_matches_jax(ranked, jm):
    jgot = jdist.distributed_window(jtable(C.kv_arrays(500, 12, 13)), jm,
                                    ["k"], [("v", False)], C.WINDOW)
    got = joined(ranked, "window")
    assert got[0] == list(jgot.names)
    assert rows_of(got) == rows_of((None, [c.to_pylist()
                                           for c in jgot.columns]))


def test_spilled_shuffle_matches_one_process(ranked, tmp_path):
    arrays = C.kv_arrays(4096, 40, 21)
    mesh = pmesh.make_mesh(C.NDEV, device="cpu")
    one = shuffle_table_spilled(C.port_table(arrays), mesh, ["k"],
                                hbm_budget_bytes=1 << 12,
                                spill_dir=str(tmp_path))
    assert rows_of(joined(ranked, "spilled")) == rows_of(C.pylists(one))
    # each rank holds the rows of its own shards
    for r, res in enumerate(ranked):
        keys = [k for k in res["spilled"][1][0]]
        t = C.port_table({"k": (np.array([0 if k is None else k
                                          for k in keys], np.int64),
                                np.array([k is not None for k in keys]))})
        from spark_rapids_jni_tpu_torch.parallel.shuffle import \
            partition_ids
        dest = partition_ids(t, C.NDEV).numpy()
        assert ((dest // (C.NDEV // WORLD)) == r).all()


def test_one_rank_group_gives_the_one_process_answer(runs):
    want = C.one_process_parallel()
    (got,) = runs["one"].result()
    (gc, gok, govf), (wc, wok, wovf) = got["shuffle/int32-key"], \
        want["shuffle/int32-key"]
    np.testing.assert_array_equal(gok, wok)
    assert govf == wovf
    for (gn, g), (wn, w) in zip(gc, wc):
        assert gn == wn
        same_column(g, w)


def test_nccl_refused_before_it_can_hang(tmp_path):
    with pytest.raises(ValueError, match="CUDA device"):
        pranks.init_ranks("nccl", 0, 1, f"file://{tmp_path / 'store'}",
                          device="cpu")
    with pytest.raises(ValueError, match="two ranks on one device"):
        pranks.check_nccl_devices(torch.device("cuda", 0),
                                  ["GPU-a", "GPU-b", "GPU-a"])
    pranks.check_nccl_devices(torch.device("cuda", 1), ["GPU-a", "GPU-b"])
    with pytest.raises(ValueError, match="backend"):
        pranks.init_ranks("mpi", 0, 1, f"file://{tmp_path / 'store'}",
                          device="cpu")
    assert not torch.distributed.is_initialized()


def test_dead_rank_makes_spawn_raise(runs):
    """A rank whose process dies without a word fails the run well within
    the group's timeout (a raising rank: tests/test_torch_ranks_engine.py);
    the launcher stops the survivor."""
    err, seconds = runs["dying"].result()
    assert err is not None and "exit 7" in str(err)
    assert seconds < 20.0
