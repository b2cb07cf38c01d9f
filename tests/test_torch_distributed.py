"""Distributed plans of the exchange layer: the port on 8 shards against the
single-device port and the JAX package's 8-device CPU mesh.

``distributed_groupby`` (sum/count/min/max/mean/var/std; null keys; rows
that do not split into equal shards; pre-padded input with
``n_valid_rows``; STRING keys), ``distributed_join`` (every ``how``;
STRING keys of mismatched widths; an explicit capacity that overflows
raises), ``distributed_cross_join`` and ``distributed_window``, on the
1 x 8 and the 2 x 4 multislice mesh.  Results compare as sorted multisets
of rows.  Tolerance: keys, counts, integer aggregates and window values
exact; float means and moments within rel 1e-9 (the shards sum in another
order than one device).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
from spark_rapids_jni_tpu_torch.ops.order import SortKey
from spark_rapids_jni_tpu_torch.ops.window import window
from spark_rapids_jni_tpu_torch.parallel import distributed as pdist
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)
NDEV = 8


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(NDEV), pmesh.make_mesh(NDEV, device="cpu")


def to_port(jt):
    return Table([column_from_numpy(HostColumn.of(c), device="cpu")
                  for c in jt.columns], jt.names)


def rows(table):
    cols = [c.to_pylist() for c in table.columns]
    return sorted(zip(*cols), key=lambda r: tuple((v is not None, v)
                                                  for v in r))


def assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12), (g, w)
            else:
                assert a == b, (g, w)


def kv_table(n, nkeys, seed, key_nulls=0.1):
    rng = np.random.default_rng(seed)
    return JTable([
        JColumn.from_numpy(rng.integers(0, nkeys, n).astype(np.int64),
                           validity=rng.random(n) > key_nulls),
        JColumn.from_numpy(rng.integers(-100, 100, n).astype(np.int64),
                           validity=rng.random(n) > 0.2),
        JColumn.from_numpy(rng.standard_normal(n) * 10 + 1e6),
    ], ["k", "v", "f"])


AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
        ("f", "mean"), ("f", "var"), ("f", "std"), ("v", "count_all")]


@pytest.mark.parametrize("n", [2048, 2043])
def test_groupby_matches_single_device_and_jax(meshes, n):
    jm, pm = meshes
    jt = kv_table(n, 30, 3)
    pt = to_port(jt)
    got = pdist.distributed_groupby(pt, pm, ["k"], AGGS)
    want = groupby(pt, ["k"], AGGS, device="cpu")
    assert_rows_close(rows(got), rows(want))
    jgot = jdist.distributed_groupby(jt, jm, ["k"], AGGS)
    assert list(got.names) == list(jgot.names)
    assert_rows_close(rows(got), rows(jgot))


def test_groupby_prepadded_with_n_valid(meshes):
    _, pm = meshes
    pt = to_port(kv_table(1001, 9, 4, key_nulls=0.3))
    padded, n = pmesh.pad_to_multiple(pt, NDEV)
    got = pdist.distributed_groupby(padded, pm, ["k"], [("v", "sum"),
                                                        ("v", "count_all")],
                                    n_valid_rows=n)
    want = groupby(pt, ["k"], [("v", "sum"), ("v", "count_all")],
                   device="cpu")
    assert rows(got) == rows(want)
    with pytest.raises(ValueError):
        pdist.distributed_groupby(pt, pm, ["k"], [("v", "sum")],
                                  n_valid_rows=1001)


def test_groupby_string_keys(meshes):
    jm, pm = meshes
    words = ["alpha", "b", "charlie-delta-echo", "", "δδ"]
    vals = [None if i % 13 == 0 else words[i % 5] for i in range(777)]
    jt = JTable([JColumn.from_pylist(vals),
                 JColumn.from_numpy(np.arange(777, dtype=np.int64))],
                ["s", "v"])
    pt = to_port(jt)
    aggs = [("v", "sum"), ("s", "count"), ("v", "max")]
    got = pdist.distributed_groupby(pt, pm, ["s"], aggs)
    assert rows(got) == rows(groupby(pt, ["s"], aggs, device="cpu"))
    assert rows(got) == rows(jdist.distributed_groupby(jt, jm, ["s"], aggs))


def join_sides(seed, nl=301, nr=257):
    rng = np.random.default_rng(seed)
    left = JTable([JColumn.from_numpy(rng.integers(0, 40, nl).astype(
        np.int64), validity=rng.random(nl) > 0.1),
        JColumn.from_numpy(np.arange(nl, dtype=np.int64))], ["k", "lv"])
    right = JTable([JColumn.from_numpy(rng.integers(0, 40, nr).astype(
        np.int64), validity=rng.random(nr) > 0.1),
        JColumn.from_numpy(np.arange(nr, dtype=np.int64) * 7)], ["k", "rv"])
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_join_every_how(meshes, how):
    jm, pm = meshes
    jl, jr = join_sides(11)
    pl, pr = to_port(jl), to_port(jr)
    got = pdist.distributed_join(pl, pr, pm, ["k"], how=how)
    want = pjoin.sort_merge_join(pl, pr, ["k"], how=how, device="cpu")
    assert list(got.names) == list(want.names)
    assert rows(got) == rows(want)
    if how in ("inner", "semi"):
        assert rows(got) == rows(jdist.distributed_join(jl, jr, jm, ["k"],
                                                        how=how))


def test_join_string_keys_mismatched_widths(meshes):
    jm, pm = meshes
    ls = [["a", "bb", "a-much-longer-key-value-here"][i % 3]
          for i in range(200)]
    rs = [["a", "bb", "zz"][i % 3] for i in range(120)]
    jl = JTable([JColumn.from_pylist(ls),
                 JColumn.from_numpy(np.arange(200, dtype=np.int64))],
                ["s", "lv"])
    jr = JTable([JColumn.from_pylist(rs),
                 JColumn.from_numpy(np.arange(120, dtype=np.int64))],
                ["s", "rv"])
    pl, pr = to_port(jl), to_port(jr)
    for how in ("inner", "full"):
        got = pdist.distributed_join(pl, pr, pm, ["s"], how=how)
        assert rows(got) == rows(pjoin.sort_merge_join(pl, pr, ["s"],
                                                       how=how,
                                                       device="cpu"))
    assert rows(pdist.distributed_join(pl, pr, pm, ["s"])) == \
        rows(jdist.distributed_join(jl, jr, jm, ["s"]))


def test_join_explicit_capacity_overflow_raises(meshes):
    _, pm = meshes
    t = to_port(JTable([JColumn.from_numpy(np.zeros(256, np.int64))],
                       ["k"]))
    with pytest.raises(RuntimeError, match="overflow"):
        pdist.distributed_join(t, t, pm, ["k"], capacity=4)


def test_cross_join_and_window(meshes):
    jm, pm = meshes
    jl, jr = join_sides(12, 37, 11)
    pl, pr = to_port(jl), to_port(jr)
    got = pdist.distributed_cross_join(pl.select(["lv"]), pr, pm)
    assert rows(got) == rows(pjoin.cross_join(pl.select(["lv"]), pr,
                                              device="cpu"))
    assert rows(got) == rows(jdist.distributed_cross_join(jl.select(["lv"]),
                                                          jr, jm))
    jt = kv_table(500, 12, 13)
    pt = to_port(jt)
    specs = [(None, "row_number"), ("v", "sum"), ("v", "max")]
    got = pdist.distributed_window(pt, pm, ["k"], [("v", False)], specs)
    want = window(pt, ["k"], [SortKey(pt["v"], ascending=False)], specs)
    assert list(got.names) == list(want.names)
    assert rows(got) == rows(want)


def test_multislice_groupby_and_join():
    pm = pmesh.make_multislice_mesh(2, 4, device="cpu")
    axis = ("dcn", "shard")
    pt = to_port(kv_table(NDEV * 40, 13, 71))
    got = pdist.distributed_groupby(pt, pm, ["k"], [("v", "sum"),
                                                    ("v", "count")],
                                    axis=axis)
    assert rows(got) == rows(groupby(pt, ["k"], [("v", "sum"),
                                                 ("v", "count")],
                                     device="cpu"))
    jl, jr = join_sides(72, NDEV * 12, NDEV * 9)
    pl, pr = to_port(jl), to_port(jr)
    got = pdist.distributed_join(pl, pr, pm, ["k"], how="full", axis=axis)
    assert rows(got) == rows(pjoin.full_join(pl, pr, ["k"], device="cpu"))
