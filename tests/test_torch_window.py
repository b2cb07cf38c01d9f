"""Parity of the port's ``ops/window.py``, ``ops/selection.py::distinct`` and
``ops/aggregate.py``'s collect_list and nunique/count_distinct with the JAX
package's.

Inputs are seeded numpy draws with ties on the order keys and nulls in
the values.  Both packages run on the CPU (the port with
``device="cpu"``).  Tolerance: none.  The port's window adds float sums in
the JAX package's order (the same segmented doubling scan), so even
standard-normal float sums, means and rolling sums agree bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import order as jorder
from spark_rapids_jni_tpu.ops import selection as jsel

from spark_rapids_jni_tpu_torch.columnar.interop import (
    HostColumn, table_from_numpy, table_to_numpy)
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import order as porder
from spark_rapids_jni_tpu_torch.ops import selection as psel
from spark_rapids_jni_tpu_torch.ops import window as pwin

torch.set_num_threads(1)
jwin = importlib.import_module("spark_rapids_jni_tpu.ops.window")


def port_table(jt):
    return table_from_numpy([HostColumn.of(c) for c in jt.columns],
                            jt.names, device="cpu")


def assert_tables_equal(want, got):
    assert list(got.names) == list(want.names)
    for jc, pc in zip([HostColumn.of(c) for c in want.columns],
                      table_to_numpy(got)):
        assert (jc.type_id, jc.scale) == (pc.type_id, pc.scale)
        assert (jc.validity is None) == (pc.validity is None)
        if jc.validity is not None:
            np.testing.assert_array_equal(jc.validity, pc.validity)
        if jc.chars is not None:
            np.testing.assert_array_equal(jc.offsets, pc.offsets)
            np.testing.assert_array_equal(jc.chars, pc.chars)
        else:
            np.testing.assert_array_equal(
                np.ascontiguousarray(jc.data).view(np.uint8),
                np.ascontiguousarray(pc.data).view(np.uint8))


def data_table(n=1500, seed=11):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * 10
    v[rng.random(n) < 0.02] = np.nan
    v[:3] = [np.inf, -np.inf, np.inf]
    return JTable([
        JColumn.fixed(jdt.INT64, rng.integers(0, 40, n)),
        JColumn.fixed(jdt.INT32, rng.integers(0, 50, n).astype(np.int32),
                      validity=rng.random(n) > 0.05),
        JColumn.fixed(jdt.FLOAT64, v, validity=rng.random(n) > 0.12),
        JColumn.fixed(jdt.INT64, rng.integers(-10**6, 10**6, n)),
        JColumn.fixed(jdt.FLOAT32, (rng.integers(-400, 400, n) / 4)
                      .astype(np.float32), validity=rng.random(n) > 0.1),
        JColumn.fixed(jdt.decimal64(-2), rng.integers(-10**5, 10**5, n),
                      validity=rng.random(n) > 0.1),
        JColumn.fixed(jdt.UINT32, rng.integers(0, 2**32, n, dtype=np.uint64)
                      .astype(np.uint32)),
    ], ["p", "o", "v", "i", "f", "d", "u"])


RANKS = [(None, "row_number"), (None, "rank"), (None, "dense_rank"),
         (None, "percent_rank"), (None, "cume_dist"), (None, "ntile", 4),
         (None, "ntile", 7), (None, "count")]
VALUE_OPS = ["sum", "min", "max", "count", "mean", "first_value",
             "last_value"]
SHIFTS = [("lag", 1), ("lead", 2), ("lag", -3), ("lag", 0), ("lead", 10**6)]
ROLLING = [("rolling_sum", 3), ("rolling_count", 5), ("rolling_mean", 4)]


def specs_for(col):
    specs = [(col, op) for op in VALUE_OPS]
    specs += [(col, op, k) for op, k in SHIFTS]
    specs += [(col, op, k) for op, k in ROLLING]
    return specs


@pytest.mark.parametrize("value", ["v", "i", "f", "d", "u"])
@pytest.mark.parametrize("keys", ["p_o", "p_only", "o_desc", "none_o"])
def test_window_matches_jax(value, keys):
    jt = data_table()
    pt = port_table(jt)
    part = {"p_o": ["p"], "p_only": ["p"], "o_desc": ["p"],
            "none_o": []}[keys]

    def order(mod, t):
        if keys == "p_only":
            return []
        if keys == "o_desc":
            return [mod.SortKey(t["o"], ascending=False), "i"]
        return ["o"]
    specs = RANKS + specs_for(value)
    want = jwin.window(jt, part, order(jorder, jt), specs)
    got = pwin.window(pt, part, order(porder, pt), specs)
    assert_tables_equal(want, got)


def test_window_live_mask_matches_jax():
    jt = data_table(600, 3)
    pt = port_table(jt)
    live = np.random.default_rng(4).random(600) > 0.3
    specs = [(None, "row_number"), ("v", "sum"), ("i", "max"), ("v", "lag")]
    want = jwin.window(jt, ["p"], ["o"], specs,
                       live=jnp.asarray(live))
    got = pwin.window(pt, ["p"], ["o"], specs, live=torch.from_numpy(live))
    for w, g in zip(want.columns[-4:], got.columns[-4:]):
        wv = np.asarray(w.data)[live]
        gv = g.data.numpy()[live]
        np.testing.assert_array_equal(wv.view(np.uint8), gv.view(np.uint8))


def test_window_errors_match_jax():
    jt = data_table(50)
    pt = port_table(jt)
    for specs, exc in (([(None, "sum")], ValueError),
                       ([("v", "ntile", 0)], ValueError),
                       ([("v", "rolling_sum", 0)], ValueError),
                       ([("v", "median")], ValueError)):
        for mod, t in ((jwin, jt), (pwin, pt)):
            with pytest.raises(exc):
                mod.window(t, ["p"], ["o"], specs)
    assert pwin.default_window_names(specs_for("v")) == \
        jwin.default_window_names(specs_for("v"))
    for op in ("row_number", "sum", "mean", "min", "rolling_count"):
        for name in ("INT32", "FLOAT32", "FLOAT64"):
            from spark_rapids_jni_tpu_torch import dtypes as pdt
            assert pwin.window_out_dtype(getattr(pdt, name), op).id == \
                jwin.window_out_dtype(getattr(jdt, name), op).id


# ------------------------------------------------------------ distinct

@pytest.mark.parametrize("subset", [None, ["k1"], ["k1", "s"], ["s"]])
def test_distinct_matches_jax(subset):
    rng = np.random.default_rng(97)
    n = 2000
    words = np.array(["red", "blue", "plum", "", "misty"], object)
    s = [None if x < 0.05 else words[i] for x, i in
         zip(rng.random(n), rng.integers(0, 5, n))]
    jt = JTable([
        JColumn.fixed(jdt.INT64, rng.integers(0, 30, n),
                      validity=rng.random(n) > 0.05),
        JColumn.fixed(jdt.INT32, rng.integers(0, 4, n).astype(np.int32)),
        JColumn.from_pylist(s),
        JColumn.fixed(jdt.FLOAT64, rng.integers(0, 3, n) / 2.0),
    ], ["k1", "k2", "s", "x"])
    assert_tables_equal(jsel.distinct(jt, subset),
                        psel.distinct(port_table(jt), subset))


# ------------------------------------------- collect_list and nunique

def agg_table(n=1200, seed=5):
    rng = np.random.default_rng(seed)
    words = np.array(["a", "bb", "ccc", "dddd", "é"], object)
    return JTable([
        JColumn.fixed(jdt.INT32, rng.integers(0, 25, n).astype(np.int32),
                      validity=rng.random(n) > 0.05),
        JColumn.fixed(jdt.INT64, rng.integers(0, 3, n)),
        JColumn.fixed(jdt.INT64, rng.integers(-9, 9, n),
                      validity=rng.random(n) > 0.2),
        JColumn.fixed(jdt.FLOAT64, rng.integers(-8, 8, n) / 4.0,
                      validity=rng.random(n) > 0.1),
        JColumn.from_pylist([None if x < 0.1 else words[i] for x, i in
                             zip(rng.random(n), rng.integers(0, 5, n))]),
    ], ["k", "k2", "v", "f", "s"])


def _list_equal(jc, pc):
    np.testing.assert_array_equal(np.asarray(jc.offsets), pc.offsets.numpy())
    assert jc.children[0].to_pylist() == pc.children[0].to_pylist()
    assert (jc.validity is None) == (pc.validity is None)


@pytest.mark.parametrize("keys", [["k"], ["k", "k2"]])
def test_collect_list_matches_jax(keys):
    jt = agg_table()
    aggs = [("v", "collect_list"), ("v", "sum"), ("f", "collect_list"),
            ("s", "collect_list"), ("v", "count")]
    want = jagg.groupby(jt, keys, aggs)
    got = pagg.groupby(port_table(jt), keys, aggs, device="cpu")
    assert list(got.names) == list(want.names)
    for (ref, op), jc, pc in zip([(k, "key") for k in keys] + aggs,
                                 want.columns, got.columns):
        if op == "collect_list":
            _list_equal(jc, pc)
        else:
            assert jc.to_pylist() == pc.to_pylist()


@pytest.mark.parametrize("op", ["nunique", "count_distinct"])
def test_nunique_matches_jax(op):
    jt = agg_table(seed=6)
    aggs = [("v", op), ("f", "max"), ("s", op), ("k2", op), ("f", op)]
    want = jagg.groupby(jt, ["k"], aggs)
    got = pagg.groupby(port_table(jt), ["k"], aggs, device="cpu")
    assert_tables_equal(want, got)
    both = [("v", op), ("s", "collect_list")]
    want = jagg.groupby(jt, ["k"], both)
    got = pagg.groupby(port_table(jt), ["k"], both, device="cpu")
    assert want.columns[1].to_pylist() == got.columns[1].to_pylist()
    _list_equal(want.columns[2], got.columns[2])
