"""GroupBy parity: the torch port's groupby / groupby_padded against the JAX
package's, for every aggregation the port implements.

Inputs are made with numpy from fixed seeds; the port runs with
``device="cpu"``.  Tolerance: bit-exact for every output (keys, counts,
integer sums, min/max, first/last, validity).  Float sums, means and
moments are bit-exact too because they only run over quarter-valued floats
(k/4 with |k| < 2^10) or int16 values: every partial sum is exact in
float64, so the two packages' different summation orders cannot differ.
The wide int64 and the decimal column take only the integer-exact ops.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import aggregate as jagg

from spark_rapids_jni_tpu_torch.columnar.interop import (
    HostColumn, table_from_numpy, table_to_numpy)
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg

torch.set_num_threads(1)

FAST_OPS = ["sum", "min", "max", "mean", "count", "count_all", "var", "std",
            "sumsq", "fsum"]


def port_table(jt):
    return table_from_numpy([HostColumn.of(c) for c in jt.columns],
                            jt.names, device="cpu")


def assert_tables_equal(want: JTable, got):
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
        else:  # every slot's bits, null slots included
            np.testing.assert_array_equal(
                np.ascontiguousarray(jc.data).view(np.uint8),
                np.ascontiguousarray(pc.data).view(np.uint8))


def quarters(rng, n, dtype):
    return (rng.integers(-1000, 1000, n) / 4.0).astype(dtype)


def value_table(n, nkeys, seed):
    rng = np.random.default_rng(seed)
    u32 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return JTable([
        JColumn.fixed(jdt.INT32, rng.integers(0, nkeys, n).astype(np.int32),
                      validity=rng.random(n) > 0.1),
        JColumn.fixed(jdt.INT64, rng.integers(-2**62, 2**62, n)
                      .astype(np.int64)),
        JColumn.fixed(jdt.FLOAT64, quarters(rng, n, np.float64),
                      validity=rng.random(n) > 0.2),
        JColumn.fixed(jdt.FLOAT32, quarters(rng, n, np.float32)),
        JColumn.fixed(jdt.INT16, rng.integers(-2**15, 2**15 - 1, n)
                      .astype(np.int16), validity=rng.random(n) > 0.5),
        JColumn.fixed(jdt.UINT32, u32),
        JColumn.fixed(jdt.decimal64(-2), rng.integers(-10**6, 10**6, n)
                      .astype(np.int64), validity=rng.random(n) > 0.3),
    ], ["k", "i64", "f64", "f32", "i16", "u32", "dec"])


@pytest.mark.parametrize("n,nkeys", [(1000, 37), (77, 5), (0, 3)])
def test_fast_ops_match_jax(n, nkeys):
    jt = value_table(n, nkeys, seed=n)
    # float moments (var, std, sumsq, fsum) only over quarter-valued or
    # small columns, where they are exact; the wide int64 and the decimal
    # (scaled by 0.01, inexact in binary) take the integer-exact ops
    aggs = [(c, op) for c in ("f64", "f32", "i16") for op in FAST_OPS]
    aggs += [(c, op) for c in ("i64", "dec", "u32")
             for op in ("sum", "min", "max", "mean", "count")]
    want = jagg.groupby(jt, ["k"], aggs)
    got = pagg.groupby(port_table(jt), ["k"], aggs, device="cpu")
    assert_tables_equal(want, got)


def test_first_last_match_jax():
    jt = value_table(500, 11, seed=5)
    aggs = [(c, op) for c in ("i64", "f64", "i16", "dec")
            for op in ("first", "last", "sum", "count", "min")]
    want = jagg.groupby(jt, ["k"], aggs)
    got = pagg.groupby(port_table(jt), ["k"], aggs, device="cpu")
    assert_tables_equal(want, got)


def test_multi_key_and_float_keys_match_jax():
    """Two keys, one of them FLOAT64 with -0.0, 0.0 and NaN payloads: Spark
    groups -0.0 with 0.0 and every NaN together."""
    rng = np.random.default_rng(11)
    n = 400
    f = rng.integers(-3, 3, n).astype(np.float64)
    bits = f.view(np.uint64)
    bits[rng.random(n) < 0.1] = 0x8000000000000000        # -0.0
    bits[rng.random(n) < 0.1] = 0x7FF8000000000000        # NaN
    bits[rng.random(n) < 0.05] = 0xFFF0000000000042       # another NaN
    jt = JTable([
        JColumn.fixed(jdt.FLOAT64, f, validity=rng.random(n) > 0.1),
        JColumn.fixed(jdt.BOOL8, rng.integers(0, 2, n).astype(np.uint8)),
        JColumn.fixed(jdt.INT64, rng.integers(-99, 99, n).astype(np.int64)),
    ], ["f", "b", "v"])
    aggs = [("v", "sum"), ("v", "count_all"), ("f", "max"), ("f", "min")]
    want = jagg.groupby(jt, ["f", "b"], aggs)
    got = pagg.groupby(port_table(jt), ["f", "b"], aggs, device="cpu")
    assert_tables_equal(want, got)


def test_string_keys_match_jax():
    rng = np.random.default_rng(12)
    words = ["", "a", "apple", "apples", "b", "zz" * 9]
    n = 300
    keys = [words[k] if k else None for k in rng.integers(0, len(words), n)]
    jt = JTable([JColumn.from_pylist(keys, dtype=jdt.STRING),
                 JColumn.fixed(jdt.INT32, rng.integers(-50, 50, n)
                               .astype(np.int32))], ["s", "v"])
    aggs = [("v", "sum"), ("v", "max"), ("v", "count")]
    want = jagg.groupby(jt, ["s"], aggs)
    got = pagg.groupby(port_table(jt), ["s"], aggs, device="cpu")
    assert_tables_equal(want, got)


def test_padded_row_mask_matches_jax():
    """groupby_padded over a padded input: dead rows join no live group."""
    jt = value_table(256, 9, seed=21)
    live = np.random.default_rng(22).random(256) > 0.25
    aggs = [("i64", "sum"), ("f64", "min"), ("i16", "count"),
            ("f32", "count_all"), ("dec", "mean")]
    jk, ja, jng = jagg.groupby_padded(jt, ["k"], aggs,
                                      row_mask=np.asarray(live))
    pk, pa, png = pagg.groupby_padded(port_table(jt), ["k"], aggs,
                                      row_mask=torch.from_numpy(live),
                                      device="cpu")
    ng = int(jng)
    assert int(png) == ng
    for (_, jd, jdat, jv), (_, pd, pdat, pv) in zip(jk, pk):
        np.testing.assert_array_equal(np.asarray(jv)[:ng], pv.numpy()[:ng])
        np.testing.assert_array_equal(np.asarray(jdat)[:ng],
                                      pdat.numpy()[:ng])
    for jc, pc in zip(ja, pa):
        jv = np.ones(ng, bool) if jc.validity is None else \
            np.asarray(jc.validity)[:ng]
        pv = np.ones(ng, bool) if pc.validity is None else \
            pc.validity.numpy()[:ng]
        np.testing.assert_array_equal(jv, pv)
        jdat = np.asarray(jc.data)[:ng]
        if jc.dtype.id == jdt.TypeId.FLOAT64:
            jdat = jdat.view(np.float64)
        np.testing.assert_array_equal(jdat[jv], pc.data.numpy()[:ng][pv])


@pytest.mark.parametrize("op", ["collect_list", "nunique", "median"])
def test_unported_ops_raise(op):
    """Only unknown ops raise: collect_list and nunique run and match the
    JAX package (tests/test_torch_window.py holds them on more inputs)."""
    jt = value_table(10, 2, seed=1)
    pt = port_table(jt)
    if op == "median":
        with pytest.raises(ValueError):
            pagg.groupby(pt, ["k"], [("i64", op)], device="cpu")
        return
    got = pagg.groupby(pt, ["k"], [("i64", op)], device="cpu")
    want = jagg.groupby(jt, ["k"], [("i64", op)])
    assert got.columns[1].to_pylist() == want.columns[1].to_pylist()
