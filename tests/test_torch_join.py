"""The port's equi-joins against the JAX package's, on the CPU.

inner_join, left_semi_join and left_anti_join over the same numpy-made
tables (null keys, duplicate keys on both sides, a multi-column key of
INT32, STRING with null strings and FLOAT64 with -0.0 and NaN, empty
sides), the port with
``device="cpu"``.  Tolerance: bit-exact, rows in the same order (probe rows
ascending, then the build rows in the JAX build order).  Also the static-
capacity ``inner_join_padded`` and the prepared-build probe, on their live
pairs.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu_torch.columnar.interop import (
    HostColumn, table_from_numpy, table_to_numpy)
from spark_rapids_jni_tpu_torch.ops import join as pjoin

torch.set_num_threads(1)
CPU = "cpu"
WORDS = ["", "a", "apple", "apples", "b", "zz" * 9, "b" * 17]


def port_table(jt):
    return table_from_numpy([HostColumn.of(c) for c in jt.columns],
                            jt.names, device=CPU)


def assert_tables_equal(want, got):
    assert list(got.names) == list(want.names)
    assert got.num_rows == want.num_rows
    for jc, pc in zip([HostColumn.of(c) for c in want.columns],
                      table_to_numpy(got)):
        assert (jc.type_id, jc.scale) == (pc.type_id, pc.scale)
        # a gather always carries validity; compare the effective masks
        np.testing.assert_array_equal(
            np.ones(got.num_rows, bool) if jc.validity is None
            else jc.validity,
            np.ones(got.num_rows, bool) if pc.validity is None
            else pc.validity)
        if jc.chars is not None:
            np.testing.assert_array_equal(jc.offsets, pc.offsets)
            np.testing.assert_array_equal(jc.chars, pc.chars)
        else:
            np.testing.assert_array_equal(
                np.ascontiguousarray(jc.data).view(np.uint8),
                np.ascontiguousarray(pc.data).view(np.uint8))


def sides(rng, nl, nr, kind):
    """(left, right, key names) JAX tables; ``kind`` picks the keys."""
    def keys(n):
        if kind == "int":
            return [JColumn.fixed(jdt.INT64, rng.integers(0, 12, n),
                                  validity=rng.random(n) > 0.15)]
        # multi: INT32, STRING with nulls, and FLOAT64 with -0.0 and NaN
        vals = rng.choice([0.0, -0.0, np.nan], n)
        return [JColumn.fixed(jdt.INT32,
                              rng.integers(0, 3, n).astype(np.int32)),
                JColumn.from_pylist(
                    [WORDS[k] if k else None
                     for k in rng.integers(0, len(WORDS), n)],
                    dtype=jdt.STRING),
                JColumn.fixed(jdt.FLOAT64, vals.view(np.int64))]

    lk, rk = keys(nl), keys(nr)
    knames = [f"k{i}" for i in range(len(lk))]
    left = JTable(lk + [JColumn.fixed(jdt.INT64, np.arange(nl) * 10)],
                  knames + ["lv"])
    right = JTable(rk + [
        JColumn.fixed(jdt.INT32, np.arange(nr, dtype=np.int32)),
        JColumn.from_pylist([f"r{i % 5}" for i in range(nr)])],
        [f"r{n}" for n in knames] + ["rv", "rs"])
    return left, right, knames, [f"r{n}" for n in knames]


# one shape for every kind, so the JAX side's compiled programs are shared
NL, NR = 40, 40  # equal sides share the JAX compiles too
CASES = [("int", NL, NR), ("multi", NL, NR), ("int", 0, NR),
         ("int", NL, 0)]


@pytest.mark.parametrize("kind,nl,nr", CASES)
def test_joins_match_jax(kind, nl, nr):
    rng = np.random.default_rng(len(kind) * 1000 + nl + nr)
    left, right, lon, ron = sides(rng, nl, nr, kind)
    pl, pr = port_table(left), port_table(right)
    if nl and nr:  # the JAX inner join needs rows on the probe side
        assert_tables_equal(jjoin.inner_join(left, right, lon, ron),
                            pjoin.inner_join(pl, pr, lon, ron, device=CPU))
    for jfn, pfn in ((jjoin.left_semi_join, pjoin.left_semi_join),
                     (jjoin.left_anti_join, pjoin.left_anti_join)):
        if nl and nr:
            assert_tables_equal(jfn(left, right, lon, ron),
                                pfn(pl, pr, lon, ron, device=CPU))
        else:  # empty sides: semi keeps nothing, anti keeps every row
            got = pfn(pl, pr, lon, ron, device=CPU)
            keep_all = pfn is pjoin.left_anti_join
            assert got.num_rows == (nl if keep_all else 0)


def test_inner_join_pair_order_with_duplicates():
    """Each duplicate probe key meets every duplicate build key, probe rows
    ascending and build rows in their stable hash order (the JAX package's
    order, which test_joins_match_jax holds the port to)."""
    left = JTable([JColumn.fixed(jdt.INT64, np.array([3, 1, 3, 2]))], ["k"])
    right = JTable([JColumn.fixed(jdt.INT64, np.array([3, 3, 1, 9, 3])),
                    JColumn.fixed(jdt.INT64, np.arange(5))], ["k", "v"])
    got = pjoin.inner_join(port_table(left), port_table(right), ["k"],
                           device=CPU)
    assert got.to_pydict() == {"k": [3, 3, 3, 1, 3, 3, 3],
                               "v": [0, 1, 4, 2, 0, 1, 4]}


@pytest.mark.parametrize("capacity", [16, 64])
def test_inner_join_padded_live_pairs(capacity):
    rng = np.random.default_rng(31)
    left, right, lon, ron = sides(rng, NL, NR, "int")
    live = rng.random(NL) > 0.2
    jli, jri, jlive, jn, jover = jjoin.inner_join_padded(
        left, right, lon, ron, capacity,
        left_live=__import__("jax").numpy.asarray(live))
    pli, pri, plive, pn, pover = pjoin.inner_join_padded(
        port_table(left), port_table(right), lon, ron, capacity,
        left_live=torch.from_numpy(live), device=CPU)
    n = int(jn)
    assert (n, int(jover)) == (int(pn), int(pover))
    np.testing.assert_array_equal(np.asarray(jlive), plive.numpy())
    np.testing.assert_array_equal(np.asarray(jli)[:n], pli.numpy()[:n])
    np.testing.assert_array_equal(np.asarray(jri)[:n], pri.numpy()[:n])


def test_prepared_build_probe():
    rng = np.random.default_rng(32)
    right = JTable([JColumn.fixed(jdt.INT64, rng.permutation(NR))], ["k"])
    left = JTable([JColumn.fixed(jdt.INT64, rng.integers(-5, NR + 5, NL),
                                 validity=rng.random(NL) > 0.1)], ["k"])
    jpb = jjoin.prepare_build(right, ["k"])
    ppb = pjoin.prepare_build(port_table(right), ["k"], device=CPU)
    assert jpb.unique and ppb.unique
    jri, jm = jjoin.probe_join_prepared(left, jpb)
    pri, pm = pjoin.probe_join_prepared(port_table(left), ppb)
    np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
    np.testing.assert_array_equal(np.asarray(jri)[np.asarray(jm)],
                                  pri.numpy()[pm.numpy()])
