"""NDS-lite queries through both packages on the same files: q64, q67, q97
and predicate-cast.

The JAX side is wired exactly as ``tests/test_query_nds.py`` wires it; the
port side is ``chip_smoke``'s ``q64_lite``/``q67_lite``/``q97_lite``/
``predicate_cast_lite`` (what the script's ``nds`` phase runs on the card),
with ``device="cpu"``, by the host and the device-decode scan routes.  The
files are the JAX tests' (pyarrow; q97 zstd and gzip; predicate-cast by
the JAX package's writer), and the pandas oracles are theirs.  Counts are
exact; float sums agree within rel 1e-9 (the port aggregates each scan
chunk first, so it adds in another order), as in the JAX tests.
"""

import datetime
import importlib
import sys

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu.io import read_parquet as jread
from spark_rapids_jni_tpu.ops.aggregate import groupby as jgroupby
from spark_rapids_jni_tpu.ops.join import inner_join, left_join
from spark_rapids_jni_tpu.ops.selection import apply_boolean_mask

from spark_rapids_jni_tpu_torch.io import read_parquet as pread

sys.path.insert(0, "tests")
from test_query_nds import (D_HI, D_LO, q64_oracle,  # noqa: E402
                            q97_oracle)

torch.set_num_threads(1)
ROUTES = ["host", "device"]


def close(a, b, rel=1e-9):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


@pytest.fixture(scope="module")
def q64_files(tmp_path_factory):
    """tests/test_query_nds.py::q64_warehouse (seed 64), cut to 8,000 fact
    rows."""
    root = tmp_path_factory.mktemp("q64")
    rng = np.random.default_rng(64)
    n = 8_000
    ss = pa.table({
        "ss_sold_date_sk": pa.array(
            rng.integers(2_450_800, 2_451_100, n), pa.int64()),
        "ss_store_sk": pa.array(rng.integers(1, 9, n), pa.int64()),
        "ss_customer_sk": pa.array(rng.integers(1, 2_001, n), pa.int64()),
        "ss_item_sk": pa.array(rng.integers(1, 301, n), pa.int64()),
        "ss_ticket_number": pa.array(np.arange(n, dtype=np.int64)),
        "ss_sales_price": pa.array(
            np.round(rng.uniform(1, 100, n), 2), pa.float64()),
    })
    nret = 1_600
    ret_rows = rng.choice(n, nret, replace=False)
    sr = pa.table({
        "sr_item_sk": pa.array(np.asarray(ss["ss_item_sk"])[ret_rows]),
        "sr_ticket_number": pa.array(
            np.asarray(ss["ss_ticket_number"])[ret_rows]),
        "sr_return_amt": pa.array(
            np.round(rng.uniform(1, 60, nret), 2), pa.float64()),
    })
    dsk = np.arange(2_450_800, 2_451_100, dtype=np.int64)
    dd = pa.table({"d_date_sk": pa.array(dsk),
                   "d_year": pa.array(1998 + (dsk - 2_450_800) // 150,
                                      pa.int64())})
    stores = pa.table({
        "s_store_sk": pa.array(np.arange(1, 9, dtype=np.int64)),
        "s_store_name": pa.array(
            ["able", "ok", "ese", "anti", "able", "ok", "ese", "anti"])})
    cust = pa.table({
        "c_customer_sk": pa.array(np.arange(1, 2_001, dtype=np.int64)),
        "c_birth_country": pa.array(
            [["US", "DE", "JP", "BR"][i % 4] for i in range(2_000)])})
    items = pa.table({
        "i_item_sk": pa.array(np.arange(1, 301, dtype=np.int64)),
        "i_color": pa.array(
            [["red", "blue", "plum", "misty"][i % 4] for i in range(300)])})
    tables = [("store_sales", ss), ("store_returns", sr), ("date_dim", dd),
              ("store", stores), ("customer", cust), ("item", items)]
    for nm, t in tables:
        pq.write_table(t, root / f"{nm}.parquet", row_group_size=3_000)
    return root, [t.to_pandas() for _, t in tables]


def jax_q64(root):
    """tests/test_query_nds.py::test_q64_lite_matches_pandas's wiring."""
    import jax.numpy as jnp
    from spark_rapids_jni_tpu.columnar import Column, Table
    ss, sr, dd, stores, cust, items = (jread(root / f"{n}.parquet") for n in (
        "store_sales", "store_returns", "date_dim", "store", "customer",
        "item"))
    colors = items["i_color"].to_pylist()
    fitems = apply_boolean_mask(items, jnp.asarray(
        np.array([c in chip_smoke.Q64_COLORS for c in colors])))
    j = inner_join(ss, dd, ["ss_sold_date_sk"], ["d_date_sk"])
    j = inner_join(j, stores, ["ss_store_sk"], ["s_store_sk"])
    j = inner_join(j, cust, ["ss_customer_sk"], ["c_customer_sk"])
    j = inner_join(j, fitems, ["ss_item_sk"], ["i_item_sk"])
    j = left_join(j, sr, ["ss_item_sk", "ss_ticket_number"],
                  ["sr_item_sk", "sr_ticket_number"])
    ret = j["sr_return_amt"]
    net = Column.fixed(ss["ss_sales_price"].dtype,
                       j["ss_sales_price"].float_values()
                       - jnp.where(ret.valid_mask(), ret.float_values(), 0.0))
    jt = Table(list(j.columns) + [net], list(j.names) + ["net"])
    g = jgroupby(jt, ["s_store_name", "d_year"],
                 [("net", "sum"), ("net", "count")], names=["net", "n"])
    return {(nm, int(y)): (s, int(n)) for nm, y, s, n in zip(
        g["s_store_name"].to_pylist(), g["d_year"].to_pylist(),
        g["net"].to_pylist(), g["n"].to_pylist())}


def test_q64_both_packages_and_pandas(q64_files):
    root, frames = q64_files
    want = q64_oracle(*frames)
    jax_got = jax_q64(root)
    assert set(jax_got) == set(want)
    for route in ROUTES:
        got, info = chip_smoke.q64_lite(root, route, "cpu")
        assert set(got) == set(want), route
        for k, (s, n) in want.items():
            assert got[k][1] == jax_got[k][1] == n, (route, k)
            assert close(got[k][0], s) and close(got[k][0], jax_got[k][0])
        assert info["groups_read"] == 3


def test_q67_both_packages_and_pandas(tmp_path):
    """tests/test_query_nds.py::test_q67_lite_topn_per_group's data (seed
    67, 12,000 rows) and oracle."""
    from spark_rapids_jni_tpu.ops.order import SortKey
    jwindow = importlib.import_module("spark_rapids_jni_tpu.ops.window")
    rng = np.random.default_rng(67)
    n = 12_000
    ss = pa.table({
        "store": pa.array(rng.integers(1, 9, n), pa.int64()),
        "cat": pa.array(rng.integers(0, 12, n), pa.int64()),
        "item": pa.array(rng.integers(0, 400, n), pa.int64()),
        "price": pa.array(np.round(rng.uniform(1, 100, n), 2), pa.float64()),
    })
    pq.write_table(ss, tmp_path / "q67_sales.parquet", row_group_size=5_000)
    t = jread(tmp_path / "q67_sales.parquet")
    per_item = jgroupby(t, ["store", "cat", "item"], [("price", "sum")],
                        names=["sales"])
    ranked = jwindow.window(per_item, ["store", "cat"],
                            [SortKey(per_item["sales"], ascending=False)],
                            [(None, "row_number")], names=["rn"])
    top = apply_boolean_mask(ranked, ranked["rn"].data <= 3)
    jax_sales = sorted(zip(top["store"].to_pylist(), top["cat"].to_pylist(),
                           [round(s, 6) for s in top["sales"].to_pylist()]))
    df = ss.to_pandas().groupby(["store", "cat", "item"], as_index=False) \
        .agg(sales=("price", "sum"))
    df["rn"] = df.sort_values("sales", ascending=False, kind="stable") \
        .groupby(["store", "cat"]).cumcount() + 1
    want = df[df.rn <= 3]
    want_sales = sorted(zip(want.store, want.cat,
                            [round(s, 6) for s in want.sales]))
    assert jax_sales == want_sales
    for route in ROUTES:
        got, info = chip_smoke.q67_lite(tmp_path, route, "cpu")
        assert got == want_sales, route
        assert info["groups_read"] == 3


def test_q97_both_packages_and_pandas(tmp_path):
    """tests/test_query_nds.py::q97_warehouse (seed 97; zstd and gzip),
    cut to 10,000 + 8,000 rows."""
    from spark_rapids_jni_tpu.columnar import Table as JTable
    from spark_rapids_jni_tpu.ops.join import full_join
    from spark_rapids_jni_tpu.ops.selection import distinct
    rng = np.random.default_rng(97)
    n_ss, n_cs = 10_000, 8_000
    ss = pd.DataFrame({
        "ss_customer_sk": rng.integers(1, 3_000, n_ss),
        "ss_item_sk": rng.integers(1, 500, n_ss),
        "ss_sold_date_sk": rng.integers(D_LO - 50, D_HI + 50, n_ss)})
    cs = pd.DataFrame({
        "cs_bill_customer_sk": rng.integers(1, 3_000, n_cs),
        "cs_item_sk": rng.integers(1, 500, n_cs),
        "cs_sold_date_sk": rng.integers(D_LO - 50, D_HI + 50, n_cs)})
    cs.iloc[:3000, :2] = ss.iloc[:3000, :2].to_numpy()  # channel overlap
    pq.write_table(pa.Table.from_pandas(ss), tmp_path / "store_sales.parquet",
                   compression="zstd")
    pq.write_table(pa.Table.from_pandas(cs),
                   tmp_path / "catalog_sales.parquet", compression="gzip")

    def scan_filter(name, date_col, keys):
        t = jread(tmp_path / name)
        d = t[date_col].data
        t = apply_boolean_mask(t, (d >= D_LO) & (d <= D_HI))
        return distinct(JTable([t[k] for k in keys], keys))

    ssk = scan_filter("store_sales.parquet", "ss_sold_date_sk",
                      ["ss_customer_sk", "ss_item_sk"])
    csk = scan_filter("catalog_sales.parquet", "cs_sold_date_sk",
                      ["cs_bill_customer_sk", "cs_item_sk"])
    out = full_join(ssk, csk, ["ss_customer_sk", "ss_item_sk"],
                    ["cs_bill_customer_sk", "cs_item_sk"])
    both = ssk.num_rows + csk.num_rows - out.num_rows
    jax_got = (ssk.num_rows - both, csk.num_rows - both, both)
    want = tuple(int(x) for x in q97_oracle(ss, cs))
    assert jax_got == want and want[2] > 0
    for route in ROUTES:
        got, _ = chip_smoke.q97_lite(tmp_path, route, "cpu", D_LO, D_HI)
        assert got == want, route


def test_predicate_cast_both_packages_and_pandas(tmp_path):
    """tests/test_query_nds.py::test_q_predicate_cast_lite's data (seed 11,
    cut to 6,000 rows), written by the JAX package's Parquet writer."""
    from spark_rapids_jni_tpu import dtypes as jdt
    from spark_rapids_jni_tpu.columnar import Column, Table
    from spark_rapids_jni_tpu.io import write_parquet
    from spark_rapids_jni_tpu.ops.cast import cast
    from spark_rapids_jni_tpu.ops.regex_rewrite import regex_matches
    rng = np.random.default_rng(11)
    n = 6_000
    cats = np.array(["cat-1A", "cat-22B", "dog-3C", "cat-9", "fish-44D"],
                    dtype=object)
    category = cats[rng.integers(0, len(cats), n)]
    amount = rng.integers(-10**6, 10**6, n).astype(np.int64)
    day = rng.integers(18000, 18010, n).astype(np.int32)
    path = str(tmp_path / "fact.parquet")
    write_parquet(Table([
        Column.from_pylist(list(category)),
        Column.fixed(jdt.decimal64(-2), amount),
        Column.fixed(jdt.DType(jdt.TypeId.TIMESTAMP_DAYS), day),
    ], ["cat", "amt", "d"]), path)
    back = jread(path)
    kept = apply_boolean_mask(back, regex_matches(back.column("cat"),
                                                  chip_smoke.PREDICATE))
    g = jgroupby(Table([cast(kept.column("d"), jdt.STRING),
                        kept.column("amt")], ["ds", "amt"]),
                 ["ds"], [("amt", "sum")])
    jax_got = dict(zip(g.column("ds").to_pylist(),
                       np.asarray(g.column("sum_amt").data).tolist()))
    pdf = pd.DataFrame({"cat": category, "amt": amount, "d": day})
    pdf = pdf[pdf.cat.str.match(chip_smoke.PREDICATE)]
    pdf["ds"] = pdf.d.map(lambda x: (datetime.date(1970, 1, 1)
                                     + datetime.timedelta(days=int(x)))
                          .isoformat())
    want = pdf.groupby("ds").amt.sum().to_dict()
    assert jax_got == want
    got = chip_smoke.predicate_cast_lite(pread(path, device="cpu"))
    assert got == want
