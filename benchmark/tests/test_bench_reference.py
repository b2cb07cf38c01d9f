"""The benchmark's references against hand-made cases and, where the
program has the same contract, against the program on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import jcudf, murmur3
from benchmark.reference.groupby import groupby_sums
from benchmark.reference.parquet_writer import write_parquet
from benchmark.reference.q5 import compare, q5_oracle

STORE_SALES = [4] * 9 + [8, 4] + [8] * 12  # 9 keys, ticket, quantity, money


def test_jcudf_layout_of_store_sales():
    offsets, validity, row = jcudf.layout(STORE_SALES)
    assert offsets[:9] == [0, 4, 8, 12, 16, 20, 24, 28, 32]
    assert offsets[9] == 40 and offsets[10] == 48 and offsets[11] == 56
    assert offsets[-1] == 144 and validity == 152 and row == 160


def test_jcudf_pack_by_hand():
    a = np.array([1, -2], np.int32)
    b = np.array([3.5, 0.0], np.float64)
    blob = jcudf.pack([(a, None), (b, np.array([True, False]))])
    assert blob.shape == (2 * 24,)  # 4 + pad 4 + 8 + 1 validity -> 24
    rows = blob.reshape(2, 24)
    assert rows[0, :4].view(np.int32)[0] == 1
    assert rows[1, :4].view(np.int32)[0] == -2
    assert rows[0, 8:16].view(np.float64)[0] == 3.5
    assert rows[0, 16] == 0b11 and rows[1, 16] == 0b01
    assert not rows[:, 4:8].any() and not rows[:, 17:].any()


def test_jcudf_round_trip():
    rng = np.random.default_rng(5)
    n = 1000
    cols = [(rng.integers(-9, 9, n, dtype=np.int32), rng.random(n) > .1),
            (rng.integers(0, 2**40, n), None),
            (rng.random(n), rng.random(n) > .5)]
    back = jcudf.unpack(jcudf.pack(cols), [c.dtype for c, _ in cols])
    for (v, ok), (gv, gok) in zip(cols, back):
        assert np.array_equal(v, gv)
        assert np.array_equal(np.ones(n, bool) if ok is None else ok, gok)


def test_jcudf_pack_equals_the_programs_rows():
    torch = pytest.importorskip("torch")
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import FLOAT64, INT32, INT64
    from spark_rapids_jni_tpu_torch.ops.row_conversion import \
        convert_to_rows
    rng = np.random.default_rng(6)
    n = 777
    cols = [(rng.integers(-99, 99, n, dtype=np.int32), rng.random(n) > .2),
            (rng.integers(-2**50, 2**50, n), None),
            (rng.standard_normal(n), rng.random(n) > .3)]
    table = Table([Column.fixed(t, v, ok, device="cpu") for (v, ok), t in
                   zip(cols, (INT32, INT64, FLOAT64))], ["a", "b", "c"])
    rows = convert_to_rows(table, device="cpu")
    got = np.concatenate([r.children[0].data.numpy().view(np.uint8)
                          for r in rows])
    assert torch.is_tensor(rows[0].offsets)
    assert np.array_equal(got, jcudf.pack(cols))


def _hash_int_py(v: int, seed: int = 42) -> int:
    m = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m
    k = rotl((v & m) * 0xCC9E2D51 & m, 15) * 0x1B873593 & m
    h = (rotl(seed ^ k, 13) * 5 + 0xE6546B64) & m
    h ^= 4
    h ^= h >> 16
    h = h * 0x85EBCA6B & m
    h ^= h >> 13
    h = h * 0xC2B2AE35 & m
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h


@pytest.mark.parametrize("v", [0, 1, -1, 42, 2**31 - 1, -2**31, 204000])
def test_murmur3_against_scalar(v):
    assert murmur3.hash_int(np.array([v], np.int32))[0] == _hash_int_py(v)


def test_murmur3_known_spark_value_and_pmod():
    # Spark: SELECT hash(0) = 933211791 (seed 42)
    assert murmur3.hash_int(np.array([0], np.int32))[0] == 933211791
    h = np.array([-1, -200, 199, 0], np.int32)
    assert murmur3.pmod(h, 200).tolist() == [199, 0, 199, 0]


def test_murmur3_equals_the_programs_hash():
    pytest.importorskip("torch")
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.dtypes import INT32
    from spark_rapids_jni_tpu_torch.ops.hash import murmur3_hash
    v = np.random.default_rng(7).integers(-2**31, 2**31, 5000,
                                          dtype=np.int64).astype(np.int32)
    got = murmur3_hash(Column.fixed(INT32, v, device="cpu"),
                       device="cpu").data.numpy()
    assert np.array_equal(got, murmur3.hash_int(v))


def test_groupby_sums_by_hand():
    keys = np.array([3, 1, 3, 2, 1], np.int32)
    q = np.array([1, 2, 3, 4, 5], np.int32)
    p = np.array([1.5, -2.0, 0.25, 9.0, 1.0])
    p_ok = np.array([True, True, False, False, True])
    out = groupby_sums(keys, [("q", q, None), ("p", p, p_ok)])
    assert out["keys"].tolist() == [1, 2, 3]
    assert out["count"].tolist() == [2, 1, 2]
    assert out["q"][0].tolist() == [7, 4, 4]
    sums, has, absum = out["p"]
    assert sums.tolist()[0] == -1.0 and sums.tolist()[2] == 1.5
    assert has.tolist() == [True, False, True]
    assert absum.tolist() == [3.0, 0.0, 1.5]


def _q5_tables():
    fact = [("ss_sold_date_sk", "int32", np.array([10, 10, 11, 12, 13],
                                                    np.int32), None, True),
            ("ss_store_sk", "int32", np.array([1, 2, 1, 2, 1], np.int32),
             np.array([True, True, False, True, True]), True),
            ("ss_ext_sales_price", "float64",
             np.array([1.0, 2.0, 4.0, 8.0, 16.0]),
             np.array([True, False, True, True, True]), False),
            ("ss_net_profit", "float64", np.array([.5, .25, 1., -2., 3.]),
             None, False)]
    dates = [("d_date_sk", "int32", np.arange(10, 14, dtype=np.int32), None,
              False)]
    stores = [("s_store_sk", "int32", np.array([1, 2, 3], np.int32), None,
               False),
              ("s_store_name", "string", [b"a", b"b", b"a"], None, False)]
    return fact, dates, stores


def test_q5_oracle_by_hand():
    fact, dates, stores = _q5_tables()
    got = q5_oracle(fact, dates, stores, 10, 12)
    # store 1: rows 0 (date 10); row 2 has a null store; store 2: rows 1, 3
    assert got["a"][:3] == (1.0, 0.5, 1)
    assert got["b"][:3] == (8.0, -1.75, 1)  # row 1's price is null
    assert got["b"][3:] == (8.0, 2.25)
    assert set(got) == {"a", "b"}


def test_q5_oracle_drops_null_dates_and_leaves_null_profits_out():
    fact, dates, stores = _q5_tables()
    date = fact[0]
    fact[0] = date[:3] + (np.array([False, True, True, True, True]),
                          date[4])
    profit = fact[3]
    fact[3] = profit[:3] + (np.array([True, True, True, False, True]),
                            profit[4])
    got = q5_oracle(fact, dates, stores, 10, 12)
    assert set(got) == {"b"}  # row 0 (store 1) has a null date
    assert got["b"][:3] == (8.0, 0.25, 1)  # row 3's profit is null
    only_null = q5_oracle(fact, dates, stores, 12, 12)
    assert only_null["b"][:3] == (8.0, None, 1)  # a sum of nulls is null
    want = dict(only_null)
    assert compare({"b": (8.0, None, 1)}, want) == (0, 0.0)
    assert compare({"b": (8.0, 0.0, 1)}, want)[0] == 1


def test_q5_compare():
    fact, dates, stores = _q5_tables()
    want = q5_oracle(fact, dates, stores, 10, 13)
    got = {k: v[:3] for k, v in want.items()}
    assert compare(got, want) == (0, 0.0)
    got["a"] = (got["a"][0] + 1.0, got["a"][1], got["a"][2])
    bad, gap = compare(got, want)
    assert bad == 0 and gap == pytest.approx(1.0 / 17.0)
    got["b"] = (got["b"][0], got["b"][1], got["b"][2] + 1)
    del got["a"]
    assert compare(got, want)[0] == 2


def test_parquet_writer_read_back_by_the_program(tmp_path):
    pytest.importorskip("torch")
    from spark_rapids_jni_tpu_torch.io import read_parquet
    rng = np.random.default_rng(8)
    n = 5000
    date = np.sort(rng.integers(100, 200, n)).astype(np.int32)
    ok = rng.random(n) > 0.1
    price = rng.integers(0, 10**6, n) / 100.0
    cols = [("d", "int32", date, None, True),
            ("p", "float64", price, ok, False),
            ("s", "string", [b"x%d" % i for i in range(n)], None, False)]
    layout = write_parquet(tmp_path / "f.parquet", cols, 1024)
    assert len(layout) == 5 and sum(g["rows"] for g in layout) == n
    assert layout[0]["columns"]["d"]["min"] == int(date[0])
    assert layout[-1]["columns"]["d"]["max"] == int(date[-1])
    t = read_parquet(tmp_path / "f.parquet", device="cpu")
    assert np.array_equal(t["d"].data.numpy(), date)
    assert np.array_equal(t["p"].valid_mask().numpy(), ok)
    assert np.array_equal(t["p"].data.numpy()[ok], price[ok])
    assert t["s"].to_pylist()[:3] == ["x0", "x1", "x2"]
