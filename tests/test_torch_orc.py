"""ORC read and write parity: the port's ``io/orc.py`` and
``io/orc_writer.py`` against the JAX package's.

Reader: pyarrow writes each file (the cases of ``tests/test_orc.py``, at
smaller sizes); both packages read it and the tables must agree bit for bit
(data, validity, offsets, chars, LIST children).  Writer: the flat and LIST
cases of ``tests/test_orc_writer.py`` (its STRUCT cases are in
``test_torch_orc_struct.py``); both writers write the same seeded table and
the files must be byte-identical, both readers must read the port's file
bit for bit, and pyarrow must read it back.  Tolerance: none.  MAP raises
in both packages; ZSTD and SNAPPY raise ``CodecUnavailableError`` on a host
without pyarrow.
"""

import datetime
import decimal
import sys

import numpy as np
import pyarrow as pa
import pyarrow.orc as porc
import pytest
import torch

from spark_rapids_jni_tpu.columnar.arrow import from_arrow as j_from_arrow
from spark_rapids_jni_tpu.io import orc as jorc
from spark_rapids_jni_tpu.io import orc_writer as jw

from spark_rapids_jni_tpu_torch.columnar.arrow import from_arrow
from spark_rapids_jni_tpu_torch.columnar.interop import HostColumn
from spark_rapids_jni_tpu_torch.io import orc as porc_port
from spark_rapids_jni_tpu_torch.io import orc_writer as pw
from spark_rapids_jni_tpu_torch.utils.errors import CodecUnavailableError

torch.set_num_threads(1)


def same_column(jc, pc, where=""):
    assert (int(jc.dtype.id), jc.dtype.scale) == \
        (int(pc.dtype.id), pc.dtype.scale), where
    if int(jc.dtype.id) == int(pc.dtype.id) and pc.dtype.id.name == "LIST":
        jv, pv = jc.validity, pc.validity
        assert (jv is None) == (pv is None), where
        if jv is not None:
            np.testing.assert_array_equal(np.asarray(jv), pv.numpy())
        np.testing.assert_array_equal(np.asarray(jc.offsets),
                                      pc.offsets.numpy())
        same_column(jc.children[0], pc.children[0], where + ".child")
        return
    a, b = HostColumn.of(jc), HostColumn.of(pc)
    assert (a.validity is None) == (b.validity is None), where
    if a.validity is not None:
        np.testing.assert_array_equal(a.validity, b.validity)
    if a.chars is not None:
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.chars, b.chars)
    else:
        np.testing.assert_array_equal(
            np.ascontiguousarray(a.data).view(np.uint8),
            np.ascontiguousarray(b.data).view(np.uint8), err_msg=where)


def same_table(jt, pt):
    assert list(jt.names) == list(pt.names)
    assert jt.num_rows == pt.num_rows
    for nm, jc, pc in zip(jt.names, jt.columns, pt.columns):
        same_column(jc, pc, nm)


def _mixed():
    return pa.table({
        "i64": pa.array([1, 2, 3, None, 5], pa.int64()),
        "i32": pa.array([10, None, 30, 40, 50], pa.int32()),
        "i16": pa.array([7, -7, None, 0, 32767], pa.int16()),
        "i8": pa.array([1, None, -128, 127, 0], pa.int8()),
        "s": pa.array(["x", "yy", None, "zzz", ""]),
        "f64": pa.array([1.5, 2.5, None, 4.0, -1.25], pa.float64()),
        "f32": pa.array([0.5, None, -2.0, 3.5, 1e30], pa.float32()),
        "b": pa.array([True, False, None, True, False]),
    })


def _reader_cases():
    rng = np.random.default_rng(0)
    outliers = rng.integers(0, 100, 20_000)
    outliers[rng.integers(0, 20_000, 64)] = 2**45
    words = ["alpha", "beta", "gamma", "delta"]
    ts = [datetime.datetime(2024, 7, 30, 12, 34, 56, 789123),
          datetime.datetime(2014, 1, 1, 0, 0, 0, 500000),
          datetime.datetime(1969, 12, 31, 23, 59, 59, 250000), None,
          datetime.datetime(1900, 6, 15, 6, 30, 0, 1),
          datetime.datetime(2015, 1, 1)]
    strs = [f"row-{i}-{'x' * (i % 13)}" for i in range(3_000)]
    strs[17], strs[100] = None, ""
    return {
        "mixed-uncompressed": (_mixed(), {"compression": "uncompressed"}),
        "mixed-zlib": (_mixed(), {"compression": "zlib"}),
        "mixed-snappy": (_mixed(), {"compression": "snappy"}),
        "mixed-zstd": (_mixed(), {"compression": "zstd"}),
        "all-null": (pa.table({"an": pa.array([None] * 3, pa.int64()),
                               "nn": pa.array([1, 2, 3], pa.int64())}), {}),
        "empty": (pa.table({"x": pa.array([], pa.int64()),
                            "s": pa.array([], pa.string()),
                            "l": pa.array([], pa.list_(pa.int64())),
                            "b": pa.array([], pa.binary())}), {}),
        "rle2-delta": (pa.table({"x": pa.array(
            np.arange(20_000, dtype=np.int64)),
            "y": pa.array(np.arange(20_000, 0, -1, dtype=np.int64))}),
            {"compression": "zlib"}),
        "rle2-short-repeat": (pa.table({"x": pa.array(
            np.full(5_000, -123456789, np.int64))}), {}),
        "rle2-direct": (pa.table({"x": pa.array(
            rng.integers(-2**40, 2**40, 20_000))}), {"compression": "snappy"}),
        "rle2-patched-base": (pa.table({"x": pa.array(outliers)}), {}),
        "rle2-negative": (pa.table({"x": pa.array(
            -rng.integers(0, 2**20, 10_000))}), {}),
        "int64-extremes": (pa.table({"x": pa.array(
            [2**63 - 1, -2**63, 0, -1, 1] * 100, pa.int64())}), {}),
        "direct-strings": (pa.table({"s": pa.array(strs)}),
                           {"compression": "zlib"}),
        "dictionary-strings": (pa.table({"s": pa.array(
            [words[i] if i < 4 else None
             for i in rng.integers(0, 5, 10_000)])}),
            {"compression": "zlib", "dictionary_key_size_threshold": 1.0}),
        "unicode": (pa.table({"s": pa.array(
            ["héllo", "日本語", "🚀", None, "a\x00b"])}), {}),
        "timestamps": (pa.table({"ts": pa.array(ts, pa.timestamp("us"))}),
                       {}),
        "timestamp-instant": (pa.table({"tz": pa.array(
            [1722340000000000, None, 0, -1000000, 1421000000123456],
            pa.timestamp("us", tz="UTC"))}), {}),
        "dates": (pa.table({"d": pa.array(
            [datetime.date(2024, 7, 30), datetime.date(1969, 1, 1), None,
             datetime.date(1583, 1, 1), datetime.date(2100, 12, 31)],
            pa.date32())}), {}),
        "decimal64": (pa.table({"d": pa.array(
            [decimal.Decimal("123.45"), decimal.Decimal("-0.01"), None,
             decimal.Decimal("99999.99"), decimal.Decimal("0.00")],
            pa.decimal128(7, 2))}), {}),
        "decimal128": (pa.table({"d": pa.array(
            [decimal.Decimal("12345678901234567890.123"), None,
             decimal.Decimal("-999999999999999999999.999"),
             decimal.Decimal("0.001"), decimal.Decimal("42.000")],
            pa.decimal128(24, 3))}), {}),
        "list-int": (pa.table({"l": pa.array([[1, 2, 3], None, [], [4],
                                              [5, 6]], pa.list_(pa.int64()))}),
                     {}),
        "list-string": (pa.table({"l": pa.array(
            [["a", "bb"], [], None, ["ccc", None, ""]],
            pa.list_(pa.string()))}), {}),
        "binary": (pa.table({"b": pa.array(
            [b"ab", None, b"", b"xyz", b"\x00\xff"], pa.binary())}), {}),
    }


READER_CASES = _reader_cases()


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_matches_jax(tmp_path, case):
    table, kw = READER_CASES[case]
    p = tmp_path / "t.orc"
    porc.write_table(table, p, **kw)
    same_table(jorc.read_orc(p), porc_port.read_orc(p, device="cpu"))


@pytest.fixture(scope="module")
def striped(tmp_path_factory):
    n = 400_000
    t = pa.table({"x": pa.array(np.arange(n, dtype=np.int64)),
                  "f": pa.array(np.linspace(-5.0, 5.0, n)),
                  "s": pa.array([f"k{i % 89}" for i in range(n)])})
    p = tmp_path_factory.mktemp("orc") / "s.orc"
    porc.write_table(t, p, compression="snappy", stripe_size=1 << 20)
    return p, n


def test_stripes_projection_and_pruning(striped):
    p, n = striped
    jf, pf = jorc.ORCFile(p), porc_port.ORCFile(p)
    assert pf.num_stripes == jf.num_stripes > 2
    assert [(nm, repr(d)) for nm, d in pf.schema] == \
        [(nm, repr(d)) for nm, d in jf.schema]
    for i in range(pf.num_stripes):
        assert pf.stripe_stat_range(i, "x") == jf.stripe_stat_range(i, "x")
        assert pf.stripe_stat_range(i, "s") == jf.stripe_stat_range(i, "s")
    same_table(jf.read(columns=["s", "x"]), pf.read(columns=["s", "x"],
                                                    device="cpu"))
    for pred in (("x", n - 10, None), ("x", None, 5), ("f", -1.0, 1.0),
                 ("s", "k1", "k2")):
        jchunks = list(jorc.ORCChunkedReader(p, columns=["x", "s"],
                                             predicate=pred))
        pchunks = list(porc_port.ORCChunkedReader(
            p, columns=["x", "s"], predicate=pred, device="cpu"))
        assert len(pchunks) == len(jchunks)
        for jc, pc in zip(jchunks, pchunks):
            same_table(jc, pc)
    assert len(list(porc_port.ORCChunkedReader(
        p, predicate=("x", n - 10, None), device="cpu"))) == 1


def test_predicate_validation(tmp_path):
    p = tmp_path / "v.orc"
    porc.write_table(pa.table({"x": pa.array([1, 2, 3], pa.int64()),
                               "s": pa.array(["a", "b", "c"])}), p)
    with pytest.raises(KeyError):
        porc_port.ORCChunkedReader(p, predicate=("nope", 0, 1), device="cpu")
    with pytest.raises(TypeError):
        porc_port.ORCChunkedReader(p, predicate=("s", 0, 10), device="cpu")
    assert len(list(porc_port.ORCChunkedReader(
        p, predicate=("s", "a", "z"), device="cpu"))) == 1


def test_struct_raises_typed_error_and_projects(tmp_path):
    """A STRUCT column reads and equals the JAX reader, whole and projected
    away; a MAP column, which both packages refuse, raises."""
    from test_torch_parquet_nested import same_table as same_nested
    p = tmp_path / "st.orc"
    porc.write_table(pa.table({
        "k": pa.array([1, 2, 3], pa.int64()),
        "st": pa.array([{"a": 1, "b": "x"}, None, {"a": 3, "b": None}],
                       pa.struct([("a", pa.int64()), ("b", pa.string())]))}),
        p)
    got = porc_port.read_orc(p, device="cpu")
    same_nested(jorc.read_orc(p), got)
    assert got["st"].to_pylist() == [(1, "x"), None, (3, None)]
    same_table(jorc.read_orc(p, columns=["k"]),
               porc_port.read_orc(p, columns=["k"], device="cpu"))
    m = tmp_path / "m.orc"
    porc.write_table(pa.table({
        "k": pa.array([1, 2], pa.int64()),
        "m": pa.array([[("a", 1)], None], pa.map_(pa.string(),
                                                  pa.int64()))}), m)
    with pytest.raises(NotImplementedError, match="unsupported ORC type kind"):
        jorc.read_orc(m)
    with pytest.raises(NotImplementedError, match="unsupported ORC type kind"):
        porc_port.read_orc(m, device="cpu")


def test_zstd_without_pyarrow_raises_typed(tmp_path, monkeypatch):
    p = tmp_path / "z.orc"
    porc.write_table(_mixed(), p, compression="zstd")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(CodecUnavailableError):
        porc_port.read_orc(p, device="cpu")


# -- writer -----------------------------------------------------------------

def _writer_tables():
    rng = np.random.default_rng(0)
    n = 4_000
    valid = rng.random(n) > 0.1
    mixed = pa.table({
        "i64": pa.array(rng.integers(-2**40, 2**40, n), mask=~valid),
        "i32": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "i16": pa.array(rng.integers(-2**14, 2**14, n).astype(np.int16)),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "f64": pa.array(rng.standard_normal(n)),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "b": pa.array(rng.random(n) > 0.5),
        "s": pa.array([None if i % 7 == 0 else f"s{i % 31}"
                       for i in range(n)]),
    })
    return {
        "mixed": mixed,
        "timestamps": pa.table({
            "s": pa.array([-2, -1, 0, 1, 2_000_000_000], pa.timestamp("s")),
            "ms": pa.array([-1500, -1, 0, 1, 123456789], pa.timestamp("ms")),
            "us": pa.array([-1080235059808322, -1, 0, 1, 5 * 10**14],
                           pa.timestamp("us")),
            "ns": pa.array([-10**18, -999, 0, 999, 10**18],
                           pa.timestamp("ns")),
            "neg_run": pa.array([-1500] * 5, pa.timestamp("ms"))}),
        "dates-decimals": pa.table({
            "d": pa.array(np.array([-30000, -1, 0, 1, 20000], np.int32),
                          pa.date32()),
            "m64": pa.array([decimal.Decimal(v).scaleb(-2) for v in
                             (-123456, 0, 1, 99, 10**15)],
                            pa.decimal128(18, 2)),
            "m128": pa.array([decimal.Decimal(v).scaleb(-3) for v in
                              (10**25 + 7, -(10**30), 0, 5, -42)],
                             pa.decimal128(38, 3))}),
        "multi-stripe": pa.table({
            "x": pa.array(np.arange(50_000, dtype=np.int64)),
            "s": pa.array([f"r{i % 97}" for i in range(50_000)])}),
        "all-null": pa.table({"x": pa.array([None] * 3, pa.int64())}),
        "empty": pa.table({"x": pa.array([], pa.int64()),
                           "s": pa.array([], pa.string())}),
        "lists": pa.table({
            "l": pa.array([[1, 2, 3], [], None, [4], [5, 6]],
                          pa.list_(pa.int64())),
            "ls": pa.array([["a", "bb"], [], None, ["ccc", None, ""], ["d"]],
                           pa.list_(pa.string())),
            "ll": pa.array([[[1], [2, 3]], None, [[]], [[4, None]], []],
                           pa.list_(pa.list_(pa.int64()))),
            "k": pa.array(np.arange(5, dtype=np.int64))}),
    }


WRITER_TABLES = _writer_tables()
WRITER_CASES = [(t, c) for t in sorted(WRITER_TABLES)
                for c in (["none", "zlib", "snappy", "zstd"] if t == "mixed"
                          else ["zlib"] if t == "multi-stripe" else ["none"])]


@pytest.mark.parametrize("name,comp", WRITER_CASES)
def test_writer_matches_jax(tmp_path, name, comp):
    table = WRITER_TABLES[name]
    rows = 15_000 if name == "multi-stripe" else 1 << 20
    jp, pp = tmp_path / "j.orc", tmp_path / "p.orc"
    jw.write_orc(j_from_arrow(table), jp, compression=comp, stripe_rows=rows)
    pw.write_orc(from_arrow(table, device="cpu"), pp, compression=comp,
                 stripe_rows=rows)
    assert pp.read_bytes() == jp.read_bytes()
    same_table(jorc.read_orc(pp), porc_port.read_orc(pp, device="cpu"))
    back = porc.ORCFile(pp).read()
    assert back.num_rows == table.num_rows
    if name == "multi-stripe":
        assert porc.ORCFile(pp).nstripes == 4
    for col in ("i64", "s", "x", "l", "ls", "ll", "m128", "neg_run"):
        if col in table.column_names:
            assert back[col].to_pylist() == table[col].to_pylist(), col


def test_writer_refuses_struct_and_missing_codec(tmp_path, monkeypatch):
    """A STRUCT writes and reads back equal to the JAX reader (and to
    pyarrow); a compressor this host lacks raises CodecUnavailableError."""
    from test_torch_parquet_nested import same_table as same_nested
    from spark_rapids_jni_tpu_torch import dtypes as pdt
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    kid = Column.fixed(pdt.INT64, np.arange(3), device="cpu")
    st = Table([Column(pdt.STRUCT, children=(kid,))], ["st"])
    pw.write_orc(st, tmp_path / "s.orc")
    same_nested(jorc.read_orc(tmp_path / "s.orc"),
                porc_port.read_orc(tmp_path / "s.orc", device="cpu"))
    assert porc.ORCFile(tmp_path / "s.orc").read()["st"].to_pylist() == \
        [{"f0": 0}, {"f0": 1}, {"f0": 2}]
    t = from_arrow(_mixed(), device="cpu")
    monkeypatch.setattr(pw, "_SNAPPY_C", None)
    with pytest.raises(CodecUnavailableError):
        pw.write_orc(t, tmp_path / "n.orc", compression="snappy")
    pw.write_orc(t, tmp_path / "z.orc", compression="zlib")
    same_table(jorc.read_orc(tmp_path / "z.orc"),
               porc_port.read_orc(tmp_path / "z.orc", device="cpu"))
