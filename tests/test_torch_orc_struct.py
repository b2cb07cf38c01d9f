"""ORC STRUCT and nested LIST, both ways: the port's ``io/orc_writer.py`` and
``io/orc.py`` against the JAX package's.

The nested cases of ``tests/test_orc_writer.py`` (LIST of INT64 and of
STRING, STRUCT with nulls at both levels and named fields, LIST of LIST,
a multi-stripe compressed STRUCT).  Both writers write the same seeded
table and the files must be byte-identical; both readers read the port's
file bit for bit at every nesting level, and pyarrow reads it back to the
values written.  Then the port writes and reads ORC (none, zlib) with
pyarrow and pandas blocked, as on a host that has neither.  Tolerance:
none.
"""

import sys

import numpy as np
import pyarrow.orc as porc
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.io import orc as jorc
from spark_rapids_jni_tpu.io import orc_writer as jw

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.io import orc as porc_port
from spark_rapids_jni_tpu_torch.io import orc_writer as pw
from spark_rapids_jni_tpu_torch.utils.errors import CodecUnavailableError

from test_torch_parquet_nested import same_table

torch.set_num_threads(1)
CPU = "cpu"


def both_struct(children, validity=None):
    """(JAX, port) STRUCT columns over ``children`` [(values, valid)]."""
    jk = tuple(JColumn.from_numpy(v, validity=ok) for v, ok in children)
    pk = tuple(Column.from_numpy(v, validity=ok, device=CPU)
               for v, ok in children)
    pv = None if validity is None else torch.from_numpy(validity)
    return (JColumn(jdt.DType(jdt.TypeId.STRUCT), validity=validity,
                    children=jk),
            Column(pdt.STRUCT, validity=pv, children=pk))


def both_list(values):
    return JColumn.from_pylist(values), Column.from_pylist(values, device=CPU)


def both_tables(cols, names):
    return (JTable([j for j, _ in cols], names),
            Table([p for _, p in cols], names))


def write_both(tmp_path, tables, **kw):
    jp, pp = tmp_path / "j.orc", tmp_path / "p.orc"
    jw.write_orc(tables[0], jp, **kw)
    pw.write_orc(tables[1], pp, **kw)
    assert pp.read_bytes() == jp.read_bytes()
    got = porc_port.read_orc(pp, device=CPU)
    jf, pf = jorc.ORCFile(pp), porc_port.ORCFile(pp)
    if jf.num_stripes == 1:
        same_table(jorc.read_orc(pp), got)
    # the JAX reader cannot concatenate STRUCT stripes: hold each stripe
    for i in range(jf.num_stripes):
        same_table(jf.read_stripe(i), pf.read_stripe(i, device=CPU))
    return pp, got


def test_list_int_roundtrip(tmp_path):
    vals = [[1, 2, 3], [], None, [4], [5, 6]]
    k = np.arange(5, dtype=np.int64)
    t = both_tables([both_list(vals), (JColumn.from_numpy(k),
                                       Column.from_numpy(k, device=CPU))],
                    ["l", "k"])
    p, got = write_both(tmp_path, t)
    back = porc.ORCFile(p).read()
    assert back["l"].to_pylist() == vals
    assert back["k"].to_pylist() == list(range(5))
    assert got["l"].to_pylist() == vals


def test_list_string_roundtrip(tmp_path):
    vals = [["a", "bb"], None, [], ["ccc", None, "d"]]
    p, got = write_both(tmp_path, both_tables([both_list(vals)], ["ls"]))
    assert porc.ORCFile(p).read()["ls"].to_pylist() == vals
    assert got["ls"].to_pylist() == vals


def test_struct_roundtrip_with_nulls(tmp_path):
    n = 500
    rng = np.random.default_rng(31)
    svalid = rng.random(n) > 0.2
    fvalid = rng.random(n) > 0.3
    x = rng.integers(-10**9, 10**9, n)
    y = rng.standard_normal(n)
    k = np.arange(n, dtype=np.int64)
    t = both_tables([both_struct([(x, fvalid), (y, None)], svalid),
                     (JColumn.from_numpy(k), Column.from_numpy(k, device=CPU))],
                    ["st", "k"])
    p, got = write_both(tmp_path, t, struct_fields={"st": ["a", "b"]})
    back = porc.ORCFile(p).read()["st"].to_pylist()
    want = [None if not svalid[i] else
            ((int(x[i]) if fvalid[i] else None), float(y[i]))
            for i in range(n)]
    assert [None if g is None else (g["a"], g["b"]) for g in back] == want
    assert got["st"].to_pylist() == want


def test_nested_list_of_list_roundtrip(tmp_path):
    vals = [[[1, 2], [3]], [], None, [[4], [], [5, 6, 7]]]
    p, got = write_both(tmp_path, both_tables([both_list(vals)], ["ll"]),
                        compression="zlib")
    assert porc.ORCFile(p).read()["ll"].to_pylist() == vals
    assert got["ll"].to_pylist() == vals


@pytest.mark.parametrize("comp", ["snappy", "zlib"])
def test_struct_multistripe_compressed(tmp_path, comp):
    n = 3_000
    rng = np.random.default_rng(33)
    v = rng.integers(0, 10**6, n)
    p, got = write_both(tmp_path, both_tables([both_struct([(v, None)])],
                                              ["s"]),
                        compression=comp, stripe_rows=700)
    assert porc.ORCFile(p).nstripes == 5
    assert [g["f0"] for g in porc.ORCFile(p).read()["s"].to_pylist()] == \
        v.tolist()
    assert [g[0] for g in got["s"].to_pylist()] == v.tolist()


def test_struct_of_string_and_list_fields(tmp_path):
    """A STRUCT whose fields are a STRING and a LIST, nulls at both levels
    (the chip phase's shape)."""
    n = 400
    rng = np.random.default_rng(35)
    sv = rng.random(n) > 0.1
    names = [None if i % 9 == 0 else f"n{i % 17}" for i in range(n)]
    lists = [None if i % 11 == 0 else list(range(i % 4)) for i in range(n)]
    jst = JColumn(jdt.DType(jdt.TypeId.STRUCT), validity=sv, children=(
        JColumn.from_pylist(names), JColumn.from_pylist(lists)))
    pst = Column(pdt.STRUCT, validity=torch.from_numpy(sv), children=(
        Column.from_pylist(names, device=CPU),
        Column.from_pylist(lists, device=CPU)))
    p, got = write_both(tmp_path, (JTable([jst], ["st"]),
                                   Table([pst], ["st"])),
                        compression="zlib",
                        struct_fields={"st": ["name", "l"]})
    want = [None if not sv[i] else (names[i], lists[i]) for i in range(n)]
    back = porc.ORCFile(p).read()["st"].to_pylist()
    assert [None if g is None else (g["name"], g["l"]) for g in back] == want
    assert got["st"].to_pylist() == want


@pytest.mark.parametrize("comp", ["none", "zlib"])
def test_without_pyarrow_or_pandas(tmp_path, monkeypatch, comp):
    """ORC write and read with pyarrow and pandas blocked, as on a host
    that has neither; the same bytes and the same table."""
    n = 1_000
    rng = np.random.default_rng(37)
    sv = rng.random(n) > 0.2
    v = rng.integers(-10**6, 10**6, n)
    lists = [None if i % 7 == 0 else list(range(i % 5)) for i in range(n)]
    t = both_tables([both_struct([(v, rng.random(n) > 0.1)], sv),
                     both_list(lists)], ["st", "l"])
    jp = tmp_path / "j.orc"
    jw.write_orc(t[0], jp, compression=comp)
    want = jorc.read_orc(jp)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    pp = tmp_path / "p.orc"
    pw.write_orc(t[1], pp, compression=comp)
    assert pp.read_bytes() == jp.read_bytes()
    same_table(want, porc_port.read_orc(pp, device=CPU))
    for codec in ("snappy", "zstd"):
        with pytest.raises(CodecUnavailableError):
            pw.write_orc(t[1], tmp_path / "x.orc", compression=codec)


def test_empty_struct_file(tmp_path):
    """A file of zero rows with a STRUCT and a LIST: the empty columns of
    both readers, whole and projected."""
    import pyarrow as pa
    p = tmp_path / "e.orc"
    porc.write_table(pa.table({
        "st": pa.array([], pa.struct([("a", pa.int64()),
                                      ("b", pa.string())])),
        "l": pa.array([], pa.list_(pa.int32())),
        "k": pa.array([], pa.int64())}), p)
    same_table(jorc.read_orc(p), porc_port.read_orc(p, device=CPU))
    same_table(jorc.read_orc(p, columns=["st"]),
               porc_port.read_orc(p, columns=["st"], device=CPU))

