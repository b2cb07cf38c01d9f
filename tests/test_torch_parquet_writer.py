"""The port's Parquet writer against the JAX package's.

The cases of ``tests/test_parquet_writer.py``: each table is built once in
the JAX package and copied buffer for buffer into the port; both writers
write it, and (pyarrow being importable here) the port's file must equal
the JAX writer's byte for byte.  Every file the port writes is read back
by both packages' readers, bit for bit against each other, and by pyarrow
against the values written.  Beyond the JAX writer: LIST of LIST (and of
LIST of LIST), and none, gzip and snappy (the port's own encoder) with
pyarrow and pandas blocked (``sys.modules["pyarrow"] = None``), where
zstd raises ``CodecUnavailableError``.  gzip's header carries the clock's second, so
the gzip cases pin it.  Tolerance: none.
"""

import gzip
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.io import parquet as jpq
from spark_rapids_jni_tpu.io import write_parquet as jwrite

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.io import parquet as ppq
from spark_rapids_jni_tpu_torch.io import write_parquet as pwrite
from spark_rapids_jni_tpu_torch.io.snappy import compress, decompress
from spark_rapids_jni_tpu_torch.utils.errors import CodecUnavailableError

from test_torch_parquet_nested import same_table

torch.set_num_threads(1)
CPU = "cpu"


def to_port(jc):
    """A JAX column's buffers as a port column on the CPU."""
    v = None if jc.validity is None else np.asarray(jc.validity)
    tid = int(jc.dtype.id)
    if tid == int(pdt.TypeId.STRUCT):
        return Column(pdt.STRUCT,
                      validity=None if v is None else torch.from_numpy(v),
                      children=tuple(to_port(c) for c in jc.children))
    if tid == int(pdt.TypeId.LIST):
        return Column.list_(to_port(jc.children[0]), np.asarray(jc.offsets),
                            v, device=CPU)
    if jc.dtype.is_string:
        return Column.string(np.asarray(jc.data), np.asarray(jc.offsets), v,
                             device=CPU)
    return Column.fixed(pdt.DType(pdt.TypeId(tid), jc.dtype.scale),
                        np.asarray(jc.data), v, device=CPU)


def port_table(jt):
    return Table([to_port(c) for c in jt.columns], jt.names)


@pytest.fixture
def frozen_gzip_clock(monkeypatch):
    """gzip headers carry the write time: pin it so two writes compare."""
    class Clock:
        @staticmethod
        def time():
            return 1_700_000_000.0
    monkeypatch.setattr(gzip, "time", Clock)


def write_both(tmp_path, jt, **kw):
    """Both writers write ``jt``; the files are equal; both readers read the
    port's file alike.  Returns (path, pyarrow table, port read)."""
    jp, pp = tmp_path / "j.parquet", tmp_path / "p.parquet"
    jwrite(jt, jp, **kw)
    pwrite(port_table(jt), pp, **kw)
    assert pp.read_bytes() == jp.read_bytes()
    got = ppq.read_parquet(pp, device=CPU)
    same_table(jpq.read_parquet(pp), got)
    return pp, pq.read_table(pp), got


def test_mixed_types_with_nulls(tmp_path):
    rng = np.random.default_rng(1)
    n = 5000
    t = JTable([
        JColumn.from_numpy(rng.integers(-2**62, 2**62, n).astype(np.int64),
                           validity=rng.random(n) > 0.2),
        JColumn.from_numpy(rng.standard_normal(n)),
        JColumn.from_numpy(rng.integers(-2**31, 2**31 - 1, n)
                           .astype(np.int32)),
        JColumn.from_numpy(rng.random(n) > 0.5, dtype=jdt.BOOL8),
        JColumn.from_pylist([None if i % 7 == 0 else f"s{i % 53}×"
                             for i in range(n)]),
        JColumn.from_numpy(rng.integers(-10**8, 10**8, n).astype(np.int64),
                           dtype=jdt.decimal64(-2)),
    ], ["a", "b", "f64", "bool", "s", "dec"])
    _, at, got = write_both(tmp_path, t, row_group_size=1500)
    for nm in t.names:
        if nm == "b":
            want = list(np.asarray(t["b"].data).view(np.float64))
            assert at.column("b").to_pylist() == want
            continue
        assert at.column(nm).to_pylist() == t[nm].to_pylist(), nm
        assert got[nm].to_pylist() == t[nm].to_pylist(), nm


def test_uncompressed_mode(tmp_path):
    t = JTable([JColumn.from_numpy(np.arange(100, dtype=np.int64))], ["x"])
    _, at, got = write_both(tmp_path, t, compression="none")
    assert at.column("x").to_pylist() == list(range(100))
    assert got["x"].to_pylist() == list(range(100))


def test_unsigned_and_small_ints(tmp_path):
    rng = np.random.default_rng(2)
    n = 300
    t = JTable([
        JColumn.from_numpy(rng.integers(0, 2**32 - 1, n).astype(np.uint32)),
        JColumn.from_numpy((rng.integers(0, 2**63, n, dtype=np.int64)
                            .astype(np.uint64) * 2 + 1)),
        JColumn.from_numpy(rng.integers(-128, 128, n).astype(np.int8)),
        JColumn.from_numpy(rng.integers(-2**15, 2**15, n).astype(np.int16)),
    ], ["u32", "u64", "i8", "i16"])
    _, at, got = write_both(tmp_path, t)
    for nm in t.names:
        assert at.column(nm).to_pylist() == t[nm].to_pylist(), nm
        assert got[nm].to_pylist() == t[nm].to_pylist(), nm


def test_timestamps(tmp_path):
    base = 1_600_000_000_000_000  # us
    t = JTable([
        JColumn.from_numpy(np.arange(10, dtype=np.int64) * 86_400_000
                           + base // 1000,
                           dtype=jdt.TIMESTAMP_MILLISECONDS),
        JColumn.from_numpy(np.arange(10, dtype=np.int64) * 86_400_000_000
                           + base, dtype=jdt.TIMESTAMP_MICROSECONDS),
        JColumn.from_numpy(np.arange(10, dtype=np.int32) + 18000,
                           dtype=jdt.TIMESTAMP_DAYS),
    ], ["ms", "us", "d"])
    _, at, got = write_both(tmp_path, t)
    assert at.column("us").cast("int64").to_pylist() == list(
        np.arange(10, dtype=np.int64) * 86_400_000_000 + base)
    for nm in t.names:
        assert got[nm].to_pylist() == t[nm].to_pylist(), nm


def test_statistics_enable_pruning(tmp_path):
    n = 4000
    vals = np.sort(np.random.default_rng(3).integers(0, 10**6, n)).astype(
        np.int64)
    p, _, _ = write_both(tmp_path, JTable([JColumn.from_numpy(vals)], ["k"]),
                         row_group_size=500)
    f = ppq.ParquetFile(p)
    assert f.num_row_groups == 8
    st = f.group_stats(0, "k")
    assert st == jpq.ParquetFile(p).group_stats(0, "k")
    assert st[0] == vals[0] and st[1] == vals[499]
    lo, hi = int(vals[n // 2]), int(vals[n // 2 + 300])
    r = ppq.ParquetChunkedReader(p, predicate=("k", lo, hi), device=CPU)
    kept = [v for tl in r for v in tl["k"].to_pylist() if lo <= v <= hi]
    assert r.groups_pruned > 0
    assert sorted(kept) == [int(v) for v in vals if lo <= v <= hi]


def test_empty_table(tmp_path):
    t = JTable([JColumn.from_numpy(np.zeros(0, np.int64)),
                JColumn.from_pylist([])], ["a", "s"])
    _, at, got = write_both(tmp_path, t)
    assert at.num_rows == 0 and got.num_rows == 0


def test_write_read_write_loop(tmp_path):
    rng = np.random.default_rng(5)
    n = 1000
    t = JTable([
        JColumn.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int64),
                           validity=rng.random(n) > 0.1),
        JColumn.from_pylist([f"v{i % 17}" for i in range(n)]),
    ], ["x", "s"])
    p1, _, t2 = write_both(tmp_path, t)
    p2 = tmp_path / "w2.parquet"
    pwrite(t2, p2)
    at = pq.read_table(p2)
    assert at.column("x").to_pylist() == t["x"].to_pylist()
    assert at.column("s").to_pylist() == t["s"].to_pylist()
    assert p2.read_bytes() == p1.read_bytes()


def test_nan_floats_omit_minmax_stats(tmp_path):
    t = JTable([JColumn.from_numpy(np.array([1.0, np.nan, 5.0]))], ["f"])
    p, at, _ = write_both(tmp_path, t)
    assert ppq.ParquetFile(p).group_stats(0, "f") is None
    got = at.column("f").to_pylist()
    assert got[0] == 1.0 and got[2] == 5.0 and np.isnan(got[1])


@pytest.mark.parametrize("comp", ["none", "snappy", "gzip", "zstd"])
def test_codec_roundtrip_matrix(tmp_path, comp, frozen_gzip_clock):
    rng = np.random.default_rng(8)
    n = 5_000
    valid = rng.random(n) > 0.2
    t = JTable([
        JColumn.from_numpy(rng.integers(-2**50, 2**50, n), validity=valid),
        JColumn.from_numpy(rng.standard_normal(n)),
        JColumn.from_numpy(rng.integers(-2**30, 2**30, n).astype(np.int32)),
        JColumn.from_numpy(rng.random(n).astype(np.float32)),
        JColumn.from_numpy(rng.random(n) > 0.5),
        JColumn.from_pylist([None if i % 11 == 0 else f"v{i % 37}"
                             for i in range(n)]),
    ], ["i64", "f64", "i32", "f32", "b", "s"])
    _, back, got = write_both(tmp_path, t, compression=comp)
    assert back.num_rows == n
    for nm in ("i64", "i32", "s"):
        assert back[nm].to_pylist() == t[nm].to_pylist()
        assert got[nm].to_pylist() == t[nm].to_pylist()
    np.testing.assert_array_equal(np.array(back["f64"]),
                                  np.asarray(t["f64"].data).view(np.float64))


def _struct_table(n, seed):
    rng = np.random.default_rng(seed)
    svalid = rng.random(n) > 0.15
    fvalid = rng.random(n) > 0.25
    x = rng.integers(-10**9, 10**9, n)
    y = rng.standard_normal(n)
    st = JColumn(jdt.DType(jdt.TypeId.STRUCT), validity=svalid,
                 children=(JColumn.from_numpy(x, validity=fvalid),
                           JColumn.from_numpy(y)))
    return JTable([JColumn.from_numpy(np.arange(n, dtype=np.int64)), st],
                  ["k", "st"]), (svalid, fvalid, x, y)


def test_struct_write_roundtrip(tmp_path):
    n = 2_500
    t, (svalid, fvalid, x, y) = _struct_table(n, 12)
    _, back, got = write_both(tmp_path, t, row_group_size=700)
    want = [None if not svalid[i] else
            ((int(x[i]) if fvalid[i] else None), float(y[i]))
            for i in range(n)]
    assert [None if g is None else (g["f0"], g["f1"])
            for g in back["st"].to_pylist()] == want
    assert got["st"].to_pylist() == want


def test_struct_field_names(tmp_path):
    t, _ = _struct_table(100, 13)
    p, back, got = write_both(tmp_path, t, struct_fields={"st": ["x", "y"]})
    assert back.schema.field("st").type.names == ["x", "y"]
    assert [f.name for f in ppq.ParquetFile(p).schema[1].fields] == \
        ["x", "y"]
    with pytest.raises(ValueError):
        pwrite(port_table(t), tmp_path / "bad.parquet",
               struct_fields={"st": ["x"]})


@pytest.mark.parametrize("compression", ["none", "snappy", "gzip", "zstd"])
def test_list_write_roundtrip(tmp_path, compression, frozen_gzip_clock):
    rows = [[1, 2, 3], [], None, [42], [-7, 0], [], [10**12], None]
    t = JTable([
        JColumn.from_pylist(rows, dtype=jdt.DType(jdt.TypeId.LIST)),
        JColumn.from_numpy(np.arange(len(rows), dtype=np.int64)),
    ], ["ls", "v"])
    _, at, got = write_both(tmp_path, t, compression=compression)
    assert at.column("ls").to_pylist() == rows
    assert got["ls"].to_pylist() == rows


@pytest.mark.parametrize("rows", [
    [[1, None, 3], [None], [], [7]],
    [["a", "bb"], [], ["δ", ""], None],
], ids=["nullable-elements", "strings"])
def test_list_write_elements(tmp_path, rows):
    t = JTable([JColumn.from_pylist(rows, dtype=jdt.DType(jdt.TypeId.LIST))],
               ["ls"])
    _, at, got = write_both(tmp_path, t)
    assert at.column("ls").to_pylist() == rows
    assert got["ls"].to_pylist() == rows


def test_list_write_multi_row_group(tmp_path):
    rows = [[i, i + 1] if i % 3 else [] for i in range(5000)]
    t = JTable([JColumn.from_pylist(rows, dtype=jdt.DType(jdt.TypeId.LIST))],
               ["ls"])
    p, at, got = write_both(tmp_path, t, row_group_size=1024)
    assert at.column("ls").to_pylist() == rows
    assert got["ls"].to_pylist() == rows
    assert pq.ParquetFile(p).metadata.num_row_groups == 5


@pytest.mark.parametrize("rgs", [1 << 20, 3])
def test_nested_list_write_beyond_jax(tmp_path, rgs):
    """LIST<LIST> and LIST<LIST<LIST>>, nulls at every level (the JAX
    writer refuses more than one level): pyarrow reads the port's file to
    the values written, and both readers read it alike."""
    ll = [[[1, 2], [3]], [], None, [[4], [], None], [[5, None, 7]]]
    l3 = [[[[1], [2, 3]]], None, [], [[[4]], [], None], [[None, [5]]]]
    ls = [[["a"], ["bb", None]], None, [[]], [["ccc"], None], []]
    t = Table([Column.from_pylist(ll, device=CPU),
               Column.from_pylist(l3, device=CPU),
               Column.from_pylist(ls, device=CPU)], ["ll", "l3", "ls"])
    p = tmp_path / "n.parquet"
    pwrite(t, p, row_group_size=rgs)
    at = pq.read_table(p)
    for nm, want in (("ll", ll), ("l3", l3), ("ls", ls)):
        assert at[nm].to_pylist() == want, nm
    got = ppq.read_parquet(p, device=CPU)
    same_table(jpq.read_parquet(p), got)
    assert got["l3"].to_pylist() == l3


@pytest.mark.parametrize("comp", ["none", "gzip", "snappy"])
def test_port_snappy_without_pyarrow(tmp_path, monkeypatch, comp):
    """With pyarrow and pandas blocked the writer still writes none, gzip
    and snappy (its own encoder, io/snappy.compress); both readers read
    the file, and zstd raises CodecUnavailableError."""
    t, (svalid, fvalid, x, y) = _struct_table(3_000, 14)
    rows = [None if i % 13 == 0 else list(range(i % 5)) for i in range(3_000)]
    jt = JTable(list(t.columns) + [JColumn.from_pylist(
        rows, dtype=jdt.DType(jdt.TypeId.LIST)), JColumn.from_pylist(
        [None if i % 7 == 0 else f"s{i % 41}" for i in range(3_000)])],
        ["k", "st", "l", "s"])
    jp = tmp_path / "j.parquet"
    jwrite(jt, jp, compression="none", row_group_size=1_000)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    pp = tmp_path / "p.parquet"
    pwrite(port_table(jt), pp, compression=comp, row_group_size=1_000)
    got = ppq.read_parquet(pp, device=CPU)
    with pytest.raises(CodecUnavailableError):
        pwrite(port_table(jt), tmp_path / "z.parquet", compression="zstd")
    monkeypatch.undo()
    same_table(jpq.read_parquet(jp), got)
    same_table(jpq.read_parquet(pp), got)
    assert pq.read_table(pp)["l"].to_pylist() == rows


@pytest.mark.parametrize("copies", [False, True])
def test_snappy_compress_round_trip(copies):
    rng = np.random.default_rng(15)
    blocks = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
              for _ in range(8)]
    data = b"".join(blocks[i] for i in rng.integers(0, 8, 5000)) + \
        rng.integers(0, 256, 100_001, dtype=np.uint8).tobytes()
    for raw in (data, b"", b"x", data[:60], data[:61]):
        enc = compress(raw, copies)
        assert decompress(enc) == raw
        assert (len(enc) < len(raw) // 2) == (copies and raw is data)
