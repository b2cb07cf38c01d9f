"""The port's host Parquet reader against the JAX package's, on the same files.

pyarrow writes the files from numpy data made with a fixed seed; both
readers read them (the port with ``device="cpu"``), and every buffer and
validity mask must be equal, bit for bit (floats compared as bits).  Also
read back: the files of ``chip_smoke.py``'s own numpy Parquet writer
(which the card's host uses, having no pyarrow), through pyarrow and both
readers, against the values the writer was given.
"""

from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu.io import parquet as jpq
from spark_rapids_jni_tpu_torch.columnar.interop import HostColumn
from spark_rapids_jni_tpu_torch.io import parquet as ppq

torch.set_num_threads(1)
CPU = "cpu"


def assert_tables_equal(jt, pt):
    assert list(jt.names) == list(pt.names)
    assert jt.num_rows == pt.num_rows
    for name, jc, pc in zip(jt.names, jt.columns, pt.columns):
        a, b = HostColumn.of(jc), HostColumn.of(pc)
        assert (a.type_id, a.scale) == (b.type_id, b.scale), name
        assert (a.validity is None) == (b.validity is None), name
        if a.validity is not None:
            np.testing.assert_array_equal(a.validity, b.validity, name)
        if a.chars is not None:
            np.testing.assert_array_equal(a.offsets, b.offsets, name)
            np.testing.assert_array_equal(a.chars, b.chars, name)
        else:
            np.testing.assert_array_equal(
                np.ascontiguousarray(a.data).view(np.uint8),
                np.ascontiguousarray(b.data).view(np.uint8), name)


def matrix_table(n, rng, nulls):
    """One column per supported physical/logical type."""
    def mask():
        return None if nulls == "none" else rng.random(n) < 0.2
    ints = rng.integers(-1000, 1000, n)
    return pa.table({
        "i8": pa.array(ints.astype(np.int8) // 8, pa.int8(), mask=mask()),
        "i16": pa.array(ints.astype(np.int16), pa.int16(), mask=mask()),
        "i32": pa.array(ints.astype(np.int32) * 99991, pa.int32(),
                        mask=mask()),
        "i64": pa.array(rng.integers(-2**62, 2**62, n), pa.int64(),
                        mask=mask()),
        "u32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32),
                        pa.uint32(), mask=mask()),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32),
                        mask=mask()),
        "f64": pa.array(np.where(rng.random(n) < 0.05, -0.0,
                                 rng.standard_normal(n)), mask=mask()),
        "b": pa.array(rng.random(n) < 0.5, mask=mask()),
        "s": pa.array([f"v{v % 37}" * (v % 4) for v in ints.tolist()],
                      mask=mask()),
        "d": pa.array(ints.astype(np.int32) + 18000, pa.date32(),
                      mask=mask()),
        "ts": pa.array(rng.integers(0, 2**50, n), pa.timestamp("us"),
                       mask=mask()),
        "dec9": pa.array([None if m else Decimal(v).scaleb(-2) for v, m in
                          zip((ints * 7).tolist(), rng.random(n) < 0.1)],
                         pa.decimal128(9, 2)),
        "dec18": pa.array([Decimal(v).scaleb(-4) for v in
                           rng.integers(-10**15, 10**15, n).tolist()],
                          pa.decimal128(18, 4)),
    })


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("nulls", ["none", "sparse"])
@pytest.mark.parametrize("encoding", ["plain", "dict"])
@pytest.mark.parametrize("codec", ["none", "snappy"])
def test_read_parquet_matrix(tmp_path, codec, encoding, nulls, version):
    rng = np.random.default_rng(21)
    path = tmp_path / "m.parquet"
    table = matrix_table(1500, rng, nulls)
    pq.write_table(table, path, row_group_size=600, compression=codec,
                   use_dictionary=encoding == "dict",
                   data_page_version=version, data_page_size=2048,
                   write_batch_size=256)
    assert_tables_equal(jpq.read_parquet(path),
                        ppq.read_parquet(path, device=CPU))
    jf, pf = jpq.ParquetFile(path), ppq.ParquetFile(path)
    for gi in range(jf.num_row_groups):
        assert_tables_equal(jf.read_row_group(gi),
                            pf.read_row_group(gi, device=CPU))
        for name in table.column_names:
            assert jf.group_stats(gi, name) == pf.group_stats(gi, name)


def test_int96_and_staged_choice(tmp_path):
    rng = np.random.default_rng(22)
    n = 700
    path = tmp_path / "t.parquet"
    pq.write_table(pa.table({
        "t96": pa.array(rng.integers(0, 2**60, n), pa.timestamp("ns")),
        "x": pa.array(rng.integers(0, 9, n), pa.int64()),
    }), path, use_deprecated_int96_timestamps=True, row_group_size=300)
    got = ppq.read_parquet(path, device=CPU)
    assert_tables_equal(jpq.read_parquet(path), got)
    # an all-fixed-width schema is staged: every buffer views one transfer
    assert len({c.data.untyped_storage().data_ptr()
                for c in got.columns}) == 1
    empty = tmp_path / "e.parquet"
    pq.write_table(pa.table({"x": pa.array([], pa.int64())}), empty)
    assert_tables_equal(jpq.read_parquet(empty),
                        ppq.read_parquet(empty, device=CPU))


@pytest.fixture(scope="module")
def sorted_file(tmp_path_factory):
    rng = np.random.default_rng(23)
    n = 6000
    key = np.sort(rng.integers(0, 1000, n))
    path = tmp_path_factory.mktemp("chunked") / "s.parquet"
    pq.write_table(pa.table({
        "k": pa.array(key, pa.int64()),
        "v": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"s{i % 13}" for i in range(n)]),
    }), path, row_group_size=1000, compression="snappy")
    return path


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("predicate", [None, ("k", 300, 620)])
def test_chunked_reader(sorted_file, prefetch, predicate):
    kw = dict(pass_read_limit=9000, predicate=predicate, prefetch=prefetch)
    jr = jpq.ParquetChunkedReader(sorted_file, **kw)
    pr = ppq.ParquetChunkedReader(sorted_file, device=CPU, **kw)
    with jr, pr:
        jchunks, pchunks = list(jr), list(pr)
    assert len(jchunks) == len(pchunks) > jr.groups_read
    for jt, pt in zip(jchunks, pchunks):
        assert_tables_equal(jt, pt)
    assert (jr.groups_read, jr.groups_pruned) == \
        (pr.groups_read, pr.groups_pruned)
    if predicate is not None:
        assert pr.groups_pruned >= 2
    assert jr.footer_chunk_estimate() == pr.footer_chunk_estimate()


def test_iter_staged_padded(sorted_file):
    cols = ["k", "v"]
    jr = jpq.ParquetChunkedReader(sorted_file, pass_read_limit=9000,
                                  columns=cols)
    pr = ppq.ParquetChunkedReader(sorted_file, pass_read_limit=9000,
                                  columns=cols, device=CPU)
    jl, pl = list(jr.iter_staged(0)), list(pr.iter_staged(2))
    assert [n for _, n in jl] == [n for _, n in pl]
    for (jt, _), (pt, _) in zip(jl, pl):
        assert_tables_equal(jt, pt)  # bucket-padded: pad rows zero, invalid


def test_nested_columns_raise(tmp_path):
    """A LIST file reads whole and equals the JAX package; the nested shape
    both packages still refuse, a group inside a struct, raises."""
    from test_torch_parquet_nested import same_table
    path = tmp_path / "l.parquet"
    pq.write_table(pa.table({"l": pa.array([[1], [2, 3], None]),
                             "x": pa.array([1, 2, 3])}), path)
    assert ppq.ParquetFile(path).names == ["l", "x"]
    got = ppq.read_parquet(path, device=CPU)
    same_table(jpq.read_parquet(path), got)
    assert got["l"].to_pylist() == [[1], [2, 3], None]
    assert_tables_equal(jpq.read_parquet(path, columns=["x"]),
                        ppq.read_parquet(path, columns=["x"], device=CPU))
    deep = tmp_path / "ss.parquet"
    inner = pa.StructArray.from_arrays([pa.array([1, 2, 3])], ["a"])
    pq.write_table(pa.table({"s": pa.StructArray.from_arrays(
        [inner, pa.array([4, 5, 6])], ["in", "b"])}), deep)
    with pytest.raises(NotImplementedError, match="nested group"):
        jpq.read_parquet(deep)
    with pytest.raises(NotImplementedError, match="nested group"):
        ppq.read_parquet(deep, device=CPU)


# -- chip_smoke.py's numpy writer, read back where pyarrow exists ------------

def _expect(kind, values, valid):
    v = np.asarray(values)
    return v if valid is None else v[valid]


@pytest.mark.parametrize("nulls", ["none", "sparse"])
@pytest.mark.parametrize("encoding", ["plain", "dict"])
@pytest.mark.parametrize("codec,copies", [("none", False),
                                          ("snappy", False),
                                          ("snappy", True)])
def test_smoke_writer_reads_back(tmp_path, codec, copies, encoding, nulls):
    cols = chip_smoke.matrix_columns(3000, 5, encoding, nulls, copies)
    path = tmp_path / "w.parquet"
    chip_smoke.write_parquet(path, cols, 1200, codec, copies,
                             page_bytes=8192)
    arrow = pq.read_table(path)
    for name, kind, values, valid, _ in cols:
        got = arrow[name]
        want_valid = np.ones(len(values), bool) if valid is None else valid
        np.testing.assert_array_equal(~np.asarray(got.is_null()), want_valid)
        np.testing.assert_array_equal(
            got.drop_null().to_numpy(zero_copy_only=False),
            _expect(kind, values, valid), name)
    jt = jpq.read_parquet(path)
    assert_tables_equal(jt, ppq.read_parquet(path, device=CPU))
    for (name, kind, values, valid, _), c in zip(cols, jt.columns):
        hc = HostColumn.of(c)
        ok = np.ones(len(values), bool) if valid is None else valid
        want = np.where(ok, np.asarray(values), np.zeros((), values.dtype))
        if kind == "bool":
            want = want.astype(np.uint8)
        np.testing.assert_array_equal(
            np.ascontiguousarray(hc.data).view(np.uint8),
            np.ascontiguousarray(want).view(np.uint8), name)


def test_smoke_writer_q5_tables(tmp_path):
    fact = chip_smoke.fact_columns(5000, 3)
    dates, stores = chip_smoke.dim_columns()
    for name, cols, rows in (("fact", fact, 1024), ("dates", dates, 1 << 20),
                             ("stores", stores, 1 << 20)):
        path = tmp_path / f"{name}.parquet"
        chip_smoke.write_parquet(path, cols, rows, "snappy")
        arrow = pq.read_table(path)
        for cname, kind, values, valid, _ in cols:
            got = arrow[cname]
            if kind == "string":
                assert got.to_pylist() == [b.decode() for b in values]
                continue
            np.testing.assert_array_equal(
                got.drop_null().to_numpy(zero_copy_only=False),
                _expect(kind, values, valid), cname)
        assert_tables_equal(jpq.read_parquet(path),
                            ppq.read_parquet(path, device=CPU))
    pf = ppq.ParquetFile(tmp_path / "fact.parquet")
    lo, hi, nulls = pf.group_stats(0, "ss_sold_date_sk")
    assert lo == fact[0][2][:1024].min() and hi == fact[0][2][:1024].max()
