"""Nested Parquet columns: the port's LIST and STRUCT host assembly against
the JAX package's, on the same pyarrow-written files.

The cases of ``tests/test_parquet.py`` (``TestListColumns`` and the STRUCT
and nested-LIST tests), read whole and through the chunked reader by both
packages (the port with ``device="cpu"``).  Offsets, validity and child
data are held bit for bit, at every level (floats compared as bits).  The
device route plans a scalar projection of a nested file and hands a
group that projects a nested column back to the host with ``"nested"``.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.io import parquet as jpq
from spark_rapids_jni_tpu_torch.columnar.interop import HostColumn
from spark_rapids_jni_tpu_torch.io import parquet as ppq
from spark_rapids_jni_tpu_torch.utils import tracing

torch.set_num_threads(1)
CPU = "cpu"


def _host(x):
    if x is None:
        return None
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def same_column(jc, pc, where="col"):
    """A JAX column and a port column hold the same buffers at every
    nesting level: validity, offsets, children, data bits."""
    assert int(jc.dtype.id) == int(pc.dtype.id), where
    assert jc.dtype.scale == pc.dtype.scale, where
    assert len(jc.children) == len(pc.children), where
    assert (jc.validity is None) == (pc.validity is None), where
    if jc.validity is not None:
        np.testing.assert_array_equal(_host(jc.validity),
                                      _host(pc.validity), where)
    if pc.dtype.is_nested:
        assert (jc.offsets is None) == (pc.offsets is None), where
        if pc.offsets is not None:
            np.testing.assert_array_equal(_host(jc.offsets),
                                          _host(pc.offsets), where)
        for i, (a, b) in enumerate(zip(jc.children, pc.children)):
            same_column(a, b, f"{where}.{i}")
        return
    a, b = HostColumn.of(jc), HostColumn.of(pc)
    if a.chars is not None:
        np.testing.assert_array_equal(a.offsets, b.offsets, where)
        np.testing.assert_array_equal(a.chars, b.chars, where)
    else:
        np.testing.assert_array_equal(
            np.ascontiguousarray(a.data).view(np.uint8),
            np.ascontiguousarray(b.data).view(np.uint8), where)


def same_table(jt, pt):
    assert list(jt.names) == list(pt.names)
    assert jt.num_rows == pt.num_rows
    for name, jc, pc in zip(jt.names, jt.columns, pt.columns):
        same_column(jc, pc, name)


def read_both(path, columns=None, limit=None):
    """Whole reads, then (with ``limit``) chunked reads, of both packages."""
    same_table(jpq.read_parquet(path, columns=columns),
               ppq.read_parquet(path, columns=columns, device=CPU))
    if limit is None:
        return
    jl = list(jpq.ParquetChunkedReader(path, pass_read_limit=limit,
                                       columns=columns))
    pl = list(ppq.ParquetChunkedReader(path, pass_read_limit=limit,
                                       columns=columns, device=CPU))
    assert len(jl) == len(pl) > 1
    for jt, pt in zip(jl, pl):
        same_table(jt, pt)


LIST_CASES = [[1, 2], None, [], [3], [4, 5, 6]]
LIST_STR_CASES = [["a"], [], None, ["b", None], ["", "cc"]]


def test_list_roundtrip_v1(tmp_path):
    p = tmp_path / "l.parquet"
    pq.write_table(pa.table({
        "l": pa.array(LIST_CASES, pa.list_(pa.int64())),
        "s": pa.array(LIST_STR_CASES, pa.list_(pa.string())),
        "x": pa.array(range(5), pa.int64())}), p)
    read_both(p)
    got = ppq.read_parquet(p, device=CPU)
    assert got["l"].to_pylist() == LIST_CASES
    assert got["s"].to_pylist() == LIST_STR_CASES


@pytest.mark.parametrize("kw", [
    dict(row_group_size=3000, compression="snappy"),
    dict(data_page_version="2.0", compression="snappy"),
    dict(use_dictionary=False),
])
def test_list_large(tmp_path, kw):
    rng = np.random.default_rng(5)
    n = 20_000
    lens = rng.integers(0, 6, n)
    vals = rng.integers(0, 50, int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    pyl = [vals[offs[i]:offs[i + 1]].tolist()
           if rng.random() > 0.1 else None for i in range(n)]
    p = tmp_path / "t.parquet"
    pq.write_table(pa.table({"l": pa.array(pyl, pa.list_(pa.int64()))}),
                   p, **kw)
    read_both(p, limit=40_000)
    assert ppq.read_parquet(p, device=CPU)["l"].to_pylist() == pyl


def test_list_chunked_slicing(tmp_path):
    rng = np.random.default_rng(6)
    n = 10_000
    pyl = [list(range(int(rng.integers(0, 4)))) for _ in range(n)]
    p = tmp_path / "t.parquet"
    pq.write_table(pa.table({"l": pa.array(pyl, pa.list_(pa.int64())),
                             "x": pa.array(range(n), pa.int64())}), p,
                   row_group_size=2_000)
    read_both(p, limit=50_000)
    out = []
    for chunk in ppq.ParquetChunkedReader(p, pass_read_limit=50_000,
                                          device=CPU):
        out.extend(chunk["l"].to_pylist())
    assert out == pyl


def test_struct_read_basic(tmp_path):
    n = 1_000
    rng = np.random.default_rng(4)
    a = rng.integers(0, 10**6, n)
    b = rng.standard_normal(n)
    s = [f"s{i % 13}" for i in range(n)]
    p = tmp_path / "st.parquet"
    pq.write_table(pa.table({
        "plain": pa.array(np.arange(n)),
        "st": pa.StructArray.from_arrays(
            [pa.array(a), pa.array(b), pa.array(s)], ["a", "b", "s"]),
    }), p, row_group_size=300)
    read_both(p, limit=8_000)
    col = ppq.read_parquet(p, device=CPU)["st"]
    assert col.to_pylist() == [(int(x), float(y), z)
                               for x, y, z in zip(a, b, s)]


def test_struct_read_nulls_both_levels(tmp_path):
    vals = [{"x": 1, "y": "a"}, None, {"x": None, "y": "c"},
            {"x": 4, "y": None}, None, {"x": 6, "y": "f"}]
    p = tmp_path / "stn.parquet"
    pq.write_table(pa.table({"st": pa.array(
        vals, type=pa.struct([("x", pa.int64()), ("y", pa.string())]))}), p)
    read_both(p)
    assert ppq.read_parquet(p, device=CPU)["st"].to_pylist() == \
        [None if v is None else (v["x"], v["y"]) for v in vals]


@pytest.mark.parametrize("comp", ["snappy", "gzip", "zstd"])
def test_struct_read_codecs_chunked(tmp_path, comp):
    n = 2_000
    rng = np.random.default_rng(5)
    mask = rng.random(n) > 0.15
    x = rng.integers(-10**9, 10**9, n)
    st = pa.StructArray.from_arrays([pa.array(x)], ["x"],
                                    mask=pa.array(~mask))
    p = tmp_path / f"stc_{comp}.parquet"
    pq.write_table(pa.table({"st": st, "k": pa.array(np.arange(n))}), p,
                   compression=comp, row_group_size=512)
    read_both(p, limit=6_000)
    back = ppq.read_parquet(p, device=CPU)
    assert back["st"].to_pylist() == \
        [(int(v),) if ok else None for v, ok in zip(x, mask)]


def test_nested_list_read(tmp_path):
    vals = [[[1, 2], [3]], [], None, [[4], [], None], [[5, 6, 7]]]
    svals = [[["a"], ["bb", None]], None, [[]], [["ccc"], None], []]
    p = tmp_path / "ll.parquet"
    pq.write_table(pa.table({
        "ll": pa.array(vals, type=pa.list_(pa.list_(pa.int64()))),
        "ls": pa.array(svals, type=pa.list_(pa.list_(pa.string()))),
    }), p)
    read_both(p)
    back = ppq.read_parquet(p, device=CPU)
    assert back["ll"].to_pylist() == vals
    assert back["ls"].to_pylist() == svals


def test_nested_list_read_deep_and_chunked(tmp_path):
    rng = np.random.default_rng(17)
    vals = []
    for _ in range(2_000):
        if rng.random() < 0.1:
            vals.append(None)
        else:
            vals.append([[int(x) for x in
                          rng.integers(0, 100, rng.integers(0, 4))]
                         if rng.random() > 0.15 else None
                         for _ in range(rng.integers(0, 3))])
    p = tmp_path / "deep.parquet"
    pq.write_table(pa.table({"ll": pa.array(
        vals, type=pa.list_(pa.list_(pa.int64())))}), p,
        row_group_size=450, compression="zstd")
    read_both(p, limit=4_000)
    assert ppq.read_parquet(p, device=CPU)["ll"].to_pylist() == vals
    v3 = [[[[1], [2, 3]]], None, [], [[[4]], []]]
    p3 = tmp_path / "l3.parquet"
    pq.write_table(pa.table({"x": pa.array(
        v3, type=pa.list_(pa.list_(pa.list_(pa.int64()))))}), p3)
    read_both(p3)
    assert ppq.read_parquet(p3, device=CPU)["x"].to_pylist() == v3


def _mixed_nested(n, seed):
    rng = np.random.default_rng(seed)
    sv = rng.random(n) > 0.1
    lens = rng.integers(0, 5, n)
    flat = rng.integers(-50, 50, int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    lists = [flat[offs[i]:offs[i + 1]].tolist() if rng.random() > 0.05
             else None for i in range(n)]
    return pa.table({
        "k": pa.array(rng.integers(0, 1000, n), mask=rng.random(n) < 0.05),
        "v": pa.array(rng.standard_normal(n)),
        "st": pa.StructArray.from_arrays(
            [pa.array(rng.integers(0, 10**6, n), mask=rng.random(n) < 0.1),
             pa.array([f"n{i % 29}" for i in range(n)])],
            ["id", "name"], mask=pa.array(~sv)),
        "l": pa.array(lists, pa.list_(pa.int32())),
    })


def test_empty_projection_and_iter_staged(tmp_path):
    """A nested file with zero row groups reads as an empty table of the
    same schema in both packages; iter_staged carries nested chunks."""
    p = tmp_path / "m.parquet"
    pq.write_table(_mixed_nested(3_000, 3), p, row_group_size=1_000)
    jl = [t for t, _ in jpq.ParquetChunkedReader(
        p, pass_read_limit=20_000).iter_staged(0)]
    pl = [t for t, _ in ppq.ParquetChunkedReader(
        p, pass_read_limit=20_000, device=CPU).iter_staged(2)]
    assert len(jl) == len(pl) > 3
    for jt, pt in zip(jl, pl):
        same_table(jt, pt)
    e = tmp_path / "e.parquet"
    pq.write_table(_mixed_nested(3_000, 3).slice(0, 0), e)
    same_table(jpq.ParquetFile(e).empty_table(),
               ppq.ParquetFile(e).empty_table(device=CPU))
    same_table(jpq.read_parquet(e), ppq.read_parquet(e, device=CPU))


def test_device_route_plans_scalars_and_returns_nested(tmp_path):
    """Spark's column pruning: the key and measure of a nested file keep
    the device route; a projection with the STRUCT or the LIST re-plans to
    the host with the reason "nested", as in the JAX package."""
    p = tmp_path / "m.parquet"
    pq.write_table(_mixed_nested(2_000, 4), p, row_group_size=1_000,
                   use_dictionary=False)
    pf, jf = ppq.ParquetFile(p), jpq.ParquetFile(p)
    chunk, reason = ppq.plan_device_group(pf, 0, ["k", "v"], device=CPU)
    assert chunk is not None and reason is None
    for cols in (["k", "st"], ["l", "v"], None):
        chunk, reason = ppq.plan_device_group(pf, 0, cols, device=CPU)
        jchunk, jreason = jpq.plan_device_group(jf, 0, cols)
        assert chunk is None and jchunk is None
        assert reason == jreason == "nested"
    tracing.reset_counters("io.device_decode.")
    got = list(ppq.ParquetChunkedReader(
        p, columns=["k", "st", "l"], device=CPU).iter_device())
    assert [kind for kind, _, _ in got] == ["host", "host"]
    assert {reason for _, _, reason in got} == {"nested"}
    assert tracing.counter_value("io.device_decode.fallbacks") == 2
    jgot = list(jpq.ParquetChunkedReader(
        p, columns=["k", "st", "l"]).iter_device())
    assert [(k, r) for k, _, r in jgot] == [(k, r) for k, _, r in got]
    for (_, (jt, jn), _), (_, (pt, pn), _) in zip(jgot, got):
        assert jn == pn
        same_table(jt, pt)
