"""RowConversion parity: the torch port against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages; the
port's side runs with ``device="cpu"`` and gets its data through
``columnar/interop.py``.  Row blobs are held bit-exact (tolerance 0): the
wire format is a byte contract.  On the CPU the port's K1/K2 wrappers take
their plain versions, which are held here against the JAX Pallas kernels
run in interpret mode, as tests/test_pallas.py runs them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import pallas_kernels as jpk
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch import dtypes as dt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.interop import (
    HostColumn, table_from_numpy, table_to_numpy)
from spark_rapids_jni_tpu_torch.kernels import row_wire
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

torch.set_num_threads(1)
CPU = "cpu"


def port_table(jtable: JTable) -> Table:
    """The JAX table's bits as a port table on the CPU."""
    return table_from_numpy([HostColumn.of(c) for c in jtable.columns],
                            jtable.names, device=CPU)


def blob_bytes(blob) -> np.ndarray:
    return np.asarray(blob.children[0].data.cpu()
                      if hasattr(blob.children[0].data, "cpu")
                      else blob.children[0].data).view(np.uint8)


def assert_blobs_equal(jblobs, pblobs):
    assert len(jblobs) == len(pblobs)
    for jb, pb in zip(jblobs, pblobs):
        np.testing.assert_array_equal(np.asarray(jb.offsets),
                                      pb.offsets.numpy())
        np.testing.assert_array_equal(blob_bytes(jb), blob_bytes(pb))


def assert_host_equal(jcols, pcols):
    """Bit-exact column equality: validity, and data on the valid rows."""
    for jc, pc in zip(jcols, pcols):
        assert (jc.type_id, jc.scale) == (pc.type_id, pc.scale)
        n = len(pc.offsets) - 1 if pc.chars is not None else len(pc.data)
        jv = np.ones(n, bool) if jc.validity is None else jc.validity
        pv = np.ones(n, bool) if pc.validity is None else pc.validity
        np.testing.assert_array_equal(jv, pv)
        if pc.chars is not None:
            np.testing.assert_array_equal(jc.offsets, pc.offsets)
            np.testing.assert_array_equal(jc.chars, pc.chars)
        elif n:
            jd = np.ascontiguousarray(jc.data).view(np.uint8).reshape(n, -1)
            pd = np.ascontiguousarray(pc.data).view(np.uint8).reshape(n, -1)
            np.testing.assert_array_equal(jd[jv], pd[pv])


# -- K1 / K2: plain versions vs the Pallas kernels ----------------------------

@pytest.mark.parametrize("nw,n", [(12, 512), (7, 256), (2, 64)])
def test_interleave_plain_matches_pallas(nw, n):
    rng = np.random.default_rng(nw)
    planes = rng.integers(0, 2**32, (nw, n), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jpk.interleave_planes([jnp.asarray(p) for p in planes],
                                            interpret=True))
    got = row_wire.interleave_planes(torch.from_numpy(planes.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = row_wire.deinterleave_wire(got, nw)
    jback = jpk.deinterleave_wire(jnp.asarray(want), nw, interpret=True)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.stack([np.asarray(p) for p in jback]))


def test_unaligned_rejected():
    with pytest.raises(ValueError):
        row_wire.interleave_planes(torch.zeros((2, 49), dtype=torch.int32))
    with pytest.raises(ValueError):
        row_wire.deinterleave_wire(torch.zeros(2 * 49, dtype=torch.int32), 2)


def test_kernel_wrappers_reject_bad_input():
    with pytest.raises(TypeError):
        row_wire.interleave_planes(torch.zeros((2, 32), dtype=torch.int64))
    with pytest.raises(ValueError):
        row_wire.deinterleave_wire(torch.zeros(33, dtype=torch.int32), 2)


# -- layout -------------------------------------------------------------------

SCHEMAS = [
    [jdt.INT8, jdt.INT64, jdt.INT16],
    [jdt.INT64, jdt.INT32, jdt.INT16, jdt.INT8],
    [jdt.INT64, jdt.FLOAT64, jdt.INT32, jdt.FLOAT32, jdt.INT16, jdt.INT8,
     jdt.BOOL8, jdt.decimal64(-4)],
    [jdt.decimal128(-6), jdt.INT8] + [jdt.BOOL8] * 9,
]


def as_port_dtype(d):
    return dt.DType(dt.TypeId(int(d.id)), d.scale)


@pytest.mark.parametrize("schema", SCHEMAS)
def test_layout_matches_jax(schema):
    want = jrc.fixed_width_layout(schema)
    got = rc.fixed_width_layout([as_port_dtype(d) for d in schema])
    assert (got.offsets, got.validity_offset, got.row_size) == \
        (want.offsets, want.validity_offset, want.row_size)


def test_layout_rejects_strings():
    with pytest.raises(TypeError):
        rc.fixed_width_layout([dt.STRING])


# -- fixed-width row blobs ----------------------------------------------------

FIXED_DTYPES = [
    jdt.INT8, jdt.INT16, jdt.INT32, jdt.INT64, jdt.UINT8, jdt.UINT16,
    jdt.UINT32, jdt.UINT64, jdt.FLOAT32, jdt.FLOAT64, jdt.BOOL8,
    jdt.TIMESTAMP_DAYS, jdt.TIMESTAMP_MICROSECONDS, jdt.decimal32(-2),
    jdt.decimal64(3), jdt.decimal128(-6),
]


def random_values(d, n, rng):
    store = d.storage
    if d.id == jdt.TypeId.DECIMAL128:
        return rng.integers(-2**62, 2**62, (n, 2), dtype=np.int64)
    if store.kind == "f":
        v = rng.standard_normal(n).astype(store)
        v[:4] = np.array([-0.0, np.nan, np.inf, -np.inf], store)[:n][:4]
        return v
    if d == jdt.BOOL8:
        return rng.integers(0, 2, n).astype(np.uint8)
    info = np.iinfo(store)
    return rng.integers(info.min, info.max, size=n, dtype=store)


@pytest.mark.parametrize("d", FIXED_DTYPES, ids=repr)
def test_single_dtype_blob_matches_jax(d):
    rng = np.random.default_rng(int(d.id) * 7 + 1)
    n = 77
    vals = random_values(d, n, rng)
    valid = rng.random(n) > 0.3
    jt = JTable([JColumn.fixed(d, vals, validity=valid),
                 JColumn.from_numpy(np.arange(n, dtype=np.int16))])
    pt = port_table(jt)
    jblobs = jrc.convert_to_rows(jt)
    pblobs = rc.convert_to_rows(pt, device=CPU)
    assert_blobs_equal(jblobs, pblobs)
    back = rc.convert_from_rows(pblobs[0], pt.dtypes(), device=CPU)
    jback = jrc.convert_from_rows(jblobs[0], jt.dtypes())
    assert_host_equal([HostColumn.of(c) for c in jback.columns],
                      table_to_numpy(back))
    # the round trip gives back every bit of the input, nulls' slots too
    for a, b in zip(pt.columns, back.columns):
        assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))


def bench_table(n, seed):
    """The stage's schema (bench.py build_host_table) as a JAX table."""
    rng = np.random.default_rng(seed)
    cols = [
        (jdt.INT64, rng.integers(-2**62, 2**62, n).astype(np.int64), None),
        (jdt.FLOAT64, rng.standard_normal(n), rng.random(n) > 0.1),
        (jdt.INT32, rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
         None),
        (jdt.FLOAT32, rng.standard_normal(n).astype(np.float32), None),
        (jdt.INT16, rng.integers(-2**15, 2**15 - 1, n).astype(np.int16),
         rng.random(n) > 0.5),
        (jdt.INT8, rng.integers(-128, 128, n).astype(np.int8), None),
        (jdt.BOOL8, (rng.random(n) > 0.5).astype(np.uint8), None),
        (jdt.decimal64(-4), rng.integers(-10**15, 10**15, n).astype(np.int64),
         None),
    ]
    return JTable([JColumn.fixed(d, v, validity=m) for d, v, m in cols],
                  ["i64", "f64", "i32", "f32", "i16", "i8", "bool", "dec64"])


@pytest.mark.parametrize("n", [0, 77, 1000])
def test_bench_schema_blob_matches_jax(n):
    jt = bench_table(n, seed=n)
    pt = port_table(jt)
    assert_blobs_equal(jrc.convert_to_rows(jt),
                       rc.convert_to_rows(pt, device=CPU))


@pytest.mark.parametrize("rows_per_batch", [40, 64, 100])
def test_batch_splits_match_jax(rows_per_batch):
    jt = bench_table(333, seed=rows_per_batch)
    pt = port_table(jt)
    cap = rows_per_batch * rc.fixed_width_layout(pt.dtypes()).row_size
    jblobs = jrc.convert_to_rows(jt, max_batch_bytes=cap)
    pblobs = rc.convert_to_rows(pt, max_batch_bytes=cap, device=CPU)
    assert len(pblobs) > 1
    assert all(b.size % 32 == 0 for b in pblobs[:-1])
    assert_blobs_equal(jblobs, pblobs)
    parts = [rc.convert_from_rows(b, pt.dtypes(), device=CPU) for b in pblobs]
    for ci, col in enumerate(pt.columns):
        got = torch.cat([p.columns[ci].data for p in parts])
        assert torch.equal(got.view(torch.uint8), col.data.view(torch.uint8))


def test_from_byte_blobs_matches_jax():
    """A blob whose child holds bytes (not packed words) decodes the same
    in both packages."""
    jt = bench_table(96, seed=9)
    [jblob] = jrc.convert_to_rows(jt)
    raw = blob_bytes(jblob).astype(np.int8)
    jbytes = JColumn.list_(JColumn.fixed(jdt.INT8, raw), jblob.offsets)
    pbytes = Column.list_(Column.fixed(dt.INT8, raw, device=CPU),
                          np.asarray(jblob.offsets), device=CPU)
    want = jrc.convert_from_rows(jbytes, jt.dtypes())
    got = rc.convert_from_rows(pbytes, [as_port_dtype(d)
                                        for d in jt.dtypes()], device=CPU)
    assert_host_equal([HostColumn.of(c) for c in want.columns],
                      table_to_numpy(got))


def test_wire_format_golden():
    """Hand-computed bytes, as tests/test_row_conversion.py has them."""
    t = Table([
        Column.from_numpy(np.array([0x11223344, -1], np.int32), device=CPU),
        Column.fixed(dt.INT8, np.array([0x7F, 2], np.int8),
                     validity=np.array([True, False]), device=CPU),
        Column.from_numpy(np.array([0x0102030405060708, 0], np.int64),
                          device=CPU),
    ])
    [blob] = rc.convert_to_rows(t, device=CPU)
    raw = blob.children[0].bytes_numpy()
    np.testing.assert_array_equal(raw[0:4], [0x44, 0x33, 0x22, 0x11])
    assert raw[4] == 0x7F
    np.testing.assert_array_equal(raw[8:16], [8, 7, 6, 5, 4, 3, 2, 1])
    assert raw[16] == 0b111 and raw[24 + 16] == 0b101
    assert int(blob.offsets[-1]) == blob.children[0].size == 48


def test_float_bits_survive_round_trip():
    """NaN payloads and -0.0 come back bit for bit (no float arithmetic on
    the data path)."""
    bits = np.array([0x7FF0000000000001, 0xFFF8000000000123,
                     0x8000000000000000, 0x0000000000000001],
                    np.uint64).view(np.int64)
    f32 = np.array([0x7F800001, 0xFFC00123, 0x80000000, 1],
                   np.uint32).view(np.float32)
    t = Table([Column.fixed(dt.FLOAT64, bits, device=CPU),
               Column.fixed(dt.FLOAT32, f32, device=CPU)])
    [blob] = rc.convert_to_rows(t, device=CPU)
    back = rc.convert_from_rows(blob, t.dtypes(), device=CPU)
    np.testing.assert_array_equal(back.columns[0].data.view(torch.int64)
                                  .numpy(), bits)
    np.testing.assert_array_equal(back.columns[1].data.view(torch.int32)
                                  .numpy(), f32.view(np.int32))


def test_error_contracts():
    t = Table([Column.from_numpy(np.arange(64, dtype=np.int64), device=CPU)])
    lay = rc.fixed_width_layout(t.dtypes())
    with pytest.raises(ValueError):  # a 32-row batch would exceed the cap
        rc.convert_to_rows(t, max_batch_bytes=16 * lay.row_size, device=CPU)
    [blob] = rc.convert_to_rows(t, device=CPU)
    with pytest.raises(ValueError):  # wrong schema -> wrong row width
        rc.convert_from_rows(blob, [dt.INT8], device=CPU)
    with pytest.raises(TypeError):
        rc.convert_from_rows(t.columns[0], [dt.INT64], device=CPU)


# -- variable-width (STRING) rows ---------------------------------------------

WORDS = ["", "a", "béta", "cherry-pie", "δelta-δelta", "x" * 37,
         "\U0001F600smile", "tail"]


def var_table(n, seed):
    rng = np.random.default_rng(seed)
    s1 = [WORDS[k] if ok else None for k, ok in
          zip(rng.integers(0, len(WORDS), n), rng.random(n) > 0.2)]
    s2 = [WORDS[k] for k in rng.integers(0, len(WORDS), n)]
    i64 = rng.integers(-2**62, 2**62, n).astype(np.int64)
    i32 = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    vi = rng.random(n) > 0.5
    return JTable([JColumn.from_numpy(i64),
                   JColumn.from_pylist(s1, dtype=jdt.STRING),
                   JColumn.fixed(jdt.INT32, i32, validity=vi),
                   JColumn.from_pylist(s2, dtype=jdt.STRING)])


def test_var_layout_matches_jax():
    schema = [jdt.INT32, jdt.STRING, jdt.INT8, jdt.STRING, jdt.INT64]
    want = jrc.variable_width_layout(schema)
    got = rc.variable_width_layout([as_port_dtype(d) for d in schema])
    assert got.string_idx == want.string_idx
    assert (got.base.offsets, got.base.validity_offset, got.base.row_size) \
        == (want.base.offsets, want.base.validity_offset, want.base.row_size)


@pytest.mark.parametrize("n,cap", [(257, None), (600, 8192), (1, None)])
def test_var_blobs_match_jax(n, cap):
    jt = var_table(n, seed=n)
    pt = port_table(jt)
    kw = {} if cap is None else {"max_batch_bytes": cap}
    jblobs = jrc.convert_to_rows(jt, **kw)
    pblobs = rc.convert_to_rows(pt, device=CPU, **kw)
    assert_blobs_equal(jblobs, pblobs)
    for jb, pb in zip(jblobs, pblobs):
        want = jrc.convert_from_rows(jb, jt.dtypes())
        got = rc.convert_from_rows(pb, pt.dtypes(), device=CPU)
        assert_host_equal([HostColumn.of(c) for c in want.columns],
                          table_to_numpy(got))


def test_var_round_trip_and_all_string_schema():
    t = Table([Column.from_pylist(["abc", "", "longer-string", None],
                                  device=CPU),
               Column.from_pylist(["x", "yy", None, "zzzz"], device=CPU)])
    [blob] = rc.convert_to_rows(t, device=CPU)
    back = rc.convert_from_rows(blob, t.dtypes(), device=CPU)
    assert back.columns[0].to_pylist() == ["abc", "", "longer-string", None]
    assert back.columns[1].to_pylist() == ["x", "yy", None, "zzzz"]


def test_var_oversized_group_cut_unaligned():
    n, cap = 40, 4096
    strs = ["x" * 1000] * n
    jt = JTable([JColumn.from_pylist(strs, dtype=jdt.STRING),
                 JColumn.from_numpy(np.arange(n, dtype=np.int64))])
    pt = port_table(jt)
    pblobs = rc.convert_to_rows(pt, max_batch_bytes=cap, device=CPU)
    assert any(b.size % 32 for b in pblobs[:-1])
    assert_blobs_equal(jrc.convert_to_rows(jt, max_batch_bytes=cap), pblobs)
