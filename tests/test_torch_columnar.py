"""Columnar core parity: the torch port's dtypes, bitmask, columns, tables,
Arrow interop, numpy carry-over, key encodings and selection against the
JAX package, on the CPU.

Inputs are made with numpy from fixed seeds; the port runs with
``device="cpu"``.  Tolerance: bit-exact throughout (no arithmetic on
values).  Also the port's two guards: it never imports jax or the JAX
package, and an entry point called without ``device=`` runs on CUDA or
raises, never on the CPU.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.columnar import arrow as jarrow
from spark_rapids_jni_tpu.ops import order as jorder
from spark_rapids_jni_tpu.ops import selection as jsel
from spark_rapids_jni_tpu.ops import strings_common as jsc
from spark_rapids_jni_tpu.utils import bitmask as jbitmask

from spark_rapids_jni_tpu_torch import dtypes as dt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import arrow as parrow
from spark_rapids_jni_tpu_torch.columnar.interop import (
    HostColumn, table_from_numpy, table_to_numpy)
from spark_rapids_jni_tpu_torch.ops import order as porder
from spark_rapids_jni_tpu_torch.ops import selection as psel
from spark_rapids_jni_tpu_torch.ops import strings_common as psc
from spark_rapids_jni_tpu_torch.utils import bitmask as pbitmask

torch.set_num_threads(1)
CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


def port_table(jt):
    return table_from_numpy([HostColumn.of(c) for c in jt.columns],
                            jt.names, device=CPU)


def assert_columns_equal(jcol, pcol):
    """Bit-exact: dtype, validity (None vs all-valid counts as equal) and
    every data slot."""
    j, p = HostColumn.of(jcol), HostColumn.of(pcol)
    assert (j.type_id, j.scale) == (p.type_id, p.scale)
    n = pcol.size
    jv = np.ones(n, bool) if j.validity is None else j.validity
    pv = np.ones(n, bool) if p.validity is None else p.validity
    np.testing.assert_array_equal(jv, pv)
    if j.chars is not None:
        np.testing.assert_array_equal(j.offsets, p.offsets)
        np.testing.assert_array_equal(j.chars, p.chars)
    else:
        np.testing.assert_array_equal(
            np.ascontiguousarray(j.data).view(np.uint8),
            np.ascontiguousarray(p.data).view(np.uint8))


def mixed_table(n, seed):
    rng = np.random.default_rng(seed)
    words = ["", "a", "abc", "héllo", "zz" * 11, None]
    f64 = rng.standard_normal(n)
    f64.view(np.uint64)[:min(n, 3)] = [0x8000000000000000,
                                       0x7FF0000000000123,
                                       0xFFF8000000000000][:min(n, 3)]
    return JTable([
        JColumn.fixed(jdt.INT32, rng.integers(-9, 9, n).astype(np.int32),
                      validity=rng.random(n) > 0.2),
        JColumn.fixed(jdt.FLOAT64, f64, validity=rng.random(n) > 0.2),
        JColumn.fixed(jdt.FLOAT32, rng.standard_normal(n)
                      .astype(np.float32)),
        JColumn.fixed(jdt.UINT32, rng.integers(0, 2**32, n, dtype=np.uint64)
                      .astype(np.uint32)),
        JColumn.fixed(jdt.UINT16, rng.integers(0, 2**16, n)
                      .astype(np.uint16), validity=rng.random(n) > 0.5),
        JColumn.fixed(jdt.BOOL8, rng.integers(0, 2, n).astype(np.uint8)),
        JColumn.from_pylist([words[k] for k in
                             rng.integers(0, len(words), n)],
                            dtype=jdt.STRING),
    ], ["i32", "f64", "f32", "u32", "u16", "b", "s"])


# -- dtypes and bitmask -------------------------------------------------------

@pytest.mark.parametrize("tid", list(jdt.TypeId), ids=lambda t: t.name)
def test_type_ids_match_jax(tid):
    p = dt.TypeId(int(tid))
    assert p.name == tid.name
    jd = jdt.DType(tid, -3 if tid in (jdt.TypeId.DECIMAL32,
                                      jdt.TypeId.DECIMAL64,
                                      jdt.TypeId.DECIMAL128) else 0)
    pd = dt.DType(p, jd.scale)
    for prop in ("is_fixed_width", "is_decimal", "is_numeric",
                 "is_integral", "is_floating", "is_string", "is_nested"):
        assert getattr(pd, prop) == getattr(jd, prop), prop
    if jd.is_fixed_width:
        assert pd.itemsize == jd.itemsize and pd.storage == jd.storage


@pytest.mark.parametrize("n", [0, 1, 77, 1000])
def test_bitmask_matches_jax(n):
    valid = np.random.default_rng(n).random(n) > 0.5
    for bits in (8, 32):
        want = np.asarray(jbitmask.pack_bits(valid, bits))
        got = pbitmask.pack_bits(torch.from_numpy(valid), bits).numpy()
        np.testing.assert_array_equal(got.view(want.dtype), want)
        np.testing.assert_array_equal(
            pbitmask.unpack_bits(torch.from_numpy(got), n).numpy(), valid)
    jcol = JColumn.fixed(jdt.INT8, np.zeros(n, np.int8), validity=valid)
    pcol = Column.fixed(dt.INT8, np.zeros(n, np.int8), validity=valid,
                        device=CPU)
    np.testing.assert_array_equal(pcol.packed_validity().numpy()
                                  .view(np.uint32),
                                  np.asarray(jcol.packed_validity()))


# -- columns, carry-over, host round trips ------------------------------------

@pytest.mark.parametrize("n", [0, 77])
def test_carry_over_is_bit_exact(n):
    jt = mixed_table(n, seed=n + 1)
    pt = port_table(jt)
    for jc, pc in zip(jt.columns, pt.columns):
        assert_columns_equal(jc, pc)
    assert pt.columns[1].data.dtype == torch.float64  # FLOAT64 stored natively
    back = table_from_numpy(table_to_numpy(pt), device=CPU)
    for a, b in zip(pt.columns, back.columns):
        assert_columns_equal(a, b)


def test_pylist_and_decimal128_match_jax():
    vals = [12345678901234567890123456789, -(1 << 126), 0, None]
    cases = [
        ([5, None, -3], jdt.INT64), ([1.5, None, -0.25], jdt.FLOAT64),
        ([True, False, None], None), (["x", None, "héllo"], None),
        (vals, jdt.decimal128(-6)), ([[1, 2], None, [], [3]], None),
        ([12, -7], jdt.decimal32(-2)),
    ]
    for values, d in cases:
        jc = JColumn.from_pylist(values, d)
        pd = None if d is None else dt.DType(dt.TypeId(int(d.id)), d.scale)
        pc = Column.from_pylist(values, pd, device=CPU)
        assert pc.to_pylist() == jc.to_pylist()
        assert pc.dtype.id == jc.dtype.id and pc.size == jc.size


def test_arrow_round_trip_matches_jax():
    pa = pytest.importorskip("pyarrow")
    at = pa.table({
        "i": pa.array([1, None, 3], pa.int64()),
        "d": pa.array([1.5, -0.0, None], pa.float64()),
        "s": pa.array(["a", None, "ccc"]),
        "dec": pa.array([1, None, -20], pa.decimal128(10, 2)),
        "ts": pa.array([0, 10**6, None], pa.timestamp("us")),
        "l": pa.array([[1, 2], None, []], pa.list_(pa.int32())),
        "b": pa.array([True, None, False]),
    })
    jt = jarrow.from_arrow(at)
    pt = parrow.from_arrow(at, device=CPU)
    for name in ("i", "d", "s", "dec", "ts", "b"):
        assert_columns_equal(jt.column(name), pt.column(name))
    assert parrow.to_arrow(pt).equals(jarrow.to_arrow(jt))


def test_padded_bytes_match_jax():
    jc = mixed_table(50, seed=3).column("s")
    pc = port_table(JTable([jc])).columns[0]
    for width in (None, 32):
        jm, jl = jsc.to_padded_bytes(jc, width)
        pm, pl = psc.to_padded_bytes(pc, width)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    back = psc.from_padded_bytes(pm, pl, pc.validity)
    assert back.to_pylist() == pc.to_pylist()


# -- key encodings and selection ----------------------------------------------

@pytest.mark.parametrize("asc,nulls_first", [(True, None), (False, None),
                                             (True, False)])
def test_key_words_and_sort_match_jax(asc, nulls_first):
    jt = mixed_table(300, seed=4)
    pt = port_table(jt)
    for name in jt.names:
        jw = jorder.encode_key(jorder.SortKey(jt.column(name), asc,
                                              nulls_first))
        pw = porder.encode_key(porder.SortKey(pt.column(name), asc,
                                              nulls_first))
        assert len(jw) == len(pw)
        for a, b in zip(jw, pw):
            np.testing.assert_array_equal(np.asarray(a).view(np.int64),
                                          b.numpy())
    keys = ["i32", "s", "f64"]
    jorder_idx = jorder.sort_indices([jorder.SortKey(jt.column(k), asc,
                                                     nulls_first)
                                      for k in keys])
    porder_idx = porder.sort_indices([porder.SortKey(pt.column(k), asc,
                                                     nulls_first)
                                      for k in keys])
    np.testing.assert_array_equal(porder_idx.numpy(), np.asarray(jorder_idx))


def test_gather_filter_slice_concat_match_jax():
    jt = mixed_table(120, seed=5)
    pt = port_table(jt)
    idx = np.random.default_rng(6).integers(-5, 130, 90)  # OOB -> null
    checks = [
        (jsel.gather_table(jt, idx),
         psel.gather_table(pt, torch.from_numpy(idx))),
        (jsel.slice_table(jt, 30, 200), psel.slice_table(pt, 30, 200)),
        (jsel.concat_tables([jt, jsel.slice_table(jt, 5, 10)]),
         psel.concat_tables([pt, psel.slice_table(pt, 5, 10)])),
        (jsel.sort_table(jt, [jorder.SortKey(jt.column("s"), False)]),
         psel.sort_table(pt, [porder.SortKey(pt.column("s"), False)])),
    ]
    mask = np.random.default_rng(7).random(120) > 0.4
    checks.append((jsel.apply_boolean_mask(jt, mask),
                   psel.apply_boolean_mask(pt, torch.from_numpy(mask))))
    for want, got in checks:
        assert got.num_rows == want.num_rows
        for jc, pc in zip(want.columns, got.columns):
            assert_columns_equal(jc, pc)


def test_list_gather_and_concat_match_jax():
    values = [[1, 2], None, [], [3, 4, 5], [6]]
    jc = JColumn.from_pylist(values)
    pc = Column.from_pylist(values, device=CPU)
    idx = np.array([4, -1, 3, 0, 9, 1, 3])
    want = jsel.gather_column(jc, idx)
    got = psel.gather_column(pc, torch.from_numpy(idx))
    assert got.to_pylist() == want.to_pylist()
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))
    both = psel.concat_tables([Table([pc]), Table([got])]).columns[0]
    assert both.to_pylist() == jsel.concat_tables(
        [JTable([jc]), JTable([want])]).columns[0].to_pylist()


def test_normalize_bits_match_jax():
    f64 = np.array([0x8000000000000000, 0x7FF0000000000001,
                    0xFFF8000000000000, 0x3FF0000000000000,
                    0x7FF0000000000000], np.uint64)
    f32 = np.array([0x80000000, 0x7F800001, 0xFFC00000, 0x3F800000,
                    0x7F800000], np.uint32)
    np.testing.assert_array_equal(
        porder.normalize_f64_bits(torch.from_numpy(f64.view(np.int64)))
        .numpy(), np.asarray(jorder.normalize_f64_bits(f64)).view(np.int64))
    np.testing.assert_array_equal(
        porder.normalize_f32_bits(torch.from_numpy(f32.astype(np.int64)))
        .numpy(), np.asarray(jorder.normalize_f32_bits(f32)).astype(np.int64))


# -- guards -------------------------------------------------------------------

def test_port_never_imports_jax():
    """A fresh interpreter runs the stage's functions through the port and
    neither jax nor the JAX package gets imported."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from spark_rapids_jni_tpu_torch import dtypes as dt
        from spark_rapids_jni_tpu_torch.columnar import Column, Table
        from spark_rapids_jni_tpu_torch.columnar import interop
        from spark_rapids_jni_tpu_torch.ops import (aggregate, hash,
                                                    row_conversion, selection)
        t = Table([Column.from_numpy(np.arange(64, dtype=np.int32) % 5,
                                     device="cpu"),
                   Column.from_pylist(["ab", None] * 32, device="cpu")],
                  ["k", "s"])
        [blob] = row_conversion.convert_to_rows(t, device="cpu")
        back = row_conversion.convert_from_rows(blob, t.dtypes(),
                                                device="cpu")
        g = aggregate.groupby(t, ["k"], [("k", "sum")], device="cpu")
        hash.murmur3_hash(g.select(["k"]), device="cpu")
        hash.xxhash64(t, device="cpu")
        interop.table_to_numpy(back)
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "spark_rapids_jni_tpu"
                     or m.startswith("spark_rapids_jni_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_entry_points_default_to_cuda():
    """Called without ``device=``, a constructor and an entry point run on
    CUDA; where torch sees no card they raise instead of returning CPU
    tensors."""
    cpu_table = Table([Column.from_numpy(np.arange(32, dtype=np.int64),
                                         device=CPU)])
    from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows
    if torch.cuda.is_available():
        assert Column.from_numpy(np.arange(4)).data.is_cuda
        assert convert_to_rows(cpu_table)[0].children[0].data.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA"):
        Column.from_numpy(np.arange(4))
    with pytest.raises(RuntimeError, match="no CUDA"):
        convert_to_rows(cpu_table)
