"""CastStrings formatting parity: the port's ``ops/cast_strings.py``
number/date -> STRING directions against the JAX package's.

The inputs are the vectors of ``tests/test_cast_format.py`` and
``tests/test_cast_strings.py`` plus seeded random values over each type's
range.  Both packages run on the CPU; the port with ``device="cpu"``.
Tolerance: none — offsets and chars are compared bit for bit.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_strings as jcs

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.ops import cast_strings as pcs

torch.set_num_threads(1)


def to_port(jc):
    return column_from_numpy(HostColumn.of(jc), device="cpu")


def assert_same(jc, pc):
    a, b = HostColumn.of(jc), HostColumn.of(pc)
    assert (a.type_id, a.scale) == (b.type_id, b.scale)
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        np.testing.assert_array_equal(a.validity, b.validity)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.chars, b.chars)


INT_CASES = [
    ("INT8", np.array([0, 1, -1, 127, -128, 42], np.int8)),
    ("INT16", np.array([0, -32768, 32767, 500], np.int16)),
    ("INT32", np.array([0, 2**31 - 1, -2**31, 7, -70], np.int32)),
    ("INT64", np.array([0, 2**63 - 1, -2**63, 10**18, -5], np.int64)),
    ("UINT32", np.array([0, 2**32 - 1, 2**31], np.uint32)),
    ("UINT64", np.array([0, 2**64 - 1, 2**63, 12], np.uint64)),
    ("BOOL8", np.array([1, 0, 1], np.uint8)),
]


@pytest.mark.parametrize("name,vals", INT_CASES)
def test_from_integer(name, vals):
    valid = np.arange(len(vals)) % 3 != 2
    jc = JColumn.fixed(getattr(jdt, name), vals, validity=valid)
    assert_same(jcs.cast_from_integer(jc), pcs.cast_from_integer(to_port(jc)))


def test_from_integer_random():
    rng = np.random.default_rng(3)
    v = rng.integers(-2**63, 2**63 - 1, 2000, dtype=np.int64)
    v[::7] //= 10 ** rng.integers(0, 18, v[::7].shape)
    jc = JColumn.fixed(jdt.INT64, v)
    assert_same(jcs.cast_from_integer(jc), pcs.cast_from_integer(to_port(jc)))


@pytest.mark.parametrize("dtype", ["decimal32", "decimal64"])
@pytest.mark.parametrize("scale", [-6, -2, 0, 3])
def test_from_decimal(dtype, scale):
    rng = np.random.default_rng(abs(scale))
    storage = np.int32 if dtype == "decimal32" else np.int64
    info = np.iinfo(storage)
    v = np.concatenate([
        rng.integers(info.min, info.max, 500, dtype=storage),
        rng.integers(-10**4, 10**4, 500).astype(storage),
        np.array([0, 1, -1, 5, -5, info.max, info.min], storage)])
    jc = JColumn.fixed(getattr(jdt, dtype)(scale), v,
                       validity=rng.random(len(v)) > 0.1)
    assert_same(jcs.cast_from_decimal(jc),
                pcs.cast_from_decimal(to_port(jc)))


@pytest.mark.parametrize("scale", [-10, -38, 0, 4])
def test_from_decimal128(scale):
    rng = np.random.default_rng(128 + scale)
    ints = [int(x) for x in rng.integers(-2**62, 2**62, 300)]
    ints += [int(x) * 10**20 + int(y) for x, y in zip(
        rng.integers(-10**18, 10**18, 300), rng.integers(0, 10**18, 300))]
    ints += [0, 1, -1, 2**127 - 1, -2**127, 10**38, -10**38, 5 * 10**20]
    jc = JColumn.fixed(jdt.decimal128(scale), np.array(ints, object))
    assert_same(jcs.cast_from_decimal(jc),
                pcs.cast_from_decimal(to_port(jc)))


def _float_inputs(rng):
    vals = np.concatenate([
        [0.0, -0.0, 1.0, -1.0, 3.5, 0.1, 123.456, 1e7, 9999999.0, 1e-3,
         0.00099, 1e16, -2.5e-9, np.nan, np.inf, -np.inf,
         3.141592653589793, 1e300, 2.0 ** -1022, 1.7976931348623157e308,
         -2.0 ** -1021, 5e-300, 1e22, 1e23, 0.3, 2.0 / 3.0],
        rng.standard_normal(400), rng.standard_normal(400) * 1e12,
        rng.standard_normal(400) * 1e-12,
        rng.integers(0, 10**7, 200).astype(np.float64),
        np.round(rng.uniform(-1e4, 1e4, 300), 2)])
    return vals


@pytest.mark.parametrize("width", ["FLOAT64", "FLOAT32"])
def test_from_float(width):
    vals = _float_inputs(np.random.default_rng(1))
    if width == "FLOAT32":
        with np.errstate(over="ignore"):
            vals = vals.astype(np.float32)
        vals = vals[(np.abs(vals) >= np.finfo(np.float32).tiny)
                    | (vals == 0) | ~np.isfinite(vals)]
    jc = JColumn.from_numpy(vals)
    jout, pout = jcs.cast_from_float(jc), pcs.cast_from_float(to_port(jc))
    # below 2^-800 the port follows Java (digits that parse back to the
    # same double, ROADMAP queue 3's kept deviation); the JAX package's
    # flushed search may print others there.  Bit for bit everywhere else.
    deep = (np.abs(vals) < 2.0 ** -800) & (vals != 0)
    got = pout.to_pylist()
    for i in np.flatnonzero(deep):
        assert float(got[i]) == vals[i], (vals[i], got[i])
    want = jout.to_pylist()
    assert [want[i] for i in np.flatnonzero(~deep)] == \
        [got[i] for i in np.flatnonzero(~deep)]
    if not deep.any():
        assert_same(jout, pout)


def test_from_float_subnormal_prints_its_digits():
    """Deviation kept on purpose: the JAX package prints subnormal doubles
    as "0.0" because XLA on the CPU flushes them to zero; the port keeps
    them (torch does not flush) and prints digits that parse back to the
    same double, as Java does."""
    vals = np.array([5e-324, -2.2250738585072e-310])
    got = pcs.cast_from_float(Column.from_numpy(vals, device="cpu"))
    for g, v in zip(got.to_pylist(), vals):
        assert float(g.replace("E", "e")) == v
    assert jcs.cast_from_float(JColumn.from_numpy(vals[:1])).to_pylist() == \
        ["0.0"]


@pytest.mark.parametrize("tid,vals", [
    ("TIMESTAMP_DAYS", np.array([0, 1, -1, 18993, -25567, 11016, 19723,
                                 -719162, 2932896], np.int32)),
    ("TIMESTAMP_SECONDS", np.array([0, 1, -1, 1700000000, -2208988800,
                                    253402300799, 86399], np.int64)),
    ("TIMESTAMP_MILLISECONDS", np.array([0, 1, -1, 1700000000123,
                                         -2208988800500], np.int64)),
    ("TIMESTAMP_MICROSECONDS", np.array([0, 1, -1, 1700000000123456,
                                         -1, 10, 120000], np.int64)),
    ("TIMESTAMP_NANOSECONDS", np.array([0, 1, -1, 1700000000123456789,
                                        -999, 1000], np.int64)),
])
def test_from_datetime(tid, vals):
    rng = np.random.default_rng(len(vals))
    info = np.iinfo(vals.dtype)
    span = {"TIMESTAMP_DAYS": 10**6, "TIMESTAMP_SECONDS": 10**11}.get(
        tid, info.max // 2)
    vals = np.concatenate([vals, rng.integers(-span, span, 300)
                           .astype(vals.dtype)])
    jc = JColumn.fixed(jdt.DType(getattr(jdt.TypeId, tid)), vals,
                       validity=rng.random(len(vals)) > 0.05)
    assert_same(jcs.cast_from_datetime(jc),
                pcs.cast_from_datetime(to_port(jc)))
