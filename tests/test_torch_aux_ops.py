"""Parity of the port's ``ops/binary.py``, ``ops/timezone.py`` (GpuTimeZoneDB),
``ops/zorder.py`` (ZOrder) and ``ops/bloom_filter.py`` (BloomFilter) with
the JAX package's, plus the independent oracles of ``tests/test_aux_ops.py``
(zoneinfo, a Python bit interleaver, Spark's murmur3 bloom positions).

Inputs are seeded numpy draws; both packages run on the CPU (the port with
``device="cpu"``).  Tolerance: none — data bits and validity compared
exactly.
"""

import sys
from datetime import datetime, timezone
from zoneinfo import ZoneInfo

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import binary as jbin
from spark_rapids_jni_tpu.ops import bloom_filter as jbloom
from spark_rapids_jni_tpu.ops import timezone as jtz
from spark_rapids_jni_tpu.ops import zorder as jz

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.ops import binary as pbin
from spark_rapids_jni_tpu_torch.ops import bloom_filter as pbloom
from spark_rapids_jni_tpu_torch.ops import timezone as ptz
from spark_rapids_jni_tpu_torch.ops import zorder as pz

sys.path.insert(0, "tests")
from test_aux_ops import py_bloom_positions, py_interleave  # noqa: E402

torch.set_num_threads(1)


def to_port(jc):
    return column_from_numpy(HostColumn.of(jc), device="cpu")


def assert_same(jc, pc):
    a, b = HostColumn.of(jc), HostColumn.of(pc)
    assert (a.type_id, a.scale) == (b.type_id, b.scale)
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        np.testing.assert_array_equal(a.validity, b.validity)
    np.testing.assert_array_equal(np.ascontiguousarray(a.data).view(np.uint8),
                                  np.ascontiguousarray(b.data).view(np.uint8))


# ---------------------------------------------------------------- binary

def operand(name, seed, n=500):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.15
    if name in ("FLOAT64", "FLOAT32"):
        v = np.concatenate([[np.nan, 0.0, -0.0, np.inf, -np.inf, 2.5, -2.5,
                             1e300], rng.standard_normal(n) * 100])[:n]
        v[rng.random(n) < 0.05] = np.nan
        return JColumn.fixed(getattr(jdt, name), v.astype(
            np.float32 if name == "FLOAT32" else np.float64), validity=valid)
    if name == "BOOL8":
        return JColumn.fixed(jdt.BOOL8, rng.integers(0, 2, n).astype(np.uint8),
                             validity=valid)
    storage = getattr(jdt, name).storage
    info = np.iinfo(storage)
    v = rng.integers(info.min, info.max, n, dtype=storage, endpoint=True)
    v[rng.random(n) < 0.1] = 0
    v[::4] = (v[::4] % 97).astype(storage)
    return JColumn.fixed(getattr(jdt, name), v, validity=valid)


PAIRS = [("INT8", "INT8"), ("INT8", "INT16"), ("INT16", "UINT16"),
         ("INT32", "INT32"), ("INT32", "UINT32"), ("INT32", "INT64"),
         ("INT64", "INT64"), ("UINT8", "UINT32"), ("UINT64", "UINT64"),
         ("INT32", "FLOAT64"), ("FLOAT32", "FLOAT64"), ("FLOAT64", "FLOAT64"),
         ("FLOAT32", "INT16")]
BINARY = ["add", "subtract", "multiply", "true_divide", "floor_div", "modulo",
          "eq", "ne", "lt", "le", "gt", "ge", "eq_null_safe"]


@pytest.mark.parametrize("a,b", PAIRS)
def test_binary_ops_match_jax(a, b):
    ja, jb = operand(a, 1), operand(b, 2)
    pa, pb = to_port(ja), to_port(jb)
    for fn in BINARY:
        if fn in ("floor_div", "modulo") and "FLOAT" in a + b:
            continue   # integral ops (the JAX package truncates floats)
        assert_same(getattr(jbin, fn)(ja, jb), getattr(pbin, fn)(pa, pb))


@pytest.mark.parametrize("name", ["INT8", "INT32", "INT64", "UINT32",
                                  "FLOAT32", "FLOAT64", "BOOL8"])
def test_unary_ops_match_jax(name):
    ja = operand(name, 3)
    pa = to_port(ja)
    fns = ["is_null", "is_not_null", "logical_not"]
    if name != "BOOL8":
        fns += ["negate", "abs_", "floor_", "ceil_"]
    for fn in fns:
        assert_same(getattr(jbin, fn)(ja), getattr(pbin, fn)(pa))
    if name != "BOOL8":
        for scale in (0, 2, -1, -3):
            assert_same(jbin.round_(ja, scale), pbin.round_(pa, scale))
    jb = operand(name, 4)
    assert_same(jbin.coalesce(ja, jb), pbin.coalesce(pa, to_port(jb)))


def test_logic_and_coalesce_match_jax():
    ja, jb = operand("BOOL8", 5), operand("BOOL8", 6)
    pa, pb = to_port(ja), to_port(jb)
    for fn in ("logical_and", "logical_or"):
        assert_same(getattr(jbin, fn)(ja, jb), getattr(pbin, fn)(pa, pb))
    jc = operand("BOOL8", 7)
    assert_same(jbin.coalesce(ja, jb, jc), pbin.coalesce(pa, pb, to_port(jc)))


def test_round_scale_limit_raises_like_jax():
    ja = operand("INT64", 8)
    for mod, c in ((jbin, ja), (pbin, to_port(ja))):
        with pytest.raises(ValueError):
            mod.round_(c, -19)


# ---------------------------------------------------------------- timezone

TS = {"TIMESTAMP_SECONDS": 1, "TIMESTAMP_MILLISECONDS": 10**3,
      "TIMESTAMP_MICROSECONDS": 10**6, "TIMESTAMP_NANOSECONDS": 10**9}
ZONES = ["America/Los_Angeles", "Asia/Kolkata", "America/New_York",
         "Europe/Paris", "Australia/Sydney", "Etc/GMT+5", "UTC"]


def ts_col(tid, seed, n=600):
    """Instants over 1900-2100 (NANOS: within its int64 range), plus each
    zone's 2021 transition edges, the LMT era and post-2037 rules."""
    rng = np.random.default_rng(seed)
    t = TS[tid]
    lo = int(datetime(1900, 1, 1, tzinfo=timezone.utc).timestamp())
    hi = int(datetime(2100, 1, 1, tzinfo=timezone.utc).timestamp())
    if tid == "TIMESTAMP_NANOSECONDS":
        lo, hi = -2**63 // t + 1, 2**63 // t - 1
    secs = rng.integers(lo, hi, n)
    edges = [int(datetime(*s, tzinfo=timezone.utc).timestamp())
             for s in [(2021, 3, 14, 10), (2021, 11, 7, 9), (2021, 3, 28, 1),
                       (2021, 10, 31, 1), (1910, 1, 1), (2040, 7, 1),
                       (2021, 3, 14, 2, 30), (2021, 11, 7, 1, 30)]]
    for i, e in enumerate(edges):
        secs[i * 3:i * 3 + 3] = [e - 1, e, e + 1]
    v = secs * t + rng.integers(0, t, n)
    return JColumn.fixed(jdt.DType(getattr(jdt.TypeId, tid)),
                         v.astype(np.int64), validity=rng.random(n) > 0.05)


@pytest.mark.parametrize("tid", list(TS))
def test_timezone_matches_jax(tid):
    jc = ts_col(tid, len(tid))
    pc = to_port(jc)
    for zone in ZONES:
        for fn in ("utc_to_local", "local_to_utc"):
            assert_same(getattr(jtz, fn)(jc, zone), getattr(ptz, fn)(pc, zone))


@pytest.mark.parametrize("zone", ["America/Los_Angeles", "Asia/Kolkata",
                                  "Europe/Paris"])
def test_utc_to_local_matches_zoneinfo(zone):
    jc = ts_col("TIMESTAMP_MICROSECONDS", 11, 300)
    micros = np.asarray(jc.data)
    got = ptz.utc_to_local(to_port(jc), zone).data.numpy()
    z = ZoneInfo(zone)
    for m, g in zip(micros.tolist(), got.tolist()):
        utc = datetime.fromtimestamp(m // 10**6, timezone.utc)
        if utc.year < 1901:
            continue  # zoneinfo's LMT/first-rule handling is not the oracle
        assert g - m == int(z.utcoffset(utc.astimezone(z))
                            .total_seconds()) * 10**6, (zone, utc)


def test_transition_tables_match_jax():
    for zone in ZONES:
        ji, jo = jtz.load_transitions(zone)
        pi_, po = ptz.load_transitions(zone)
        np.testing.assert_array_equal(ji, pi_)
        np.testing.assert_array_equal(jo, po)
        for ticks in TS.values():
            a = ptz._device_tables(zone, ticks, "cpu")
            b = jtz._device_tables(zone, ticks)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_tzif_by_absolute_path_and_unknown_zone():
    path = "/usr/share/zoneinfo/Asia/Kolkata"
    np.testing.assert_array_equal(ptz.load_transitions(path)[1],
                                  ptz.load_transitions("Asia/Kolkata")[1])
    for mod in (jtz, ptz):
        with pytest.raises(ValueError):
            mod.load_transitions("Not/AZone")
    with pytest.raises(TypeError):
        ptz.utc_to_local(Column.from_pylist([1], pdt.INT64, device="cpu"),
                         "UTC")


# ---------------------------------------------------------------- zorder

@pytest.mark.parametrize("name,k", [("INT32", 2), ("INT64", 3), ("INT16", 2),
                                    ("UINT8", 4), ("INT64", 1),
                                    ("UINT32", 3)])
def test_interleave_bits_matches_jax(name, k):
    cols = [operand(name, 20 + i, 300) for i in range(k)]
    want = jz.interleave_bits(JTable(cols))
    got = pz.interleave_bits(Table([to_port(c) for c in cols]))
    np.testing.assert_array_equal(np.asarray(want.offsets),
                                  got.offsets.numpy())
    raw = got.children[0].data.numpy()
    np.testing.assert_array_equal(np.asarray(want.children[0].data), raw)
    w = getattr(pdt, name).itemsize * 8
    raw = raw.view(np.uint8).reshape(300, -1)
    vals = [np.asarray(c.data).astype(np.int64) for c in cols]
    for i in range(0, 300, 37):
        assert raw[i].tobytes() == py_interleave(
            [int(v[i]) & ((1 << w) - 1) for v in vals], w)


def test_interleave_rejects_like_jax():
    for mod, mk, T in ((jz, JColumn, JTable), (pz, None, Table)):
        if mk is None:
            a = Column.fixed(pdt.INT32, np.zeros(2, np.int32), device="cpu")
            b = Column.fixed(pdt.INT64, np.zeros(2, np.int64), device="cpu")
        else:
            a = JColumn.from_numpy(np.zeros(2, np.int32))
            b = JColumn.from_numpy(np.zeros(2, np.int64))
        with pytest.raises(TypeError):
            mod.interleave_bits(T([a, b]))


# ---------------------------------------------------------------- bloom

@pytest.mark.parametrize("items,k", [(3000, 3), (500, 7)])
def test_bloom_matches_jax_and_spark(items, k):
    rng = np.random.default_rng(items)
    vals = rng.integers(-2**63, 2**63 - 1, items, dtype=np.int64)
    vals[:4] = [0, 1, -1, 2**62]
    jc = JColumn.fixed(jdt.INT64, vals, validity=rng.random(items) > 0.05)
    pc = to_port(jc)
    nb = pbloom.optimal_num_bits(items, 0.03)
    assert nb == jbloom.optimal_num_bits(items, 0.03)
    assert pbloom.optimal_num_hashes(items, nb) == \
        jbloom.optimal_num_hashes(items, nb)
    jbits = np.asarray(jbloom.bloom_build(jc, nb, k))
    pbits = pbloom.bloom_build(pc, nb, k)
    np.testing.assert_array_equal(jbits, pbits.numpy())
    # Spark's BloomFilterImpl positions (py_murmur_long), first rows
    pos, _ = pbloom._positions(pc, k, nb)
    for i in range(0, 40):
        assert pos[i].tolist() == py_bloom_positions(int(vals[i]), k, nb)
    probe = JColumn.fixed(jdt.INT64, np.concatenate(
        [vals[:500], rng.integers(-2**40, 2**40, 500)]),
        validity=rng.random(1000) > 0.1)
    assert_same(jbloom.bloom_might_contain(jbits, probe, k),
                pbloom.bloom_might_contain(pbits, to_port(probe), k))
    other = pbloom.bloom_build(to_port(probe), nb, k)
    merged = pbloom.bloom_merge([pbits, other])
    np.testing.assert_array_equal(
        np.asarray(jbloom.bloom_merge([jbits, np.asarray(
            jbloom.bloom_build(probe, nb, k))])), merged.numpy())
    buf = pbloom.spark_serialize(merged, k)
    assert buf == jbloom.spark_serialize(merged.numpy(), k)
    bits, kk = pbloom.spark_deserialize(buf)
    assert kk == k
    np.testing.assert_array_equal(bits[:nb], merged.numpy())
