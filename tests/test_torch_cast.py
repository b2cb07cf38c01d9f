"""Parity of the port's ``utils/int128.py``, ``ops/datetime.py`` and
``ops/cast.py`` with the JAX package's, and the port's DECIMAL128 rules in
sort, hash and aggregate.

Inputs are seeded numpy draws that cover each type's extremes; both
packages run on the CPU (the port with ``device="cpu"``).  Tolerance:
none — data bits (FLOAT64 by its int64 bits) and validity are compared
exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import datetime as jdtm
from spark_rapids_jni_tpu.ops import aggregate as jagg, hash as jhash
from spark_rapids_jni_tpu.ops import order as jorder
from spark_rapids_jni_tpu.utils import int128 as ji

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import cast as pcast
from spark_rapids_jni_tpu_torch.ops import datetime as pdtm
from spark_rapids_jni_tpu_torch.ops import hash as phash
from spark_rapids_jni_tpu_torch.ops import order as porder
from spark_rapids_jni_tpu_torch.utils import int128 as pi

torch.set_num_threads(1)
jcast = importlib.import_module("spark_rapids_jni_tpu.ops.cast")


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


# ---------------------------------------------------------------- int128

def _limbs(seed, n=600):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    hi = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    hi[::3] >>= rng.integers(1, 63, hi[::3].shape)   # small magnitudes
    hi[1::5] = 0
    lo[2::7] = np.array([0, -1, 2**63 - 1, -2**63], np.int64)[
        np.arange(len(lo[2::7])) % 4]
    return lo, hi


def _u(x):
    return np.asarray(x).astype(np.uint64).view(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("case", ["split_apply", "mul_small", "divmod_small",
                                  "mul_pow10", "div_pow10", "fits_le_f64",
                                  "dyn"])
def test_int128_matches_jax(case):
    lo, hi = _limbs(len(case))
    jlo, jhi, jneg = ji.split_sign(jnp.asarray(lo), jnp.asarray(hi))
    plo, phi, pneg = pi.split_sign(_t(lo), _t(hi))
    np.testing.assert_array_equal(_u(jlo), plo.numpy())
    np.testing.assert_array_equal(_u(jhi), phi.numpy())
    np.testing.assert_array_equal(np.asarray(jneg), pneg.numpy())
    got, want = [], []
    if case == "split_apply":
        want = ji.apply_sign(jlo, jhi, jneg)
        got = pi.apply_sign(plo, phi, pneg)
    elif case == "mul_small":
        for c in (1, 10, 999_999_937, 1 << 30):
            want += ji.mul_small(jlo, jhi, c)
            got += pi.mul_small(plo, phi, c)
    elif case == "divmod_small":
        for c in (1, 10, 10**9, 1 << 30):
            want += ji.divmod_small(jlo, jhi, c)
            got += pi.divmod_small(plo, phi, c)
    elif case == "mul_pow10":
        for k in (0, 1, 9, 20, 38):
            want += ji.mul_pow10(jlo, jhi, k)
            got += pi.mul_pow10(plo, phi, k)
    elif case == "div_pow10":
        for k in (1, 5, 18, 37):
            for half in (False, True):
                want += ji.div_pow10(jlo, jhi, k, half)
                got += pi.div_pow10(plo, phi, k, half)
    elif case == "fits_le_f64":
        for bits in (1, 31, 64, 100, 127, 128):
            want.append(ji.fits_bits(jlo, jhi, bits))
            got.append(pi.fits_bits(plo, phi, bits))
        for bound in (0, 2**31 - 1, 2**62, 2**63, 2**64 - 1):
            want.append(ji.le_u64(jlo, jhi, bound))
            got.append(pi.le_u64(plo, phi, bound))
        want.append(ji.to_f64(jlo, jhi).view(jnp.int64))
        got.append(pi.to_f64(plo, phi).view(torch.int64))
    else:
        k = np.random.default_rng(7).integers(0, 21, len(lo))
        want += ji.mul_pow10_dyn(jlo, jhi, jnp.asarray(k), 20)
        got += pi.mul_pow10_dyn(plo, phi, _t(k), 20)
        for half in (False, True):
            want += ji.div_pow10_dyn(jlo, jhi, jnp.asarray(k), 20, half)
            got += pi.div_pow10_dyn(plo, phi, _t(k), 20, half)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.bool_:
            np.testing.assert_array_equal(w, g)
        else:
            np.testing.assert_array_equal(_u(w), g)


# ---------------------------------------------------------------- datetime

TS_TYPES = ["TIMESTAMP_DAYS", "TIMESTAMP_SECONDS", "TIMESTAMP_MILLISECONDS",
            "TIMESTAMP_MICROSECONDS", "TIMESTAMP_NANOSECONDS"]
DT_FUNCS = ["year", "month", "dayofmonth", "dayofweek", "dayofyear",
            "quarter", "last_day", "hour", "minute", "second"]


def ts_column(tid: str, seed: int, n: int = 800):
    rng = np.random.default_rng(seed)
    per_day = {"TIMESTAMP_DAYS": 1, "TIMESTAMP_SECONDS": 86_400,
               "TIMESTAMP_MILLISECONDS": 86_400_000,
               "TIMESTAMP_MICROSECONDS": 86_400 * 10**6,
               "TIMESTAMP_NANOSECONDS": 86_400 * 10**9}[tid]
    span = min(200 * 365 * per_day, 2**62)
    v = rng.integers(-span, span, n)
    v[:8] = [0, -1, 1, per_day - 1, -per_day, 59 * per_day, 60 * per_day,
             11016 * per_day]
    storage = np.int32 if tid == "TIMESTAMP_DAYS" else np.int64
    return JColumn.fixed(jdt.DType(getattr(jdt.TypeId, tid)),
                         v.astype(storage), validity=rng.random(n) > 0.05)


@pytest.mark.parametrize("tid", TS_TYPES)
def test_datetime_fields_match_jax(tid):
    jc = ts_column(tid, len(tid))
    pc = to_port(jc)
    for fn in DT_FUNCS:
        if tid == "TIMESTAMP_DAYS" and fn in ("hour", "minute", "second"):
            for mod, col in ((jdtm, jc), (pdtm, pc)):
                with pytest.raises(TypeError):
                    getattr(mod, fn)(col)
            continue
        assert_same(getattr(jdtm, fn)(jc), getattr(pdtm, fn)(pc))


# ---------------------------------------------------------------- cast

def source_column(name: str, seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    if name in ("FLOAT32", "FLOAT64"):
        v = np.concatenate([
            [0.0, -0.0, np.nan, np.inf, -np.inf, 0.5, -0.5, 1.5, 2.5, -2.5,
             2.0**63, -2.0**63, 2.0**64, 1e30, -1e30, 127.9, 128.0, -129.0,
             2.0**31, 4.2949673e9, 0.125, 1.005, 2.675],
            rng.standard_normal(n) * 10.0 ** rng.integers(-4, 20, n)])[:n]
        v = np.round(v, 3) if seed % 2 else v
        v = v.astype(np.float32 if name == "FLOAT32" else np.float64)
        return JColumn.fixed(getattr(jdt, name), v, validity=valid)
    if name.startswith("DEC128"):
        scale = int(name.split("_")[1])
        ints = [int(a) * int(b) for a, b in zip(
            rng.integers(-2**62, 2**62, n), rng.integers(1, 2**40, n))]
        ints[:6] = [0, 1, -1, 2**127 - 1, -2**127, 5 * 10**20]
        return JColumn.fixed(jdt.decimal128(scale), np.array(ints, object),
                             validity=valid)
    if name.startswith("DEC"):
        width, scale = name[3:].split("_")
        storage = np.int32 if width == "32" else np.int64
        info = np.iinfo(storage)
        v = rng.integers(info.min, info.max, n, dtype=storage)
        v[::2] //= (10 ** rng.integers(0, 8, v[::2].shape)).astype(storage)
        v[:4] = [0, 5, -5, 149]
        return JColumn.fixed(getattr(jdt, f"decimal{width}")(int(scale)), v,
                             validity=valid)
    if name == "BOOL8":
        return JColumn.fixed(jdt.BOOL8, rng.integers(0, 2, n)
                             .astype(np.uint8), validity=valid)
    storage = getattr(jdt, name).storage
    info = np.iinfo(storage)
    v = rng.integers(info.min, info.max, n, dtype=storage, endpoint=True)
    v[::3] = (v[::3] // 10**6).astype(storage) if info.bits > 32 else v[::3]
    v[:2] = [info.min, info.max]
    return JColumn.fixed(getattr(jdt, name), v, validity=valid)


SOURCES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT32", "UINT64",
           "FLOAT32", "FLOAT64", "BOOL8", "DEC32_-2", "DEC64_-3", "DEC64_2",
           "DEC128_-4", "DEC128_3"]
TARGETS = ["INT8", "INT16", "INT32", "INT64", "UINT16", "UINT32", "UINT64",
           "FLOAT32", "FLOAT64", "BOOL8", "DEC32_-1", "DEC64_-2", "DEC64_-6",
           "DEC64_1", "DEC128_-2", "DEC128_-20", "DEC128_2"]


def target_dtype(mod, name):
    if name.startswith("DEC"):
        width, scale = name[3:].split("_")
        return getattr(mod, f"decimal{width}")(int(scale))
    return getattr(mod, name)


@pytest.mark.parametrize("src", SOURCES)
def test_cast_matches_jax(src):
    jc = source_column(src, SOURCES.index(src))
    pc = to_port(jc)
    for tgt in TARGETS:
        want = jcast.cast(jc, target_dtype(jdt, tgt))
        got = pcast.cast(pc, target_dtype(pdt, tgt))
        assert_same(want, got)


@pytest.mark.parametrize("src,tgt", [
    (a, b) for a in TS_TYPES for b in TS_TYPES if a != b])
def test_cast_timestamps_match_jax(src, tgt):
    jc = ts_column(src, 3)
    assert_same(jcast.cast(jc, jdt.DType(getattr(jdt.TypeId, tgt))),
                pcast.cast(to_port(jc), pdt.DType(getattr(pdt.TypeId, tgt))))


def test_cast_string_directions_delegate():
    jc = JColumn.from_pylist(["12", " -3.5 ", "x", None, "1e2"])
    pc = to_port(jc)
    for tgt in ("INT32", "FLOAT64", "DEC64_-2", "BOOL8"):
        assert_same(jcast.cast(jc, target_dtype(jdt, tgt)),
                    pcast.cast(pc, target_dtype(pdt, tgt)))
    back = pcast.cast(pcast.cast(pc, pdt.INT32), pdt.STRING)
    assert back.to_pylist() == ["12", "-3", None, None, None]


# ------------------------------------------------ DECIMAL128 elsewhere

D128 = [5, -3, 2**70, 7, 5, -(2**100), 0, 2**64 - 1, -1]


def d128_pair():
    jc = JColumn.from_pylist(D128, jdt.decimal128(-2))
    return jc, to_port(jc)


def test_decimal128_sort_orders_by_value():
    """JAX encodes a DECIMAL128 key as an [n, 2] word and returns an
    [n, 2] array that is no permutation; the port sorts by value (hi
    signed, then lo unsigned)."""
    jc, pc = d128_pair()
    jorder_out = np.asarray(jorder.sort_indices([jorder.SortKey(jc)]))
    assert jorder_out.ndim == 2
    got = porder.sort_indices([porder.SortKey(pc)]).tolist()
    assert [D128[i] for i in got] == sorted(D128)
    assert got == sorted(range(len(D128)), key=lambda i: D128[i])
    desc = porder.sort_indices([porder.SortKey(pc, ascending=False)])
    assert [D128[i] for i in desc.tolist()] == sorted(D128, reverse=True)


@pytest.mark.parametrize("fn", ["murmur3_hash", "xxhash64"])
def test_decimal128_hash_raises_like_jax(fn):
    jc, pc = d128_pair()
    with pytest.raises(ValueError):
        getattr(jhash, fn)(JTable([jc], ["a"]))
    with pytest.raises(ValueError):
        getattr(phash, fn)(Table([pc], ["a"]), device="cpu")


@pytest.mark.parametrize("op", ["min", "max", "sum", "mean"])
def test_decimal128_aggregate_raises_like_jax(op):
    jc, pc = d128_pair()
    keys = [1, 1, 2, 2, 1, 3, 3, 2, 1]
    jt = JTable([JColumn.from_pylist(keys, jdt.INT32), jc], ["k", "v"])
    pt = Table([Column.from_pylist(keys, pdt.INT32, device="cpu"), pc],
               ["k", "v"])
    with pytest.raises(ValueError):
        jagg.groupby(jt, ["k"], [("v", op)])
    with pytest.raises(ValueError):
        pagg.groupby(pt, ["k"], [("v", op)], device="cpu")


def test_decimal128_count_matches_jax():
    jc, pc = d128_pair()
    keys = [1, 1, 2, 2, 1, 3, 3, 2, 1]
    jt = JTable([JColumn.from_pylist(keys, jdt.INT32), jc], ["k", "v"])
    pt = Table([Column.from_pylist(keys, pdt.INT32, device="cpu"), pc],
               ["k", "v"])
    want = jagg.groupby(jt, ["k"], [("v", "count")])
    got = pagg.groupby(pt, ["k"], [("v", "count")], device="cpu")
    for a, b in zip(want.columns, got.columns):
        assert_same(a, b)
