"""General column casts (the cudf::cast role), Spark non-ANSI semantics.

- integral -> integral: two's-complement narrowing (Java semantics);
- float -> integral: truncate toward zero, NaN -> 0, +/-inf and
  out-of-range saturate to the target min/max (JVM double-to-long rules);
- integral/bool -> float and float widths: value conversion;
- numeric <-> BOOL8: zero is false, nonzero is true; bool -> 0/1;
- timestamps: unit rescale (floor on downscale, Spark's instant
  semantics); DATE <-> timestamp via day boundaries;
- decimals: scale change by powers of ten; values that overflow the
  target width become null (Spark's non-ANSI overflow-to-null), HALF_UP
  on a coarser decimal scale;
- STRING directions delegate to ``ops.cast_strings`` (CastStrings).

The same rules as ``spark_rapids_jni_tpu/ops/cast.py``.  UINT16/32/64
columns keep their bits in the signed torch type of the same width
(``dtypes.py``), and u64 values are handled through ``utils.int128``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import DType, INT64, TypeId, int64_values
from ..utils import int128 as i128
from ..utils.floatbits import SIGN64
from ..utils.tracing import traced

_TS_UNIT = {
    TypeId.TIMESTAMP_SECONDS: 10**9,
    TypeId.TIMESTAMP_MILLISECONDS: 10**6,
    TypeId.TIMESTAMP_MICROSECONDS: 10**3,
    TypeId.TIMESTAMP_NANOSECONDS: 1,
}

_INT_IDS = (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
            TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64)
_FLOAT_IDS = (TypeId.FLOAT32, TypeId.FLOAT64)


def _fixed(dtype: DType, data: torch.Tensor, validity=None) -> Column:
    """Column of ``dtype`` whose storage holds ``data`` converted (integer
    conversions to narrower types wrap, keeping the low bits)."""
    tdt = dtype.torch_dtype
    if data.dtype == torch.bool and tdt != torch.uint8:
        data = data.to(torch.int64)
    return Column(dtype, data=data.to(tdt), validity=validity)


def _int_values(col: Column) -> torch.Tensor:
    """int64 values of an integral/bool/decimal column (UINT64 bits)."""
    if col.dtype.id == TypeId.BOOL8:
        return col.data.to(torch.int64)
    return int64_values(col.dtype, col.data)


def _to_float(col: Column, tdt: torch.dtype) -> torch.Tensor:
    """Value conversion to float32/float64, one rounding (as XLA's)."""
    if col.dtype.is_floating:
        return col.data.to(tdt)
    v = _int_values(col)
    if col.dtype.id != TypeId.UINT64:
        return v.to(tdt)
    if tdt == torch.float64:
        return i128.u64_to_f64(v)
    # u64 -> f32 in one rounding: halve with a sticky bit (exact in the
    # 63-bit range), convert, double
    big = v < 0
    halved = i128.lsr(v, 1) | (v & 1)
    return torch.where(big, halved.to(tdt) * 2.0, v.to(tdt))


@traced("cast")
def cast(col: Column, to: DType, ansi: bool = False) -> Column:
    """Cast a column to ``to`` with Spark non-ANSI semantics (see module
    docstring); ``ansi=True`` applies to the string directions
    (``ops.cast_strings``)."""
    f = col.dtype
    if f == to:
        return col

    if f.is_string:
        from . import cast_strings as cs
        if to.id in _INT_IDS:
            return cs.cast_to_integer(col, to, ansi=ansi)
        if to.id in _FLOAT_IDS:
            return cs.cast_to_float(col, to, ansi=ansi)
        if to.is_decimal:
            return cs.cast_to_decimal(col, to, ansi=ansi)
        if to.id == TypeId.BOOL8:
            return cs.cast_to_bool(col, ansi=ansi)
        raise NotImplementedError(f"cast STRING -> {to!r}")
    if to.is_string:
        from . import cast_strings as cs
        if f.id in _INT_IDS or f.id == TypeId.BOOL8:
            return cs.cast_from_integer(col)
        if f.id in _FLOAT_IDS:
            return cs.cast_from_float(col)
        if f.is_decimal:
            return cs.cast_from_decimal(col)
        if f.is_timestamp:
            return cs.cast_from_datetime(col)
        raise NotImplementedError(f"cast {f!r} -> STRING")

    if f.is_timestamp and to.is_timestamp:
        v = col.data.to(torch.int64)
        if TypeId.TIMESTAMP_DAYS in (f.id, to.id):
            # per-unit day length with no nanosecond intermediate (a ns
            # intermediate wraps int64 outside ~1677..2262)
            if f.id == TypeId.TIMESTAMP_DAYS:
                out = v * (86_400 * (10**9 // _TS_UNIT[to.id]))
            else:
                out = v // (86_400 * (10**9 // _TS_UNIT[f.id]))
            return _fixed(to, out, col.validity)
        uf, ut = _TS_UNIT[f.id], _TS_UNIT[to.id]
        out = v * (uf // ut) if uf >= ut else v // (ut // uf)
        return _fixed(to, out, col.validity)

    if f.is_decimal or to.is_decimal:
        return _cast_decimal(col, to)

    if to.id == TypeId.BOOL8:
        v = col.data if f.is_floating else _int_values(col)
        return _fixed(to, v != 0, col.validity)
    if to.id in _FLOAT_IDS:
        tdt = torch.float32 if to.id == TypeId.FLOAT32 else torch.float64
        return _fixed(to, _to_float(col, tdt), col.validity)
    if to.id in _INT_IDS:
        if f.is_floating:
            return _fixed(to, _float_to_int(col.data.to(torch.float64), to),
                          col.validity)
        v = _int_values(col)
        bits = to.storage.itemsize * 8
        if bits < 64:   # two's-complement narrowing (Java semantics)
            v = v & ((1 << bits) - 1)
            if to.storage.kind == "i":
                sign = 1 << (bits - 1)
                v = (v ^ sign) - sign
        return _fixed(to, v, col.validity)
    raise NotImplementedError(f"cast {f!r} -> {to!r}")


def _float_to_int(v: torch.Tensor, to: DType) -> torch.Tensor:
    """JVM double -> integral: NaN -> 0, truncate toward zero, saturate
    EXACTLY at the target's min/max (int64 bits of the target value)."""
    info = np.iinfo(to.storage)
    t = torch.where(torch.isnan(v), torch.zeros_like(v), torch.trunc(v))
    edge = float(info.max)
    lo = float(info.min)
    if to.storage.itemsize == 8:
        # float(info.max) rounds UP to 2**63 (2**64 unsigned): a clean edge
        hi = float(np.nextafter(np.float64(edge), 0.0))
        over = t >= edge
    else:
        hi, over = edge, t > edge
    safe = t.clamp(lo, hi)
    if to.id == TypeId.UINT64:
        top = safe >= 2.0 ** 63   # exact: safe is integral here
        conv = torch.where(top, (safe - 2.0 ** 63).to(torch.int64) ^ SIGN64,
                           safe.to(torch.int64))
        vmax = -1                 # bits of 2^64 - 1
    else:
        conv, vmax = safe.to(torch.int64), int(info.max)
    out = torch.where(over, torch.full_like(conv, vmax), conv)
    return torch.where(t < lo, torch.full_like(conv, int(info.min)), out)


def _div_half_up(iv: torch.Tensor, q: int) -> torch.Tensor:
    """Integer divide rounding half away from zero (Spark HALF_UP)."""
    a = iv.abs()
    m = (a + q // 2) // q
    return torch.where(iv >= 0, m, -m)


def _cast_decimal128(col: Column, to: DType) -> Column:
    """Casts where either side is DECIMAL128: 128-bit limb arithmetic
    (``utils.int128``), Spark non-ANSI overflow-to-null throughout."""
    f = col.dtype
    valid = col.valid_mask()
    fs = f.scale if f.is_decimal else 0
    ts = to.scale if to.is_decimal else 0

    if f.id == TypeId.DECIMAL128:
        lo, hi, neg = i128.split_sign(col.data[:, 0], col.data[:, 1])
        ok = torch.ones_like(neg)
    elif f.is_floating:
        # Spark's float -> decimal goes through BigDecimal.valueOf, the
        # SHORTEST decimal string of the double: rescale those digits
        # exactly in 128-bit integers
        from .cast_strings import _shortest_digits
        m, p, e, neg, nanm, infm, zerom = _shortest_digits(col)
        lo, hi = i128.from_u64(m)
        k = e.to(torch.int64) - (p.to(torch.int64) - 1) - ts
        ok = ~(nanm | infm) & (k <= 41)  # 10^41 overflows 2^127
        lo, hi, ovf = i128.mul_pow10_dyn(lo, hi, k.clamp(0, 41), 41)
        ok = ok & ~ovf
        lo, hi = i128.div_pow10_dyn(lo, hi, (-k).clamp(0, 20), 20,
                                    half_up=True)
        lo = torch.where(zerom, torch.zeros_like(lo), lo)
        hi = torch.where(zerom, torch.zeros_like(hi), hi)
        neg = neg & ~zerom
        fs = ts  # already at the target scale
    else:
        iv = _int_values(col)
        neg = iv < 0
        lo, hi = i128.from_u64(torch.where(neg, -iv, iv))
        ok = torch.ones_like(neg)

    # value-preserving targets need no limb rescale
    if to.id in _FLOAT_IDS:
        mf = i128.to_f64(lo, hi) * (10.0 ** fs)
        vf = torch.where(neg, -mf, mf)
        return _fixed(to, vf, col.validity)
    if to.id == TypeId.BOOL8:
        return _fixed(to, (lo | hi) != 0, col.validity)

    diff = fs - ts if to.is_decimal else fs
    if diff > 0:
        lo, hi, ovf = i128.mul_pow10(lo, hi, diff)
        ok = ok & ~ovf
    elif diff < 0:
        # decimal targets round HALF_UP (Spark); integral targets truncate
        lo, hi, _ = i128.div_pow10(lo, hi, -diff, half_up=to.is_decimal)

    if to.id == TypeId.DECIMAL128:
        ok = ok & i128.fits_bits(lo, hi, 127)
        slo, shi = i128.apply_sign(lo, hi, neg)
        zero = torch.zeros_like(slo)
        data = torch.stack([torch.where(ok, slo, zero),
                            torch.where(ok, shi, zero)], dim=1)
        return Column(to, data=data, validity=valid & ok)
    if to.is_decimal:
        bound = 2**31 - 1 if to.id == TypeId.DECIMAL32 else 2**62
        ok = ok & i128.le_u64(lo, hi, bound)
        slo, _ = i128.apply_sign(lo, hi, neg)
        return _fixed(to, torch.where(ok, slo, torch.zeros_like(slo)),
                      valid & ok)
    # integral targets: must fit int64 after the rescale, then narrow
    ok = ok & i128.le_u64(lo, hi, 2**63)  # magnitude; 2^63 only when neg
    ok = ok & ((lo >= 0) | neg)
    slo, _ = i128.apply_sign(lo, hi, neg)
    return cast(Column(INT64, data=torch.where(ok, slo, torch.zeros_like(slo)),
                       validity=valid & ok), to)


def _cast_decimal(col: Column, to: DType) -> Column:
    f = col.dtype
    if TypeId.DECIMAL128 in (f.id, to.id):
        return _cast_decimal128(col, to)
    fs = f.scale if f.is_decimal else 0
    ts = to.scale if to.is_decimal else 0
    valid = col.valid_mask()
    if f.is_decimal and not to.is_decimal:
        if to.id in _FLOAT_IDS:
            v = col.data.to(torch.float64) * (10.0 ** fs)
            return _fixed(to, v, col.validity)
        iv = col.data.to(torch.int64)
        if fs >= 0:
            mul = 10 ** fs
            out = iv * mul
            valid = valid & ((out // mul) == iv)  # upscale overflow -> null
        else:
            q = 10 ** (-fs)
            out = torch.where(iv >= 0, iv // q, -((-iv) // q))  # trunc to 0
        return cast(Column(INT64, data=out, validity=valid), to)
    width_max = 2**31 - 1 if to.id == TypeId.DECIMAL32 else 2**62
    if not f.is_decimal:
        # numeric -> decimal: mantissa = value * 10^-ts (HALF_UP), null on
        # target-width overflow
        if f.is_floating:
            v = col.data.to(torch.float64)
            scaled = v * (10.0 ** (-ts))
            m = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                            torch.ceil(scaled - 0.5))
            ok = torch.isfinite(v) & (m.abs() <= float(width_max))
            return _fixed(to, torch.where(ok, m, torch.zeros_like(m))
                          .to(torch.int64), valid & ok)
        iv = _int_values(col)
        if ts <= 0:
            mul = 10 ** (-ts)
            m = iv * mul
            ok = ((m // mul) == iv) & (m.abs() <= width_max)
            return _fixed(to, m, valid & ok)
        m = _div_half_up(iv, 10 ** ts)
        return _fixed(to, m, valid & (m.abs() <= width_max))
    # decimal -> decimal rescale
    diff = fs - ts
    iv = col.data.to(torch.int64)
    if diff >= 0:
        mul = 10 ** diff
        m = iv * mul
        ok = (m // mul) == iv
    else:
        m = _div_half_up(iv, 10 ** (-diff))
        ok = torch.ones_like(valid)  # rounding, not exactness
    return _fixed(to, m, valid & ok & (m.abs() <= width_max))
