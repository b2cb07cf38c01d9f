"""Column expression ops: null-propagating arithmetic/comparison/logical.

The port of ``spark_rapids_jni_tpu/ops/binary.py`` (the libcudf binary and
unary-op role).  Rules follow Spark SQL:

- null in -> null out (except null-safe equality and the AND/OR truth
  tables);
- float comparisons use Spark's NaN ordering, not IEEE: NaN == NaN is
  true and NaN sorts above every other double;
- integer division/modulo by zero -> null;
- comparisons return BOOL8 columns.

Integer arithmetic runs in the type numpy (and JAX) promote the two
inputs to, wrapping at its width, then widens to INT64, as the JAX
package's does.  UINT16/32/64 buffers hold signed bits (``dtypes.py``),
so their values are zero-extended first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import BOOL8, DType, FLOAT64, INT64, TypeId, int64_values
from ..utils.floatbits import SIGN64
from ..utils.tracing import traced


def _vals(col: Column) -> torch.Tensor:
    """Computation view of a column: floats as floats, BOOL8 as bool,
    integers as int64 values."""
    if col.dtype.is_floating:
        return col.data
    if col.dtype.id == TypeId.BOOL8:
        return col.data != 0
    return int64_values(col.dtype, col.data)


def _f64(col: Column) -> torch.Tensor:
    """float64 values (UINT64 converted as unsigned, as numpy does)."""
    if col.dtype.id == TypeId.UINT64:
        from ..utils.int128 import u64_to_f64
        return u64_to_f64(col.data)
    return _vals(col).to(torch.float64)


def _storage(dtype: DType):
    return np.dtype(np.bool_) if dtype.id == TypeId.BOOL8 else dtype.storage


def _wrap(v: torch.Tensor, a: DType, b: DType) -> torch.Tensor:
    """int64 ``v`` wrapped to the width of the inputs' promoted type."""
    pt = np.promote_types(_storage(a), _storage(b))
    bits = pt.itemsize * 8
    if pt.kind not in "iu" or bits >= 64:
        return v
    v = v & ((1 << bits) - 1)
    if pt.kind == "i":
        sign = 1 << (bits - 1)
        v = (v ^ sign) - sign
    return v


def _both_valid(a: Column, b: Column):
    if a.validity is None and b.validity is None:
        return None
    return a.valid_mask() & b.valid_mask()


def _result(dtype: DType, data: torch.Tensor, valid) -> Column:
    if data.dtype == torch.bool and dtype.id != TypeId.BOOL8:
        data = data.to(torch.int64)
    return Column(dtype, data=data.to(dtype.torch_dtype), validity=valid)


def _is_float(a: Column, b: Column) -> bool:
    return a.dtype.is_floating or b.dtype.is_floating


def _arith(a: Column, b: Column, fn) -> Column:
    if _is_float(a, b):
        out = fn(_f64(a), _f64(b))
        return _result(FLOAT64, out, _both_valid(a, b))
    out = _wrap(fn(_vals(a).to(torch.int64), _vals(b).to(torch.int64)),
                a.dtype, b.dtype)
    return _result(INT64, out, _both_valid(a, b))


@traced("binary_op")
def add(a: Column, b: Column) -> Column:
    return _arith(a, b, torch.add)


@traced("binary_op")
def subtract(a: Column, b: Column) -> Column:
    return _arith(a, b, torch.sub)


@traced("binary_op")
def multiply(a: Column, b: Column) -> Column:
    return _arith(a, b, torch.mul)


def _by_zero(a: Column, b: Column, zero: torch.Tensor):
    valid = _both_valid(a, b)
    return ~zero if valid is None else (valid & ~zero)


@traced("binary_op")
def true_divide(a: Column, b: Column) -> Column:
    """Spark ``/``: always double; x/0 is null (not inf)."""
    av = _f64(a)
    bv = _f64(b)
    zero = bv == 0.0
    out = av / torch.where(zero, torch.ones_like(bv), bv)
    return _result(FLOAT64, out, _by_zero(a, b, zero))


@traced("binary_op")
def floor_div(a: Column, b: Column) -> Column:
    """Spark ``div``: integral quotient truncated toward zero (Java);
    by-zero is null."""
    av = _vals(a).to(torch.int64)
    bv = _vals(b).to(torch.int64)
    zero = bv == 0
    safe = torch.where(zero, torch.ones_like(bv), bv)
    q = (av.abs() // safe.abs()) * torch.sign(av) * torch.sign(safe)
    return _result(INT64, q, _by_zero(a, b, zero))


@traced("binary_op")
def modulo(a: Column, b: Column) -> Column:
    """Spark ``%``: the sign follows the dividend (Java); by-zero is null."""
    av = _vals(a).to(torch.int64)
    bv = _vals(b).to(torch.int64)
    zero = bv == 0
    safe = torch.where(zero, torch.ones_like(bv), bv)
    r = torch.sign(av) * (av.abs() % safe.abs())
    return _result(INT64, r, _by_zero(a, b, zero))


def _nan_eq(av, bv):
    """Spark equality over doubles: IEEE ``==`` plus NaN == NaN."""
    return (av == bv) | (torch.isnan(av) & torch.isnan(bv))


def _nan_lt(av, bv):
    """Spark ordering over doubles: NaN is greater than everything else."""
    return (av < bv) | (torch.isnan(bv) & ~torch.isnan(av))


def _compare(a: Column, b: Column, fn, nan_fn=None) -> Column:
    if _is_float(a, b):
        av = _f64(a)
        bv = _f64(b)
        if nan_fn is not None:
            fn = nan_fn
    else:
        av, bv = _vals(a), _vals(b)
        if TypeId.UINT64 == a.dtype.id == b.dtype.id:  # unsigned order
            av, bv = av ^ SIGN64, bv ^ SIGN64
    return _result(BOOL8, fn(av, bv), _both_valid(a, b))


@traced("binary_op")
def eq(a: Column, b: Column) -> Column:
    return _compare(a, b, torch.eq, _nan_eq)


@traced("binary_op")
def ne(a: Column, b: Column) -> Column:
    return _compare(a, b, torch.ne, lambda x, y: ~_nan_eq(x, y))


@traced("binary_op")
def lt(a: Column, b: Column) -> Column:
    return _compare(a, b, torch.lt, _nan_lt)


@traced("binary_op")
def le(a: Column, b: Column) -> Column:
    # a <= NaN for every a: NaN is the maximum and equals itself
    return _compare(a, b, torch.le, lambda x, y: (x <= y) | torch.isnan(y))


@traced("binary_op")
def gt(a: Column, b: Column) -> Column:
    return _compare(a, b, torch.gt, lambda x, y: _nan_lt(y, x))


@traced("binary_op")
def ge(a: Column, b: Column) -> Column:
    return _compare(a, b, torch.ge, lambda x, y: (x >= y) | torch.isnan(x))


@traced("binary_op")
def eq_null_safe(a: Column, b: Column) -> Column:
    """Spark ``<=>``: nulls compare equal; never null."""
    if _is_float(a, b):
        same_v = _nan_eq(_f64(a),
                         _f64(b))
    else:
        same_v = _vals(a) == _vals(b)
    va, vb = a.valid_mask(), b.valid_mask()
    return _result(BOOL8, (same_v & va & vb) | (~va & ~vb), None)


def _logical(a: Column, b: Column, is_and: bool) -> Column:
    """SQL three-valued AND (false dominates null) / OR (true does)."""
    av, bv = _vals(a) != 0, _vals(b) != 0
    va, vb = a.valid_mask(), b.valid_mask()
    if is_and:
        out = av & bv
        valid = (va & vb) | (va & ~av) | (vb & ~bv)
    else:
        out = av | bv
        valid = (va & vb) | (va & av) | (vb & bv)
    return _result(BOOL8, out, valid)


@traced("binary_op")
def logical_and(a: Column, b: Column) -> Column:
    return _logical(a, b, True)


@traced("binary_op")
def logical_or(a: Column, b: Column) -> Column:
    return _logical(a, b, False)


@traced("unary_op")
def logical_not(a: Column) -> Column:
    return _result(BOOL8, _vals(a) == 0, a.validity)


@traced("unary_op")
def negate(a: Column) -> Column:
    return _result(a.dtype, -_vals(a), a.validity)


@traced("unary_op")
def abs_(a: Column) -> Column:
    return _result(a.dtype, _vals(a).abs(), a.validity)


@traced("unary_op")
def round_(a: Column, scale: int = 0) -> Column:
    """Spark ``round(col, scale)``: HALF_UP (away from zero).

    Floats become FLOAT64 (rounded via v * 10^scale, the JAX package's
    documented divergence from Spark's BigDecimal route); integral inputs
    round at negative scales and pass through otherwise, saturating at
    the largest representable multiple of the unit; ``scale <= -19``
    raises."""
    if a.dtype.is_floating:
        v = a.data.to(torch.float64)
        p = 10.0 ** scale
        s = v * p
        r = torch.where(s >= 0, torch.floor(s + 0.5), torch.ceil(s - 0.5))
        return _result(FLOAT64, r / p, a.validity)
    if scale >= 0:
        return a
    if scale <= -19:
        raise ValueError("round scale <= -19 exceeds the int64 range")
    q = 10 ** (-scale)
    v = _vals(a)
    # overflow-free HALF_UP: floor-div + remainder comparison
    b = v // q
    r = v - b * q                        # in [0, q)
    up = torch.where(v >= 0, 2 * r >= q, 2 * (q - r) < q)
    lim = (2**63 - 1) // q
    return _result(INT64, (b + up.to(torch.int64)).clamp(-lim, lim) * q,
                   a.validity)


def _float_to_long(a: Column, fn) -> Column:
    from .cast import cast
    # cast()'s saturating double -> long rules (NaN -> 0, +/-inf and
    # out-of-range saturate)
    return cast(Column(FLOAT64, data=fn(a.data.to(torch.float64)),
                       validity=a.validity), INT64)


@traced("unary_op")
def floor_(a: Column) -> Column:
    """Spark ``floor(double) -> long``; integral inputs pass through."""
    return _float_to_long(a, torch.floor) if a.dtype.is_floating else a


@traced("unary_op")
def ceil_(a: Column) -> Column:
    """Spark ``ceil(double) -> long``; integral inputs pass through."""
    return _float_to_long(a, torch.ceil) if a.dtype.is_floating else a


@traced("unary_op")
def is_null(a: Column) -> Column:
    return _result(BOOL8, ~a.valid_mask(), None)


@traced("unary_op")
def is_not_null(a: Column) -> Column:
    return _result(BOOL8, a.valid_mask(), None)


@traced("unary_op")
def coalesce(*cols: Column) -> Column:
    """First non-null value per row across the arguments (same dtype)."""
    if not cols:
        raise ValueError("coalesce needs at least one column")
    out_v = _vals(cols[0])
    out_ok = cols[0].valid_mask()
    for c in cols[1:]:
        take = ~out_ok & c.valid_mask()
        out_v = torch.where(take, _vals(c).to(out_v.dtype), out_v)
        out_ok = out_ok | c.valid_mask()
    return _result(cols[0].dtype, out_v, out_ok)
