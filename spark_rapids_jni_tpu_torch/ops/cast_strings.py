"""CastStrings: Spark-semantics string <-> numeric/decimal/bool/date casts.

The port of ``spark_rapids_jni_tpu/ops/cast_strings.py`` (the reference's
CastStrings component).  Behaviour follows Spark's CAST:

- string -> int/long/short/byte: trim, optional sign, digits, optionally a
  fraction that is validated but truncated ("123.456" -> 123); anything
  else, or overflow, is null (or raises with ``ansi=True``).
- string -> float/double: optional sign, digits with fraction and
  exponent, case-insensitive "inf"/"infinity"/"nan", an optional trailing
  d/f suffix (Java parseDouble).
- string -> decimal(scale): exact integer parsing with HALF_UP rounding to
  the target scale, null on overflow of the storage type.
- string -> bool with Spark's literal sets; int/bool/decimal/float/date ->
  string with Spark's formatting (floats as Java's shortest round-trip
  digits).

The parse is one pass over the columns of the padded byte matrix: every
row takes the same per-character state-machine step (the JAX package runs
the same step as a ``lax.scan``).  The u64 mantissa lives in int64
tensors holding its bits (``utils.int128``).  float64 arithmetic on CPU
and CUDA is correctly rounded, so the shortest-digits search always runs
on the column's device (the JAX package probes its backend for this,
``_f64_exact``, and takes the same branch on the CPU).
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import BOOL8, DType, TypeId, int64_values
from ..utils import int128 as i128
from ..utils.tracing import traced
from .strings_common import from_padded_bytes, to_padded_bytes

# u64 mantissa capacity: accumulating another digit is safe below this
_ACC_CAP = (2**64 - 1 - 9) // 10
_UMAX = 2**64 - 1

_POW10_U64_NP = np.array([i128.u64_const(10**k) for k in range(20)],
                         np.int64)
# (2^64 - 1) // 10^k, the largest digits value that * 10^k does not wrap
_UMAX_DIV_NP = np.array([i128.u64_const(_UMAX // 10**k) for k in range(20)],
                        np.int64)
# f64 powers of ten, exact to double rounding, index k -> 10^(k-350)
_POW10_F64_NP = np.array([float(f"1e{k}") for k in range(-350, 351)])


def _pow10_err_table():
    """Exact residual (10^k - float(10^k)) per table entry, as float64:
    the correction term that lets the shortest-digits search evaluate
    decimal-vs-binary deltas in double-double precision."""
    errs = []
    for k in range(-350, 351):
        t = float(f"1e{k}")
        if t == 0.0 or np.isinf(t):
            errs.append(0.0)
            continue
        errs.append(float(Fraction(10) ** k - Fraction(t)))
    return np.array(errs)


_POW10_F64_ERR_NP = np.asarray(_pow10_err_table())
# exact f64 powers of two, index e -> 2^(e-1100) (0 below the subnormal
# floor, inf above the exponent cap)
_POW2_F64_NP = np.array(
    [0.0 if e < -1074 else (np.inf if e > 1023 else float(2.0 ** e))
     for e in range(-1100, 1101)])

# Values below the normal range are scaled by 2^256 (exact: a power of two)
# so that every intermediate of a parse or of the shortest-digits test stays
# a normal double.  The scaled powers 10^k * 2^256 and their exact residuals
# are correctly rounded from Fractions; the search reads them from the upper
# half of one table, index k + 350 + 701.
_SCALE_EXP = 256
_SMALL = 2.0 ** -800      # values below this take the scaled search


def _scaled_pow10_tables():
    vals, errs = [], []
    for k in range(-350, 351):
        exact = Fraction(10) ** k * 2 ** _SCALE_EXP
        if k > 0:  # never read: only values below 2^-800 are scaled
            vals.append(np.inf)
            errs.append(0.0)
            continue
        t = float(exact)
        vals.append(t)
        errs.append(float(exact - Fraction(t)))
    return np.array(vals), np.array(errs)


_POW10S_F64_NP, _POW10S_ERR_NP = _scaled_pow10_tables()

_TABLES = {"pow10_u64": _POW10_U64_NP, "umax_div": _UMAX_DIV_NP,
           "pow10_f64": _POW10_F64_NP, "pow2_f64": _POW2_F64_NP,
           "pow10s_f64": _POW10S_F64_NP,
           "pow10_cat": np.concatenate([_POW10_F64_NP, _POW10S_F64_NP]),
           "pow10_err_cat": np.concatenate([_POW10_F64_ERR_NP,
                                            _POW10S_ERR_NP])}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: str) -> torch.Tensor:
    """A constant table on ``device`` (copied there once per process)."""
    return torch.from_numpy(_TABLES[name].copy()).to(device)


def _take(name: str, idx: torch.Tensor) -> torch.Tensor:
    return _table(name, str(idx.device))[idx.to(torch.int64)]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when none), as jnp.argmax."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def _trim_bounds(mat, lengths):
    """Spark trims leading/trailing ASCII control+space (UTF8String.trim)."""
    n, w = mat.shape
    pos = torch.arange(w, device=mat.device)[None, :]
    in_str = pos < lengths[:, None]
    non_ws = (mat > 32) & in_str
    any_non = non_ws.any(dim=1)
    start = _first_true(non_ws)
    end = w - _first_true(non_ws.flip(1))
    zero = torch.zeros_like(start)
    return torch.where(any_non, start, zero), torch.where(any_non, end, zero)


def _char_at(mat, pos):
    """mat[row, pos[row]] with pos clamped into the matrix."""
    w = mat.shape[1]
    return torch.gather(mat, 1, pos.clamp(0, max(w - 1, 0))[:, None])[:, 0]


# parser states
_S_START, _S_INT, _S_FRAC, _S_EXP0, _S_EXP, _S_BAD = range(6)


def _parse_number(mat, lengths, allow_frac: bool, allow_exp: bool,
                  accumulate_frac: bool, allow_suffix: bool = False):
    """Data-parallel numeric-literal state machine.

    Returns per-row tensors: neg, digits (u64 bits of the mantissa: int
    [+ frac] digits), frac_kept, dropped_int, exp (signed), ndigits,
    syntax_ok, overflow.
    """
    n, w = mat.shape
    dev = mat.device
    start, end = _trim_bounds(mat, lengths)
    if allow_suffix and w:
        # Java parseDouble accepts a trailing d/D/f/F suffix
        last = _char_at(mat, end - 1)
        has_suffix = ((last == ord('d')) | (last == ord('D'))
                      | (last == ord('f')) | (last == ord('F'))) \
            & (end - start > 1)
        end = torch.where(has_suffix, end - 1, end)

    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    state = torch.full((n,), _S_START, dtype=torch.int64, device=dev)
    neg = torch.zeros(n, dtype=torch.bool, device=dev)
    exp_neg = torch.zeros_like(neg)
    digits, ndigits, frac_kept, dropped_int = zi, zi, zi, zi
    exp, exp_digits = zi, zi
    for p in range(w):
        ch = mat[:, p]
        active = (p >= start) & (p < end)
        st = state
        nd_before = ndigits
        d = ch.to(torch.int64) - ord('0')
        is_digit = (d >= 0) & (d <= 9)
        is_sign = (ch == ord('+')) | (ch == ord('-'))
        at_start = start == p
        start_or_int = (st == _S_START) | (st == _S_INT)
        in_exp = (st == _S_EXP0) | (st == _S_EXP)

        act_digit = active & is_digit
        acc_int = act_digit & start_or_int
        acc_frac = act_digit & (st == _S_FRAC) if accumulate_frac else \
            torch.zeros_like(acc_int)
        can = i128.ule(digits, _ACC_CAP)
        digits = torch.where((acc_int | acc_frac) & can, digits * 10 + d,
                             digits)
        # dropped int digits shift the magnitude; dropped frac digits only
        # lose precision
        dropped_int = dropped_int + (acc_int & ~can).to(torch.int64)
        frac_kept = frac_kept + (acc_frac & can).to(torch.int64)
        ndigits = ndigits + (act_digit & ~in_exp).to(torch.int64)
        acc_exp = act_digit & in_exp
        exp = torch.where(acc_exp, torch.clamp(exp * 10 + d, max=99999), exp)
        exp_digits = exp_digits + acc_exp.to(torch.int64)
        neg = neg | (active & at_start & (ch == ord('-')))
        exp_neg = exp_neg | (active & (st == _S_EXP0) & (ch == ord('-')))

        nxt_digit = torch.where(start_or_int, _S_INT, torch.where(
            st == _S_FRAC, _S_FRAC, torch.where(in_exp, _S_EXP, _S_BAD)))
        nxt = torch.where(is_digit, nxt_digit, torch.full_like(st, _S_BAD))
        nxt = torch.where(is_sign & at_start & (st == _S_START),
                          torch.full_like(st, _S_START), nxt)
        nxt = torch.where(is_sign & (st == _S_EXP0) & ~at_start,
                          torch.full_like(st, _S_EXP), nxt)
        if allow_frac:
            nxt = torch.where((ch == ord('.')) & start_or_int,
                              torch.full_like(st, _S_FRAC), nxt)
        if allow_exp:
            is_e = (ch == ord('e')) | (ch == ord('E'))
            nxt = torch.where(is_e & ((st == _S_INT) | (st == _S_FRAC))
                              & (nd_before > 0),
                              torch.full_like(st, _S_EXP0), nxt)
        nxt = torch.where(st == _S_BAD, st, nxt)
        state = torch.where(active, nxt, st)

    syntax_ok = ((state == _S_INT) | (state == _S_FRAC) | (state == _S_EXP)) \
        & (ndigits > 0) & (end > start)
    # "1e+" / "1e-" reach _S_EXP via the sign without any exponent digit
    syntax_ok = syntax_ok & ~((state == _S_EXP) & (exp_digits == 0))
    return dict(neg=neg, digits=digits, frac_kept=frac_kept,
                dropped_int=dropped_int,
                exp=torch.where(exp_neg, -exp, exp), ndigits=ndigits,
                syntax_ok=syntax_ok, overflow=dropped_int > 0)


_INT_BOUNDS = {
    TypeId.INT8: 2**7, TypeId.INT16: 2**15, TypeId.INT32: 2**31,
    TypeId.INT64: 2**63,
}


def _null_out(col: Column, ok):
    return ok if col.validity is None else (ok & col.validity)


def _check_ansi(col: Column, ok, what: str):
    if bool((~ok & col.valid_mask()).any()):
        raise ValueError(f"invalid input for CAST to {what} in ANSI mode")


def _pick(cond, a: int, b: int) -> torch.Tensor:
    """int64 ``a`` where ``cond`` else ``b``."""
    return torch.where(cond, torch.full(cond.shape, a, device=cond.device),
                       torch.full(cond.shape, b, device=cond.device))


def _umin(a, b):
    return torch.where(i128.ule(a, b), a, b)


@traced("cast.to_integer")
def cast_to_integer(col: Column, dtype: DType, ansi: bool = False) -> Column:
    """string -> byte/short/int/long with Spark CAST semantics."""
    if dtype.id not in _INT_BOUNDS:
        raise TypeError(f"not an integer target: {dtype!r}")
    mat, lengths = to_padded_bytes(col)
    p = _parse_number(mat, lengths, True, False, False)
    bound = _INT_BOUNDS[dtype.id]
    limit = _pick(p["neg"], i128.u64_const(bound), bound - 1)
    ok = p["syntax_ok"] & ~p["overflow"] & i128.ule(p["digits"], limit)
    mag = _umin(p["digits"], limit)
    signed = torch.where(p["neg"], -mag, mag)
    if ansi:
        _check_ansi(col, ok, repr(dtype))
    return Column(dtype, data=signed.to(dtype.torch_dtype),
                  validity=_null_out(col, ok))


def _keyword_match(mat, start, end, word: bytes):
    """Case-insensitive match of the trimmed region against a keyword."""
    m = (end - start) == len(word)
    for i, ch in enumerate(word):
        c = _char_at(mat, start + i)
        lower = torch.where((c >= 65) & (c <= 90), c + 32, c)
        m = m & (lower == ch)
    return m


@traced("cast.to_float")
def cast_to_float(col: Column, dtype: DType, ansi: bool = False) -> Column:
    """string -> float/double with Spark CAST semantics."""
    if dtype.id not in (TypeId.FLOAT32, TypeId.FLOAT64):
        raise TypeError(f"not a float target: {dtype!r}")
    mat, lengths = to_padded_bytes(col)
    start, end = _trim_bounds(mat, lengths)
    p = _parse_number(mat, lengths, True, True, True, True)

    # value = digits * 10^(exp + dropped_int - frac_kept)
    eff = (p["exp"] + p["dropped_int"] - p["frac_kept"]).clamp(-350, 350)
    digits = i128.u64_to_f64(p["digits"])
    # Below the normal range 10^eff is subnormal or 0 in the table, so the
    # scale goes in two steps that keep the product normal: 10^eff * 2^256,
    # then 2^-256 (exact, or the one rounding into a subnormal).  Java reads
    # these as parseDouble does; the JAX package flushes them to 0.
    deep = eff <= -308
    mag = torch.where(
        deep,
        digits * _take("pow10s_f64", eff + 350) * 2.0 ** -_SCALE_EXP,
        digits * _take("pow10_f64", eff + 350))
    # zero digits read 0 whatever the exponent ("0e999" is 0.0 in Java;
    # 0 x inf would be NaN)
    mag = torch.where(p["digits"] == 0, torch.zeros_like(mag), mag)
    # the sign as a bit flip, which negation is on every device
    val = (mag.view(torch.int64) ^ (p["neg"].to(torch.int64) << 63)) \
        .view(torch.float64)

    # keywords (after an optional sign; a NaN's sign is ignored)
    first = _char_at(mat, start)
    has_sign = (first == ord('+')) | (first == ord('-'))
    kw_start = torch.where(has_sign, start + 1, start)
    is_inf = (_keyword_match(mat, kw_start, end, b"inf")
              | _keyword_match(mat, kw_start, end, b"infinity"))
    is_nan = _keyword_match(mat, kw_start, end, b"nan")
    inf = torch.where(first == ord('-'), -torch.inf, torch.inf) \
        .to(torch.float64)
    val = torch.where(is_inf, inf, val)
    val = torch.where(is_nan, torch.full_like(val, torch.nan), val)

    ok = p["syntax_ok"] | is_inf | is_nan
    if ansi:
        _check_ansi(col, ok, repr(dtype))
    return Column(dtype, data=val.to(dtype.torch_dtype),
                  validity=_null_out(col, ok))


def _udivmod_pow10(x, k):
    """(x // 10^k, x % 10^k) for u64 ``x`` and per-row k in [0, 19]."""
    q = x
    rest = k
    for _ in range(3):   # 10^19 = 10^9 * 10^9 * 10
        step = rest.clamp(max=9)
        q, _ = i128.divmod_u64(q, _take("pow10_u64", step))
        rest = rest - step
    return q, x - q * _take("pow10_u64", k)


@traced("cast.to_decimal")
def cast_to_decimal(col: Column, dtype: DType, ansi: bool = False) -> Column:
    """string -> decimal32/64 at the target scale, HALF_UP rounding
    (stored integer = value * 10^(-scale))."""
    if not dtype.is_decimal:
        raise TypeError(f"not a decimal target: {dtype!r}")
    mat, lengths = to_padded_bytes(col)
    p = _parse_number(mat, lengths, True, True, True)
    digits = p["digits"]

    # unscaled = digits * 10^shift, shift = -scale - frac_kept + exp + dropped
    shift = (-dtype.scale) - p["frac_kept"] + p["exp"] + p["dropped_int"]
    up = shift.clamp(0, 19)
    down = (-shift).clamp(0, 19)
    mul = _take("pow10_u64", up)
    # overflow if digits * mul wraps: digits > umax // mul
    mul_ovf = (shift > 0) & i128.ult(_take("umax_div", up), digits)
    scaled_up = digits * torch.where(mul_ovf, torch.ones_like(mul), mul)
    q, r = _udivmod_pow10(scaled_up, down)
    div = _take("pow10_u64", down)
    # HALF_UP without u64 overflow: r*2 >= div  <=>  r >= div - r  (r < div)
    q = q + ((shift < 0) & i128.ule(div - r, r)).to(torch.int64)
    q = torch.where((shift > 19) & (digits != 0), torch.full_like(q, -1), q)
    q = torch.where(shift < -19, torch.zeros_like(q), q)

    store_max = 2**31 - 1 if dtype.id == TypeId.DECIMAL32 else 2**63 - 1
    limit = _pick(p["neg"], i128.u64_const(store_max + 1), store_max)
    ok = p["syntax_ok"] & ~mul_ovf & ~p["overflow"] & i128.ule(q, limit)
    mag = _umin(q, limit)
    signed = torch.where(p["neg"], -mag, mag)
    if ansi:
        _check_ansi(col, ok, repr(dtype))
    return Column(dtype, data=signed.to(dtype.torch_dtype),
                  validity=_null_out(col, ok))


_TRUE_LITS = (b"t", b"true", b"y", b"yes", b"1")
_FALSE_LITS = (b"f", b"false", b"n", b"no", b"0")


@traced("cast.to_bool")
def cast_to_bool(col: Column, ansi: bool = False) -> Column:
    """string -> boolean with Spark's accepted literal sets."""
    mat, lengths = to_padded_bytes(col)
    start, end = _trim_bounds(mat, lengths)
    is_true = functools.reduce(torch.bitwise_or, (
        _keyword_match(mat, start, end, lit) for lit in _TRUE_LITS))
    is_false = functools.reduce(torch.bitwise_or, (
        _keyword_match(mat, start, end, lit) for lit in _FALSE_LITS))
    ok = is_true | is_false
    if ansi:
        _check_ansi(col, ok, "BOOLEAN")
    return Column(BOOL8, data=is_true.to(torch.uint8),
                  validity=_null_out(col, ok))


# ---------------------------------------------------------------------------
# formatting casts (X -> STRING)
# ---------------------------------------------------------------------------

_ZERO = ord("0")


def _digits_lsf(mag: torch.Tensor, count: int) -> torch.Tensor:
    """int64[n, count + 1] decimal digits of u64 ``mag``, least significant
    first, with a trailing zero column (the value of any digit past it)."""
    cols = []
    for _ in range(count):
        mag, r = i128.divmod_u64(mag, 10)
        cols.append(r)
    cols.append(torch.zeros_like(mag))
    return torch.stack(cols, dim=1)


def _digit_at(table: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """table[row, j] (j: [n, W]); indices past the table read 0."""
    return torch.gather(table, 1, j.clamp(0, table.shape[1] - 1))


def _ndigits(mag: torch.Tensor, count: int) -> torch.Tensor:
    """Decimal digit count (>= 1) of u64 ``mag`` with at most ``count``."""
    nd = torch.ones_like(mag)
    for k in range(1, count):
        nd = torch.where(i128.ule(i128.u64_const(10**k), mag), k + 1, nd)
    return nd


def _render_signed(body: torch.Tensor, body_len: torch.Tensor,
                   neg: torch.Tensor):
    """(char matrix, lengths): the body's first ``body_len`` chars,
    shifted right one slot behind a '-' on negative rows."""
    n, width = body.shape
    lane = torch.arange(width, device=body.device)[None, :]
    out = torch.where(lane < body_len[:, None], body, torch.zeros_like(body))
    shifted = torch.cat([torch.full((n, 1), ord("-"), dtype=body.dtype,
                                    device=body.device), out[:, :-1]], dim=1)
    return torch.where(neg[:, None], shifted, out), \
        body_len + neg.to(body_len.dtype)


def _decimal_body(digit_at, ndig, frac: int, width: int):
    """(body chars [n, width], body length) of a decimal magnitude whose
    digit j (from the least significant) is ``digit_at(j)``; ``frac``
    fraction digits render zero-padded ("0.005")."""
    show = torch.clamp(ndig, min=frac + 1)[:, None]
    dot = 1 if frac > 0 else 0
    int_digits = show - frac
    i = torch.arange(width, device=ndig.device)[None, :]
    j = torch.where(i < int_digits, show - 1 - i, show - 1 - (i - dot))
    ch = digit_at(j.clamp(min=0)) + _ZERO
    if dot:
        ch = torch.where(i == int_digits, torch.full_like(ch, ord(".")), ch)
    return ch.to(torch.uint8), (show + dot)[:, 0]


@traced("cast.from_integer")
def cast_from_integer(col: Column) -> Column:
    """byte/short/int/long/bool -> string (Spark CAST)."""
    if not col.dtype.is_integral and not col.dtype.is_decimal \
            and col.dtype.id != TypeId.BOOL8:
        raise TypeError(f"expected integral column, got {col.dtype!r}")
    dev = col.data.device
    if col.dtype.id == TypeId.BOOL8:
        truth = col.data != 0
        lits = torch.tensor([list(b"false"), list(b"true\0")],
                            dtype=torch.uint8, device=dev)
        mat = lits[truth.to(torch.int64)]
        lengths = torch.where(truth, 4, 5).to(torch.int32)
        return from_padded_bytes(mat, lengths, col.validity)
    vals = int64_values(col.dtype, col.data)
    neg = vals < 0
    mag = torch.where(neg, -vals, vals)   # correct incl. INT64_MIN
    table = _digits_lsf(mag, 20)
    mat, lengths = _render_signed(*_decimal_body(
        lambda j: _digit_at(table, j), _ndigits(mag, 20), 0, 20), neg)
    return from_padded_bytes(mat, lengths, col.validity)


_CHUNK = 10**9  # 128-bit magnitudes decompose into five 9-digit chunks


def _digits128_lsf(lo, hi) -> tuple[torch.Tensor, torch.Tensor]:
    """(int64[n, 46] digits least significant first, digit count) of a
    uint128 magnitude (at most 39 digits)."""
    cols = []
    for _ in range(5):
        lo, hi, r = i128.divmod_small(lo, hi, _CHUNK)
        for _ in range(9):
            cols.append(r % 10)
            r = r // 10
    cols.append(torch.zeros_like(lo))
    table = torch.stack(cols, dim=1)
    nz = table[:, :45] != 0
    last = 44 - _first_true(nz.flip(1))   # most significant nonzero digit
    return table, torch.where(nz.any(dim=1), last + 1, torch.ones_like(last))


@traced("cast.from_decimal")
def cast_from_decimal(col: Column) -> Column:
    """DECIMAL32/64/128 -> STRING with Spark formatting: the unscaled value
    at the type's scale, zero-padded fractions (``0.005``), trailing zeros
    kept (scale is part of the type)."""
    if not col.dtype.is_decimal:
        raise TypeError(f"expected decimal column, got {col.dtype!r}")
    scale = col.dtype.scale
    frac = max(-scale, 0)
    if col.dtype.id == TypeId.DECIMAL128:
        lo, hi, neg = i128.split_sign(col.data[:, 0], col.data[:, 1])
        table, ndig = _digits128_lsf(lo, hi)
        is_zero = (lo | hi) == 0
        max_digits = 39
    else:
        vals = col.data.to(torch.int64)
        neg = vals < 0
        mag = torch.where(neg, -vals, vals)
        table, ndig = _digits_lsf(mag, 20), _ndigits(mag, 20)
        is_zero = mag == 0
        max_digits = 19
    if scale > 0:  # value = unscaled * 10^scale: trailing zeros
        def digit_at(j):
            return torch.where(j < scale, torch.zeros_like(j),
                               _digit_at(table, (j - scale).clamp(min=0)))
        ndig = torch.where(is_zero, torch.ones_like(ndig), ndig + scale)
    else:
        def digit_at(j):
            return _digit_at(table, j)
    width = max_digits + max(scale, 0) + frac + 3
    mat, lengths = _render_signed(*_decimal_body(digit_at, ndig, frac, width),
                                  neg)
    return from_padded_bytes(mat, lengths, col.validity)


def _float_bits(col: Column):
    """(float64 values, IEEE bits: int32 for FLOAT32, int64 for FLOAT64)."""
    if col.dtype.id == TypeId.FLOAT32:
        return col.data.to(torch.float64), col.data.view(torch.int32)
    return col.data, col.data.view(torch.int64)


def _shortest_digits(col: Column):
    """Shortest round-tripping decimal digits of a float column.

    Returns (m, p, e10, neg, nanm, infm, zerom): per row the mantissa
    digits as int64 (p digits), the decimal exponent (value ~
    m * 10^(e10-p+1)), the sign, and the special masks.  The backbone of
    both the Java-style rendering (``cast_from_float``) and Spark's float
    -> decimal casts (BigDecimal.valueOf goes through the shortest string).

    The acceptance test is rigorous: m*10^k parses back to this float iff
    |m*10^k - a| < ulp(a)/2, with the delta taken in double-double
    precision (Veltkamp two-products and the exact residual of each table
    power) and the half-ulp from the bit pattern.
    """
    if col.dtype.id not in (TypeId.FLOAT32, TypeId.FLOAT64):
        raise TypeError(f"expected float column, got {col.dtype!r}")
    is32 = col.dtype.id == TypeId.FLOAT32
    v, bits = _float_bits(col)
    maxp = 9 if is32 else 17
    n = v.shape[0]
    dev = v.device
    a = v.abs()
    nanm = torch.isnan(v)
    infm = torch.isinf(v)
    zerom = a == 0.0
    neg = (bits < 0) & ~nanm   # the sign bit is the MSB of the pattern
    safe_a = torch.where(nanm | infm | zerom, torch.ones_like(a), a)

    # Rows below 2^-800 run the test scaled by 2^256 (``_SMALL``): their
    # table powers, value and half-ulp are all multiplied by the same power
    # of two, so the test's answer is unchanged and no intermediate is
    # subnormal.  Larger rows take the unscaled table, as in the JAX
    # package (which flushes subnormal intermediates and so prints digits
    # that do not parse back below ~1e-268).
    small = safe_a < _SMALL
    tab_off = torch.where(small, 701, 0) + 350
    a_s = torch.where(small, safe_a * 2.0 ** _SCALE_EXP, safe_a)

    def t10(e):
        return _take("pow10_cat", (e.clamp(-350, 350) + tab_off))

    def t10err(e):
        return _take("pow10_err_cat", (e.clamp(-350, 350) + tab_off))

    def t10u(e):  # unscaled, for the mantissa estimate
        return _take("pow10_f64", (e + 350).clamp(0, 700))

    # decimal exponent estimate + guarded corrections (log10 is inexact at
    # boundaries)
    e10 = torch.floor(torch.log10(safe_a)).to(torch.int64)
    for _ in range(2):
        pe = t10(e10)
        e10 = torch.where((pe > 0) & (a_s < pe), e10 - 1, e10)
    for _ in range(2):
        pe = t10(e10 + 1)
        e10 = torch.where((pe > 0) & (a_s >= pe), e10 + 1, e10)

    def pow10_mul(x, k):
        # x * 10^k with k possibly beyond double's exponent range
        k1 = k.clamp(-300, 300)
        return x * t10u(k1) * t10u(k - k1)

    split = float((1 << 27) + 1)

    def two_prod(x, y):
        prod = x * y
        xc, yc = x * split, y * split
        xh = xc - (xc - x)
        xl = x - xh
        yh = yc - (yc - y)
        yl = y - yh
        err = xh * yh - prod + xh * yl + xl * yh + xl * yl
        return prod, err

    def dd_delta(m, k, aa):
        # m*10^k - aa, with m < 2^57 split into exact f64 halves
        mh = (m // (1 << 26)).to(torch.float64) * float(1 << 26)
        ml = (m & ((1 << 26) - 1)).to(torch.float64)
        t = t10(k)
        p1, er1 = two_prod(mh, t)
        p2, er2 = two_prod(ml, t)
        return p1 - aa + p2 + (er1 + er2 + (mh + ml) * t10err(k))

    if is32:
        be = ((bits >> 23) & 0xFF).to(torch.int64)
        half_ulp = _take("pow2_f64", (be - 151 + 1100).clamp(0, 2200))
    else:
        # a subnormal's ulp is that of the smallest exponent (be = 1)
        be = ((bits >> 52) & 0x7FF).clamp(min=1) + \
            torch.where(small, _SCALE_EXP, 0)
        half_ulp = _take("pow2_f64", (be - 1076 + 1100).clamp(0, 2200))
    margin = half_ulp * 0.99999

    best_p = torch.full((n,), maxp, dtype=torch.int64, device=dev)
    best_m = torch.zeros(n, dtype=torch.int64, device=dev)
    best_e = e10
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for p in range(1, maxp + 1):
        k = e10 - (p - 1)
        t = t10(k)
        m0 = torch.round(pow10_mul(safe_a, -k)).to(torch.int64)
        # one Newton step in mantissa units absorbs pow10_mul's rounding
        adj = torch.round(dd_delta(m0, k, a_s) / t)
        m1 = m0 - adj.to(torch.int64)
        # of the three candidates take the acceptable one with the SMALLEST
        # delta: Java prints the decimal nearest the value
        sel_ok = torch.zeros_like(found)
        sel_d = torch.full((n,), torch.inf, dtype=torch.float64, device=dev)
        sel_m = torch.zeros_like(best_m)
        sel_bump = torch.zeros_like(found)
        for c in (-1, 0, 1):
            mc = m1 + c
            bump = mc >= 10 ** p  # "9.99" rounds up to "10.0"
            mcb = torch.where(bump, mc // 10, mc)
            kc = torch.where(bump, k + 1, k)
            lo_ok = mcb >= (10 ** (p - 1) if p > 1 else 1)
            in_range = lo_ok & (mcb < 10 ** p)
            dabs = dd_delta(mcb, kc, a_s).abs()
            ok = in_range & (dabs < margin)
            better = ok & (dabs < sel_d)
            sel_m = torch.where(better, mcb, sel_m)
            sel_bump = torch.where(better, bump, sel_bump)
            sel_d = torch.where(better, dabs, sel_d)
            sel_ok = sel_ok | ok
        hit = sel_ok & ~found
        best_p = torch.where(hit, p, best_p)
        best_m = torch.where(hit, sel_m, best_m)
        best_e = torch.where(hit, torch.where(sel_bump, e10 + 1, e10), best_e)
        found = found | sel_ok
    # nothing accepted (half-ulp ties): max precision
    m17 = torch.round(pow10_mul(safe_a, -(e10 - (maxp - 1)))).to(torch.int64)
    bump = m17 >= 10 ** maxp
    best_m = torch.where(found, best_m, torch.where(bump, m17 // 10, m17))
    best_e = torch.where(found, best_e, torch.where(bump, e10 + 1, e10))
    p_ = torch.where(found, best_p, maxp)
    m_, e_ = best_m, best_e
    # Java prints the shortest mantissa: strip trailing zeros
    for _ in range(maxp - 1):
        can = (m_ % 10 == 0) & (p_ > 1)
        m_ = torch.where(can, m_ // 10, m_)
        p_ = torch.where(can, p_ - 1, p_)
    return m_, p_, e_, neg, nanm, infm, zerom


def _literal_row(text: bytes, width: int, dev) -> torch.Tensor:
    row = torch.zeros(width, dtype=torch.uint8, device=dev)
    row[:len(text)] = torch.tensor(list(text), dtype=torch.uint8)
    return row


@traced("cast.from_float")
def cast_from_float(col: Column) -> Column:
    """FLOAT32/64 -> STRING following Java Double/Float.toString: plain
    decimal in [1e-3, 1e7), otherwise ``d.dddE±x``; the digit count is the
    shortest that round-trips (searched 1..17 / 1..9).  Half-ulp ties may
    print one more digit than Java (never a wrong value), as in the JAX
    package.  Below ~1e-268 the JAX package prints digits that do not parse
    back; the port prints digits that do, down to the smallest subnormal."""
    m_, p_, e_, neg, nanm, infm, zerom = _shortest_digits(col)
    dev = m_.device
    W = 28
    table = _digits_lsf(m_, 20)
    i = torch.arange(W, device=dev)[None, :]
    p = p_[:, None]
    e = e_[:, None]

    def mdigit(j):  # mantissa digit j from the least significant
        d = _digit_at(table, j.clamp(0, 19))
        return torch.where((j < 0) | (j > 19), torch.zeros_like(d), d)

    sci = (e_ >= 7) | (e_ < -3)

    # scientific body: [d][.][frac...][E][-][exp digits]
    ae = e.abs()
    elen = 1 + (ae >= 10).to(torch.int64) + (ae >= 100).to(torch.int64)
    esign = (e < 0).to(torch.int64)
    fp_sci = (p - 1).clamp(min=1)
    len_sci = 2 + fp_sci + 1 + esign + elen
    t = i - 2
    ch = torch.where(p == 1, _ZERO, mdigit(p - 2 - t) + _ZERO)
    ch = torch.where(t < fp_sci, ch, _ZERO)
    epos = 2 + fp_sci
    ch = torch.where(i == epos, ord("E"), ch)
    kk = i - epos - 1
    ch = torch.where((kk == 0) & (esign == 1) & (i > epos), ord("-"), ch)
    ed = kk - esign  # exponent digit position from the left
    digs = (ae // _take("pow10_u64", (elen - 1 - ed).clamp(0, 19))) % 10
    ch = torch.where((i > epos) & (ed >= 0) & (ed < elen), digs + _ZERO, ch)
    ch = torch.where(i == 1, ord("."), ch)
    sci_ch = torch.where(i == 0, mdigit(p - 1) + _ZERO, ch)

    # plain body: [int digits][.][frac digits]
    ilen = torch.where(e >= 0, e + 1, 1)
    zlead = (-e - 1).clamp(min=0)  # zeros after "0." for e10 < 0
    fplain = torch.where(e >= 0, (p - (e + 1)).clamp(min=1), zlead + p)
    len_plain = ilen + 1 + fplain
    jint = p - 1 - i
    ich = torch.where((e >= 0) & (jint >= 0), mdigit(jint) + _ZERO, _ZERO)
    ch = torch.where(i == ilen, ord("."), ich)
    t = i - ilen - 1
    jpos = p - 1 - (ilen + t)                 # e10 >= 0
    jneg = p - 1 - (t - zlead)                # e10 < 0
    fch = torch.where(e >= 0,
                      torch.where(jpos >= 0, mdigit(jpos) + _ZERO, _ZERO),
                      torch.where(t < zlead, _ZERO, mdigit(jneg) + _ZERO))
    plain_ch = torch.where(i > ilen, fch, ch)

    body = torch.where(sci[:, None], sci_ch, plain_ch).to(torch.uint8)
    body_len = torch.where(sci, len_sci[:, 0], len_plain[:, 0])
    mat, lengths = _render_signed(body, body_len, neg)

    # specials: NaN / Infinity / -Infinity / 0.0 / -0.0
    for mask, text in ((nanm, b"NaN"), (infm & ~neg, b"Infinity"),
                       (infm & neg, b"-Infinity"), (zerom & ~neg, b"0.0"),
                       (zerom & neg, b"-0.0")):
        mat = torch.where(mask[:, None], _literal_row(text, W, dev)[None, :],
                          mat)
        lengths = torch.where(mask, len(text), lengths)
    return from_padded_bytes(mat, lengths, col.validity)


_YW = 12  # year digits: 4-digit zero-padded, widening up to 12


@traced("cast.from_datetime")
def cast_from_datetime(col: Column) -> Column:
    """DATE/TIMESTAMP -> STRING with Spark CAST formatting: ``yyyy-MM-dd``
    for dates, ``yyyy-MM-dd HH:mm:ss[.ffffff]`` for timestamps (fraction
    only when nonzero, trailing zeros stripped)."""
    from .datetime import _civil, _days_and_secs
    if not col.dtype.is_timestamp:
        raise TypeError(f"expected date/timestamp column, got {col.dtype!r}")
    is_date = col.dtype.id == TypeId.TIMESTAMP_DAYS
    days, secs = _days_and_secs(col)
    y, mo, d = _civil(days)
    n = days.shape[0]
    dev = days.device

    # sub-second micros (unit-dependent)
    unit = {TypeId.TIMESTAMP_SECONDS: 1,
            TypeId.TIMESTAMP_MILLISECONDS: 10**3,
            TypeId.TIMESTAMP_MICROSECONDS: 10**6,
            TypeId.TIMESTAMP_NANOSECONDS: 10**9}.get(col.dtype.id, 1)
    if unit > 1:
        per_day = 86_400 * unit
        v = col.data.to(torch.int64)
        sub = (v - (v // per_day) * per_day) % unit
        micros = sub * (10**6 // unit) if unit <= 10**6 else \
            sub // (unit // 10**6)
    else:
        micros = torch.zeros(n, dtype=torch.int64, device=dev)

    # fraction length: micros to 6 digits, trailing zeros stripped
    flen = torch.full((n,), 6, dtype=torch.int64, device=dev)
    for t in range(1, 7):
        flen = torch.where(micros % 10 ** t == 0, 6 - t, flen)
    flen = torch.where(micros == 0, 0, flen)

    def two(x):
        return [x // 10 + _ZERO, x % 10 + _ZERO]

    neg_y = y < 0
    ay = y.abs()
    ylen = torch.full_like(ay, 4)
    for t in range(5, _YW + 1):
        ylen = torch.where(ay >= 10 ** (t - 1), t, ylen)
    W = _YW + 6 + (0 if is_date else 16)
    out = torch.zeros((n, W), dtype=torch.int64, device=dev)
    # year digits right-aligned in a 12-slot window, then shifted out below
    ypos0 = _YW - ylen
    ytable = _digits_lsf(ay, _YW)
    lane = torch.arange(_YW, device=dev)[None, :]
    ych = _digit_at(ytable, ylen[:, None] - 1 - (lane - ypos0[:, None])) \
        + _ZERO
    out[:, :_YW] = torch.where(lane >= ypos0[:, None], ych, 0)
    rest = [ord("-"), *two(mo), ord("-"), *two(d)]
    if not is_date:
        rest += [ord(" "), *two(secs // 3600), ord(":"),
                 *two((secs // 60) % 60), ord(":"), *two(secs % 60), ord(".")]
        rest += [(micros // 10 ** (5 - k)) % 10 + _ZERO for k in range(6)]
    for i, ch in enumerate(rest):
        out[:, _YW + i] = ch
    # compact the year's left padding: shift rows left by ypos0 slots, then
    # trim: dates end after "-MM-dd"; timestamps keep ".f..." only when the
    # fraction is nonzero
    blen = ylen + 6 if is_date else \
        ylen + 15 + torch.where(flen > 0, flen + 1, 0)
    src = torch.arange(W, device=dev)[None, :] + ypos0[:, None]
    final = torch.where(src < W, torch.gather(out, 1, src.clamp(max=W - 1)),
                        0)
    final = torch.cat([final, torch.zeros((n, 1), dtype=final.dtype,
                                          device=dev)], dim=1)
    mat, lengths = _render_signed(final.to(torch.uint8), blen, neg_y)
    return from_padded_bytes(mat, lengths, col.validity)
