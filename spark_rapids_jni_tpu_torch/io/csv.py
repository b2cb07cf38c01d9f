"""CSV: delimited text <-> Tables.

The port of ``spark_rapids_jni_tpu/io/csv.py``.  ``write_csv`` is a copy
(Spark text forms, RFC 4180 quoting).  The JAX ``read_csv`` tokenizes and
infers types with pandas' C parser; the card's host has no pandas, so this
``read_csv`` tokenizes with Python's ``csv`` module and infers types itself,
to the same table the JAX reader gives:

- null: pandas' default NA spellings (``keep_default_na``) plus
  ``na_values``; a blank line is skipped, a short row is null-padded;
- inference in pandas' order: int64 (an int64 overflow tries uint64, and
  a uint64 overflow gives up on numbers), float64, bool (``true`` and
  ``false`` in any case), else STRING with the raw text;
- floats parse as pandas' default ("high" precision) parser does, not
  correctly rounded: at most 17 significant digits, leading zeros
  included, accumulated in a double and scaled by a power of ten;
- pandas' sentinel quirks: an inferred int64 of -2^63 and a uint64 of
  2^64 - 1 read as null;
- forced ``dtypes`` parse as pandas' nullable extension types do (ints
  from int or integral float text, wrapping to the storage width; floats
  from float text or a column of bools; bools from True/1/1.0 and
  False/0/0.0 spellings; STRING keeps the raw text).
"""

from __future__ import annotations

import csv
import itertools
import os
import re

import numpy as np

from .. import device as _device
from .. import dtypes as dt
from ..columnar import Column, Table

# pandas' default NA spellings (pandas._libs.parsers.STR_NA_VALUES)
DEFAULT_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
# inference takes "true"/"false" in any case; a forced BOOL8 column (pandas'
# "boolean") takes these spellings only
_FORCED_TRUE = frozenset({"True", "TRUE", "true", "1", "1.0"})
_FORCED_FALSE = frozenset({"False", "FALSE", "false", "0", "0.0"})
_POS_INF = frozenset({"inf", "+inf", "infinity", "+infinity"})
_NEG_INF = frozenset({"-inf", "-infinity"})

_WS = "[ \t\n\v\f\r]*"
_INT_RE = re.compile(_WS + r"[+-]?[0-9]+" + _WS + r"\Z")
# at least one mantissa digit, before or after the point
_FLOAT_RE = re.compile(_WS + r"([+-]?)(?=\.?[0-9])([0-9]*)(?:\.([0-9]*))?"
                       r"(?:[eE]([+-]?[0-9]+))?" + _WS + r"\Z")
_I64 = (-(1 << 63), (1 << 63) - 1)
_U64_MAX = (1 << 64) - 1
_MAX_DIGITS = 17                      # pandas' precise_xstrtod
_POW10 = np.array([float(f"1e{k}") for k in range(309)])


def _floats(vals: list) -> np.ndarray | None:
    """pandas' float parse of every value, or None if one is not a float.

    The mantissa takes the first 17 digits (leading zeros count), each
    step ``number * 10 + digit`` in a double; further integer digits raise
    the exponent, further fraction digits are dropped; the result is then
    multiplied or divided by 10^|exponent| (twice below 10^-308).
    """
    n = len(vals)
    if n and _FLOAT_RE.match(vals[0]) is None and \
            vals[0].lower() not in _POS_INF | _NEG_INF:
        return None  # most text columns stop at their first value
    ms = list(map(_FLOAT_RE.match, vals))
    special = {}
    for i in (i for i, m in enumerate(ms) if m is None) if None in ms \
            else ():
        low = vals[i].lower()
        if low not in _POS_INF and low not in _NEG_INF:
            return None
        special[i] = np.inf if low in _POS_INF else -np.inf
        ms[i] = _FLOAT_RE.match("0")
    groups = [m.groups() for m in ms]
    whole = [g[1] for g in groups]
    # the first 17 digits of whole + fraction: numpy's S17 truncates
    digits = [g[1] + g[2] if g[2] else g[1] for g in groups]
    mat = np.frombuffer(np.array(digits, dtype=f"S{_MAX_DIGITS}").tobytes(),
                        np.uint8).reshape(n, _MAX_DIGITS) \
        if n else np.zeros((0, _MAX_DIGITS), np.uint8)
    count = np.minimum(np.fromiter(map(len, digits), np.int64, n),
                       _MAX_DIGITS)
    e10 = np.fromiter((max(-10_000, min(10_000, int(g[3]))) if g[3] else 0
                       for g in groups), np.int64, n)
    exp = np.fromiter(map(len, whole), np.int64, n) - count + e10
    number = np.zeros(n, np.float64)
    for j in range(_MAX_DIGITS):
        step = number * 10.0 + (mat[:, j].astype(np.float64) - 48.0)
        number = np.where(j < count, step, number)
    neg = np.fromiter((g[0] == "-" for g in groups), np.bool_, n)
    number = np.where(neg, -number, number)
    up = np.clip(exp, 0, 308)
    down = np.clip(-exp, 0, 308)
    deep = np.clip(-308 - exp, 0, 308)
    with np.errstate(over="ignore", under="ignore"):
        out = np.where(exp > 0, number * _POW10[up], number / _POW10[down])
        out = np.where(exp < -308, number / _POW10[deep] / _POW10[308], out)
    out = np.where(exp < -616, 0.0, out)
    out = np.where(exp > 308, np.where(number == 0, 0.0,
                                       np.copysign(np.inf, number)), out)
    if special:
        out[list(special)] = list(special.values())
    return out


def _ints(vals: list):
    """pandas' int64 then uint64 attempt, in file order: ``(dtype, values,
    null mask)``, ``"float"`` (try floats next) or ``"string"``."""
    n = len(vals)
    if n and _INT_RE.match(vals[0]) is None:
        return "float"
    ms = list(map(_INT_RE.match, vals))
    inv = ms.index(None) if None in ms else n
    ints = list(map(int, vals[:inv]))
    try:
        arr = np.array(ints, np.int64)
        ovf = inv
    except OverflowError:
        ovf = next(i for i, v in enumerate(ints)
                   if not _I64[0] <= v <= _I64[1])
    if ovf == inv:
        if inv < n:
            return "float"
        return dt.INT64, arr, arr == _I64[0]  # the Int64 NA sentinel
    # an int64 overflow: the uint64 parse, from the first value again
    bad = next((i for i, v in enumerate(ints)
                if v > _U64_MAX or v < _I64[0]), inv)
    if bad < inv:
        return "string"
    if inv < n:
        return "float"
    if min(ints) < 0:
        return "string"  # negatives beside values above int64
    arr = np.array(ints, np.uint64)
    return dt.UINT64, arr, arr == _U64_MAX  # the UInt64 NA sentinel


def _infer(vals: list):
    """(dtype, dense values, extra null mask) of the non-null texts, or
    (STRING, None, None)."""
    got = _ints(vals)
    if got == "float":
        floats = _floats(vals)
        if floats is not None:
            return dt.FLOAT64, floats, None
    elif got != "string":
        return got
    bools = _bools(vals)
    if vals and bools is not None:
        return dt.BOOL8, bools, None
    return dt.STRING, None, None


def _bools(vals: list) -> np.ndarray | None:
    """uint8 truth of every value ("true"/"false" in any case), or None."""
    if not all(v.lower() in ("true", "false") for v in set(vals)):
        return None
    return (np.fromiter(map(len, vals), np.int64, len(vals)) == 4) \
        .astype(np.uint8)


def _forced(vals: list, dtype: dt.DType, name) -> np.ndarray:
    """Dense storage values of the non-null texts of a forced column."""
    if dtype.id == dt.TypeId.BOOL8:
        bad = [v for v in vals if v not in _FORCED_TRUE and
               v not in _FORCED_FALSE]
        if bad:
            raise ValueError(f"CSV column {name!r}: {bad[0]!r} cannot be "
                             "cast to bool")
        return np.fromiter((v in _FORCED_TRUE for v in vals), np.uint8,
                           len(vals))
    storage = np.dtype(dtype.storage)
    if storage.kind == "f":
        # numbers, or else a column of nothing but bools (as 1.0 / 0.0)
        out = _floats(vals)
        if out is None:
            out = _bools(vals)
        if out is None:
            raise ValueError(f"CSV column {name!r}: could not convert a "
                             "value to float")
        with np.errstate(over="ignore"):  # 1e39 -> inf in FLOAT32
            return out.astype(np.float64).astype(storage)
    if storage.kind not in "iu":
        raise NotImplementedError(
            f"CSV column {name!r}: forced {dtype!r} is unsupported")
    ints = np.empty(len(vals), np.int64)
    for i, v in enumerate(vals):
        if _INT_RE.match(v):
            ints[i] = int(v)
            continue
        f = _floats([v])
        if f is None or f[0] != np.floor(f[0]):
            raise ValueError(f"CSV column {name!r}: {v!r} is not an "
                             "integer")
        ints[i] = int(f[0])
    return ints.astype(storage)  # wraps to the width, as pandas' cast


def _strings(texts, valid, vals, device) -> Column:
    """A STRING column of the non-null texts (null rows hold no bytes), as
    the JAX reader's ``Column.from_pylist`` builds it."""
    if not vals:  # from_pylist of nothing but nulls infers INT64
        return Column.from_pylist([None] * len(texts), device=device)
    enc = list(map(str.encode, vals))
    lens = np.zeros(len(texts), np.int64)
    lens[valid] = np.fromiter(map(len, enc), np.int64, len(enc))
    offsets = np.zeros(len(texts) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] > np.iinfo(np.int32).max:
        raise ValueError("CSV string column exceeds int32 offsets")
    chars = np.frombuffer(b"".join(enc), np.uint8)
    return Column.string(chars, offsets.astype(np.int32),
                         None if valid.all() else valid, device=device)


def _column_names(first: list, header: bool, names) -> list:
    if names is not None:
        return [str(x) for x in names]
    if not header:
        return [str(i) for i in range(len(first))]
    out, seen = [], {}
    for i, nm in enumerate(first):
        nm = nm or f"Unnamed: {i}"
        if nm in seen:  # pandas mangles duplicates: a, a.1, a.2
            seen[nm] += 1
            nm = f"{nm}.{seen[nm]}"
        else:
            seen[nm] = 0
        out.append(nm)
    return out


def read_csv(path, *, delimiter: str = ",", header: bool = True,
             names: list | None = None, dtypes: dict | None = None,
             na_values=("", "null", "NULL"),
             device=_device.DEFAULT) -> Table:
    """Read a CSV file into a Table on ``device``.

    ``dtypes`` maps column name -> DType to force a type; unforced columns
    infer int64 / float64 / bool / string like Spark's CSV schema
    inference (and like the JAX reader, which asks pandas).
    """
    na = DEFAULT_NA | frozenset(na_values)
    limit = csv.field_size_limit()
    csv.field_size_limit(max(limit, 1 << 30))
    try:
        with open(os.fspath(path), newline="", encoding="utf-8") as f:
            rows = [r for r in csv.reader(f, delimiter=delimiter,
                                          quotechar='"', doublequote=True)
                    if r]  # blank lines are skipped
    finally:
        csv.field_size_limit(limit)
    first = rows[0] if rows else []
    cols_names = _column_names(first, header, names)
    body = rows[1:] if header and rows else rows
    width = len(cols_names)
    if set(map(len, body)) - {width}:
        for r in body:
            if len(r) > width:
                raise ValueError(f"CSV row of {len(r)} fields under a "
                                 f"header of {width}")
            r.extend([""] * (width - len(r)))  # a short row: nulls
    columns = list(zip(*body)) if body else [() for _ in range(width)]
    dtypes = dtypes or {}
    out = []
    for name, texts in zip(cols_names, columns):
        n = len(texts)
        valid = ~np.fromiter(map(na.__contains__, texts), np.bool_, n)
        vals = list(itertools.compress(texts, valid))
        forced = dtypes.get(name)
        if forced is not None and forced.is_string or \
                forced is None and n == 0:
            out.append(_strings(texts, valid, vals, device))
            continue
        if forced is not None:
            dtype, dense, extra = forced, _forced(vals, forced, name), None
        else:
            dtype, dense, extra = _infer(vals)
        if dtype.is_string:
            out.append(_strings(texts, valid, vals, device))
            continue
        if extra is not None and extra.any():
            valid[np.flatnonzero(valid)[extra]] = False
            dense = dense[~extra]
        full = np.zeros(n, dense.dtype)
        full[valid] = dense
        out.append(Column.from_numpy(
            full.astype(dtype.storage), validity=None if valid.all()
            else valid, dtype=dtype, device=device))
    return Table(out, cols_names)


def _render(v, na_rep: str) -> str:
    """One value in Spark's text form (the JAX writer's ``render``)."""
    import decimal as _decimal
    if v is None:
        return na_rep
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v != v:
            # Spark's text form.  CSV cannot distinguish NaN from null
            # without reader options (Spark: nanValue); read_csv also maps
            # it to null: a lossy round trip.
            return "NaN"
        if v == float("inf"):
            return "Infinity"
        if v == float("-inf"):
            return "-Infinity"
        return repr(v)
    if isinstance(v, _decimal.Decimal):
        return format(v, "f")
    return str(v)


def _texts(col, na_rep: str) -> list:
    """Every row of ``col`` rendered, column-wise for the common types."""
    d = col.dtype
    valid = None if col.validity is None else col.validity_numpy()
    if d.is_string or d.is_nested or d.is_decimal:
        return [_render(v, na_rep) for v in col.to_pylist()]
    vals = col.to_numpy()
    if d.id == dt.TypeId.BOOL8:
        out = np.where(vals, "true", "false").tolist()
    elif d.is_floating:
        out = list(map(repr, vals.tolist()))
        for i in np.flatnonzero(~np.isfinite(vals)).tolist():
            out[i] = _render(float(vals[i]), na_rep)
    else:  # integers and timestamp ticks
        out = list(map(str, vals.tolist()))
    if valid is not None:
        for i in np.flatnonzero(~valid).tolist():
            out[i] = na_rep
    return out


def write_csv(table: Table, path, *, delimiter: str = ",",
              header: bool = True, na_rep: str = "") -> None:
    """Write a Table as delimited text (the libcudf CSV-writer role).

    Values render with Spark-compatible text forms: booleans as
    true/false, decimals with their scale applied, timestamps as raw
    integer ticks (the engine has no session timezone); nulls as
    ``na_rep``.  Quoting: fields containing the delimiter, quotes or
    newlines are double-quoted with embedded quotes doubled (RFC 4180).
    The bytes equal the JAX writer's; columns render whole, not value by
    value.
    """
    special = (delimiter, '"', "\n", "\r")

    def quote(s: str) -> str:
        if any(ch in s for ch in special):
            return '"' + s.replace('"', '""') + '"'
        return s

    cols = []
    for c in table.columns:
        texts = _texts(c, na_rep)
        joined = "".join(texts)
        if any(ch in joined for ch in special):
            texts = list(map(quote, texts))
        cols.append(texts)
    names = [nm or f"c{i}" for i, nm in enumerate(
        table.names or [f"c{i}" for i in range(table.num_columns)])]
    with open(path, "w", newline="", encoding="utf-8") as f:
        if header:
            f.write(delimiter.join(quote(nm) for nm in names) + "\n")
        if cols and table.num_rows:
            f.write("\n".join(map(delimiter.join, zip(*cols))) + "\n")
