"""Datetime field extraction from TIMESTAMP columns (UTC).

The libcudf datetime role (Spark lowers year()/month()/dayofmonth()/...
onto it).  Civil-date decomposition uses the days-from-epoch algorithm
(Howard Hinnant's civil_from_days) in int64 arithmetic: branch-free and
exact over the whole TIMESTAMP range.  Timezone-aware extraction composes
with ``ops.timezone`` (convert the instant to wall time first); these
functions are UTC.  ``//`` and ``%`` on torch integer tensors floor, as
``jnp.floor_divide`` and ``jnp.mod`` do.
"""

from __future__ import annotations

import torch

from ..columnar import Column
from ..dtypes import INT32, TIMESTAMP_DAYS, TypeId
from ..utils.tracing import traced

_UNIT_S = {
    TypeId.TIMESTAMP_SECONDS: 1,
    TypeId.TIMESTAMP_MILLISECONDS: 10**3,
    TypeId.TIMESTAMP_MICROSECONDS: 10**6,
    TypeId.TIMESTAMP_NANOSECONDS: 10**9,
}


def _days_and_secs(col: Column):
    """(days since the epoch, seconds into the day or None for DATE)."""
    if not col.dtype.is_timestamp:
        raise TypeError(f"expected a timestamp column, got {col.dtype!r}")
    v = col.data.to(torch.int64)
    if col.dtype.id == TypeId.TIMESTAMP_DAYS:
        return v, None
    per = _UNIT_S[col.dtype.id]
    day_units = 86_400 * per
    days = v // day_units
    return days, (v - days * day_units) // per


def _civil(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month [1..12], day [1..31])."""
    z = days + 719_468
    era = z // 146_097
    doe = z - era * 146_097                                  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36_524
           - doe // 146_096) // 365                          # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    return y + (m <= 2).to(y.dtype), m, d


def _days_from_civil(y, m, d):
    """Inverse of ``_civil``."""
    y = y - (m <= 2).to(y.dtype)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def _extract(col: Column, fn) -> Column:
    days, secs = _days_and_secs(col)
    return Column(INT32, data=fn(days, secs).to(torch.int32),
                  validity=col.validity)


def _secs(s):
    if s is None:
        raise TypeError("time-of-day extraction needs a sub-day timestamp "
                        "(DATE columns have no time component)")
    return s


@traced("datetime")
def year(col: Column) -> Column:
    return _extract(col, lambda d, s: _civil(d)[0])


@traced("datetime")
def month(col: Column) -> Column:
    return _extract(col, lambda d, s: _civil(d)[1])


@traced("datetime")
def dayofmonth(col: Column) -> Column:
    return _extract(col, lambda d, s: _civil(d)[2])


day = dayofmonth  # Spark alias


@traced("datetime")
def dayofweek(col: Column) -> Column:
    """Spark dayofweek: 1 = Sunday ... 7 = Saturday (1970-01-01 was a
    Thursday)."""
    return _extract(col, lambda d, s: (d + 4) % 7 + 1)


@traced("datetime")
def dayofyear(col: Column) -> Column:
    def f(d, s):
        y = _civil(d)[0]
        one = torch.ones_like(y)
        return d - _days_from_civil(y, one, one) + 1
    return _extract(col, f)


@traced("datetime")
def hour(col: Column) -> Column:
    return _extract(col, lambda d, s: _secs(s) // 3600)


@traced("datetime")
def minute(col: Column) -> Column:
    return _extract(col, lambda d, s: (_secs(s) % 3600) // 60)


@traced("datetime")
def second(col: Column) -> Column:
    return _extract(col, lambda d, s: _secs(s) % 60)


@traced("datetime")
def quarter(col: Column) -> Column:
    return _extract(col, lambda d, s: (_civil(d)[1] - 1) // 3 + 1)


@traced("datetime")
def last_day(col: Column) -> Column:
    """Last day of the month as TIMESTAMP_DAYS (Spark last_day)."""
    days, _ = _days_and_secs(col)
    y, m, _ = _civil(days)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    out = _days_from_civil(ny, nm, torch.ones_like(nm)) - 1
    return Column(TIMESTAMP_DAYS, data=out.to(torch.int32),
                  validity=col.validity)
