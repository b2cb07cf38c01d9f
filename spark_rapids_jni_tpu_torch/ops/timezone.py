"""TimeZoneDB: timezone-aware timestamp conversion from transition tables.

The port of ``spark_rapids_jni_tpu/ops/timezone.py`` (the reference's
GpuTimeZoneDB component: each zone's transition rules load into a device
table once, then every row binary-searches it):

- host side: parse the system TZif database (/usr/share/zoneinfo, the IANA
  data the JVM uses) into (transition instants, utc offsets) int64 arrays,
  cached per zone.  This part is numpy and Python and is copied from the
  JAX package unchanged;
- device side: ``torch.searchsorted`` into the transition instants picks
  each row's offset; the tables are cached per (zone, ticks, device).

Semantics match Spark's from_utc_timestamp/to_utc_timestamp: local->UTC
resolves gaps and overlaps with the offset in force *before* the
wall-clock transition (Java's earlier-offset rule).  All four timestamp
precisions are supported.  Rule-based zones stay correct past the TZif
enumeration horizon (2037): the POSIX TZ footer's DST rules are expanded
through ``EXPAND_THROUGH_YEAR``.  A zone may also be named by the absolute
path of a TZif file.
"""

from __future__ import annotations

import datetime
import functools
import re
import struct

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import TypeId

_TZPATHS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo", "/etc/zoneinfo")

MICROS = 1_000_000
_SENTINEL = np.iinfo(np.int64).min // 2  # below any representable micros

# How far past the TZif table the POSIX footer rules are expanded.  2200
# covers any timestamp a NANOS column can represent (int64 nanos max out in
# 2262) at ~2 transitions/year of table size.
EXPAND_THROUGH_YEAR = 2200

# ticks per second for each supported precision
_TICKS = {
    TypeId.TIMESTAMP_SECONDS: 1,
    TypeId.TIMESTAMP_MILLISECONDS: 1_000,
    TypeId.TIMESTAMP_MICROSECONDS: 1_000_000,
    TypeId.TIMESTAMP_NANOSECONDS: 1_000_000_000,
}


def _read_tzif(name: str) -> bytes:
    if "/" in name and name.startswith("/"):
        path_candidates = [name]
    else:
        path_candidates = [f"{p}/{name}" for p in _TZPATHS]
    for p in path_candidates:
        try:
            with open(p, "rb") as f:
                return f.read()
        except OSError:
            continue
    raise ValueError(f"unknown timezone {name!r}")


# --- POSIX TZ footer (TZif v2+ trailing rule string) -----------------------

_POSIX_NAME = r"(?:[A-Za-z]{3,}|<[A-Za-z0-9+\-]{3,}>)"
_POSIX_OFF = r"([+-]?\d{1,2}(?::\d{1,2}(?::\d{1,2})?)?)"


def _parse_posix_offset(s: str) -> int:
    """POSIX offset (west-positive, local + offset = UTC) -> seconds."""
    sign = -1 if s.startswith("-") else 1
    parts = s.lstrip("+-").split(":")
    sec = int(parts[0]) * 3600
    if len(parts) > 1:
        sec += int(parts[1]) * 60
    if len(parts) > 2:
        sec += int(parts[2])
    return sign * sec


def _parse_posix_time(s: str | None) -> int:
    """Transition time-of-day (may be negative or >24h, TZ extension)."""
    if not s:
        return 2 * 3600
    sign = -1 if s.startswith("-") else 1
    parts = s.lstrip("+-").split(":")
    sec = int(parts[0]) * 3600
    if len(parts) > 1:
        sec += int(parts[1]) * 60
    if len(parts) > 2:
        sec += int(parts[2])
    return sign * sec


def _rule_day(year: int, rule: str) -> datetime.date:
    """Resolve an Mm.w.d / Jn / n date rule for one year."""
    if rule.startswith("M"):
        m, w, d = (int(x) for x in rule[1:].split("."))
        # d-th weekday (0=Sunday) of week w (5 = last) in month m
        first = datetime.date(year, m, 1)
        want_wd = d % 7  # python: Monday=0 ... convert below
        # python weekday(): Mon=0..Sun=6; POSIX: Sun=0..Sat=6
        first_wd = (first.weekday() + 1) % 7
        day1 = 1 + (want_wd - first_wd) % 7
        day = day1 + (w - 1) * 7
        # clamp week 5 = last occurrence
        while True:
            try:
                out = datetime.date(year, m, day)
                return out
            except ValueError:
                day -= 7
    if rule.startswith("J"):  # 1..365, Feb 29 never counted
        n = int(rule[1:])
        d = datetime.date(year, 1, 1) + datetime.timedelta(days=n - 1)
        if (datetime.date(year, 3, 1) - datetime.date(year, 1, 1)).days == 60 \
                and n >= 60:  # leap year, day >= Mar 1
            d += datetime.timedelta(days=1)
        return d
    n = int(rule)  # 0..365, leap day counted
    return datetime.date(year, 1, 1) + datetime.timedelta(days=n)


def _parse_posix_tz(footer: str):
    """Parse a POSIX TZ string -> (std_off, dst_off, start_rule, end_rule).

    Offsets are utoff seconds (east-positive, the TZif convention — POSIX
    signs are inverted).  Returns None for rules this implementation cannot
    expand; constant-offset strings return (std, None, None, None).
    """
    m = re.match(
        rf"^{_POSIX_NAME}{_POSIX_OFF}"
        rf"(?:({_POSIX_NAME})(?:{_POSIX_OFF})?"
        rf"(?:,([^,/]+)(?:/([^,]+))?,([^,/]+)(?:/([^,]+))?)?)?$",
        footer.strip())
    if not m:
        return None
    std_posix = _parse_posix_offset(m.group(1))
    std = -std_posix  # POSIX west-positive -> utoff east-positive
    if not m.group(2):
        return (std, None, None, None)
    dst = -_parse_posix_offset(m.group(3)) if m.group(3) else std + 3600
    if not m.group(4):
        # DST name without rules: POSIX default rules (US); rare in TZif
        start = ("M3.2.0", 2 * 3600)
        end = ("M11.1.0", 2 * 3600)
        return (std, dst, start, end)
    start = (m.group(4), _parse_posix_time(m.group(5)))
    end = (m.group(6), _parse_posix_time(m.group(7)))
    return (std, dst, start, end)


_EPOCH = datetime.date(1970, 1, 1)


def _expand_posix(footer: str, from_instant: int):
    """Generate (instants, offsets) seconds-UTC from the footer rules for
    all transitions strictly after ``from_instant`` through
    EXPAND_THROUGH_YEAR.  Empty arrays when the footer is constant-offset
    or unparseable."""
    parsed = _parse_posix_tz(footer)
    if not parsed or parsed[1] is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    std, dst, (start_rule, start_tod), (end_rule, end_tod) = parsed
    year0 = max(1970, datetime.datetime.fromtimestamp(
        max(from_instant, 0), datetime.timezone.utc).year)
    inst, offs = [], []
    for year in range(year0, EXPAND_THROUGH_YEAR + 1):
        sd = _rule_day(year, start_rule)
        ed = _rule_day(year, end_rule)
        # start time is wall clock under std offset; end under dst offset
        s_utc = (sd - _EPOCH).days * 86400 + start_tod - std
        e_utc = (ed - _EPOCH).days * 86400 + end_tod - dst
        for t, o in sorted([(s_utc, dst), (e_utc, std)]):
            if t > from_instant:
                inst.append(t)
                offs.append(o)
    return np.array(inst, np.int64), np.array(offs, np.int64)


@functools.lru_cache(maxsize=None)
def load_transitions(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(instants int64[T] seconds-UTC, offsets int64[T] seconds) for a zone.

    ``offsets[i]`` is in force from ``instants[i]`` (inclusive) to
    ``instants[i+1]``; ``instants[0]`` is -inf sentinel carrying the earliest
    known offset.  Enumerated TZif transitions are extended by the expanded
    POSIX footer rules (post-2037 correctness for rule-based zones).
    """
    raw = _read_tzif(name)
    if raw[:4] != b"TZif":
        raise ValueError(f"{name!r}: not a TZif file")
    version = raw[4:5]

    def parse_block(buf, off, time_size, time_fmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt) = \
            struct.unpack(">6I", buf[off + 20:off + 44])
        p = off + 44
        times = np.frombuffer(buf, dtype=time_fmt, count=timecnt, offset=p)
        p += timecnt * time_size
        idx = np.frombuffer(buf, dtype=np.uint8, count=timecnt, offset=p)
        p += timecnt
        ttinfo = []
        for i in range(typecnt):
            utoff, isdst, abbrind = struct.unpack(
                ">iBB", buf[p + 6 * i:p + 6 * i + 6])
            ttinfo.append(utoff)
        p += 6 * typecnt + charcnt + leapcnt * (time_size + 4)
        p += isstdcnt + isutcnt
        return times.astype(np.int64), idx, np.array(ttinfo, np.int64), p

    footer = ""
    if version >= b"2":
        # skip the v1 block, parse the 64-bit v2 block
        _, _, _, end_v1 = parse_block(raw, 0, 4, ">i4")
        times, idx, offsets_by_type, end_v2 = parse_block(raw, end_v1, 8,
                                                          ">i8")
        # trailing newline-enclosed POSIX TZ string (RFC 9636 §3.3)
        tail = raw[end_v2:].decode("ascii", "replace")
        if tail.startswith("\n"):
            footer = tail[1:].split("\n", 1)[0]
    else:
        times, idx, offsets_by_type, _ = parse_block(raw, 0, 4, ">i4")

    if offsets_by_type.size == 0:
        raise ValueError(f"{name!r}: no time types")
    first = offsets_by_type[0]
    if times.size:
        instants = np.concatenate([[_SENTINEL], times]).astype(np.int64)
        offs = np.concatenate([[first], offsets_by_type[idx]]).astype(np.int64)
    else:
        instants = np.array([_SENTINEL], np.int64)
        offs = np.array([first], np.int64)
    if footer:
        last = int(instants[-1]) if instants.size > 1 else 0
        ext_i, ext_o = _expand_posix(footer, last)
        if ext_i.size:
            instants = np.concatenate([instants, ext_i])
            offs = np.concatenate([offs, ext_o])
    return instants, offs


@functools.lru_cache(maxsize=None)
def _device_tables(name: str, ticks: int, device: str):
    """(instants, offsets) in ticks on ``device``.  Only the real
    transitions are scaled: the -2^62 sentinel times 10^6 is a multiple of
    2^64 and would wrap to 0, unsorting the table."""
    instants, offs = load_transitions(name)
    scaled = np.concatenate([[_SENTINEL], instants[1:] * ticks])
    return (torch.from_numpy(scaled).to(device),
            torch.from_numpy(offs * ticks).to(device))


@functools.lru_cache(maxsize=None)
def _device_wall_tables(name: str, ticks: int, device: str):
    """(wall-clock transition instants, offsets) in ticks on ``device``:
    ``wall[i]`` is the local tick at which ``offs[i]`` takes effect."""
    instants, offs = load_transitions(name)
    wall = np.concatenate([[_SENTINEL],
                           instants[1:] * ticks + offs[1:] * ticks])
    return (torch.from_numpy(wall).to(device),
            torch.from_numpy(offs * ticks).to(device))


def _check_ts(col: Column) -> int:
    """Validate the column is a timestamp; return its ticks a second."""
    ticks = _TICKS.get(col.dtype.id)
    if ticks is None:
        raise TypeError(f"expected a TIMESTAMP column, got {col.dtype!r}")
    return ticks


def utc_to_local(col: Column, zone: str) -> Column:
    """Spark from_utc_timestamp: a UTC instant on the zone's wall clock."""
    ticks = _check_ts(col)
    instants, offs = _device_tables(zone, ticks, str(col.data.device))
    # pre-sentinel timestamps take the earliest offset
    idx = (torch.searchsorted(instants, col.data, side="right") - 1) \
        .clamp(min=0)
    return Column(col.dtype, data=col.data + offs[idx], validity=col.validity)


def local_to_utc(col: Column, zone: str) -> Column:
    """Spark to_utc_timestamp: wall-clock ticks in the zone to UTC (the
    offset in force before a wall-clock transition wins)."""
    ticks = _check_ts(col)
    wall, offs = _device_wall_tables(zone, ticks, str(col.data.device))
    idx = (torch.searchsorted(wall, col.data, side="right") - 1) \
        .clamp(0, wall.shape[0] - 1)
    return Column(col.dtype, data=col.data - offs[idx], validity=col.validity)
