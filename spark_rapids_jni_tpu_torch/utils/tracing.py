"""Profiling scopes and named event counters.

- ``traced(name)`` wraps an entry point in ``torch.profiler.record_function``,
  so a ``torch.profiler`` trace attributes host and device time to the op
  (the analog of the reference's NVTX ranges).
- ``count(name)`` / ``counter_value(name)``: process-wide monotonic counters
  keyed by dotted name.  The kernel wrappers count their launches here as
  ``kernel.<wrapper>``; the engine its cache hits and misses as
  ``engine.<cache>.<event>``.  ``counters_snapshot`` / ``reset_counters``
  isolate a prefix.  Thread-safe.
"""

from __future__ import annotations

import functools
import threading

import torch


def traced(name: str):
    """Decorator: run the op inside ``record_function(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


_counters: dict[str, int] = {}
_counters_lock = threading.Lock()


def count(name: str, n: int = 1) -> int:
    """Increment counter ``name`` by ``n``; returns the new value."""
    with _counters_lock:
        v = _counters.get(name, 0) + n
        _counters[name] = v
        return v


def counter_value(name: str) -> int:
    with _counters_lock:
        return _counters.get(name, 0)


def counters_snapshot(prefix: str = "") -> dict:
    """Copy of all counters whose name starts with ``prefix``."""
    with _counters_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Zero the counters under ``prefix``."""
    with _counters_lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]
