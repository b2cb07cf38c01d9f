"""Profiling scopes and named event counters.

- ``span(name)`` opens ``torch.profiler.record_function(name)``, so a
  ``torch.profiler`` trace attributes host and device time to the range
  (the analog of the reference's NVTX ranges); ``traced(name)`` is its
  decorator form, for an entry point.  The ranges are unconditional: the
  profiler records them on every thread it traces, and they cost an
  enter and an exit otherwise.
- ``sync_point(site)`` marks a deliberate device-to-host read inside an
  op: the span ``sync.<site>`` and one more on ``ops.host_sync.<site>``.
  These are apart from the engine's budgeted ``engine.host_sync``
  (``utils/metrics.host_sync``).
- ``count(name)`` / ``counter_value(name)``: process-wide monotonic counters
  keyed by dotted name.  The kernel wrappers count their launches here as
  ``kernel.<wrapper>``; the engine its cache hits and misses as
  ``engine.<cache>.<event>``.  ``counters_snapshot`` / ``reset_counters``
  isolate a prefix.  Thread-safe.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch


def span(name: str):
    """Context manager: the profiler range ``name``."""
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator: run the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def sync_point(site: str):
    """Context manager around one deliberate device-to-host read inside an
    op: counts it on ``ops.host_sync.<site>`` and opens ``sync.<site>``."""
    count(f"ops.host_sync.{site}")
    with span(f"sync.{site}"):
        yield


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
