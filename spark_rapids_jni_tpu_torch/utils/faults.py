"""Deterministic fault injection (``config.faults``).

The port of ``spark_rapids_jni_tpu/utils/faults.py``: the same sites,
grammar, kinds and counters.  Every recovery path in the engine (retry, OOM
degradation, cancellation) must be testable on the CPU without real
hardware faults.  ``check(site)`` seams sit at the engine's real failure
domains, and the ``config.faults`` spec arms them deterministically.

Spec grammar (comma-separated entries)::

    faults = site:nth[:kind][,site:nth[:kind]...]

- ``site``  one of :data:`SITES` (a seam location).
- ``nth``   1-based occurrence to fault, or ``*`` for every occurrence.
- ``kind``  ``io_error`` (default) | ``oom`` | ``timeout``.

Examples::

    parquet.chunk:3:io_error          # 3rd row-group decode fails
    exchange.dispatch:1:oom           # 1st exchange chunk runs out of memory
    parquet.chunk:*:io_error          # every decode fails
    spill.write:2,staging.transfer:1:oom

Kinds map to the taxonomy (utils/errors.py): ``io_error`` raises
:class:`InjectedIOError` (transient, retryable), ``oom`` raises
:class:`InjectedResourceExhausted` (resource: the degradation ladder steps,
as for a real ``torch.cuda.OutOfMemoryError``), ``timeout`` sleeps
:data:`HANG_S` so deadline tokens trip at the next boundary.  Each injection
ticks ``faults.injected.<site>.<kind>``.

With ``config.faults`` empty, ``check`` is one falsy attribute test and a
return, safe on per-chunk hot paths.  Occurrence counters key off the live
spec string, so setting a new spec re-arms them; ``reset()`` re-arms the
counters for a fresh run under the same spec.
"""

from __future__ import annotations

import logging
import threading
import time

from . import errors
from .config import config

_log = logging.getLogger(__name__)

#: the planted seams (one per engine failure domain)
SITES = (
    "parquet.chunk",      # io/parquet.py: per-row-group host decode
    "parquet.prefetch",   # io/parquet.py: prefetch producer thread
    "parquet.device_decode",  # io/parquet.py: device page-plane transfer
    "staging.transfer",   # io/staging.py: host->device staging
    "exchange.dispatch",  # parallel/shuffle.py: per-chunk shuffle dispatch
    "spill.write",        # parallel/spill.py: spill-pass buffer write
    "bridge.op",          # bridge/server.py: op dispatch
)

KIND_IO_ERROR = "io_error"
KIND_OOM = "oom"
KIND_TIMEOUT = "timeout"
KINDS = (KIND_IO_ERROR, KIND_OOM, KIND_TIMEOUT)

#: how long a ``timeout`` injection stalls (long enough for a sub-second
#: ``config.query_timeout_s`` deadline to expire before the next boundary check)
HANG_S = 0.05


class InjectedIOError(errors.TransientError, OSError):
    """A fault-injected transient I/O failure."""


class InjectedResourceExhausted(errors.ResourceExhaustedError):
    """A fault-injected allocation failure (a device out-of-memory error)."""

    def __str__(self) -> str:  # carry the runtime's marker so code that
        # matches on the message treats injections identically
        return f"RESOURCE_EXHAUSTED (injected): {super().__str__()}"


class FaultSpecError(ValueError):
    """``config.faults`` failed to parse."""


_lock = threading.Lock()
_armed_for: str | None = None              # spec string the state matches
_rules: dict[str, list] = {}               # site -> [(nth|None, kind), ...]
_hits: dict[str, int] = {}                 # site -> occurrences so far


def parse(spec: str) -> dict:
    """Parse a spec string into ``{site: [(nth|None, kind), ...]}``."""
    rules: dict[str, list] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise FaultSpecError(
                f"bad fault-spec entry {entry!r} (want site:nth[:kind])")
        site, nth_s = parts[0].strip(), parts[1].strip()
        kind = parts[2].strip() if len(parts) == 3 else KIND_IO_ERROR
        if site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} (known: {', '.join(SITES)})")
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} (known: {', '.join(KINDS)})")
        if nth_s == "*":
            nth = None
        else:
            try:
                nth = int(nth_s)
            except ValueError:
                raise FaultSpecError(
                    f"bad occurrence {nth_s!r} in {entry!r} "
                    "(want a 1-based integer or '*')") from None
            if nth < 1:
                raise FaultSpecError(
                    f"occurrence must be >= 1 in {entry!r}")
        rules.setdefault(site, []).append((nth, kind))
    return rules


def _arm(spec: str) -> None:
    """(Re)build rules + zero the hit counters for ``spec`` (lock held)."""
    global _armed_for, _rules
    _rules = parse(spec)
    _hits.clear()
    _armed_for = spec


def reset() -> None:
    """Zero the occurrence counters (tests re-arm between runs)."""
    with _lock:
        _hits.clear()


def active() -> bool:
    return bool(config.faults)


def check(site: str) -> None:
    """Fault seam: count this occurrence of ``site`` and inject if armed.

    First line is the zero-overhead gate: with ``config.faults`` empty this
    is a falsy attribute test and a return.
    """
    spec = config.faults
    if not spec:
        return
    with _lock:
        if spec != _armed_for:
            _arm(spec)
        rules = _rules.get(site)
        if not rules:
            return
        n = _hits.get(site, 0) + 1
        _hits[site] = n
        kind = None
        for nth, k in rules:
            if nth is None or nth == n:
                kind = k
                break
        if kind is None:
            return
    _inject(site, n, kind)


def _inject(site: str, n: int, kind: str) -> None:
    from . import metrics
    metrics.count(f"faults.injected.{site}.{kind}")
    _log.info("fault injected at %s#%d: %s", site, n, kind)
    if kind == KIND_IO_ERROR:
        raise InjectedIOError(f"injected io_error at {site}#{n}")
    if kind == KIND_OOM:
        raise InjectedResourceExhausted(f"injected oom at {site}#{n}")
    # timeout: stall so a deadline token expires before the next boundary
    time.sleep(HANG_S)
