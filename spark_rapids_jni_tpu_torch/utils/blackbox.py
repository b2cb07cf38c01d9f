"""Always-on flight recorder, post-mortem bundles, and SLO evaluation.

The port of ``spark_rapids_jni_tpu/utils/blackbox.py``: the same ring,
bundle format and SLO report.  The metrics, timeline and profile layers are
opt-in and in-process: with ``config.metrics`` off a crashed query leaves
nothing behind, and nothing ties a client's call to the server's spans.
This module is the serving floor under all of them:

- **Flight recorder**: a bounded ring of recent coarse events (query
  begin/end, exchange, degradation rung, retry, host sync, error, admission
  shed), recorded even with the metrics layer and the timeline off.  Gated
  only by ``config.blackbox`` (default on); capacity
  ``config.blackbox_cap``.  Every entry point is dict work under one lock,
  never a device sync.
- **Trace context**: ``query_scope()`` binds a ``trace_id`` (minted, or
  carried in from the bridge frame or ``config.trace_id``) to the executing
  thread, so client spans, server spans and timeline events share one id.
- **Post-mortem bundles**: on a classified error, timeout, cancel or
  degradation, ``post_mortem()`` writes one JSON bundle atomically to
  ``config.blackbox_dir`` (empty = ring only): trace_id, ring tail, error
  taxonomy doc with the server-side traceback, query summary, plan and
  decision ledger, live progress, config and faults spec.  One bundle per
  query execution (dedup by execution scope or exception identity); the
  directory is a bounded ring like the profile store.
- **SLO layer**: ``config.slo_ms`` declares latency objectives (a default
  plus per-source-fingerprint overrides, ``500,ab12cd34ef56=200``);
  ``slo_report()`` evaluates burn rates from profile-store history,
  ``metrics.prometheus_text()`` exposes them as gauges, and the scheduler
  sheds a saturated server's burning fingerprints by them.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import traceback
from collections import deque
from dataclasses import fields as _dc_fields

from . import errors
from .config import config

#: bundle schema version (bump on breaking change)
VERSION = 1

#: on-disk bundle ring bound (oldest pruned), like the profile store's
_DIR_KEEP = 256

#: in-memory dedup registries stay bounded regardless of uptime
_REG_KEEP = 512

_lock = threading.Lock()
_ring: deque | None = None
_drops = 0
_seq = itertools.count(1)
_exec_ids = itertools.count(1)
#: execution-scope key -> bundle path (one bundle per query execution)
_bundled: dict[str, str] = {}
#: a rank of the ranked bridge server other than 0 ends its bundles' names
#: with ``-rank<r>`` (``set_rank``), so the ranks can share a directory
_name_tag = ""
#: trace_id -> newest bundle path (the bridge error reply's pointer)
_last_by_trace: dict[str, str] = {}

_tls = threading.local()


def enabled() -> bool:
    """Live ``config.blackbox`` gate, read at call time."""
    return config.blackbox


def new_trace_id() -> str:
    """128-bit random trace id, 32 hex chars (W3C traceparent width)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit random span id, 16 hex chars."""
    return os.urandom(8).hex()


class _Scope:
    """One query execution's trace binding on the executing thread."""

    __slots__ = ("trace_id", "exec_id")

    def __init__(self, trace_id: str, exec_id: int):
        self.trace_id = trace_id
        self.exec_id = exec_id


def current_trace() -> str:
    """The trace id bound to this thread ("" outside any scope).

    Falls back to the active query's stamped trace (helper threads that
    re-enter with ``metrics.bind``) and then to ``config.trace_id`` (a
    parent handing its trace to a helper)."""
    s = getattr(_tls, "scope", None)
    if s is not None:
        return s.trace_id
    from . import metrics
    q = metrics.current()
    if q is not None and getattr(q, "trace_id", ""):
        return q.trace_id
    return config.trace_id


@contextlib.contextmanager
def query_scope(trace_id: str = "", label: str = ""):
    """Bind a trace to this thread for one query execution.

    Re-entrant like ``metrics.maybe_query``: a nested scope joins the
    enclosing one (adopting ``trace_id`` into it if the outer scope was
    minted without one) so one top-level execute means one exec_id — the
    post-mortem dedup key.  With no inherited id, one is minted."""
    prev = getattr(_tls, "scope", None)
    if prev is not None:
        if trace_id and not prev.trace_id:
            prev.trace_id = trace_id
        yield prev
        return
    s = _Scope(trace_id or config.trace_id or new_trace_id(),
               next(_exec_ids))
    _tls.scope = s
    record("query.begin", trace=s.trace_id, label=label)
    try:
        yield s
    except BaseException as e:
        record("error", trace=s.trace_id, etype=type(e).__name__,
               kind=errors.classify(e)[0], msg=str(e)[:200])
        raise
    finally:
        _tls.scope = None
        record("query.end", trace=s.trace_id, label=label)


# -- the ring -----------------------------------------------------------------

def _buffer() -> deque:
    """(lock held) ring matching the live cap, rebuilt keeping newest."""
    global _ring
    cap = max(16, int(config.blackbox_cap))
    if _ring is None or _ring.maxlen != cap:
        old = list(_ring) if _ring is not None else []
        _ring = deque(old[-cap:], maxlen=cap)
    return _ring


def record(event: str, **fields) -> None:
    """Append one coarse event to the flight-recorder ring.

    Always on (independent of the metrics layer and the timeline) unless
    ``config.blackbox`` is off.  Pure host-side dict work under one lock.  The
    event type lands under ``ev`` so fields named ``kind`` (error kinds,
    exchange kinds, degradation kinds) pass through untouched."""
    if not config.blackbox:
        return
    ev = {"seq": next(_seq), "t": round(time.time(), 6), "ev": event}
    tid = fields.pop("trace", "") or current_trace()
    if tid:
        ev["trace"] = tid
    from . import metrics
    q = metrics.current()
    if q is not None:
        ev["qid"] = q.qid
        ev["query"] = q.name
    th = threading.current_thread().name
    if th != "MainThread":
        ev["thread"] = th
    ev.update(fields)
    global _drops
    with _lock:
        buf = _buffer()
        if len(buf) == buf.maxlen:
            _drops += 1
        buf.append(ev)


def tail(n: int | None = None) -> list:
    """Newest-last copy of the ring (all of it, or the last ``n``)."""
    with _lock:
        evs = list(_buffer())
    return evs if n is None else evs[-n:]


def ring_stats() -> dict:
    with _lock:
        buf = _buffer()
        return {"events": len(buf), "cap": buf.maxlen, "drops": _drops}


def reset() -> None:
    """Drop the ring and bundle registries (test isolation)."""
    global _ring, _drops
    with _lock:
        _ring = None
        _drops = 0
        _bundled.clear()
        _last_by_trace.clear()


# -- post-mortem bundles ------------------------------------------------------

def post_mortem(reason: str, exc: BaseException | None = None,
                qm=None, trace_id: str = "",
                dir_path: str | None = None,
                extra: dict | None = None) -> str | None:
    """Write one post-mortem bundle; returns its path (None = not written).

    Best-effort end to end: stamps ``exc.trace_id`` so callers can join
    the exception to telemetry even when no bundle lands on disk, dedups
    to one bundle per query execution (a degradation followed by the
    final error reuses the first bundle), writes atomically (tmp +
    rename, a failed write leaves nothing torn behind), and prunes the
    directory past ``_DIR_KEEP``."""
    if not config.blackbox:
        return None
    tid = trace_id or current_trace()
    if exc is not None:
        if tid and not getattr(exc, "trace_id", ""):
            try:
                exc.trace_id = tid
            except (AttributeError, TypeError):
                pass  # __slots__ exception without the attribute
        prev = getattr(exc, "bundle_path", "")
        if prev:
            return prev  # this failure already has its bundle
    d = dir_path or config.blackbox_dir
    if not d:
        record("post_mortem", reason=reason, trace=tid, written=False)
        return None
    s = getattr(_tls, "scope", None)
    key = (f"exec:{s.exec_id}" if s is not None
           else f"trace:{tid}" if tid else "")
    with _lock:
        existing = _bundled.get(key) if key else None
    if existing:
        if exc is not None:
            try:
                exc.bundle_path = existing
            except (AttributeError, TypeError):
                pass
        return existing
    from . import metrics
    cq = qm if qm is not None else metrics.current()
    summary = cq.summary() if cq is not None else None
    doc = {"version": VERSION, "reason": reason, "trace_id": tid,
           "ts": round(time.time(), 6),
           "ring": tail(), "ring_stats": ring_stats(),
           "progress": metrics.progress_snapshot(),
           "config": {f.name: getattr(config, f.name)
                      for f in _dc_fields(type(config))},
           "faults": config.faults}
    if exc is not None:
        edoc = errors.to_wire(exc)
        # the server-side stack context the wire error doc cannot carry:
        # it lives here, and the wire doc points here (bundle path)
        edoc["traceback"] = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))[-8000:]
        doc["error"] = edoc
    if summary:
        doc["query"] = summary
        doc["plan"] = {"fingerprint": summary.get("fingerprint", ""),
                       "source_fingerprint":
                           summary.get("source_fingerprint", ""),
                       "decisions": summary.get("decisions") or [],
                       "degradations": summary.get("degradations") or []}
    if extra:
        doc["extra"] = dict(extra)
    tmp = ""
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"blackbox-{time.time_ns():020d}-{(tid or 'notrace')[:12]}"
               f"{_name_tag}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"), default=str)
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        # a failed bundle write must never mask the error it describes,
        # and a torn .tmp must never look like a bundle
        if tmp:
            try:
                os.remove(tmp)
            except OSError:
                pass
        return None
    with _lock:
        if key:
            _bundled[key] = path
            while len(_bundled) > _REG_KEEP:
                _bundled.pop(next(iter(_bundled)))
        if tid:
            _last_by_trace[tid] = path
            while len(_last_by_trace) > _REG_KEEP:
                _last_by_trace.pop(next(iter(_last_by_trace)))
    _prune_dir(d)
    record("post_mortem", reason=reason, trace=tid,
           bundle=os.path.basename(path))
    if exc is not None:
        try:
            exc.bundle_path = path
        except (AttributeError, TypeError):
            pass
    return path


def last_bundle(trace_id: str = "") -> str | None:
    """Newest bundle written for ``trace_id`` in this process (None = no
    bundle for that trace — the wire error doc then carries no pointer)."""
    if not trace_id:
        return None
    with _lock:
        return _last_by_trace.get(trace_id)


def set_rank(rank: int) -> None:
    """Name this process's bundles after its rank (none for rank 0)."""
    global _name_tag
    _name_tag = f"-rank{rank}" if rank else ""


def list_bundles(dir_path: str | None = None) -> list:
    """Bundle paths, oldest first (lexical = chronological, like the
    profile store).  ``.tmp`` leftovers never match."""
    d = dir_path or config.blackbox_dir
    if not d or not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.startswith("blackbox-") and n.endswith(".json"))


def read_bundle(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _prune_dir(d: str) -> None:
    paths = list_bundles(d)
    for p in paths[:max(0, len(paths) - _DIR_KEEP)]:
        try:
            os.remove(p)
        except OSError:
            pass  # concurrent pruner got it first


# -- SLO evaluation -----------------------------------------------------------

def slo_targets() -> tuple:
    """Parse ``config.slo_ms`` into ``(default_ms | None, {fp_prefix: ms})``.

    Grammar: comma-separated terms; a bare number is the default
    objective, ``<fp_prefix>=<ms>`` overrides it for source fingerprints
    starting with that prefix.  Malformed terms are skipped (flag
    hygiene)."""
    default_ms = None
    per: dict[str, float] = {}
    for part in config.slo_ms.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            fp, _, ms = part.partition("=")
            try:
                per[fp.strip()] = float(ms)
            except ValueError:
                continue
        else:
            try:
                default_ms = float(part)
            except ValueError:
                continue
    return default_ms, per


def slo_enabled() -> bool:
    default_ms, per = slo_targets()
    return default_ms is not None or bool(per)


def _objective_for(fp: str, default_ms, per: dict):
    for ov, ms in per.items():
        if ov and fp.startswith(ov):
            return ms
    return default_ms


def slo_objective_for(fp: str):
    """The latency objective (ms) that applies to source fingerprint
    ``fp``, or ``None`` when no SLO covers it.  The scheduler derives a
    session's fair-share weight from this (tighter objective -> more
    chunks per round)."""
    default_ms, per = slo_targets()
    return _objective_for(fp[:12], default_ms, per)


def slo_burn_for(fp: str, dir_path: str | None = None):
    """Windowed burn rate for source fingerprint ``fp`` from the profile
    store, or ``None`` when SLOs are off or the fingerprint has no
    history.  This is the admission controller's shed signal
    (engine/scheduler.py): a fingerprint already burning its error
    budget is shed when the server saturates, instead of queueing
    behind queries that still have budget to protect."""
    rep = slo_report(dir_path)
    if not rep.get("enabled"):
        return None
    p = fp[:12]
    for e in rep["entries"]:
        if e["fingerprint"] == p:
            return e["burn_rate"]
    return None


def slo_report(dir_path: str | None = None) -> dict:
    """Per-source-fingerprint SLO burn from profile-store history.

    A run breaches its objective when its wall time exceeds the
    objective OR it ended in a classified error (an error consumes
    budget exactly like a slow success).  ``burn_rate`` is
    breaches/runs over the stored window — the profile store is already
    a bounded recent ring, so this IS a windowed burn rate."""
    default_ms, per = slo_targets()
    if default_ms is None and not per:
        return {"enabled": False, "default_ms": None, "entries": []}
    from . import profile
    groups: dict[str, dict] = {}
    for p in profile.list_profiles(dir_path):
        try:
            prof = profile.read(p)
        except (OSError, ValueError):
            continue  # torn/pruned profile: skip, like profile.history
        fp = (prof.get("source_fingerprint")
              or prof.get("fingerprint") or "")[:12] or "(none)"
        objective = _objective_for(fp, default_ms, per)
        if objective is None:
            continue  # override-only spec: unlisted fingerprints opt out
        g = groups.setdefault(fp, {"fingerprint": fp,
                                   "objective_ms": objective,
                                   "runs": 0, "breaches": 0, "errors": 0,
                                   "worst_ms": 0.0})
        g["runs"] += 1
        wall_ms = float(prof.get("wall_s") or 0.0) * 1000.0
        g["worst_ms"] = max(g["worst_ms"], wall_ms)
        err = (prof.get("outcome") or {}).get("status") == "error"
        if err:
            g["errors"] += 1
        if err or wall_ms > objective:
            g["breaches"] += 1
    entries = []
    for g in groups.values():
        g["burn_rate"] = (round(g["breaches"] / g["runs"], 4)
                          if g["runs"] else 0.0)
        g["worst_ms"] = round(g["worst_ms"], 3)
        entries.append(g)
    entries.sort(key=lambda g: (-g["burn_rate"], g["fingerprint"]))
    return {"enabled": True, "default_ms": default_ms, "entries": entries}
