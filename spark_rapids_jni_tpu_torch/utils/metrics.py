"""Query-scoped metrics: spans, histograms, gauges over the flat counters.

The port of ``spark_rapids_jni_tpu/utils/metrics.py``.  ``utils.tracing``
gives the process flat monotonic counters; this module adds the
attribution layer: a ``QueryMetrics`` context that collects per-plan-node
spans (wall time, rows in/out, chunk count, padded-vs-live row waste,
host-sync count), per-query counter attribution, and lock-protected
histograms and gauges keyed by dotted name, so concurrent queries never
collide.  ``engine.explain_analyze`` renders the spans; ``snapshot()`` and
``prometheus_text()`` export the registry.

Collection is gated by ``config.metrics`` (default on): every entry point
is dict and ``perf_counter`` work, never a device sync, and with the flag
off each returns at once.  The flat counters stay on unconditionally.

Threading: the active query is a thread-local; code that fans work out to
helper threads captures ``current()`` and re-enters it with ``bind(qm)``.
``QueryMetrics`` carries its own lock.

With ``config.profile_dir`` set, every query writes one compact profile
at close (``utils/profile.py``), keyed by its plan fingerprint and its
pre-optimization source fingerprint; ``host_sync`` drops an instant on the
event timeline (``utils/timeline.py``) when that is on, and an event in
the flight recorder's ring (``utils/blackbox.py``) always.  A query carries
the trace id of its ``blackbox.query_scope`` (the bridge's client id), which
its summary, progress entry and profile repeat; ``prometheus_text`` adds
the SLO burn gauges when objectives are declared (``config.slo_ms``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import threading
import time
from collections import deque

from . import timeline, tracing
from .config import config

_lock = threading.Lock()
_hists: dict[str, dict] = {}
_gauges: dict[str, float] = {}

#: in-flight queries, qid -> QueryMetrics (registered at construction,
#: dropped at ``finish``)
_progress: dict[int, "QueryMetrics"] = {}

_RECENT_LIMIT = 32
_recent: "deque[dict]" = deque(maxlen=_RECENT_LIMIT)

_tls = threading.local()
_qids = itertools.count(1)


def enabled() -> bool:
    return config.metrics


def _bucket_le(value: float) -> float:
    """Smallest power-of-two upper bound for ``value`` (0.0 for <= 0)."""
    v = float(value)
    if v <= 0.0:
        return 0.0
    return 2.0 ** math.ceil(math.log2(v))


def _hist_add(hists: dict, name: str, value: float) -> None:
    h = hists.get(name)
    if h is None:
        h = hists[name] = {"count": 0, "sum": 0.0,
                           "min": None, "max": None, "buckets": {}}
    v = float(value)
    h["count"] += 1
    h["sum"] += v
    h["min"] = v if h["min"] is None else min(h["min"], v)
    h["max"] = v if h["max"] is None else max(h["max"], v)
    le = _bucket_le(v)
    h["buckets"][le] = h["buckets"].get(le, 0) + 1


def _hist_percentiles(h: dict, qs=(0.5, 0.9, 0.99)) -> dict:
    """p50/p90/p99 interpolated inside the power-of-two buckets (at most
    one bucket width of error), clamped to the observed [min, max]."""
    n = h["count"]
    if not n:
        return {f"p{int(q * 100)}": None for q in qs}
    items = sorted(h["buckets"].items())
    out = {}
    for q in qs:
        target = q * n
        cum = 0.0
        val = h["max"]
        for le, c in items:
            if cum + c >= target:
                if le <= 0:
                    val = 0.0
                else:
                    lo = le / 2.0
                    val = lo + (le - lo) * ((target - cum) / c)
                break
            cum += c
        out[f"p{int(q * 100)}"] = min(max(val, h["min"]), h["max"])
    return out


def _hist_dump(h: dict) -> dict:
    return {"count": h["count"], "sum": h["sum"],
            "mean": (h["sum"] / h["count"]) if h["count"] else None,
            "min": h["min"], "max": h["max"],
            **_hist_percentiles(h),
            "buckets": sorted([le, n] for le, n in h["buckets"].items())}


def _hist_load(d: dict) -> dict:
    return {"count": d["count"], "sum": d["sum"],
            "min": d["min"], "max": d["max"],
            "buckets": {float(le): n for le, n in d["buckets"]}}


def q_error(est, actual) -> float | None:
    """Cardinality q-error ``max(est/actual, actual/est)``; zeros clamp to
    one row, an unknown (``None``) estimate gives ``None``."""
    if est is None:
        return None
    e = max(float(est), 1.0)
    a = max(float(actual or 0), 1.0)
    return round(max(e / a, a / e), 4)


# -- per-query context ------------------------------------------------------

_NODE_FIELDS = ("calls", "wall_s", "rows_in", "rows_out", "chunks",
                "padded_rows", "host_syncs", "bytes_in", "bytes_out",
                "wire_bytes")


class QueryMetrics:
    """One query's attribution: node spans, counters, histograms, timers.

    Node spans are keyed by the caller's choice (the executor uses
    ``id(node)`` within one optimized plan) and accumulate across calls, so
    a per-chunk re-walk adds one call per chunk to each node it touches.
    """

    __slots__ = ("qid", "name", "t0", "wall_s", "stats", "counters",
                 "node_spans", "hists", "timers", "mem", "fingerprint",
                 "source_fingerprint", "outcome", "degradations",
                 "decisions", "progress", "trace_id", "_lock")

    def __init__(self, name: str = ""):
        self.qid = next(_qids)
        self.name = name or f"q{self.qid}"
        # end-to-end trace id (utils/blackbox.py query_scope), so client
        # spans, server spans and post-mortem bundles join on one id
        self.trace_id: str = ""
        self.t0 = time.perf_counter()
        self.wall_s: float | None = None
        self.stats: dict = {}
        self.counters: dict[str, int] = {}
        self.node_spans: dict = {}
        self.hists: dict[str, dict] = {}
        self.timers: dict[str, float] = {}
        self.mem: dict = {}
        self.fingerprint: str = ""  # plan fingerprint (profile-store key)
        # pre-optimization fingerprint (AQE profile-history key: stable
        # across runs even when warming changes the optimized shape)
        self.source_fingerprint: str = ""
        self.outcome: dict = {}
        self.degradations: list = []
        self.decisions: list = []
        self.progress: dict = {"chunks_done": 0, "chunks_total": 0,
                               "rows": 0, "bytes": 0}
        self._lock = threading.Lock()
        with _lock:
            _progress[self.qid] = self

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            _hist_add(self.hists, name, value)

    def add_time(self, name: str, dt: float) -> None:
        with self._lock:
            self.timers[name] = self.timers.get(name, 0.0) + dt

    def _span_record(self, key, label: str) -> dict:
        r = self.node_spans.get(key)
        if r is None:
            r = self.node_spans[key] = dict.fromkeys(_NODE_FIELDS, 0)
            r["wall_s"] = 0.0
            r["label"] = label
        return r

    def node_add(self, key, label: str, **fields) -> None:
        """Accumulate span fields (``_NODE_FIELDS``) onto node ``key``."""
        with self._lock:
            r = self._span_record(key, label)
            for k, v in fields.items():
                r[k] += v

    def node_set(self, key, label: str, **fields) -> None:
        """Set derived span fields on node ``key`` (no accumulation) and
        re-stamp its label."""
        with self._lock:
            r = self._span_record(key, label)
            r["label"] = label
            r.update(fields)

    def host_sync(self, n: int = 1, key=None, label: str = "") -> None:
        self.count("engine.host_sync", n)
        if key is not None:
            self.node_add(key, label, host_syncs=n)

    def mem_sample(self, snap: dict) -> None:
        """Fold one ``memory.telemetry_snapshot`` into the query's
        device-memory record: last live bytes and the high-water mark."""
        live = int(snap.get("live_bytes") or 0)
        peak = snap.get("peak_bytes")
        with self._lock:
            m = self.mem
            m["source"] = snap.get("source", "runtime")
            m["samples"] = m.get("samples", 0) + 1
            m["live_bytes"] = live
            m["high_water_bytes"] = max(m.get("high_water_bytes", 0), live,
                                        int(peak) if peak else 0)

    def note_stats(self, stats: dict) -> None:
        self.stats = dict(stats)

    def degrade(self, step: str, cause: str = "") -> None:
        """Record one degradation-ladder step (engine/recovery.py)."""
        with self._lock:
            self.degradations.append({"step": step, "cause": cause})

    def set_decisions(self, decisions) -> None:
        """Adopt the optimizer's decision ledger (``plan._decisions``)."""
        with self._lock:
            self.decisions = [dict(d) for d in decisions]

    def progress_total(self, chunks: int) -> None:
        """Grow the expected-chunk total (a footer estimate per stream)."""
        with self._lock:
            self.progress["chunks_total"] += int(chunks)

    def progress_step(self, chunks: int = 0, rows: int = 0,
                      nbytes: int = 0) -> None:
        """Publish one chunk boundary from host-side counts."""
        with self._lock:
            p = self.progress
            p["chunks_done"] += int(chunks)
            p["rows"] += int(rows)
            p["bytes"] += int(nbytes)

    def set_outcome(self, status: str, kind: str = "",
                    error: str = "") -> None:
        """Stamp the query's terminal status (``ok`` | ``error``)."""
        with self._lock:
            self.outcome = {"status": status}
            if kind:
                self.outcome["kind"] = kind
            if error:
                self.outcome["error"] = error[:200]

    def finish(self) -> None:
        if self.wall_s is None:
            self.wall_s = time.perf_counter() - self.t0
        with _lock:
            _progress.pop(self.qid, None)

    def summary(self) -> dict:
        """JSON-ready snapshot (safe to call live or after ``finish``)."""
        with self._lock:
            wall = self.wall_s if self.wall_s is not None \
                else time.perf_counter() - self.t0
            nodes = [{k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in r.items()} for r in self.node_spans.values()]
            out = {"qid": self.qid, "name": self.name,
                   "wall_s": round(wall, 6),
                   "stats": dict(self.stats),
                   "counters": dict(self.counters),
                   "timers": {k: round(v, 6)
                              for k, v in self.timers.items()},
                   "histograms": {k: _hist_dump(h)
                                  for k, h in self.hists.items()},
                   "nodes": nodes}
            if self.mem:
                out["memory"] = dict(self.mem)
            if self.fingerprint:
                out["fingerprint"] = self.fingerprint
            if self.source_fingerprint:
                out["source_fingerprint"] = self.source_fingerprint
            if self.outcome:
                out["outcome"] = dict(self.outcome)
            if self.degradations:
                out["degradations"] = list(self.degradations)
            if self.decisions:
                out["decisions"] = [dict(d) for d in self.decisions]
            if self.trace_id:
                out["trace_id"] = self.trace_id
            return out


def current() -> QueryMetrics | None:
    """The query context bound to this thread (None outside any query)."""
    return getattr(_tls, "q", None)


@contextlib.contextmanager
def query(name: str = ""):
    """Open a query context on this thread; records its summary on exit.
    Yields ``None`` (and collects nothing) when metrics are off."""
    if not config.metrics:
        yield None
        return
    qm = QueryMetrics(name)
    prev = current()
    _tls.q = qm
    try:
        yield qm
    finally:
        _tls.q = prev
        qm.finish()
        summary = qm.summary()
        with _lock:
            _recent.append(summary)
        if config.profile_dir:
            # one compact profile per query (utils/profile.py): host I/O
            # that must never fail the query it describes
            try:
                from . import profile
                profile.write(summary)
            except Exception as e:  # noqa: BLE001 -- best-effort telemetry
                logging.getLogger(__name__).warning(
                    "profile write failed: %s", e)


@contextlib.contextmanager
def maybe_query(name: str = ""):
    """``query(name)`` unless one is already active on this thread; yields
    the NEW context or ``None``, never the enclosing one."""
    if not config.metrics or current() is not None:
        yield None
        return
    with query(name) as qm:
        yield qm


@contextlib.contextmanager
def bind(qm: QueryMetrics | None):
    """Re-enter a captured query context on a helper thread."""
    prev = current()
    _tls.q = qm
    try:
        yield qm
    finally:
        _tls.q = prev


# -- module-level recording -------------------------------------------------

def count(name: str, n: int = 1) -> int:
    """Flat counter tick (always on) + active-query attribution."""
    v = tracing.count(name, n)
    q = current()
    if q is not None:
        q.count(name, n)
    return v


def observe(name: str, value: float) -> None:
    """Record ``value`` into histogram ``name`` (global + active query)."""
    if not config.metrics:
        return
    with _lock:
        _hist_add(_hists, name, value)
    q = current()
    if q is not None:
        q.observe(name, value)


def time_add(name: str, dt: float) -> None:
    """Accumulate a duration gauge (global) + per-query timer."""
    if not config.metrics:
        return
    with _lock:
        _gauges[name] = _gauges.get(name, 0.0) + dt
    q = current()
    if q is not None:
        q.add_time(name, dt)


def gauge_set(name: str, value: float) -> None:
    if not config.metrics:
        return
    with _lock:
        _gauges[name] = value


def gauge_max(name: str, value: float) -> None:
    """Keep the high-water mark of ``name``."""
    if not config.metrics:
        return
    with _lock:
        if value > _gauges.get(name, float("-inf")):
            _gauges[name] = value


def host_sync(n: int = 1, key=None, label: str = "") -> None:
    """Record a deliberate device->host sync point (attributed if keyed).
    Also drops a timeline instant at the sync site, gated by the timeline
    alone, so the trace marks the engine's deliberate syncs with the
    metrics layer off, and a flight-recorder event, which survives with
    both off."""
    from . import blackbox
    blackbox.record("host_sync", label=label, n=n)
    if config.timeline:
        timeline.instant("engine.host_sync",
                         {"label": label} if label else None)
    if not config.metrics:
        return
    tracing.count("engine.host_sync", n)
    q = current()
    if q is not None:
        q.host_sync(n, key=key, label=label)


def mem_checkpoint(device) -> None:
    """Sample ``device``'s allocator into the active query and the process
    gauges (a no-op on a CPU device).  Host-side counters, no sync."""
    if not config.metrics:
        return
    from . import memory
    snap = memory.telemetry_snapshot(device)
    if snap is None:
        return
    live = int(snap["live_bytes"])
    gauge_set("memory.device.live_bytes", live)
    gauge_max("memory.device.high_water_bytes", int(snap["peak_bytes"]))
    q = current()
    if q is not None:
        q.mem_sample(snap)


# -- snapshots / test isolation ---------------------------------------------

def histograms_snapshot(prefix: str = "") -> dict:
    with _lock:
        return {k: _hist_dump(h) for k, h in _hists.items()
                if k.startswith(prefix)}


def gauges_snapshot(prefix: str = "") -> dict:
    with _lock:
        return {k: v for k, v in _gauges.items() if k.startswith(prefix)}


def recent_summaries(limit: int | None = None) -> list:
    """Completed-query summaries, oldest first (bounded window)."""
    with _lock:
        out = list(_recent)
    return out if limit is None else out[-limit:]


def progress_snapshot() -> list:
    """One entry per in-flight query, qid order: chunk/row/byte progress
    and an ETA (remaining chunks x the query's own chunk-latency p50).
    ``key`` is the trace id (``qid:<n>`` for an untraced query): two
    concurrent sessions of the same plan share name and fingerprint."""
    with _lock:
        live = list(_progress.values())
    out = []
    for qm in sorted(live, key=lambda q: q.qid):
        with qm._lock:
            p = dict(qm.progress)
            h = qm.hists.get("engine.stream.chunk_latency_s")
            p50 = _hist_percentiles(h, (0.5,))["p50"] if h else None
            entry = {"qid": qm.qid, "name": qm.name,
                     "key": qm.trace_id or f"qid:{qm.qid}",
                     "fingerprint": qm.fingerprint,
                     "trace_id": qm.trace_id,
                     "wall_s": round(time.perf_counter() - qm.t0, 6), **p}
        remaining = p["chunks_total"] - p["chunks_done"]
        entry["eta_s"] = (round(remaining * p50, 6)
                          if p50 is not None and remaining > 0 else None)
        out.append(entry)
    return out


# -- Prometheus text exposition ----------------------------------------------

def _prom_name(name: str) -> str:
    safe = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return f"srjt_{safe}"


def _prom_hist(name: str, h: dict, lines: list) -> None:
    lines.append(f"# TYPE {name} histogram")
    cum = 0
    for le, n in h.get("buckets", ()):
        cum += n
        lines.append(f'{name}_bucket{{le="{float(le):g}"}} {cum}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
    lines.append(f"{name}_sum {float(h['sum']):g}")
    lines.append(f"{name}_count {h['count']}")


def prometheus_text(snap: dict | None = None, prefix: str = "") -> str:
    """The counters/gauges/histograms registry in Prometheus text format
    (version 0.0.4).  ``snap`` takes a ``snapshot()``-shaped dict (an
    ``OP_METRICS`` reply carries its ``slo`` block); the default is this
    process's live registry plus in-flight progress and, with objectives
    declared, the SLO burn per source fingerprint."""
    if snap is None:
        snap = {"counters": tracing.counters_snapshot(prefix),
                "histograms": histograms_snapshot(prefix),
                "gauges": gauges_snapshot(prefix),
                "progress": progress_snapshot()}
        from . import blackbox
        if blackbox.slo_enabled():
            snap["slo"] = blackbox.slo_report()
    lines: list[str] = []
    for k in sorted(snap.get("counters") or {}):
        name = _prom_name(k)
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {snap['counters'][k]}")
    for k in sorted(snap.get("gauges") or {}):
        name = _prom_name(k)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(snap['gauges'][k]):g}")
    for k in sorted(snap.get("histograms") or {}):
        _prom_hist(_prom_name(k), snap["histograms"][k], lines)
    progress = snap.get("progress")
    if progress is not None:
        lines.append("# TYPE srjt_queries_in_flight gauge")
        lines.append(f"srjt_queries_in_flight {len(progress)}")
        for g in ("chunks_done", "chunks_total", "rows", "bytes"):
            name = f"srjt_query_progress_{g}"
            if progress:
                lines.append(f"# TYPE {name} gauge")
                for e in progress:
                    lines.append(f'{name}{{qid="{e["qid"]}",'
                                 f'name="{e["name"]}"}} {e[g]}')
    slo = snap.get("slo") or {}
    if slo.get("enabled"):
        if slo.get("default_ms") is not None:
            lines.append("# TYPE srjt_slo_default_objective_ms gauge")
            lines.append("srjt_slo_default_objective_ms "
                         f"{float(slo['default_ms']):g}")
        entries = slo.get("entries") or []
        for g in ("objective_ms", "runs", "breaches", "errors",
                  "worst_ms", "burn_rate"):
            if not entries:
                break
            name = f"srjt_slo_{g}"
            lines.append(f"# TYPE {name} gauge")
            for e in entries:
                lines.append(f'{name}{{fingerprint="{e["fingerprint"]}"}} '
                             f"{float(e[g]):g}")
    return "\n".join(lines) + "\n"


def snapshot(prefix: str = "") -> dict:
    """The full export body: counters + histograms + gauges + queries."""
    return {"counters": tracing.counters_snapshot(prefix),
            "histograms": histograms_snapshot(prefix),
            "gauges": gauges_snapshot(prefix),
            "queries": recent_summaries()}


def reset(prefix: str = "") -> None:
    """Zero histograms/gauges under ``prefix``; a full reset (empty
    prefix) also drops the recent-query window."""
    with _lock:
        for k in [k for k in _hists if k.startswith(prefix)]:
            del _hists[k]
        for k in [k for k in _gauges if k.startswith(prefix)]:
            del _gauges[k]
        if not prefix:
            _recent.clear()


def restore(hists: dict | None = None, gauges: dict | None = None,
            prefix: str = "") -> None:
    """Put back a ``histograms_snapshot``/``gauges_snapshot`` pair taken
    before ``reset(prefix)``."""
    with _lock:
        for k in [k for k in _hists if k.startswith(prefix)]:
            del _hists[k]
        for k in [k for k in _gauges if k.startswith(prefix)]:
            del _gauges[k]
        for k, d in (hists or {}).items():
            _hists[k] = _hist_load(d)
        _gauges.update(gauges or {})
