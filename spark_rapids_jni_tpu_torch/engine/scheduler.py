"""Multi-tenant query scheduler: admission control, fair-share
interleaving and per-session memory budgets.

The port of ``spark_rapids_jni_tpu/engine/scheduler.py``: the same policy,
constants and counters.  Everything below the bridge is concurrency-ready
(fingerprints are session-agnostic, the caches are locked LRUs, trace ids
join a query's spans, profiles and bundles across connections); this
module decides WHO gets on the device, WHEN their chunks run, and HOW MUCH
memory each tenant may pin.  Three pieces, one ``Scheduler`` facade
(``SCHEDULER``):

**SLO-aware admission.**  ``admit()`` bounds live sessions at
``config.max_sessions``.  Arrivals past the bound queue on a condition
variable up to ``config.admission_queue_s``, except fingerprints whose
windowed SLO burn rate (``blackbox.slo_burn_for``, fed by the profile
store) is already at or over ``config.admission_burn``: those are shed at
once when the server is saturated, since queueing a query that has burned
its error budget only adds queue delay for tenants that still have budget.
A shed raises the typed ``AdmissionRejectedError`` (the bridge client
re-raises it with its trace id and bundle pointer) and records
``admission.shed`` in the flight recorder.

**Fair-share interleaving.**  Admitted queries execute as cooperative
chunk streams; every chunk boundary runs ``RecoveryPolicy.checkpoint()``,
which calls ``QuerySession.gate()``: deficit round-robin.  A session spends
one credit a chunk and blocks once its credits run out, until every live
session has drained its round and credits replenish at ``quantum x
weight`` (bounded waits; a round is forced after ``_FORCE_ROUND_S`` even if
a credit holder is stalled in a long device op, so it cannot deadlock).
Weight follows the SLO class (``weight_for_objective``): a point query with
a tight objective gets more chunks a round than a bulk scan, so a scan
cannot starve it.  With one live session the gate is a no-op.

Over a group of ranks (``bridge/ranked.py``) plans do not block at the
gate: the group has one turn, and rank 0 passes it from plan to plan at
the points where every rank meets (the chunk-boundary votes and a plan's
closing report).  There ``pick`` names who holds the turn next, without
blocking, by the same deficit-round-robin step (``_spend``) as ``gate``:
the holder keeps the turn while it has credits, a waiting session with
credits takes it when the holder's are spent, and a round starts once
every contender's are.

**Per-session memory budgets.**  ``config.session_budget_bytes`` caps a
session's largest chunk working set (charged at the executor's existing
``table_nbytes`` sites: no added device sync).  The spilled-exchange rung
clamps its ``hbm_budget_bytes`` to the session's remaining budget, and the
OOM ladder asks ``over_budget()`` before degrading: a session within its
own budget that runs out of device memory is feeling a neighbour's
allocation, so it retries the same rung once
(``engine.sched.neighbor_pressure``, engine/recovery.py).

Every session shares the process's current CUDA stream: the scheduler
orders chunks, not streams.  Counters: ``engine.sched.*``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from ..utils import blackbox, metrics
from ..utils.config import config
from ..utils.errors import AdmissionRejectedError

#: chunks per weight unit per round — small enough that a point query
#: waits at most a few chunks behind a scan, large enough to amortize
#: the condvar handoff
_QUANTUM = 4
#: bounded gate wait between deficit re-checks (seconds)
_GATE_WAIT_S = 0.05
#: force a replenish round after this long even if some credit-holding
#: session never reached a chunk boundary (stalled in a device op) —
#: bounds worst-case starvation and makes deadlock structurally
#: impossible
_FORCE_ROUND_S = 0.25
#: admission burn-rate lookups hit the on-disk profile store; cache the
#: report briefly so a shed storm doesn't become a stat storm
_BURN_TTL_S = 1.0


def weight_for_objective(objective_ms) -> int:
    """Fair-share weight from an SLO objective: chunks per round scale
    inversely with the latency target, clamped to [1, 8].  No objective
    (or a slack one) means weight 1 — bulk work shares evenly."""
    if not objective_ms or objective_ms <= 0:
        return 1
    return max(1, min(8, int(2000.0 / float(objective_ms))))


class QuerySession:
    """One admitted query's scheduling identity: fair-share credits plus
    the device-memory budget ledger.  Created by ``Scheduler.admit`` and
    threaded to the executor via ``RecoveryPolicy(session=...)``."""

    __slots__ = ("sid", "trace_id", "fingerprint", "source_fingerprint",
                 "objective_ms", "weight", "budget_bytes",
                 "peak_chunk_bytes", "charged_chunks", "credits",
                 "queued_s", "_sched", "_lock")

    def __init__(self, sid: int, sched: "Scheduler", trace_id: str = "",
                 fingerprint: str = "", source_fingerprint: str = "",
                 objective_ms=None, budget_bytes: Optional[int] = None):
        self.sid = sid
        self.trace_id = trace_id
        self.fingerprint = fingerprint
        self.source_fingerprint = source_fingerprint
        self.objective_ms = objective_ms
        self.weight = weight_for_objective(objective_ms)
        self.budget_bytes = (config.session_budget_bytes
                             if budget_bytes is None else int(budget_bytes))
        self.peak_chunk_bytes = 0
        self.charged_chunks = 0
        self.credits = _QUANTUM * self.weight
        self.queued_s = 0.0
        self._sched = sched
        self._lock = threading.Lock()

    # -- memory budget ----------------------------------------------------

    def charge(self, nbytes: int) -> None:
        """Record a chunk's bytes against the session working set.

        Tracks the PEAK single-chunk footprint — the quantity the budget
        bounds: chunk buffers are transient, so the steady-state device
        claim of a streaming session is its largest chunk, not the sum."""
        with self._lock:
            self.charged_chunks += 1
            if nbytes > self.peak_chunk_bytes:
                self.peak_chunk_bytes = nbytes

    def over_budget(self) -> bool:
        """True when a budget is set and the session's peak chunk has
        exceeded it — this session earned its own OOM; degrade it."""
        return self.budget_bytes > 0 and \
            self.peak_chunk_bytes > self.budget_bytes

    def budget_remaining(self) -> Optional[int]:
        """Bytes of budget headroom (``None`` = unlimited); the spilled
        exchange clamps its HBM budget to this."""
        if self.budget_bytes <= 0:
            return None
        return max(0, self.budget_bytes - self.peak_chunk_bytes)

    # -- fair share -------------------------------------------------------

    def gate(self) -> None:
        """Chunk-boundary scheduling point (RecoveryPolicy.checkpoint)."""
        self._sched.gate(self)

    def release(self) -> None:
        self._sched.release(self)

    def snapshot(self) -> dict:
        with self._lock:
            return {"sid": self.sid, "trace_id": self.trace_id,
                    "fingerprint": self.fingerprint[:12],
                    "weight": self.weight, "credits": self.credits,
                    "budget_bytes": self.budget_bytes,
                    "peak_chunk_bytes": self.peak_chunk_bytes,
                    "charged_chunks": self.charged_chunks}


class Scheduler:
    """Admission controller + deficit-round-robin interleaver.

    All shared state (the live-session table and every session's
    credits) is guarded by one condition variable ``_cv`` — admission
    waits, gate waits and round replenishes are all wakeups on it."""

    def __init__(self):
        self._cv = threading.Condition()
        self._live: dict = {}          # sid -> QuerySession (under _cv)
        self._ids = itertools.count(1)
        self._rounds = 0
        self.admitted = 0
        self.queued = 0
        self.shed = 0
        self._burn_cache: dict = {}    # fp12 -> burn rate (under _cv)
        self._burn_stamp = 0.0

    # -- admission --------------------------------------------------------

    def _burn_rate(self, source_fingerprint: str):
        """Cached ``blackbox.slo_burn_for`` (lock held) — refreshed at
        most every ``_BURN_TTL_S`` so saturation doesn't stat-storm the
        profile store."""
        now = time.monotonic()
        if now - self._burn_stamp > _BURN_TTL_S:
            self._burn_cache = {}
            self._burn_stamp = now
        fp = (source_fingerprint or "")[:12]
        if fp not in self._burn_cache:
            try:
                self._burn_cache[fp] = blackbox.slo_burn_for(fp)
            except Exception:  # noqa: BLE001 — admission must not crash
                self._burn_cache[fp] = None
        return self._burn_cache[fp]

    def _shed(self, reason: str, fingerprint: str, trace_id: str,
              waited_s: float, live: int):
        """Reject at admission (lock held): count, record, raise typed."""
        self.shed += 1
        metrics.count("engine.sched.shed")
        blackbox.record("admission.shed", reason=reason,
                        fingerprint=fingerprint[:12], trace_id=trace_id,
                        waited_s=round(waited_s, 4), live=live)
        raise AdmissionRejectedError(
            f"admission rejected ({reason}): {live}/{config.max_sessions} "
            f"sessions live after {waited_s:.2f}s queued")

    def admit(self, fingerprint: str = "", source_fingerprint: str = "",
              trace_id: str = "") -> QuerySession:
        """Block until a session slot frees (bounded), or shed.

        Saturated + burning fingerprint => immediate shed; saturated
        otherwise => queue up to ``config.admission_queue_s`` then shed."""
        t0 = time.monotonic()
        deadline = t0 + config.admission_queue_s
        src = source_fingerprint or fingerprint
        queued_counted = False
        with self._cv:
            while len(self._live) >= config.max_sessions:
                burn = self._burn_rate(src)
                if burn is not None and burn >= config.admission_burn:
                    self._shed(f"slo-burn {burn:.2f}", fingerprint,
                               trace_id, time.monotonic() - t0,
                               len(self._live))
                if not queued_counted:
                    queued_counted = True
                    self.queued += 1
                    metrics.count("engine.sched.queued")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._shed("queue-timeout", fingerprint, trace_id,
                               time.monotonic() - t0, len(self._live))
                self._cv.wait(min(remaining, _GATE_WAIT_S))
            session = QuerySession(
                next(self._ids), self, trace_id=trace_id,
                fingerprint=fingerprint,
                source_fingerprint=src,
                objective_ms=blackbox.slo_objective_for(src))
            session.queued_s = time.monotonic() - t0
            self._live[session.sid] = session
            self.admitted += 1
            metrics.count("engine.sched.admitted")
            metrics.gauge_set("engine.sched.live", len(self._live))
            if session.queued_s > 0.001:
                metrics.observe("engine.sched.queue_wait_s",
                                session.queued_s)
            return session

    def release(self, session: QuerySession) -> None:
        with self._cv:
            self._live.pop(session.sid, None)
            metrics.gauge_set("engine.sched.live", len(self._live))
            self._cv.notify_all()

    # -- deficit round-robin ----------------------------------------------

    def _new_round(self, members):
        """Replenish ``members``' credits (lock held)."""
        self._rounds += 1
        metrics.count("engine.sched.rounds")
        for s in members:
            s.credits = _QUANTUM * s.weight
        self._cv.notify_all()

    def _spend(self, session: QuerySession, members) -> bool:
        """The deficit-round-robin step (lock held): spend one of
        ``session``'s credits, first starting a round when every one of
        ``members`` has spent its own; False when ``session`` has none
        left while another member still has some."""
        if session.credits <= 0:
            if any(m.credits > 0 for m in members):
                return False
            self._new_round(members)
        session.credits -= 1
        return True

    def gate(self, session: QuerySession) -> None:
        """Spend one chunk credit; block while the session's round is
        drained and others still hold credits.  Bounded waits plus the
        ``_FORCE_ROUND_S`` forced replenish keep this deadlock-free even
        when a credit holder stalls off a chunk boundary."""
        with self._cv:
            if len(self._live) <= 1:
                return  # single tenant: no contention, no bookkeeping
            t0 = None
            while not self._spend(session, self._live.values()):
                if session.sid not in self._live:
                    return  # released concurrently (cancel path)
                now = time.monotonic()
                if t0 is None:
                    t0 = now
                if now - t0 >= _FORCE_ROUND_S:
                    self._new_round(self._live.values())
                else:
                    self._cv.wait(_GATE_WAIT_S)
            if t0 is not None:
                metrics.observe("engine.sched.gate_wait_s",
                                time.monotonic() - t0)

    def pick(self, holding: Optional[QuerySession],
             waiting: list) -> Optional[QuerySession]:
        """The group's gate: who holds the group's turn next.  ``holding``
        holds it and runs on (None when its plan has ended); ``waiting``
        wait for it, the one that waited longest first.  Never blocks:
        the holder keeps the turn while it has a credit, else the first
        waiting session with one takes it (``engine.sched.handoffs``),
        and when every contender's round is spent a new one starts.  The
        session named spends one credit: the chunk it runs next."""
        members = ([] if holding is None else [holding]) + list(waiting)
        if len(members) <= 1:
            return members[0] if members else None  # no contention
        with self._cv:
            nxt = next(s for s in members if self._spend(s, members))
            if nxt is not holding:
                metrics.count("engine.sched.handoffs")
            return nxt

    # -- introspection ----------------------------------------------------

    def live_count(self) -> int:
        with self._cv:
            return len(self._live)

    def stats(self) -> dict:
        with self._cv:
            return {"live": len(self._live), "admitted": self.admitted,
                    "queued": self.queued, "shed": self.shed,
                    "rounds": self._rounds,
                    "max_sessions": config.max_sessions,
                    "sessions": [s.snapshot()
                                 for s in self._live.values()]}


#: process-wide scheduler (the bridge server's admission point)
SCHEDULER = Scheduler()
