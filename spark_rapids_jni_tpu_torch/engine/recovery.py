"""Query-level recovery policy: retry, degradation ladder, cancellation,
and the query's scheduling session.

The port of ``spark_rapids_jni_tpu/engine/recovery.py``.  The executor
threads one :class:`RecoveryPolicy` through every streaming loop.  It owns
three behaviours, each bounded and each counted:

1. **Retry**: transient failures (kind ``transient`` in utils/errors.py)
   retry per site with exponential backoff and deterministic jitter, at
   most ``config.retry_max`` times.  Counted as ``engine.retries`` /
   ``engine.retries.<site>``.
2. **Degradation ladder**: resource exhaustion (``torch.cuda.
   OutOfMemoryError`` and the other allocation failures ``classify`` maps
   to ``resource``, injected ones included) is never blind-retried; the
   executor steps down instead, each rung counted as ``engine.degraded`` /
   ``engine.degraded.<step>``, recorded on the query's outcome and in the
   flight recorder, with a post-mortem bundle:
   - exchange: full capacity -> halved chunk capacity -> spilled shuffle
     (``parallel/spill.py``) -> passthrough;
   - fused streaming aggregate: segments -> the interpreted per-chunk path.
3. **Cancellation**: a ``CancelToken`` (``config.query_timeout_s`` or the
   bridge's ``OP_CANCEL``) checked at chunk boundaries and polled by the
   prefetch producer.

With a :class:`~.scheduler.QuerySession` attached (the bridge's
``PLAN_EXECUTE``), every chunk boundary is also a fair-share scheduling
point (``session.gate()``), chunk bytes charge the session's budget, and
the OOM ladder consults that budget first: a session within its own budget
that runs out of memory is feeling a neighbour's pressure and retries the
same rung once (``oom_retry_first``) instead of being degraded for
someone else's allocation.

Over a group of ranks (``parallel/ranks.py``) no rank raises a
cancellation alone: another rank would wait for it in a collective until
the group's timeout.  The token is the group's.  Every chunk boundary
and every gather (``checkpoint``) is one reduction of each
rank's cancel and expiry flags over the host group, with no card sync,
and every rank raises the same typed error at the same boundary.  A rank
whose chunk loop ends first votes on (``finish``) until every rank's has
ended, so ranks that read different numbers of chunks stay in step.  The
session's remaining budget is the group's minimum.

Plans over a group share one turn (``bridge/ranked.py``): only the plan
that holds it issues device work and collectives on a rank.  The votes
are where the turn changes hands, in place of the fair-share gate: rank
0's row of each vote carries its scheduler's choice (``Scheduler.pick``),
every rank hands the turn to the plan it names, and the voting plan waits
until the turn comes back before its next chunk.  A plan whose token
tripped while it waited is named with its error, and every rank raises
that error together when it resumes.  A plan that has the group to itself
(no seat: ``Ranks.turn`` None) votes without a handoff.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from ..utils import metrics
from ..utils.config import config
from ..utils.errors import (CancelToken, QueryCancelledError,
                            QueryTimeoutError, classify,
                            is_resource_exhausted, retry_call)

_log = logging.getLogger(__name__)

#: an unbudgeted rank's vote in the group's least remaining budget
_NO_BUDGET = 1 << 62

__all__ = ["RecoveryPolicy", "CancelToken", "QueryCancelledError",
           "QueryTimeoutError", "query_cancel_token"]


class RecoveryPolicy:
    """Per-query retry/degradation policy + cancellation token carrier."""

    __slots__ = ("cancel", "session", "degradations", "_oom_retries",
                 "ranks", "group_cancel")

    def __init__(self, cancel: Optional[CancelToken] = None, session=None,
                 ranks=None):
        from ..parallel import ranks as _ranks
        self.ranks = ranks if _ranks.active(ranks) else None
        # over ranks the token is only voted on (``_vote``): the readers and
        # retries below see no token, so none raises on one rank alone
        self.group_cancel = cancel if self.ranks is not None else None
        self.cancel = cancel if self.ranks is None else None
        self.session = session
        self.degradations: list[dict] = []
        self._oom_retries: set[str] = set()

    # -- retry ---------------------------------------------------------------

    def retry(self, site: str, fn: Callable):
        """Run ``fn``, retrying transient failures (bounded, backed off by
        ``config.retry_max`` and ``config.retry_backoff_s``)."""
        return retry_call(fn, site, cancel=self.cancel)

    # -- cancellation --------------------------------------------------------

    def checkpoint(self) -> None:
        """Chunk-boundary cancellation/deadline check — and, with a
        session attached, the fair-share scheduling point (no-op when
        untokened and unscheduled).  Over ranks: the group's vote, at
        which the group's turn may pass to another plan and back."""
        if self.ranks is not None:
            self._vote(1)
            return
        if self.cancel is not None:
            self.cancel.check()
        if self.session is not None:
            self.session.gate()

    def finish(self) -> None:
        """The end of a chunk loop: over ranks, vote "done" until every
        rank's loop has ended; nothing without a group."""
        if self.ranks is not None:
            while self._vote(0):
                pass

    def _vote(self, active: int) -> int:
        """One host-group reduction of every rank's (active, cancelled,
        expired) flags; raises the typed cancellation on every rank when
        any rank's token tripped, else returns how many ranks are still
        active.  With a seat at the group's turn the vote also carries
        rank 0's handoff, and returns once the turn is this plan's
        again."""
        from ..parallel import ranks as _ranks
        tok = self.group_cancel
        row = [active, tok is not None and tok.cancelled,
               tok is not None and tok.expired]
        seat = self.ranks.turn
        votes = _ranks.host_gather_ints(row, self.ranks) if seat is None \
            else seat.vote(row)
        if any(v[1] or v[2] for v in votes):
            if tok is not None:
                tok.check()  # this rank's own token: its own message
            if any(v[1] for v in votes):
                raise QueryCancelledError(
                    "query cancelled: cancelled on rank "
                    f"{next(r for r, v in enumerate(votes) if v[1])}")
            raise QueryTimeoutError("query deadline exceeded")
        return sum(v[0] for v in votes)

    # -- session memory budget -----------------------------------------------

    def charge(self, nbytes: int) -> None:
        """Charge a chunk's bytes against the session budget (no-op
        without a session) — called from the executor's existing
        ``table_nbytes`` sites, so tracking adds no device syncs."""
        if self.session is not None:
            self.session.charge(nbytes)

    def session_budget_remaining(self) -> Optional[int]:
        """Remaining session budget in bytes; ``None`` = unbudgeted.  Over
        ranks the group's least (only rank 0 holds the session), so every
        rank sizes the same passes from it."""
        rem = None if self.session is None else \
            self.session.budget_remaining()
        if self.ranks is None:
            return rem
        from ..parallel import ranks as _ranks
        low = _ranks.host_min(_NO_BUDGET if rem is None else int(rem),
                              self.ranks)
        return None if low == _NO_BUDGET else low

    # -- degradation ---------------------------------------------------------

    def can_degrade(self, exc: BaseException) -> bool:
        """Only resource exhaustion walks the ladder; transient failures
        are the retry layer's job and cancellation/fatal propagate."""
        return is_resource_exhausted(exc)

    def oom_retry_first(self, site: str, exc: BaseException) -> bool:
        """Should this OOM retry the SAME rung once before degrading?

        The pre-concurrency ladder consulted only the global memory
        picture, so ANY resource exhaustion stepped the query down —
        even when the allocation pressure came from a neighboring
        session's transient spike.  With a session budget attached the
        call is better informed: a session still WITHIN its own budget
        did not earn this OOM, so it deserves one same-rung retry after
        the neighbor's chunk retires (counted as
        ``engine.sched.neighbor_pressure``).  A session over its budget
        — or an unbudgeted/unscheduled query — degrades immediately,
        exactly the old behavior.  One retry per site per query: if the
        pressure persists, the ladder proceeds.

        Over ranks only rank 0 holds the session, so every rank in the
        ladder takes rank 0's answer (one host gather): a fault that
        every rank sees at the same site steps every rank the same way."""
        retry = self._retry_first(site, exc)
        if self.ranks is None:
            return retry
        from ..parallel import ranks as _ranks
        return bool(_ranks.host_gather_ints([retry], self.ranks)[0][0])

    def _retry_first(self, site: str, exc: BaseException) -> bool:
        """This rank's own answer to ``oom_retry_first``."""
        if self.session is None or not is_resource_exhausted(exc):
            return False
        if self.session.over_budget() or self.session.budget_bytes <= 0:
            return False
        if site in self._oom_retries:
            return False
        self._oom_retries.add(site)
        metrics.count("engine.sched.neighbor_pressure")
        from ..utils import blackbox
        blackbox.record("neighbor_pressure", site=site,
                        trace_id=self.session.trace_id,
                        peak_chunk_bytes=self.session.peak_chunk_bytes,
                        budget_bytes=self.session.budget_bytes)
        _log.warning(
            "OOM at %s within session budget (%d/%d peak bytes): "
            "retrying same rung once before degrading", site,
            self.session.peak_chunk_bytes, self.session.budget_bytes)
        return True

    def degrade(self, step: str, exc: BaseException,
                stats: Optional[dict] = None) -> None:
        """Record one ladder step: count, log, stamp query outcome.

        Also feeds the flight recorder and writes a post-mortem bundle
        (utils/blackbox.py): a query that gave up capacity is a serving
        incident worth a durable record even when it ultimately succeeds.
        Bundle dedup is per query execution, so a degradation followed by
        more rungs — or the final error — still yields exactly one."""
        kind, _ = classify(exc)
        metrics.count("engine.degraded")
        metrics.count(f"engine.degraded.{step}")
        rec = {"step": step, "cause": kind, "error": str(exc)[:200]}
        self.degradations.append(rec)
        if stats is not None:
            stats.setdefault("degradations", []).append(rec)
        qm = metrics.current()
        if qm is not None:
            qm.degrade(step, kind)
        from ..utils import blackbox
        blackbox.record("degrade", step=step, kind=kind,
                        msg=str(exc)[:200])
        blackbox.post_mortem(f"degrade:{step}", qm=qm)
        _log.warning("degraded (%s) after %s: %s", step, kind, exc)


def query_cancel_token() -> Optional[CancelToken]:
    """A deadline token when ``config.query_timeout_s`` is set, else None."""
    if config.query_timeout_s > 0:
        return CancelToken(config.query_timeout_s)
    return None
