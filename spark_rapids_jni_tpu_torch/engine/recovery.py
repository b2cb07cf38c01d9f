"""Query-level recovery policy: degradation ladder and cancellation.

The port of ``spark_rapids_jni_tpu/engine/recovery.py``.  The executor
threads one :class:`RecoveryPolicy` through every streaming loop.  It owns
two behaviours, each bounded and each counted (transient failures retry at
their own sites through ``utils.errors.retry_call``):

1. **Degradation ladder**: resource exhaustion (``torch.cuda.
   OutOfMemoryError`` and the other allocation failures ``classify`` maps
   to ``resource``) is never blind-retried; the fused streaming aggregate
   steps down to the interpreted per-chunk path instead, counted as
   ``engine.degraded`` / ``engine.degraded.<step>`` and recorded on the
   query's outcome.
2. **Cancellation**: a ``CancelToken`` (``config.query_timeout_s`` or the
   caller's) checked at chunk boundaries and polled by the prefetch
   producer.

3. **Retry**: ``retry`` runs an exchange dispatch under
   ``utils.errors.retry_call`` (transient failures only, bounded, backed
   off).

The JAX package's session scheduling (``session.gate``, the session memory
budget and the neighbour-pressure retry) and its flight-recorder calls are
not ported yet (ROADMAP queue 1 item 5): a policy here has no session, so
``charge`` is a no-op and ``oom_retry_first`` always answers no, so an
out-of-memory error (``torch.cuda.OutOfMemoryError``) steps the ladder
down at once.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from ..utils import metrics
from ..utils.config import config
from ..utils.errors import (CancelToken, QueryCancelledError,
                            QueryTimeoutError, classify,
                            is_resource_exhausted, retry_call)

__all__ = ["RecoveryPolicy", "CancelToken", "QueryCancelledError",
           "QueryTimeoutError", "query_cancel_token"]


class RecoveryPolicy:
    """Per-query degradation policy + cancellation token carrier."""

    __slots__ = ("cancel", "degradations")

    def __init__(self, cancel: Optional[CancelToken] = None):
        self.cancel = cancel
        self.degradations: list[dict] = []

    def retry(self, site: str, fn: Callable):
        """Run ``fn``, retrying transient failures (bounded, backed off)."""
        return retry_call(fn, site, cancel=self.cancel)

    def checkpoint(self) -> None:
        """Chunk-boundary cancellation/deadline check."""
        if self.cancel is not None:
            self.cancel.check()

    def charge(self, nbytes: int) -> None:
        """Charge a chunk's bytes against the session budget: no sessions
        in the port yet, so nothing to charge."""

    def can_degrade(self, exc: BaseException) -> bool:
        """Only resource exhaustion walks the ladder."""
        return is_resource_exhausted(exc)

    def oom_retry_first(self, site: str, exc: BaseException) -> bool:
        """Should this out-of-memory error retry the same rung once before
        degrading?  Only a query of a session still within its own budget
        earns that (the pressure was a neighbour's); the port has no
        sessions yet, so it always degrades at once."""
        return False

    def degrade(self, step: str, exc: BaseException,
                stats: Optional[dict] = None) -> None:
        """Record one ladder step: count, log, stamp the query outcome."""
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
        logging.getLogger(__name__).warning(
            "degraded (%s) after %s: %s", step, kind, exc)


def query_cancel_token() -> Optional[CancelToken]:
    """A deadline token when ``config.query_timeout_s`` is set, else None."""
    if config.query_timeout_s > 0:
        return CancelToken(config.query_timeout_s)
    return None
