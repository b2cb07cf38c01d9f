"""Plan, build and result caches of the engine.

The port of ``spark_rapids_jni_tpu/engine/cache.py``.  ``PlanCache`` maps
the fingerprint of a submitted (unoptimized) plan to a ``CompiledPlan``:
a repeat query skips optimization and reuses the same object, whose
segments are already in ``SEGMENT_CACHE``.  Hit/miss counts flow through
``utils.tracing`` counters (``engine.plan_cache.hit`` / ``.miss``) and
``stats()``.

``BUILD_CACHE`` holds prepared join build sides (``ops.join.PreparedBuild``:
build hash + stable sort) keyed by (join-node fingerprint, build
shape-class), so a streamed probe join hashes and sorts its dimension table
once per execution, and not at all on a repeat over a same-shaped build.

``ResultCache`` (off by default) serves a repeat plan over unchanged input
files (``data_version``) without executing it.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

from .. import device as _device
from ..utils import metrics
from ..utils.config import config
from .executor import execute
from .optimizer import optimize
from .plan import PlanNode, Scan


class CompiledPlan:
    """An optimized plan plus its execution entry point."""

    __slots__ = ("key", "plan", "optimized", "executions")

    def __init__(self, key: str, plan: PlanNode, optimized: PlanNode):
        self.key = key
        self.plan = plan
        self.optimized = optimized
        self.executions = 0

    def execute(self, stats: Optional[dict] = None, cancel=None,
                device=_device.DEFAULT, session=None, ranks=None):
        self.executions += 1
        return execute(self.optimized, stats=stats, cancel=cancel,
                       device=device, session=session, ranks=ranks)


class PlanCache:
    """LRU map: plan fingerprint → ``CompiledPlan`` (thread-safe).

    Capacity defaults to ``config.plan_cache``; evictions are recorded
    alongside hits/misses in both ``stats()`` and the tracing counter
    registry (``engine.plan_cache.eviction``).
    """

    def __init__(self, maxsize: Optional[int] = None):
        self._maxsize = None if maxsize is None else int(maxsize)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, CompiledPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def maxsize(self) -> int:
        # resolved per use, so a change to config.plan_cache retunes
        # live caches
        return self._maxsize if self._maxsize is not None \
            else config.plan_cache

    def holds(self, plan: PlanNode) -> bool:
        """Whether ``get(plan)`` would hit (counts nothing)."""
        with self._lock:
            return plan.fingerprint() in self._entries

    def get(self, plan: PlanNode, ranks=None,
            hit: Optional[bool] = None) -> CompiledPlan:
        """The plan's ``CompiledPlan``, optimized on a miss.

        Over ``ranks`` (a group of ``parallel/ranks.py``) every rank calls
        ``get`` with rank 0's decision ``hit`` (its ``holds``), and a miss
        is ``optimize(plan, ranks=)``, a collective in which rank 0 plans.
        Every rank's cache sees the same calls in the same order, so rank
        0's hit is a hit on every rank."""
        from ..parallel import ranks as _ranks
        key = plan.fingerprint()
        ranked = _ranks.active(ranks)
        with self._lock:
            got = self._entries.get(key)
            if ranked:
                if hit and got is None:
                    raise RuntimeError(
                        f"plan cache of rank {ranks.rank} is out of step "
                        f"with rank 0's: no entry for {key[:12]}")
                got = got if hit else None
            if got is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.plan_cache.hit")
                return got
        # optimize outside the lock (reads file footers for schemas)
        compiled = CompiledPlan(key, plan, optimize(plan, ranks=ranks))
        with self._lock:
            racer = self._entries.get(key)
            if racer is not None and not ranked:
                # lost a concurrent-miss race: their entry
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.plan_cache.hit")
                return racer
            self.misses += 1
            metrics.count("engine.plan_cache.miss")
            self._entries[key] = compiled
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                metrics.count("engine.plan_cache.eviction")
            return compiled

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


class BuildCache:
    """LRU: (join fingerprint, build shape-class) -> ``PreparedBuild``.

    The join analog of ``SegmentCache``: the segment cache dedups compiled
    segments, this dedups the build-side prep (xxhash64 + stable sort)
    a streamed probe join would otherwise redo per chunk.  ``get`` is
    called once per chunk by the fused streaming loop — the first call
    misses and prepares, every later chunk (and every repeat execution
    with a same-shaped build) hits, so a stream of N chunks shows exactly
    ``hits == N - 1`` on a cold cache.  Counters flow through
    ``utils.tracing`` as ``engine.build_cache.{hit,miss,eviction}``;
    capacity from ``config.build_cache``.
    """

    def __init__(self, maxsize: Optional[int] = None):
        self._maxsize = None if maxsize is None else int(maxsize)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def maxsize(self) -> int:
        return self._maxsize if self._maxsize is not None \
            else config.build_cache

    def get(self, fingerprint: str, build_table, builder):
        """The prepared build for ``(fingerprint, shape_class(build))``,
        computing it via ``builder()`` on a miss."""
        from .segment import shape_class
        key = (fingerprint, shape_class(build_table))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.build_cache.hit")
                return hit
        prepared = builder()  # hash+sort outside the lock (device work)
        with self._lock:
            racer = self._entries.get(key)
            if racer is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.build_cache.hit")
                return racer
            self.misses += 1
            metrics.count("engine.build_cache.miss")
            self._entries[key] = prepared
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                metrics.count("engine.build_cache.eviction")
            return prepared

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


#: process-wide prepared-build cache (the streamed-join prep layer)
BUILD_CACHE = BuildCache()


def data_version(plan: PlanNode):
    """Freshness key for the result-set cache: the sorted
    ``(path, mtime_ns, size)`` tuple over every ``Scan`` leaf.

    A rewritten input file changes its mtime (and usually size), so the
    composite key ``(plan fingerprint, data_version)`` misses — the cache
    never serves stale rows; it only skips re-reading data that has not
    moved.  Returns ``None`` (uncacheable) when any input can't be
    stat'ed — a vanishing file should fail in the scan, not be masked by
    a stale cached result.
    """
    paths = set()
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, Scan):
            paths.add(n.path)
        stack.extend(n.children())
    version = []
    for p in sorted(paths):
        try:
            st = os.stat(p)
        except OSError:
            return None
        version.append((p, st.st_mtime_ns, st.st_size))
    return tuple(version)


class ResultCache:
    """LRU: (plan fingerprint, data version) -> completed result table.

    The fourth, and cheapest, cache layer: where ``PlanCache`` skips
    optimization and ``SegmentCache`` skips compilation, this skips the
    *execution*.  Off by default (``config.result_cache = 0``): serving
    deployments opt in, and plan-cache contract tests keep observing real
    executions.  Keys carry the input files' identity (``data_version``)
    so a repeat query is served only while its data is bit-identical on
    disk.  Counters ``engine.result_cache.{hit,miss,eviction}`` attribute
    per query like every other cache; capacity is entries, resolved per
    use.

    ``get``/``put`` are split (unlike the builder-callback caches)
    because the execution between them runs under the caller's session,
    cancel token and stats plumbing; a concurrent-miss race on ``put``
    keeps the first-stored result.
    """

    def __init__(self, maxsize: Optional[int] = None):
        self._maxsize = None if maxsize is None else int(maxsize)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def maxsize(self) -> int:
        return self._maxsize if self._maxsize is not None \
            else config.result_cache

    @property
    def enabled(self) -> bool:
        return self.maxsize > 0

    def get(self, fingerprint: str, version):
        """The cached result for ``(fingerprint, version)`` or ``None``;
        an unstattable ``version`` (None) never hits and never counts."""
        if version is None or not self.enabled:
            return None
        key = (fingerprint, version)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.result_cache.hit")
                return hit
            self.misses += 1
            metrics.count("engine.result_cache.miss")
            return None

    def put(self, fingerprint: str, version, result) -> None:
        if version is None or not self.enabled or result is None:
            return
        key = (fingerprint, version)
        with self._lock:
            if key in self._entries:  # concurrent miss: first store wins
                self._entries.move_to_end(key)
                return
            self._entries[key] = result
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                metrics.count("engine.result_cache.eviction")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


#: process-wide result-set cache (the skip-the-execution layer)
RESULT_CACHE = ResultCache()
