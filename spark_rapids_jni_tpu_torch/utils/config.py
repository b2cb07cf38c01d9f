"""Engine settings: the fields of the JAX package's ``Config`` that the
engine reads, with the same defaults but one: ``device_decode`` follows the
target (the device route on a card, the host route on the CPU) unless a
caller pins it, where the JAX package's defaults to the host route.

The JAX package reads each field from an ``SRJT_*`` environment variable at
import; the port reads no environment.  Callers set fields on the
module-level ``config`` (tests and tools wrap that in a context manager, as
the fuzzer's ``_flags`` does), and every reader looks the value up at the
time of use.

| field | default | what it selects |
|---|---|---|
| ``fuse``            | ``True``  | Filter/Project/Aggregate chains run as compiled segments |
| ``prefetch``        | ``1``     | chunked-scan pipeline depth (0 = serial) |
| ``fuse_join``       | ``True``  | scan-independent-build joins join the streamed chunk segment |
| ``topk``            | ``True``  | streaming top-k for ``TopK`` plans |
| ``plan_cache``      | ``128``   | ``PlanCache`` capacity (entries) |
| ``segment_cache``   | ``256``   | compiled-segment cache capacity (entries) |
| ``build_cache``     | ``32``    | prepared-join-build cache capacity (entries) |
| ``result_cache``    | ``0``     | result-set cache capacity (0 = off) |
| ``metrics``         | ``True``  | query-scoped metrics (``utils/metrics.py``) |
| ``verify``          | ``True``  | static plan verification in ``optimize`` |
| ``device_decode``   | ``None``  | streamed scans decode pages on the device: ``None`` on a card target, ``True``/``False`` pin a route |
| ``shards``          | ``None``  | shards of the engine's mesh over every rank: ``None`` is one a rank (1 without a group of ranks, ``parallel/ranks.py``) |
| ``broadcast_rows``  | ``100000``| distributed planning replicates a join build of at most this many estimated rows |
| ``spill_dir``       | ``None``  | host directory of the spilled exchange's buffers (``None``: host memory) |
| ``query_timeout_s`` | ``0.0``   | cooperative per-query deadline (0 = none) |
| ``roofline_gbps``   | ``0.0``   | device bandwidth ceiling for explain's ``roofline_frac`` (0 = none) |
| ``aqe``             | ``False`` | adaptive execution (``engine/adaptive.py``): broadcast flip, skew split, profile-warmed planning |
| ``aqe_skew``        | ``4.0``   | measured exchange skew (max/mean destination rows) above which the hot-key split fires |
| ``aqe_broadcast_rows`` | ``-1`` | runtime broadcast-flip threshold in rows (-1 = follow ``broadcast_rows``) |
| ``fuse_exchange``   | ``False`` | the partial-agg -> hash Exchange -> final-agg sandwich runs as one fused stage |
| ``fuse_groups``     | ``4096``  | the fused stage's static per-shard group budget (power-of-two bucketed) |
| ``profile_dir``     | ``""``    | query-profile store directory (``utils/profile.py``; empty = off) |
| ``profile_cap``     | ``512``   | profile-store ring capacity (files) |
| ``timeline``        | ``False`` | in-process event timeline (``utils/timeline.py``) |
| ``timeline_cap``    | ``16384`` | timeline ring capacity (events) |
| ``faults``          | ``""``    | fault-injection spec ``site:nth[:kind],...`` (``utils/faults.py``; empty = every seam a no-op) |
| ``retry_max``       | ``3``     | retries of a transient failure a site (``engine/recovery.py``) |
| ``retry_backoff_s`` | ``0.01``  | first retry backoff in seconds (doubles an attempt, deterministic jitter) |
| ``bridge_timeout_s`` | ``60.0`` | per-op socket deadline of the bridge client and server (0 = none) |
| ``mem_debug``       | ``False`` | ``MemoryScope`` reports at exit and the chunked reader's census checkpoints (``utils/memory.py``) |
| ``blackbox``        | ``True``  | the flight recorder's ring (``utils/blackbox.py``) |
| ``blackbox_dir``    | ``""``    | post-mortem bundle directory (empty = ring only) |
| ``blackbox_cap``    | ``512``   | flight-recorder ring capacity (events) |
| ``slo_ms``          | ``""``    | latency objectives ``default_ms[,fp12=ms,...]``, evaluated from the profile store |
| ``trace_id``        | ``""``    | inherited trace id (minted per client or query when empty) |
| ``sched``           | ``True``  | the scheduler (``engine/scheduler.py``) admits every bridge ``PLAN_EXECUTE`` |
| ``max_sessions``    | ``8``     | concurrent admitted ``PLAN_EXECUTE`` sessions; arrivals past it queue |
| ``admission_queue_s`` | ``5.0`` | longest wait in the admission queue before a query is shed |
| ``admission_burn``  | ``0.9``   | SLO burn rate at or above which a saturated server sheds a fingerprint at once |
| ``session_budget_bytes`` | ``0`` | a session's device-memory budget, charged at chunk boundaries (0 = none) |

The bridge server (``bridge/server.py``) sets fields from its
``--set field=value`` arguments through ``parse_setting``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional


@dataclass
class Config:
    fuse: bool = True
    prefetch: int = 1
    fuse_join: bool = True
    topk: bool = True
    plan_cache: int = 128
    segment_cache: int = 256
    build_cache: int = 32
    result_cache: int = 0
    metrics: bool = True
    verify: bool = True
    device_decode: Optional[bool] = None
    shards: Optional[int] = None
    broadcast_rows: int = 100_000
    spill_dir: Optional[str] = None
    query_timeout_s: float = 0.0
    roofline_gbps: float = 0.0
    aqe: bool = False
    aqe_skew: float = 4.0
    aqe_broadcast_rows: int = -1
    fuse_exchange: bool = False
    fuse_groups: int = 4096
    profile_dir: str = ""
    profile_cap: int = 512
    timeline: bool = False
    timeline_cap: int = 16384
    faults: str = ""
    retry_max: int = 3
    retry_backoff_s: float = 0.01
    bridge_timeout_s: float = 60.0
    mem_debug: bool = False
    blackbox: bool = True
    blackbox_dir: str = ""
    blackbox_cap: int = 512
    slo_ms: str = ""
    trace_id: str = ""
    sched: bool = True
    max_sessions: int = 8
    admission_queue_s: float = 5.0
    admission_burn: float = 0.9
    session_budget_bytes: int = 0


config = Config()


def parse_setting(text: str) -> tuple:
    """``"field=value"`` -> ``(field, value)`` typed as the field's
    annotation (``bool`` reads 1/true/yes/on; an ``Optional`` field reads
    ``none`` as None).  Raises ``ValueError`` for an unknown field or a
    value of the wrong type."""
    name, sep, raw = text.partition("=")
    name, raw = name.strip(), raw.strip()
    kinds = {f.name: f.type for f in fields(Config)}
    if not sep or name not in kinds:
        raise ValueError(f"bad setting {text!r}: want field=value with a "
                         f"field of {sorted(kinds)}")
    kind = kinds[name]
    if "Optional" in kind and raw.lower() == "none":
        return name, None
    if "bool" in kind:
        low = raw.lower()
        if low not in ("1", "true", "yes", "on", "0", "false", "no", "off"):
            raise ValueError(f"bad boolean for {name}: {raw!r}")
        return name, low in ("1", "true", "yes", "on")
    if "int" in kind:
        return name, int(raw)
    if "float" in kind:
        return name, float(raw)
    return name, raw
