"""Device-memory accounting, observability and budgets (the RMM role).

The port of ``spark_rapids_jni_tpu/utils/memory.py``.  The reference
threads an ``rmm::mr::device_memory_resource*`` through every op so callers
control and observe allocation; here the allocator is PyTorch's CUDA
caching allocator, so control lives in the size-bounded entry points that
already exist (``convert_to_rows`` batch bytes, the chunked reader's pass
limit, shuffle capacities) and observability lives here:

- ``table_nbytes`` sums buffer metadata (``nbytes``), so the executor
  accounts bytes per plan node without a transfer or a sync;
- ``device_memory_stats`` is the allocator's own ``torch.cuda.memory_stats``
  (``{}`` for a CPU device, which has no allocator to ask);
  ``telemetry_snapshot`` is the per-query sample the metrics layer keeps;
- ``MemoryScope`` follows a scope's live allocator bytes and high-water
  mark at the checkpoints its caller passes through; with
  ``config.mem_debug`` set the chunked Parquet reader runs under one, and
  the scope prints its marks to stderr at exit (the ``RMM_LOGGING_LEVEL``
  analog).  Session budgets are the scheduler's (``engine/scheduler.py``).

All of it reads host-side allocator counters: no device sync.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import torch

from .. import device as _device
from .config import config


def column_nbytes(col) -> int:
    """Buffer bytes of one column (data + validity + offsets + children)."""
    total = 0
    for buf in (col.data, col.validity, col.offsets):
        if buf is not None:
            total += buf.nbytes
    for child in col.children:
        total += column_nbytes(child)
    return total


def table_nbytes(table) -> int:
    """Buffer bytes of a Table: the ``bytes_moved`` unit that
    ``engine.explain_analyze`` divides by wall time."""
    return sum(column_nbytes(c) for c in table.columns)


def device_memory_stats(device=_device.DEFAULT) -> dict:
    """The CUDA caching allocator's ``torch.cuda.memory_stats`` for
    ``device`` (``allocated_bytes.all.current``, ``.peak``, ...); ``{}``
    for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(dev))


def live_bytes(device=_device.DEFAULT) -> int:
    """Bytes the allocator holds for live tensors on ``device`` (0 on the
    CPU)."""
    return int(device_memory_stats(device).get(
        "allocated_bytes.all.current", 0))


def telemetry_snapshot(device) -> Optional[dict]:
    """``{"source": "runtime", "live_bytes", "peak_bytes"}`` from the CUDA
    caching allocator of ``device``, or ``None`` for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return {"source": "runtime",
            "live_bytes": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


@dataclass
class ScopeStats:
    name: str
    start_bytes: int = 0
    high_water_bytes: int = 0
    end_bytes: int = 0

    @property
    def delta_bytes(self) -> int:
        return self.end_bytes - self.start_bytes


class MemoryScope:
    """Scoped live-byte tracking: ``checkpoint()`` at a path's natural batch
    boundaries (where the reference would consult its memory resource)
    refreshes the high-water mark."""

    def __init__(self, name: str = "scope", device=_device.DEFAULT):
        self.stats = ScopeStats(name)
        self.device = device

    def __enter__(self) -> "MemoryScope":
        self.stats.start_bytes = live_bytes(self.device)
        self.stats.high_water_bytes = self.stats.start_bytes
        return self

    def checkpoint(self) -> int:
        live = live_bytes(self.device)
        if live > self.stats.high_water_bytes:
            self.stats.high_water_bytes = live
        return live

    def __exit__(self, *exc):
        self.stats.end_bytes = live_bytes(self.device)
        if self.stats.end_bytes > self.stats.high_water_bytes:
            self.stats.high_water_bytes = self.stats.end_bytes
        if config.mem_debug:
            s = self.stats
            print(f"[mem] {s.name}: start={s.start_bytes} "
                  f"high={s.high_water_bytes} end={s.end_bytes} "
                  f"delta={s.delta_bytes}", file=sys.stderr, flush=True)
        return False

