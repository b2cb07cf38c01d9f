"""Device-memory accounting: buffer bytes of tables and allocator samples.

The port of the parts of ``spark_rapids_jni_tpu/utils/memory.py`` the
engine reads.  ``table_nbytes`` sums buffer metadata (``nbytes``), so the
executor accounts bytes per plan node without a transfer or a sync.
``telemetry_snapshot`` samples the CUDA caching allocator
(``torch.cuda.memory_allocated`` / ``max_memory_allocated``): host-side
counters, no device sync.  A CPU device has no allocator to sample and
gives ``None`` (the JAX package's live-array census has no torch
counterpart).
"""

from __future__ import annotations

from typing import Optional

import torch


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


def telemetry_snapshot(device) -> Optional[dict]:
    """``{"source": "runtime", "live_bytes", "peak_bytes"}`` from the CUDA
    caching allocator of ``device``, or ``None`` for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return {"source": "runtime",
            "live_bytes": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
