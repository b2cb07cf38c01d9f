"""The measured window: task slots in a closed loop.

Each slot is a thread that starts its next task as soon as its last one has
ended, while the window is open; a task started in the window runs to its
end and counts.  The rate is taken over all rows of those tasks and the
time from the window's start to the end of the last of them; the tail over
all their latencies.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
import traceback

from benchmark.core import device as D
from benchmark.core.trace import WINDOW_RANGE, DeviceTrace


def closed_loop(slots: int, seconds: float, task, trace_scope=None) -> dict:
    """Run ``task(slot, k)`` (k: the slot's k-th task) in ``slots`` threads
    for ``seconds``.  ``task`` returns ``(rows, result)``.  Returns
    ``{"t0", "t_end", "tasks": [{"slot", "k", "start", "end", "rows",
    "result", "error"}]}`` in the order the tasks started."""
    records: list = []
    lock = threading.Lock()
    start = threading.Barrier(slots + 1)
    box = {}

    def worker(slot: int):
        start.wait()
        t_close = box["t0"] + seconds
        k = 0
        while True:
            t = time.perf_counter()
            if t >= t_close:
                return
            rec = {"slot": slot, "k": k, "start": t, "rows": 0,
                   "result": None, "error": None}
            try:
                rec["rows"], rec["result"] = task(slot, k)
            except Exception:  # counted as failed, the run goes on
                rec["error"] = traceback.format_exc(limit=-3).strip()
            rec["end"] = time.perf_counter()
            with lock:
                records.append(rec)
            k += 1

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(slots)]
    for t in threads:
        t.start()
    with (trace_scope() if trace_scope else contextlib.nullcontext()):
        box["t0"] = time.perf_counter()
        start.wait()
        for t in threads:
            t.join()
        t_end = max((r["end"] for r in records), default=box["t0"])
    records.sort(key=lambda r: r["start"])
    return {"t0": box["t0"], "t_end": t_end, "tasks": records}


def measure(ctx, torch, slots: int, task) -> dict:
    """Close set-up (its memory peak read, the peak reset), then run the
    window, under the profiler when the run is traced.  Returns ``{"win",
    "setup_end", "window_peak", "device", "trace"}``."""
    D.sync(torch, ctx.device)
    setup_peak = D.peak_bytes(torch, ctx.device)
    D.reset_peak(torch, ctx.device)
    setup_end = time.perf_counter()
    tracer = DeviceTrace(torch, ctx.device) if ctx.trace else None
    with tracer or contextlib.nullcontext():
        win = closed_loop(slots, ctx.seconds, task,
                          lambda: torch.profiler.record_function(
                              WINDOW_RANGE))
        D.sync(torch, ctx.device)
    peak = D.peak_bytes(torch, ctx.device)
    return {"win": win, "setup_end": setup_end, "window_peak": peak,
            "device": D.info(torch, ctx.device, max(setup_peak, peak)),
            "trace": tracer.reduce(ctx.ranges) if tracer else None}


def one_round(slots: int, task) -> None:
    """``task(slot, 0)`` in every slot at once (warm-up); raises the first
    error."""
    errors = []

    def worker(slot: int):
        try:
            task(slot, 0)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(slots)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def rows_per_s(window: dict) -> float:
    done = [r for r in window["tasks"] if r["error"] is None]
    span = window["t_end"] - window["t0"]
    return sum(r["rows"] for r in done) / span if span > 0 else 0.0


def latencies_ms(window: dict) -> list:
    return [(r["end"] - r["start"]) * 1e3 for r in window["tasks"]
            if r["error"] is None]


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (q in 0..100)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]
