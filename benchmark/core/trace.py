"""The traced window: ``torch.profiler`` over the card, reduced here.

Only the profiler's raw events are read (``kineto_results.events()``): the
FunctionEvent tree torch builds from them takes tens of seconds at the
hundreds of thousands of events a window makes.

- Device busy time is the union of the kernels', copies' and sets'
  intervals on the card, clipped to the window (the CPU range
  ``bench.window`` that the harness opens around it).
- A device operation is attributed to the host thread and time that
  launched it: its linked CPU op (the innermost profiler range or aten op
  open at the launch), else its runtime call by correlation id.  Its time
  counts under a named range when that range was open on that thread then,
  so the ranges of concurrent task threads do not take each other's
  kernels.
- Idle gaps are labelled by the innermost profiler ranges open on the host
  threads at the gap's middle.
"""

from __future__ import annotations

import bisect
import collections

WINDOW_RANGE = "bench.window"
TOP = 10


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _inside(merged: list, starts: list, t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and merged[i][1] >= t


class DeviceTrace:
    """Context manager: profile CPU and CUDA activity; ``reduce`` after."""

    def __init__(self, torch, device: str = "cuda"):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.cuda = device.startswith("cuda")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        # the task slots are threads of their own: record them all
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self.prof = profile(activities=acts, experimental_config=cfg)

    def __enter__(self):
        if self.cuda:
            self.torch.cuda.synchronize()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.torch.cuda.synchronize()
        return self.prof.__exit__(*exc)

    def reduce(self, ranges=()) -> dict:
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             ranges)


def reduce_events(events, ranges=()) -> dict:
    from torch.autograd import DeviceType
    cpu, dev = [], []
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CPU:
            cpu.append((e.name(), e.start_thread_id(), e.start_ns(),
                        e.end_ns(), e.correlation_id(),
                        e.linked_correlation_id(), e.is_user_annotation()))
        elif kind == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            dev.append((e.name(), e.start_ns(), e.end_ns(),
                        e.correlation_id(), e.linked_correlation_id()))

    win = [(s, t) for n, _, s, t, _, _, _ in cpu if n == WINDOW_RANGE]
    if win:
        w0, w1 = win[0]
    elif dev:
        w0, w1 = min(d[1] for d in dev), max(d[2] for d in dev)
    else:
        w0 = w1 = 0

    ops, runtime = {}, {}
    spans = collections.defaultdict(list)      # (name, tid) -> intervals
    annotations = collections.defaultdict(list)  # tid -> (start, end, name)
    for name, tid, s, t, corr, linked, user in cpu:
        (runtime if linked else ops)[corr] = (tid, s)
        if name in ranges:
            spans[(name, tid)].append((s, t))
        if user and name != WINDOW_RANGE:
            annotations[tid].append((s, t, name))
    merged = {k: _merge(v) for k, v in spans.items()}
    starts = {k: [m[0] for m in v] for k, v in merged.items()}

    range_ns = dict.fromkeys(ranges, 0)
    by_name = collections.Counter()
    intervals = []
    via = collections.Counter()
    for name, s, t, corr, linked in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        intervals.append((s, t))
        by_name[name[:80]] += t - s
        at = ops.get(linked) if linked else None
        if at is not None:
            via["linked"] += 1
        else:
            at = runtime.get(corr)
            via["runtime" if at else "none"] += 1
        if at is None:
            continue
        tid, when = at
        for r in ranges:
            key = (r, tid)
            if key in merged and _inside(merged[key], starts[key], when):
                range_ns[r] += t - s

    busy = _merge(intervals)
    busy_ns = sum(e - s for s, e in busy)
    gaps, last = [], w0
    for s, e in busy:
        if s > last:
            gaps.append((s - last, last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((w1 - last, last, w1))
    gaps.sort(reverse=True)
    idle = [[_host_label(annotations, (a + b) // 2), g / 1e9]
            for g, a, b in gaps[:TOP]]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "range_device_s": {r: v / 1e9 for r, v in range_ns.items()},
        "breakdown": {
            "device_ops": [[n, v / 1e9] for n, v in by_name.most_common(TOP)],
            "idle_gaps": idle},
        "device_ops": len(intervals),
        "attributed": dict(via),
    }


def idle_pct(reduced):
    """Share of the traced window with nothing on the card (None without a
    device trace)."""
    if not reduced or not reduced["window_s"] or not reduced["device_ops"]:
        return None
    return 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])


def _host_label(annotations: dict, t: int) -> str:
    """The innermost profiler range open at ``t`` on each host thread."""
    names = set()
    for spans in annotations.values():
        inner = None
        for s, e, name in spans:
            if s <= t <= e and (inner is None or s >= inner[0]):
                inner = (s, name)
        if inner:
            names.add(inner[1])
    return "|".join(sorted(names)) or "no range open"
