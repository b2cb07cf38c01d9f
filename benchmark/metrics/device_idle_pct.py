"""Share of the traced window with no kernel, copy or set on the card (the
union of the profiler's device intervals)."""

from benchmark.core.trace import idle_pct


def read(run):
    return idle_pct(run.get("trace"))
