"""95th percentile of the traced run's task latencies (benchmark's clock)."""

from benchmark.core.window import percentile


def read(run):
    return percentile(run["tasks_ms"], 95) if run["tasks_ms"] else None
