"""Device ms a task under the groupby's reduce phase (``groupby.reduce``:
the first-row scatter, the key gathers, every aggregation's scatter),
over the tasks finished in the window."""

from benchmark.metrics.rowconv_planes_ms import span_ms

RANGES = ("groupby.reduce",)


def read(run):
    return span_ms(run, RANGES)
