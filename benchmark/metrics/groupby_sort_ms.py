"""Device ms a task under the groupby's sort phase (``groupby.sort``: key
encoding, lexsort, segment bounds, group ids), over the tasks finished in
the window."""

from benchmark.metrics.rowconv_planes_ms import span_ms

RANGES = ("groupby.sort",)


def read(run):
    return span_ms(run, RANGES)
