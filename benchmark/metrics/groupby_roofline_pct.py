"""Share of the memory bound of the partial aggregate: the key and values
read once and the result written once at 3.35 TB/s, over the device time
under the ``groupby`` range."""

from benchmark.core.peaks import roofline_pct

RANGES = ("groupby",)


def read(run):
    t = run.get("trace")
    if not t:
        return None
    return roofline_pct(run["bytes"].get("groupby"),
                        t["range_device_s"].get("groupby"))
