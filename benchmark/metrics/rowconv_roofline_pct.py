"""Share of the memory bound of the row conversions: each input byte read
once and each output byte written once (from the shapes) at 3.35 TB/s,
over the device time under the ``convert_from_rows`` and
``convert_to_rows`` ranges."""

from benchmark.core.peaks import roofline_pct

RANGES = ("convert_from_rows", "convert_to_rows")


def read(run):
    t = run.get("trace")
    if not t:
        return None
    b = run["bytes"]
    if "from_rows" not in b:
        return None
    s = sum(t["range_device_s"].get(r) or 0.0 for r in RANGES)
    return roofline_pct(b["from_rows"] + b["to_rows"], s)
