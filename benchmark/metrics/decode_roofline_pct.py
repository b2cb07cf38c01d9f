"""Share of the memory bound of the device decode: the bytes the decode has
to move (the compressed column chunks read once, the decoded columns
written once, counted from the benchmark's own file layout) at 3.35 TB/s,
over the device time under the program's ``decode_table`` range."""

from benchmark.core.peaks import roofline_pct

RANGES = ("decode_table",)


def read(run):
    t = run.get("trace")
    if not t:
        return None
    return roofline_pct(run["bytes"].get("decode"),
                        t["range_device_s"].get("decode_table"))
