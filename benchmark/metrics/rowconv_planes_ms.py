"""Device ms a task under the row conversions' plane phases: the word
planes built from the columns before K1 (``row_conversion.planes``) and
the columns and masks cut from the planes after K2
(``row_conversion.columns``), over the tasks finished in the window."""

RANGES = ("row_conversion.planes", "row_conversion.columns")


def span_ms(run, ranges):
    """Device ms a finished task under ``ranges``; None without a trace,
    without tasks, or where no device time fell under them (a program
    without the spans)."""
    t = run.get("trace")
    if not t or not run.get("queries"):
        return None
    s = sum(t["range_device_s"].get(r) or 0.0 for r in ranges)
    return s * 1e3 / run["queries"] if s else None


def read(run):
    return span_ms(run, RANGES)
