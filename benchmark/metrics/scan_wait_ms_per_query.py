"""Time the executor waited on the scan's host planning and transfer, a
query: the delta of the program's ``io.parquet.prefetch.consumer_idle_s``
timer over the window, over the queries finished."""


def read(run):
    if not run.get("queries") or run.get("scan_wait_s") is None:
        return None
    return run["scan_wait_s"] * 1e3 / run["queries"]
