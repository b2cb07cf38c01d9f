"""Deliberate device-to-host syncs a query: the delta of the program's
``engine.host_sync`` counter over the window, over the queries finished."""


def read(run):
    if not run.get("queries") or run.get("host_syncs") is None:
        return None
    return run["host_syncs"] / run["queries"]
