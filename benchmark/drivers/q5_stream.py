"""Driver ``q5_stream``: Spark task slots running NDS q5-lite over a split.

Each slot is a thread on the one card; each of its tasks builds the q5-lite
plan for one calendar year, runs ``engine.optimize`` and
``engine.execute`` with the program's defaults, and ends when the answer is
on the host.  A slot takes the years in a cycle that the seed permutes,
starting at its own place in it, so every seed runs the same mix of years
in another order.

Set-up makes the files (the configuration's generator), then warms up:
each year once alone, then one round of every slot at once.  After the
window every answer is held against the NumPy q5 oracle of its year.

Traffic parameters (``workloads/<cell>.json``): ``task_slots``,
``chunk_bytes`` (the fact scan's chunk), ``fact_columns_read`` (the
columns the query reads, for the decode's byte count), ``sum_gap_limit``.
"""

from __future__ import annotations

import numpy as np

from benchmark.core.window import latencies_ms, measure, one_round, \
    rows_per_s
from benchmark.reference.q5 import compare, q5_oracle


def q5_plan(pe, root, date_lo: int, date_hi: int, chunk_bytes: int):
    """NDS q5-lite as a plan: the date filter sits above the semi join, so
    the optimizer splits it, sinks it onto the fact side and feeds the
    scan's pruning predicate."""
    col, lit = pe.col, pe.lit
    between = ("&", (">=", col("ss_sold_date_sk"), lit(date_lo)),
               ("<=", col("ss_sold_date_sk"), lit(date_hi)))
    dates = pe.Filter(pe.Scan(str(root / "date_dim.parquet")),
                      ("&", (">=", col("d_date_sk"), lit(date_lo)),
                       ("<=", col("d_date_sk"), lit(date_hi))))
    sales = pe.Scan(str(root / "store_sales.parquet"),
                    chunk_bytes=chunk_bytes)
    kept = pe.Filter(pe.Join(sales, dates, ["ss_sold_date_sk"],
                             ["d_date_sk"], how="semi"), between)
    totals = pe.Aggregate(kept, ["ss_store_sk"],
                          [("ss_ext_sales_price", "sum"),
                           ("ss_net_profit", "sum"),
                           ("ss_ext_sales_price", "count")],
                          names=["sales", "profit", "n"])
    joined = pe.Join(totals, pe.Scan(str(root / "store.parquet")),
                     ["ss_store_sk"], ["s_store_sk"], how="inner")
    return pe.Aggregate(joined, ["s_store_name"],
                        [("sales", "sum"), ("profit", "sum"), ("n", "sum")],
                        names=["sales", "profit", "n"])


def answer(table) -> dict:
    """The result table on the host: {name: (sales, profit, n)}."""
    return {nm: (s, p, int(n)) for nm, s, p, n in zip(
        table["s_store_name"].to_pylist(), table["sales"].to_pylist(),
        table["profit"].to_pylist(), table["n"].to_pylist())}


def decode_bytes(layout: list, columns, lo: int, hi: int,
                 date_col: str = "ss_sold_date_sk") -> int:
    """Bytes one query's decode has to move: the column chunks of the row
    groups whose dates meet ``[lo, hi]``, read once as laid out on disk,
    and their decoded values written once (validity as one bit a row)."""
    total = 0
    for g in layout:
        d = g["columns"][date_col]
        if d["max"] < lo or d["min"] > hi:
            continue
        for name, width, nullable in columns:
            total += g["columns"][name]["disk_bytes"] + g["rows"] * width
            if nullable:
                total += -(-g["rows"] // 8)
    return total


def run(ctx) -> dict:
    import torch

    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.utils import metrics, tracing

    tr, dev = ctx.traffic, ctx.device
    data = ctx.generator.make(ctx.config, ctx.seed, ctx.cache)
    root, years = data["root"], data["years"]
    rows = ctx.config["tables"]["store_sales"]["rows"]
    order = [int(y) for y in
             np.random.default_rng(ctx.seed).permutation(sorted(years))]
    slots = tr["task_slots"]

    def task(year: int):
        lo, hi = years[year]
        with torch.profiler.record_function("bench.task"):
            with torch.profiler.record_function("bench.optimize"):
                plan = pe.optimize(q5_plan(pe, root, lo, hi,
                                           tr["chunk_bytes"]))
            with torch.profiler.record_function("bench.execute"):
                table = pe.execute(plan, device=dev)
            with torch.profiler.record_function("bench.to_host"):
                return answer(table)

    def slot_task(slot: int, k: int):
        year = order[(slot + k) % len(order)]
        return rows, (year, task(year))

    for y in order:  # every year alone, then all slots at once
        task(y)
    one_round(slots, slot_task)

    def counters():
        g = metrics.gauges_snapshot("io.parquet.prefetch.consumer_idle_s")
        return {"host_syncs": tracing.counter_value("engine.host_sync"),
                "scan_wait_s": sum(g.values()),
                "compiles": tracing.counter_value("engine.segment.compile")}

    before = counters()
    m = measure(ctx, torch, slots, slot_task)
    after = counters()
    win = m["win"]

    tasks = win["tasks"]
    done = [t for t in tasks if t["error"] is None]
    lat = latencies_ms(win)
    fact = ctx.config["tables"]["store_sales"]
    spec = {c["name"]: c for c in fact["columns"]}
    cols = [(c, np.dtype(spec[c]["type"]).itemsize,
             fact["null_rate"] > 0 and not spec[c].get("key"))
            for c in tr["fact_columns_read"]]
    nq = len(done)
    layer = {
        "tasks_ms": lat, "queries": nq,
        "host_syncs": after["host_syncs"] - before["host_syncs"],
        "scan_wait_s": after["scan_wait_s"] - before["scan_wait_s"],
        "segment_compiles": after["compiles"] - before["compiles"],
        "bytes": {"decode": sum(decode_bytes(data["layout"], cols,
                                             *years[t["result"][0]])
                                for t in done)},
        "trace": m["trace"],
    }

    # every answer against the oracle of its year, once the window closed
    want = {y: q5_oracle(data["fact"], data["dates"], data["stores"],
                         *years[y]) for y in {t["result"][0] for t in done}}
    bad, gap = 0, 0.0
    for t in done:
        year, got = t["result"]
        b, g = compare(got, want[year])
        bad, gap = bad + b, max(gap, g)
    return {
        "attempted": len(tasks), "failed": len(tasks) - nq,
        "errors": sorted({t["error"] for t in tasks if t["error"]})[:3],
        "setup_end": m["setup_end"],
        "end_to_end": {"query_rows_per_s": rows_per_s(win),
                       "query_peak_gib": m["window_peak"] / 2**30},
        "device": m["device"],
        "layer": layer,
        "checks": [("q5_mismatches", bad, 0),
                   ("q5_sum_gap", gap, tr["sum_gap_limit"])],
    }
