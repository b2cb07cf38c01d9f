"""Driver ``rows_roundtrip``: ColumnarToRow then RowToColumnar, as for a
CPU-only operator between two GPU operators in a spark-rapids plan.

Set-up makes the configuration's batches on the host (the reference's
packer gives each batch's rows) and copies their columns to the card once.
Each task takes the next batch in turn and runs ``convert_to_rows`` of its
columns and ``convert_from_rows`` of those rows; it ends when the card has
finished.

The outputs of a few tasks that the seed picks among the first ones are
copied to the host as each ends (inside the window, so its rate pays for
the copies; off the card, so its memory peak is the round trip's); after
the window the reference judges them: the rows byte for byte against the
reference's packer over the batch, the columns back bit for bit, validity
included, against the batch.

Traffic parameters (``workloads/<cell>.json``): ``task_slots``,
``checked_tasks`` (how many outputs are kept, drawn from the first
``checked_among``).
"""

from __future__ import annotations

import numpy as np

from benchmark.core import device as D
from benchmark.core.window import latencies_ms, measure, percentile, \
    rows_per_s
from benchmark.drivers.rows_stage import host_columns, mismatches
from benchmark.reference import jcudf


def conversion_bytes(n: int, itemsizes) -> int:
    """Bytes one conversion of ``n`` rows has to move, either way: each row
    byte once, each column byte once, validity as one bit a row and
    column."""
    _, _, row = jcudf.layout(itemsizes)
    return n * row + n * sum(itemsizes) + len(itemsizes) * -(-n // 8)


def run(ctx) -> dict:
    import torch

    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import FLOAT64, INT32, INT64
    from spark_rapids_jni_tpu_torch.ops.row_conversion import (
        convert_from_rows, convert_to_rows)

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    data = ctx.generator.make(cfg, ctx.seed)
    names, dtypes = data["names"], data["dtypes"]
    port_type = {np.dtype("int32"): INT32, np.dtype("int64"): INT64,
                 np.dtype("float64"): FLOAT64}
    schema = [port_type[d] for d in dtypes]
    n = cfg["batch_rows"]

    tables = [Table([Column.fixed(t, v, ok, device=dev)
                     for t, (_, v, ok) in zip(schema, b["columns"])], names)
              for b in data["batches"]]

    def task(k: int):
        with torch.profiler.record_function("bench.task"):
            rows = convert_to_rows(tables[k % len(tables)], device=dev)
            back = Table(convert_from_rows(rows[0], schema,
                                           device=dev).columns, names)
            D.sync(torch, dev)
        return rows, back

    keep = set(np.random.default_rng(ctx.seed).choice(
        tr["checked_among"], tr["checked_tasks"], replace=False).tolist())
    kept = {}

    def slot_task(slot: int, k: int):
        rows, back = task(k)
        if k in keep:  # off the card, so that the window's peak is the task's
            kept[k] = (np.concatenate(
                [r.children[0].data.cpu().numpy().view(np.uint8).reshape(-1)
                 for r in rows]), host_columns(back))
        return n, None

    for k in range(len(tables)):  # every batch once
        task(k)
    m = measure(ctx, torch, tr["task_slots"], slot_task)
    win = m["win"]

    tasks = win["tasks"]
    done = [t for t in tasks if t["error"] is None]
    lat = latencies_ms(win)
    one = conversion_bytes(n, [d.itemsize for d in dtypes])
    layer = {"tasks_ms": lat, "queries": len(done),
             "bytes": {"to_rows": one * len(done),
                       "from_rows": one * len(done)},
             "trace": m["trace"]}
    blob_bad = rows_bad = 0
    for k, (blob, back) in sorted(kept.items()):
        batch = data["batches"][k % len(data["batches"])]
        want = batch["rows"]
        blob_bad += int(np.count_nonzero(blob != want)) \
            if len(blob) == len(want) else len(want) + 1
        rows_bad += mismatches(back, batch["columns"], dtypes)
    return {
        "attempted": len(tasks), "failed": len(tasks) - len(done),
        "errors": sorted({t["error"] for t in tasks if t["error"]})[:3],
        "setup_end": m["setup_end"],
        "end_to_end": {"rows_per_s": rows_per_s(win),
                       "task_p95_ms": percentile(lat, 95),
                       "device_peak_gib": m["window_peak"] / 2**30},
        "device": m["device"],
        "layer": layer,
        "checks": [("to_rows_mismatches", blob_bad, 0),
                   ("rows_mismatches", rows_bad, 0),
                   ("unchecked_tasks", tr["checked_tasks"] - len(kept), 0)],
    }
