"""Driver ``rows_stage``: RowToColumnar, partial HashAggregate,
HashPartitioning and ColumnarToRow, as a spark-rapids shuffle stage fed by
a CPU operator runs them.

Set-up makes the configuration's batches on the host, packed into JCUDF
rows by the reference's packer, and copies their rows to the card once.
Each task takes the next batch in turn and runs ``convert_from_rows``,
``groupby`` (sums and a row count by the key), ``murmur3_hash`` of the
keys with ``pmod`` by the shuffle's partitions, and ``convert_to_rows`` of
the aggregate with its partition ids; it ends when the card has finished.

The outputs of a few tasks that the seed picks among the first ones are
copied to the host as each ends (inside the window, so its rate pays for
the copies; off the card, so its memory peak is the stage's); after the
window the reference judges them: the columns against the ones the rows
were packed from, the aggregate against a NumPy groupby, the partition ids
against a NumPy murmur3, the aggregate's rows against the reference's
packer over the program's aggregate.

Traffic parameters (``workloads/<cell>.json``): ``task_slots``,
``checked_tasks`` (how many outputs are kept, drawn from the first
``checked_among``), ``sum_gap_limit``.
"""

from __future__ import annotations

import numpy as np

from benchmark.core import device as D
from benchmark.core.window import latencies_ms, measure, percentile, \
    rows_per_s
from benchmark.reference import jcudf, murmur3
from benchmark.reference.groupby import groupby_sums


def stage_bytes(n: int, itemsizes, groups: int, agg_sizes) -> dict:
    """Bytes each step of one task has to move: each input byte read once,
    each output byte written once, validity as one bit a row and column.

    ``itemsizes``: the batch's columns; ``agg_sizes``: the aggregate's
    columns with the partition id (key, sums, count, id)."""
    _, _, row = jcudf.layout(itemsizes)
    _, _, agg_row = jcudf.layout(agg_sizes)
    bits = lambda rows, cols: cols * -(-rows // 8)  # noqa: E731
    cols_in = n * sum(itemsizes) + bits(n, len(itemsizes))
    agg_cols = groups * sum(agg_sizes) + bits(groups, len(agg_sizes))
    # groupby reads the key and three values (with their validity) and
    # writes the key, three sums and the count (the sums with validity)
    return {
        "from_rows": n * row + cols_in,
        "to_rows": agg_cols + groups * agg_row,
        "groupby": n * (4 + 4 + 8 + 8) + bits(n, 3)
                   + groups * (4 + 8 + 8 + 8 + 8) + bits(groups, 3),
    }


def run(ctx) -> dict:
    import torch

    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import (FLOAT64, INT32, INT64,
                                                   UINT8)
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.hash import murmur3_hash
    from spark_rapids_jni_tpu_torch.ops.row_conversion import (
        convert_from_rows, convert_to_rows)

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    st = cfg["stage"]
    data = ctx.generator.make(cfg, ctx.seed)
    names, dtypes = data["names"], data["dtypes"]
    port_type = {np.dtype("int32"): INT32, np.dtype("int64"): INT64,
                 np.dtype("float64"): FLOAT64}
    schema = [port_type[d] for d in dtypes]
    key = st["group_by"]
    aggs = [(c, "sum") for c in st["sums"]] + [(key, "count_all")]
    agg_names = [f"sum_{c}" for c in st["sums"]] + ["count"]
    parts = st["shuffle_partitions"]
    n = cfg["batch_rows"]
    _, _, row_size = jcudf.layout([d.itemsize for d in dtypes])

    blobs = []
    for b in data["batches"]:
        child = Column(UINT8, data=torch.from_numpy(b["rows"]).to(dev))
        offsets = torch.arange(n + 1, dtype=torch.int32,
                               device=dev) * row_size
        blobs.append(Column.list_(child, offsets, device=dev))

    def task(k: int):
        with torch.profiler.record_function("bench.task"):
            table = Table(convert_from_rows(blobs[k % len(blobs)], schema,
                                            device=dev).columns, names)
            agg = groupby(table, [key], aggs, names=agg_names, device=dev)
            h = murmur3_hash(agg.select([key]), seed=st["hash_seed"],
                             device=dev)
            pid = torch.remainder(h.data.to(torch.int64), parts) \
                .to(torch.int32)
            out = Table(list(agg.columns) + [Column(INT32, data=pid)],
                        list(agg.names) + ["partition"])
            rows = convert_to_rows(out, device=dev)
            D.sync(torch, dev)
        return table, out, rows

    keep = set(np.random.default_rng(ctx.seed).choice(
        tr["checked_among"], tr["checked_tasks"], replace=False).tolist())
    kept, groups = {}, []

    def slot_task(slot: int, k: int):
        table, out, rows = task(k)
        groups.append(out.num_rows)
        if k in keep:  # off the card, so that the window's peak is the stage's
            kept[k] = to_host(table, out, rows)
        return n, None

    for k in range(len(blobs)):  # every batch once
        task(k)
    m = measure(ctx, torch, tr["task_slots"], slot_task)
    win = m["win"]

    tasks = win["tasks"]
    done = [t for t in tasks if t["error"] is None]
    lat = latencies_ms(win)
    agg_sizes = [4] + [8] * len(st["sums"]) + [8, 4]
    totals: dict = {}
    for g in groups[:len(done)]:
        for step, v in stage_bytes(n, [d.itemsize for d in dtypes], g,
                                   agg_sizes).items():
            totals[step] = totals.get(step, 0) + v
    layer = {"tasks_ms": lat, "queries": len(done), "bytes": totals,
             "trace": m["trace"]}
    checks = judge(kept, data, key, st, agg_names, parts,
                   tr["sum_gap_limit"])
    checks.append(("unchecked_tasks", tr["checked_tasks"] - len(kept), 0))
    return {
        "attempted": len(tasks), "failed": len(tasks) - len(done),
        "errors": sorted({t["error"] for t in tasks if t["error"]})[:3],
        "setup_end": m["setup_end"],
        "end_to_end": {"rows_per_s": rows_per_s(win),
                       "task_p95_ms": percentile(lat, 95),
                       "device_peak_gib": m["window_peak"] / 2**30},
        "device": m["device"],
        "layer": layer,
        "checks": checks,
    }


def host_columns(table) -> dict:
    """A table copied to the host: ``{name: (values, validity or None)}``."""
    return {nm: (c.data.cpu().numpy(),
                 None if c.validity is None else c.validity.cpu().numpy())
            for nm, c in zip(table.names, table.columns)}


def to_host(table, out, rows) -> tuple:
    """A task's outputs copied to the host: the columns back from rows and
    the aggregate (``host_columns``), and the aggregate's row bytes."""
    blob = np.concatenate([r.children[0].data.cpu().numpy().view(np.uint8)
                           .reshape(-1) for r in rows])
    return host_columns(table), host_columns(out), blob


def mismatches(back: dict, columns: list, dtypes) -> int:
    """Values and validity bits of the columns back from rows
    (``host_columns``) that differ from the batch's ``[(name, values,
    valid or None)]``; a column of another length counts all its rows and
    one more."""
    bad = 0
    for (nm, v, ok), d in zip(columns, dtypes):
        gv, gok = back[nm]
        if len(gv) != len(v):
            bad += len(v) + 1
            continue
        bad += int(np.count_nonzero(
            gv.view(f"u{d.itemsize}") != v.view(f"u{d.itemsize}")))
        gok = np.ones(len(v), np.bool_) if gok is None else gok
        want_ok = np.ones(len(v), np.bool_) if ok is None else ok
        bad += int(np.count_nonzero(gok != want_ok))
    return bad


def sum_gap(got: np.ndarray, want: np.ndarray, absum: np.ndarray) -> float:
    """The widest gap of float sums, each against the sum of the absolute
    values of its terms."""
    d = np.abs(got - want) / np.maximum(absum, 1e-300)
    return float(d.max()) if len(d) else 0.0


def judge(kept: dict, data: dict, key: str, st: dict, agg_names: list,
          parts: int, gap_limit: float) -> list:
    """The checks over the kept tasks' outputs: (name, value, limit)."""
    dtypes = data["dtypes"]
    nb = len(data["batches"])
    refs = {}
    rows_bad = agg_bad = part_bad = blob_bad = 0
    gap = 0.0
    for k, (back, got, got_blob) in sorted(kept.items()):
        batch = data["batches"][k % nb]
        cols = {nm: (v, ok) for nm, v, ok in batch["columns"]}
        # the columns back from rows, bit for bit, validity included
        rows_bad += mismatches(back, batch["columns"], dtypes)
        if k % nb not in refs:
            refs[k % nb] = groupby_sums(
                cols[key][0], [(c, *cols[c]) for c in st["sums"]])
        ref = refs[k % nb]
        gkeys = got[key][0]
        order = np.argsort(gkeys, kind="stable")
        if len(gkeys) != len(ref["keys"]) or \
                not np.array_equal(gkeys[order], ref["keys"]):
            agg_bad += abs(len(gkeys) - len(ref["keys"])) + 1
            continue
        agg_bad += int(np.count_nonzero(
            got["count"][0][order] != ref["count"]))
        for c, nm in zip(st["sums"], agg_names):
            want, has, absum = ref[c]
            gv, gok = got[nm]
            gv = gv[order]
            gok = np.ones(len(gv), np.bool_) if gok is None else gok[order]
            agg_bad += int(np.count_nonzero(gok != has))
            if absum is None:
                agg_bad += int(np.count_nonzero((gv != want) & has))
            else:
                gap = max(gap, sum_gap(gv[has], want[has], absum[has]))
        want_pid = murmur3.pmod(murmur3.hash_int(ref["keys"],
                                                 st["hash_seed"]), parts)
        got_pid = got["partition"][0][order]
        part_bad += int(np.count_nonzero(got_pid != want_pid))
        # the aggregate's rows against the reference packer over the
        # program's own aggregate columns
        want_blob = jcudf.pack(list(got.values()))
        blob_bad += int(np.count_nonzero(got_blob != want_blob)) \
            if len(got_blob) == len(want_blob) else len(want_blob) + 1
    return [("rows_mismatches", rows_bad, 0), ("agg_mismatches", agg_bad, 0),
            ("partition_mismatches", part_bad, 0),
            ("agg_rows_mismatches", blob_bad, 0),
            ("agg_sum_gap", gap, gap_limit)]
