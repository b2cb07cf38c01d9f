#!/usr/bin/env python3
"""The control of ``correct``: the reference in the program's place, one
precision down.

The configurations state float64 values and sums; the control takes them
in float32 (the values rounded to float32, each sum added in float32) and
is judged as the program is: q5's answers by ``reference.q5.compare``
against the float64 oracle of their year, the stage's sums by
``rows_stage.sum_gap`` against the float64 NumPy groupby, the round trip's
rows (the reference's packer over the rounded values) and the columns back
from them against the batch, bit for bit.  In q5 and the stage every other
number is exact, and the control's are exact there too, so the sums' gap
is the number the control has to fail there.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the control's readings beside the cell's
limits.  It needs no card; the benchmark's runs do not run it.  A cell of
``pending/`` is found too.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core import harness as H  # noqa: E402
from benchmark.reference import jcudf  # noqa: E402
from benchmark.reference.groupby import groupby_sums  # noqa: E402
from benchmark.reference.q5 import COLUMNS, compare, q5_oracle  # noqa: E402


def q5_reading(cfg: dict, gen, seed: int) -> dict:
    fact = gen.fact_columns(cfg, seed, COLUMNS)
    dates, stores = gen.dim_columns(cfg)
    bad, gap = 0, 0.0
    for lo, hi in gen.year_ranges(dates, cfg["years"]).values():
        want = q5_oracle(fact, dates, stores, lo, hi)
        got = q5_oracle(fact, dates, stores, lo, hi, np.float32)
        b, g = compare(got, want)
        bad, gap = bad + b, max(gap, g)
    return {"q5_mismatches": bad, "q5_sum_gap": gap}


def stage_reading(cfg: dict, gen, seed: int) -> dict:
    from benchmark.drivers.rows_stage import sum_gap
    st = cfg["stage"]
    rng = np.random.default_rng(seed + 29)
    gap = 0.0
    for _ in range(cfg["batches"]):
        cols = {nm: (v, ok) for nm, v, ok in gen.batch_columns(cfg, rng)}
        values = [(c, *cols[c]) for c in st["sums"]]
        want = groupby_sums(cols[st["group_by"]][0], values)
        got = groupby_sums(cols[st["group_by"]][0], values, np.float32)
        for c in st["sums"]:
            w, has, absum = want[c]
            if absum is not None:
                gap = max(gap, sum_gap(got[c][0].astype(np.float64)[has],
                                       w[has], absum[has]))
    return {"agg_sum_gap": gap}


def roundtrip_reading(cfg: dict, gen, seed: int) -> dict:
    from benchmark.drivers.rows_stage import mismatches
    data = gen.make(cfg, seed)
    blob_bad = rows_bad = 0
    for b in data["batches"]:
        low = [(v.astype(np.float32).astype(v.dtype)
                if v.dtype == np.float64 else v, ok)
               for _, v, ok in b["columns"]]
        blob = jcudf.pack(low)
        blob_bad += int(np.count_nonzero(blob != b["rows"]))
        back = jcudf.unpack(blob, data["dtypes"])
        rows_bad += mismatches(dict(zip(data["names"], back)),
                               b["columns"], data["dtypes"])
    return {"to_rows_mismatches": blob_bad, "rows_mismatches": rows_bad}


READINGS = {"q5_stream": q5_reading, "rows_stage": stage_reading,
            "rows_roundtrip": roundtrip_reading}


def reading(plan: dict, seed: int) -> dict:
    gen = H.load_module(plan["generator"], "bench_config_control")
    return READINGS[plan["traffic"]["driver"]](plan["config"], gen, seed)


def limit(plan: dict, name: str) -> float:
    """The cell's limit of one number: a sum's gap, or 0 for a count."""
    return plan["traffic"]["sum_gap_limit"] if name.endswith("_gap") else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    plan = H.cell_plan(H.with_pending(H.manifest()), args.workload)
    for s in args.seeds.split(","):
        r = reading(plan, int(s))
        print(json.dumps({"workload": args.workload, "seed": int(s), **r,
                          "limits": {k: limit(plan, k) for k in r},
                          "fails": any(v > limit(plan, k)
                                       for k, v in r.items())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
