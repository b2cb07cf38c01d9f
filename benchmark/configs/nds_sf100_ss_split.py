"""Inputs of ``nds_sf100_ss_split``: a store_sales split, date_dim and store.

All 23 store_sales columns drawn by ``reference.store_sales`` (the null
model ``nds_sf100_ss_rows`` uses too), the dimensions frozen from
``chip_smoke.py::dim_columns``, surrogate keys INT32 as NDS's schema has
them, written by the benchmark's own Parquet writer.  ``make`` returns the
columns q5 reads (for the reference) and the files (for the program).  The
files sit in ``<cache>/seed<seed>/``; a run that finds its seed there
reuses them, and one directory is kept at most.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from benchmark.reference.parquet_writer import write_parquet
from benchmark.reference.q5 import COLUMNS
from benchmark.reference.store_sales import draw_columns, sort_nulls_first

FILES = ("store_sales.parquet", "date_dim.parquet", "store.parquet")


def fact_columns(cfg: dict, seed: int, keep=None) -> list:
    """store_sales at NDS shape, every column of the configuration drawn
    by ``reference.store_sales``, sorted by the date with its nulls first:
    [(name, kind, values, valid, dictionary)], of the columns in ``keep``
    if it is given (the draws are the same either way)."""
    t = cfg["tables"]["store_sales"]
    rng = np.random.default_rng(seed + 11)
    out = []
    for name, kind, v, ok in draw_columns(t["columns"], t["rows"],
                                          t["null_rate"], rng):
        if keep is not None and name not in keep:
            continue
        if name == t["sorted_by"]:
            v, ok = sort_nulls_first(v, ok)
        out.append((name, kind, v, ok, name in t["dictionary"]))
    return out


def dim_columns(cfg: dict) -> tuple:
    """date_dim (d_date_sk, d_year) and store (s_store_sk, s_store_name)."""
    d = cfg["tables"]["date_dim"]
    d0 = d["date_sk_first"]
    dsk = np.arange(d0, d0 + d["rows"], dtype=np.int32)
    year = (1900 + (dsk.astype(np.int64) - d0) // 365.25).astype(np.int32)
    dates = [("d_date_sk", "int32", dsk, None, False),
             ("d_year", "int32", year, None, False)]
    s = cfg["tables"]["store"]
    syl = s["name_syllables"]
    names = [(syl[(i // 10) % 10] + syl[i % 10]).encode()
             for i in range(s["rows"])]  # every tenth store shares a name
    stores = [("s_store_sk", "int32",
               np.arange(1, s["rows"] + 1, dtype=np.int32), None, False),
              ("s_store_name", "string", names, None, False)]
    return dates, stores


def year_ranges(dates: list, years) -> dict:
    """{year: (first d_date_sk, last d_date_sk)} of each calendar year."""
    dsk, year = dates[0][2], dates[1][2]
    return {int(y): (int(dsk[year == y].min()), int(dsk[year == y].max()))
            for y in years}


def make(cfg: dict, seed: int, cache: Path) -> dict:
    """The inputs of one run: the columns q5 reads, the three files and the
    fact file's layout."""
    fact = fact_columns(cfg, seed)
    dates, stores = dim_columns(cfg)
    root = Path(cache) / f"seed{seed}"
    done = root / "layout.json"
    wrote = False
    if not done.exists():
        if Path(cache).exists():
            shutil.rmtree(cache)  # one seed is kept at most
        root.mkdir(parents=True)
        t = cfg["tables"]["store_sales"]
        layout = write_parquet(root / FILES[0], fact, t["row_group_rows"],
                               t["codec"])
        big = 1 << 30
        write_parquet(root / FILES[1], dates, big, t["codec"])
        write_parquet(root / FILES[2], stores, big, t["codec"])
        done.write_text(json.dumps(layout))
        wrote = True
    return {"fact": [c for c in fact if c[0] in COLUMNS], "dates": dates, "stores": stores, "root": root,
            "layout": json.loads(done.read_text()), "wrote_files": wrote,
            "years": year_ranges(dates, cfg["years"])}
