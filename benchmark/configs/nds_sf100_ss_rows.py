"""Inputs of ``nds_sf100_ss_rows``: batches of store_sales in JCUDF rows.

Every column drawn by ``reference.store_sales`` from the seed on the host
(uniform over its SF100 range, money in cents, nulls at the configured rate
outside the key columns); each batch packed into rows by the reference's
own packer.  The program gets the rows; the reference keeps the columns
they were packed from.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import jcudf
from benchmark.reference.store_sales import draw_columns


def batch_columns(cfg: dict, rng) -> list:
    """[(name, values, valid or None)] of one batch."""
    return [(name, v, ok) for name, _, v, ok in draw_columns(
        cfg["columns"], cfg["batch_rows"], cfg["null_rate"], rng)]


def make(cfg: dict, seed: int, cache=None) -> dict:
    """``{"names", "dtypes", "batches": [{"columns", "rows"}]}``: each
    batch's columns and its rows as ``uint8[n * row_size]``."""
    rng = np.random.default_rng(seed + 29)
    batches = []
    for _ in range(cfg["batches"]):
        cols = batch_columns(cfg, rng)
        batches.append({"columns": cols,
                        "rows": jcudf.pack([(v, ok) for _, v, ok in cols])})
    return {"names": [c["name"] for c in cfg["columns"]],
            "dtypes": [np.dtype(c["type"]) for c in cfg["columns"]],
            "batches": batches}
