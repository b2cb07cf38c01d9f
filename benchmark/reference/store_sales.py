"""TPC-DS ``store_sales`` columns drawn from a seed, for both configurations.

One null model and one set of ranges serve every configuration that holds
store_sales: each column uniform over its SF100 range (money in cents),
nulls at the configuration's ``null_rate`` in every column that is not
part of the key (``ss_item_sk``, ``ss_ticket_number``).
"""

from __future__ import annotations

import numpy as np


def draw_columns(columns: list, n: int, null_rate: float, rng) -> list:
    """[(name, type, values, valid or None)] of ``n`` rows, one column of
    ``columns`` (the configuration's list) after the other."""
    out = []
    for c in columns:
        if c["type"] == "float64":
            lo, hi = c["cents"]
            v = rng.integers(lo, hi + 1, n) / 100.0
        else:
            lo, hi = c["range"]
            v = rng.integers(lo, hi + 1, n, dtype=np.dtype(c["type"]))
        ok = None if c.get("key") else rng.random(n) >= null_rate
        out.append((c["name"], c["type"], v, ok))
    return out


def sort_nulls_first(values: np.ndarray, valid) -> tuple:
    """The column sorted ascending with its nulls first, as Spark's ``ORDER
    BY`` lays it out: the same number of nulls, the non-null values in
    order after them (a null's slot holds the smallest value)."""
    if valid is None:
        return np.sort(values), None
    k = int(np.count_nonzero(~valid))
    out = np.empty_like(values)
    out[k:] = np.sort(values[valid])
    out[:k] = out[k] if k < len(values) else 0
    ok = np.ones(len(values), np.bool_)
    ok[:k] = False
    return out, ok
