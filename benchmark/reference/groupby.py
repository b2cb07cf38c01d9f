"""Partial HashAggregate in NumPy: sums and a count by one integer key.

Integer sums are exact in int64; float sums are added in ``dtype`` in row
order (float64 is the reference, float32 the control), and beside each the
sum of absolute values of its terms, against which a gap is judged.  A sum
with no valid term is null, as Spark's is.
"""

from __future__ import annotations

import numpy as np


def groupby_sums(keys: np.ndarray, values, dtype=np.float64) -> dict:
    """``values``: [(name, array, valid or None)].  Returns ``{"keys":
    sorted distinct keys, "count": rows a key, name: (sums, valid,
    abs_sums or None)}``."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]]) if len(k) else \
        np.zeros(0, np.int64)
    out = {"keys": k[starts],
           "count": np.diff(np.r_[starts, len(k)]).astype(np.int64)}
    for name, v, ok in values:
        ok = np.ones(len(v), np.bool_) if ok is None else ok
        vo, oko = v[order], ok[order]
        has = np.add.reduceat(oko.astype(np.int64), starts) > 0 if len(k) \
            else np.zeros(0, np.bool_)
        if np.issubdtype(v.dtype, np.integer):
            terms = np.where(oko, vo.astype(np.int64), 0)
            sums = np.add.reduceat(terms, starts) if len(k) else terms[:0]
            out[name] = (sums, has, None)
        else:
            terms = np.where(oko, vo, 0.0)
            sums = (np.add.reduceat(terms.astype(dtype), starts) if len(k)
                    else terms[:0].astype(dtype))
            absum = (np.add.reduceat(np.abs(terms), starts) if len(k)
                     else terms[:0])
            out[name] = (sums, has, absum)
    return out
