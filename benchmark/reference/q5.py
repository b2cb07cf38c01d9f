"""NDS q5-lite (store channel) in NumPy, frozen from ``chip_smoke.py``.

Sales, profit and the count of priced sales by store name over the fact
rows of ``[date_lo, date_hi]``, with the date's and the store key's nulls
dropped (the joins) and the price's and profit's nulls left out of their
sums, the price's out of the count.  Beside each sum it gives the sum of
absolute values of its terms, the scale against which a gap in the sum is
judged.  ``dtype`` is the precision the
sums are taken in: float64 is the reference, float32 the control.
"""

from __future__ import annotations

import numpy as np

# the store_sales columns the query reads
COLUMNS = ("ss_sold_date_sk", "ss_store_sk", "ss_ext_sales_price",
           "ss_net_profit")


def _group_sums(keys: np.ndarray, vals: np.ndarray, m: int,
                dtype) -> np.ndarray:
    """Sums of ``vals`` by ``keys`` (< m), each added in ``dtype`` in row
    order."""
    order = np.argsort(keys, kind="stable")
    k, v = keys[order], vals[order].astype(dtype)
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]]) if len(k) else \
        np.zeros(0, np.int64)
    out = np.zeros(m, dtype)
    if len(k):
        out[k[starts]] = np.add.reduceat(v, starts)
    return out


def _valid(ok, n: int) -> np.ndarray:
    return np.ones(n, np.bool_) if ok is None else ok


def _add(a, b, dtype):
    """Spark's sum of two partial sums, None standing for null."""
    if a is None or b is None:
        return b if a is None else a
    return dtype(a + b)


def q5_oracle(fact, dates, stores, date_lo: int, date_hi: int,
              dtype=np.float64) -> dict:
    """{name: (sales, profit, n, sum |price|, sum |profit|)}; a sum with no
    non-null term is None (null), as Spark's."""
    c = {name: (v, ok) for name, _, v, ok, _ in fact}
    date, dok = c["ss_sold_date_sk"]
    d = dates[0][2]
    keep = np.isin(date, d[(d >= date_lo) & (d <= date_hi)])
    keep &= _valid(dok, len(date))
    store, sok = c["ss_store_sk"]
    keep &= _valid(sok, len(store))
    price, pok = c["ss_ext_sales_price"]
    profit, fok = c["ss_net_profit"]
    m = int(stores[0][2].max()) + 1
    sk = store[keep].astype(np.int64)
    pv = _valid(pok, len(price))[keep]
    fv = _valid(fok, len(profit))[keep]
    kept_price = np.where(pv, price[keep], 0.0)
    kept_profit = np.where(fv, profit[keep], 0.0)
    sales = _group_sums(sk, kept_price, m, dtype)
    prof = _group_sums(sk, kept_profit, m, dtype)
    abs_sales = np.bincount(sk, np.abs(kept_price), m)
    abs_prof = np.bincount(sk, np.abs(kept_profit), m)
    cnt = np.bincount(sk[pv], minlength=m)
    n_prof = np.bincount(sk[fv], minlength=m)
    has = np.bincount(sk, minlength=m) > 0
    out: dict = {}
    for s_sk, name in zip(stores[0][2].tolist(), stores[1][2]):
        if not has[s_sk]:
            continue
        key = name.decode()
        a, b, k, x, y = out.get(key, (None, None, 0, 0.0, 0.0))
        out[key] = (_add(a, sales[s_sk] if cnt[s_sk] else None, dtype),
                    _add(b, prof[s_sk] if n_prof[s_sk] else None, dtype),
                    k + int(cnt[s_sk]), x + abs_sales[s_sk],
                    y + abs_prof[s_sk])
    return out


def compare(got: dict, want: dict) -> tuple:
    """(mismatches, widest gap) of one answer against the reference's.

    A mismatch is a store name on one side only, a count that differs or a
    sum null on one side only.  The gap of a sum is ``|got - want| / sum
    |terms|``; the widest over both sums of every name is returned."""
    bad = len(set(got) ^ set(want))
    gap = 0.0
    for name in set(got) & set(want):
        gs, gp, gn = got[name][:3]
        ws, wp, wn, xs, xp = want[name]
        bad += int(gn != wn)
        for g, w, x in ((gs, ws, xs), (gp, wp, xp)):
            if g is None or w is None:
                bad += int((g is None) != (w is None))
                continue
            gap = max(gap, abs(float(g) - float(w)) / max(x, 1e-300))
    return bad, gap
