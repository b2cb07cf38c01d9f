"""Window functions: partitioned, ordered analytics over rows.

The port of ``spark_rapids_jni_tpu/ops/window.py`` (the libcudf
rolling/window role; Spark plans these as WindowExec).  One stable
lexsort by (partition, order) keys puts every partition's rows together
in order; ranks and running aggregates are segmented scans over the
sorted rows; results scatter back to input row order through the
permutation.

- Counts, row numbers, integer and decimal sums: ``cumsum`` less the
  running total at the segment's start (exact: int64 wraps alike).
- Float sums, min and max: the segmented doubling scan of the JAX package
  (``_seg_scan``), so float sums add in the JAX package's order and agree
  with it, and between CPU and card, bit for bit.
- The RANGE frame's peers read the value at the end of their peer run,
  found by a reversed ``cummin`` over run-end positions.

Supported ops (Spark names): row_number, rank, dense_rank, percent_rank,
cume_dist, ntile (k), lag/lead (k), first_value/last_value, running
sum/min/max/count/mean over the default frame (RANGE UNBOUNDED PRECEDING
.. CURRENT ROW), and rolling_sum/rolling_count/rolling_mean (w) over ROWS
BETWEEN w-1 PRECEDING AND CURRENT ROW.
"""

from __future__ import annotations

import torch

from ..columnar import Column, Table
from ..dtypes import FLOAT64, INT64, int64_values
from ..utils.tracing import traced
from .aggregate import _minmax_key
from .order import SortKey, encode_keys, lexsort


def window_out_dtype(col_dtype, op: str):
    """Result dtype of a window op."""
    if op in ("row_number", "rank", "dense_rank", "count", "ntile"):
        return INT64
    if op in ("lag", "lead", "min", "max", "first_value", "last_value"):
        return col_dtype
    if op in ("mean", "percent_rank", "cume_dist"):
        return FLOAT64
    if op in ("sum", "rolling_sum"):
        if col_dtype.is_floating:
            return FLOAT64
        return col_dtype if col_dtype.is_decimal else INT64
    if op == "rolling_count":
        return INT64
    if op == "rolling_mean":
        return FLOAT64
    raise ValueError(f"unknown window op {op!r}")


def default_window_names(specs) -> list:
    """Default (de-duplicated) output names."""
    names, seen = [], {}
    for spec in specs:
        ref, op, *_ = spec
        nm = op if ref is None or not isinstance(ref, str) else f"{op}_{ref}"
        if nm in seen:
            seen[nm] += 1
            nm = f"{nm}_{seen[nm]}"
        else:
            seen[nm] = 1
        names.append(nm)
    return names


def _shift_down(arr: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Row i sees row i-k (front-filled)."""
    pad = torch.full((k,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([pad, arr[:-k]])


def _shift_up(arr: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Row i sees row i+k (back-filled)."""
    pad = torch.full((k,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr[k:], pad])


def _seg_scan(vals: torch.Tensor, seg: torch.Tensor, op) -> torch.Tensor:
    """Running ``op`` from each segment's start, by log2(n) doubling passes
    (the JAX package's ``_seg_scan``: the same operands meet in the same
    order)."""
    n = vals.shape[0]
    shift = 1
    while shift < n:
        same = seg[shift:] == seg[:-shift]
        vals = torch.cat([vals[:shift], torch.where(
            same, op(vals[shift:], vals[:-shift]), vals[shift:])])
        shift *= 2
    return vals


class _Frame:
    """The sorted rows' segment structure: partitions (``seg``), peer runs
    and positions, each a tensor over the sorted rows."""

    def __init__(self, pbounds: torch.Tensor, obounds: torch.Tensor):
        n = pbounds.shape[0]
        dev = pbounds.device
        self.n = n
        self.idx = torch.arange(n, device=dev)
        self.pbounds, self.obounds = pbounds, obounds
        self.seg = torch.cumsum(pbounds.to(torch.int64), 0) - 1
        zero = torch.zeros_like(self.idx)
        self.seg_start = torch.cummax(torch.where(pbounds, self.idx, zero),
                                      0).values
        self.run_start = torch.cummax(torch.where(obounds, self.idx, zero),
                                      0).values
        self.row_number = self.idx - self.seg_start + 1
        self.run_end = self._next_end(obounds)
        self.seg_end = self._next_end(pbounds)

    def _next_end(self, starts: torch.Tensor) -> torch.Tensor:
        """Index of the last row of each row's run, runs starting where
        ``starts`` is set."""
        is_end = torch.cat([starts[1:], torch.ones_like(starts[:1])])
        ends = torch.where(is_end, self.idx, torch.full_like(self.idx,
                                                             self.n))
        return torch.cummin(ends.flip(0), 0).values.flip(0)

    def running_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """Segmented inclusive prefix sum: exact cumsum arithmetic for
        integers, the doubling scan for floats."""
        if vals.dtype.is_floating_point:
            return _seg_scan(vals, self.seg, torch.add)
        c = torch.cumsum(vals, 0)
        return c - (c - vals)[self.seg_start]

    def peer_fill(self, arr: torch.Tensor) -> torch.Tensor:
        """RANGE frame: every peer reads its peer run's last value."""
        return arr[self.run_end]


def _float_vals(col: Column, sval: torch.Tensor) -> torch.Tensor:
    if col.dtype.is_floating:
        return sval.to(torch.float64)
    return int64_values(col.dtype, sval)


def _running(op: str, col: Column, sval, svalid, fr: _Frame):
    """(dtype, data, validity) of a running aggregate over the default
    frame; with no ORDER BY the whole partition is one peer run."""
    cnt = fr.peer_fill(fr.running_sum(svalid.to(torch.int64)))
    if op == "count":
        return INT64, cnt, None
    if op in ("sum", "mean"):
        vf = _float_vals(col, sval)
        s = fr.peer_fill(fr.running_sum(
            torch.where(svalid, vf, torch.zeros_like(vf))))
        if op == "mean":
            mean = s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
            if col.dtype.is_decimal:
                mean = mean * (10.0 ** col.dtype.scale)
            return FLOAT64, mean, cnt > 0
        if col.dtype.is_floating:
            return FLOAT64, s, cnt > 0
        return (col.dtype if col.dtype.is_decimal else INT64), s, cnt > 0
    if op in ("min", "max"):
        key, decode, ident_min, ident_max = _minmax_key(
            Column(col.dtype, data=sval))
        ident = ident_min if op == "min" else ident_max
        red = _seg_scan(torch.where(svalid, key, torch.full_like(key, ident)),
                        fr.seg, torch.minimum if op == "min"
                        else torch.maximum)
        return col.dtype, decode(fr.peer_fill(red)), cnt > 0
    raise ValueError(f"unknown window aggregate {op!r}")


def _rolling(op: str, col: Column, sval, svalid, fr: _Frame, k: int):
    """ROWS frame of the last ``k`` rows of the partition, by prefix
    differences; non-finite floats are counted apart so a NaN or an
    infinity only reaches the windows that hold it."""
    n = fr.n
    kk = min(k, n)

    def windowed(contrib):
        ps = fr.running_sum(contrib)
        if kk == 0:
            return ps
        pk = _shift_down(ps, kk, 0)
        sk = _shift_down(fr.seg, kk, -1)
        return ps - torch.where(sk == fr.seg, pk, torch.zeros_like(pk))

    is_float = col.dtype.is_floating
    vf = _float_vals(col, sval)
    zero = torch.zeros_like(vf)
    if is_float:
        finite = torch.isfinite(vf)
        rsum = windowed(torch.where(svalid & finite, vf, zero))
        nan_w = windowed((svalid & torch.isnan(vf)).to(torch.int64))
        pinf_w = windowed((svalid & torch.isposinf(vf)).to(torch.int64))
        ninf_w = windowed((svalid & torch.isneginf(vf)).to(torch.int64))
        rsum = torch.where(pinf_w > 0, torch.inf, rsum)
        rsum = torch.where(ninf_w > 0, -torch.inf, rsum)
        rsum = torch.where((nan_w > 0) | ((pinf_w > 0) & (ninf_w > 0)),
                           torch.nan, rsum)
    else:
        rsum = windowed(torch.where(svalid, vf, zero))
    rcnt = windowed(svalid.to(torch.int64))
    if op == "rolling_count":
        return INT64, rcnt, None
    if op == "rolling_sum":
        if is_float:
            return FLOAT64, rsum, rcnt > 0
        return (col.dtype if col.dtype.is_decimal else INT64), rsum, rcnt > 0
    mean = rsum.to(torch.float64) / rcnt.clamp(min=1).to(torch.float64)
    if col.dtype.is_decimal:
        mean = mean * (10.0 ** col.dtype.scale)
    return FLOAT64, mean, rcnt > 0


def _resolve_specs(table: Table, specs):
    """[(value column or None, op, k)], with Spark's lag(-k) == lead(k)."""
    resolved = []
    for spec in specs:
        ref, op, *rest = spec
        col = None
        if ref is None:
            if op == "count":  # count(*): peers share the frame (RANGE)
                op = "count_star"
            elif op not in ("row_number", "rank", "dense_rank",
                            "percent_rank", "cume_dist", "ntile"):
                raise ValueError(
                    f"window op {op!r} needs a value column (got None)")
        else:
            col = ref if isinstance(ref, Column) else table.column(ref)
            if col.dtype.is_string:
                raise TypeError("string value columns are not supported in "
                                "window aggregates")
            if col.data is None or col.data.dim() != 1:
                raise TypeError(
                    f"window value column must be 1-D fixed-width; "
                    f"{col.dtype!r} is not (DECIMAL128 limb pairs and "
                    "nested columns are not window values)")
        k = int(rest[0]) if rest else 1
        if op == "ntile" and k < 1:
            raise ValueError(f"NTILE bucket count must be >= 1, got {k}")
        if op.startswith("rolling_") and k < 1:
            raise ValueError(f"rolling window size must be >= 1, got {k}")
        if op in ("lag", "lead") and k < 0:
            op = "lead" if op == "lag" else "lag"
            k = -k
        resolved.append((col, op, k))
    return resolved


def _bounds(words, order, first):
    out = first.clone()
    for w in words:
        s = w[order]
        out[1:] |= s[1:] != s[:-1]
    return out


@traced("window")
def window(table: Table, partition_by: list, order_by: list,
           specs: list[tuple], names: list | None = None,
           live=None) -> Table:
    """Append window columns; rows keep their input order.

    ``specs``: (column_or_None, op) or (column, op, k) for lag/lead, ntile
    and the rolling ops.  ``order_by`` entries may be names or SortKeys.
    ``live``: optional bool[n] row mask of padded inputs; dead rows form
    their own trailing partition (their outputs are garbage to be masked).
    """
    n = table.num_rows
    pkeys = [k if isinstance(k, SortKey) else SortKey(table.column(k))
             for k in partition_by]
    okeys = [k if isinstance(k, SortKey) else SortKey(table.column(k))
             for k in order_by]
    pwords = encode_keys(pkeys)
    if live is not None:
        pwords = [(~live).to(torch.int64)] + pwords
    owords = encode_keys(okeys)
    resolved = _resolve_specs(table, specs)
    dev = table.columns[0].device if table.columns else \
        torch.device("cpu")

    order = lexsort(pwords + owords) if pwords or owords else \
        torch.arange(n, device=dev)
    first = torch.arange(n, device=dev) == 0
    pbounds = _bounds(pwords, order, first)
    fr = _Frame(pbounds, _bounds(owords, order, pbounds))
    sorted_cols: dict[int, tuple] = {}

    def sorted_of(col):
        if id(col) not in sorted_cols:
            sorted_cols[id(col)] = (col.data[order], col.valid_mask()[order])
        return sorted_cols[id(col)]

    out_sorted = []
    for col, op, k in resolved:
        if op == "row_number":
            out_sorted.append((INT64, fr.row_number, None))
        elif op == "count_star":
            out_sorted.append((INT64, fr.peer_fill(fr.row_number), None))
        elif op in ("rank", "percent_rank"):
            rank = fr.row_number[fr.run_start]
            if op == "rank":
                out_sorted.append((INT64, rank, None))
            else:
                ps = fr.row_number[fr.seg_end].to(torch.float64)
                out_sorted.append((FLOAT64, (rank - 1).to(torch.float64)
                                   / (ps - 1.0).clamp(min=1.0), None))
        elif op == "cume_dist":
            out_sorted.append((FLOAT64, fr.peer_fill(fr.row_number).to(
                torch.float64) / fr.row_number[fr.seg_end].to(torch.float64),
                None))
        elif op == "ntile":
            # Spark NTile: the first (n % k) buckets get ceil(n/k) rows
            ps = fr.row_number[fr.seg_end]
            base, rem = ps // k, ps % k
            rn0 = fr.row_number - 1
            big = (base + 1) * rem
            tile = torch.where(rn0 < big, rn0 // (base + 1).clamp(min=1),
                               rem + (rn0 - big) // base.clamp(min=1))
            out_sorted.append((INT64, tile + 1, None))
        elif op == "dense_rank":
            d = torch.cumsum(fr.obounds.to(torch.int64), 0)
            out_sorted.append((INT64, d - d[fr.seg_start] + 1, None))
        elif op in ("lag", "lead"):
            sval, sv = sorted_of(col)
            if k == 0:
                shifted, shv, sseg = sval, sv, fr.seg
            elif k >= n:  # the whole partition is out of range: all null
                shifted = torch.zeros_like(sval)
                shv = torch.zeros_like(sv)
                sseg = torch.full_like(fr.seg, -1)
            else:
                shift = _shift_down if op == "lag" else _shift_up
                shifted = shift(sval, k, 0)
                shv = shift(sv, k, False)
                sseg = shift(fr.seg, k, -1)
            out_sorted.append((col.dtype, shifted, (sseg == fr.seg) & shv))
        elif op in ("first_value", "last_value"):
            # default frame: the partition's first row; the end of the
            # current peer run
            sval, sv = sorted_of(col)
            at = fr.seg_start if op == "first_value" else fr.run_end
            out_sorted.append((col.dtype, sval[at], sv[at]))
        elif op.startswith("rolling_"):
            sval, sv = sorted_of(col)
            out_sorted.append(_rolling(op, col, sval, sv, fr, k))
        else:
            sval, sv = sorted_of(col)
            out_sorted.append(_running(op, col, sval, sv, fr))

    out_cols = []
    for dtype, data, valid in out_sorted:
        back = torch.empty_like(data)
        back[order] = data
        bvalid = None
        if valid is not None:
            bvalid = torch.empty_like(valid)
            bvalid[order] = valid
        out_cols.append(Column(dtype, data=back, validity=bvalid))
    out_names = list(names) if names is not None \
        else default_window_names(specs)
    return Table(list(table.columns) + out_cols,
                 list(table.names or [f"c{i}" for i in
                                      range(table.num_columns)]) + out_names)
