"""GroupBy aggregation (the partial HashAggregate of a Spark stage).

Groups come out in the JAX package's order: ascending in the encoded key
words (``ops/order.py``), nulls first.  The steps:

    1. order = stable lexsort of the key words
    2. bounds = sorted row != previous row; seg = cumsum(bounds) - 1
    3. gid[order] = seg                       (group id of each input row)
    4. each aggregation scatters its rows into their group
       (``index_add_`` / ``scatter_reduce``)

The JAX package carries values through the sort and takes prefix-sum
differences because scatters serialize on a TPU; on a GPU a scatter with
atomics is the natural form.  Integer sums, counts and min/max are exact
either way; float sums are taken in another order (atomics), so they agree
with the JAX package exactly only where the sum is exact.

Null semantics match Spark and the JAX package: null keys form one group;
null values are left out of sum/min/max/mean/var/count(col); count_all
counts rows; first/last take the group's first/last row in input order
(ignoreNulls=False).  ``groupby_padded`` returns n-row outputs and the
group count as a tensor (no host sync); ``groupby`` compacts to the groups,
reading the group count and each key's null check on the host
(``ops.host_sync.groupby.*``).  The profiler ranges ``groupby.sort``,
``groupby.reduce`` and ``groupby.compact`` split the op into its phases.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..columnar import Column, Table
from ..dtypes import TypeId, INT64, FLOAT64, int64_values
from ..utils.floatbits import SIGN64
from ..utils.tracing import span, sync_point, traced
from .order import (SortKey, _fixed_to_u64, decode_minmax_bits, encode_keys,
                    lexsort, rows_differ_from_prev)
from .strings_common import from_padded_bytes, to_padded_bytes

AGGS = ("sum", "min", "max", "mean", "count", "count_all", "var", "std",
        "sumsq", "fsum", "first", "last", "collect_list")

_DISTINCT_OPS = ("nunique", "count_distinct")  # Spark count(DISTINCT col)

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
def _float64_vals(col: Column) -> torch.Tensor:
    """float64 values (Spark casts var/std inputs to double)."""
    if col.dtype.is_floating:
        return col.data.to(torch.float64)
    if col.dtype.is_decimal:
        return int64_values(col.dtype, col.data).to(torch.float64) * \
            (10.0 ** col.dtype.scale)
    return int64_values(col.dtype, col.data).to(torch.float64)


def _minmax_key(col: Column):
    """(signed-order int64 key, key -> data decoder, min identity, max
    identity) for min/max; the identities are the JAX package's (the
    storage type's extremes for integers, the encoded extremes for
    floats), so empty groups hold the same bits."""
    d = col.dtype
    if d.id == TypeId.DECIMAL128:
        # as in the JAX package, which raises on the [n, 2] limb pairs
        raise ValueError("min/max over DECIMAL128 is not supported")
    if d.is_floating:
        def decode(red):
            return decode_minmax_bits(red ^ SIGN64, d)
        return _fixed_to_u64(col) ^ SIGN64, decode, _I64_MAX, _I64_MIN
    if d.id == TypeId.UINT64:
        def decode(red):
            return red ^ SIGN64
        return col.data ^ SIGN64, decode, _I64_MAX, _I64_MIN
    info = np.iinfo(d.storage)
    tdt = d.torch_dtype

    def decode(red):
        return red.to(tdt)
    return (int64_values(col.dtype, col.data), decode, int(info.max),
            int(info.min))


def _groups(key_cols, row_mask, n: int, dev: torch.device):
    """(gid[n] group id of every input row, ngroups as a 0-d tensor).
    Masked-out rows sort after every live row, into groups >= ngroups."""
    words = encode_keys([SortKey(c) for c in key_cols])
    if row_mask is not None:
        words = [(~row_mask).to(torch.int64)] + words
    order = lexsort(words)
    bounds = rows_differ_from_prev(words, order)
    seg = torch.cumsum(bounds.to(torch.int64), 0) - 1
    gid = torch.empty(n, dtype=torch.int64, device=dev)
    gid[order] = seg
    if n == 0:
        ngroups = torch.zeros((), dtype=torch.int64, device=dev)
    elif row_mask is None:
        ngroups = seg[-1] + 1
    else:
        ngroups = (bounds & row_mask[order]).sum()
    return gid, ngroups


def _scatter_sum(gid, vals, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, gid, vals)


def _scatter_ext(gid, vals, n: int, fill: int, reduce: str) -> torch.Tensor:
    """Per-group amin/amax of ``vals`` (int64), ``fill`` where empty."""
    return torch.full((n,), fill, dtype=vals.dtype, device=vals.device) \
        .scatter_reduce_(0, gid, vals, reduce, include_self=True)


def _agg_column(col, op: str, gid, n: int, live) -> Column:
    """One aggregation, n-row output (rows >= ngroups are padding).
    ``live``: bool[n] live-row mask of padded pipelines, or None."""
    dev = gid.device
    idx = torch.arange(n, device=dev)
    if op == "count_all":
        ones = torch.ones(n, dtype=torch.int64, device=dev) if live is None \
            else live.to(torch.int64)
        return Column(INT64, data=_scatter_sum(gid, ones, n))
    if col.dtype.is_string and op != "count":
        raise TypeError("string value aggregation not supported")
    if op in ("first", "last"):
        # the group's first/last live row in input order (the key sort is
        # stable), whatever its validity
        keep = idx if live is None else torch.where(
            live, idx, torch.full_like(idx, n if op == "first" else -1))
        pos = _scatter_ext(gid, keep, n, n if op == "first" else -1,
                           "amin" if op == "first" else "amax")
        has_row = (pos >= 0) & (pos < n)
        pos_c = pos.clamp(0, max(n - 1, 0))
        return Column(col.dtype, data=col.data[pos_c],
                      validity=col.valid_mask()[pos_c] & has_row)

    valid = col.valid_mask() if live is None else col.valid_mask() & live
    counts = _scatter_sum(gid, valid.to(torch.int64), n)
    if op == "count":
        return Column(INT64, data=counts)
    has_any = counts > 0

    if op in ("sum", "mean"):
        tid = col.dtype.id
        if tid == TypeId.DECIMAL128:
            # as in the JAX package, which raises on the [n, 2] limb pairs
            raise ValueError("sum/mean over DECIMAL128 is not supported")
        is_float = col.dtype.is_floating
        vals = col.data.to(torch.float64) if is_float else \
            int64_values(col.dtype, col.data)
        s = _scatter_sum(gid, torch.where(valid, vals,
                                          torch.zeros_like(vals)), n)
        if op == "mean":
            m = s.to(torch.float64) / counts.clamp(min=1).to(torch.float64)
            if col.dtype.is_decimal:
                m = m * (10.0 ** col.dtype.scale)
            return Column(FLOAT64, data=m, validity=has_any)
        if is_float:
            return Column(FLOAT64, data=s, validity=has_any)
        return Column(col.dtype if col.dtype.is_decimal else INT64, data=s,
                      validity=has_any)

    if op in ("var", "std", "sumsq", "fsum"):
        vf = torch.where(valid, _float64_vals(col),
                         torch.zeros(n, dtype=torch.float64, device=dev))
        if op in ("var", "std"):
            # shift by the group's first VALID value (variance is
            # shift-invariant; the two-moment formula cancels when
            # |mean| >> std; null slots must not leak in)
            first = _scatter_ext(gid, torch.where(valid, idx,
                                                  torch.full_like(idx, n)),
                                 n, n, "amin")
            pivot = vf[first.clamp(0, max(n - 1, 0))]
            vf = torch.where(valid, vf - pivot[gid], torch.zeros_like(vf))
        s = _scatter_sum(gid, vf, n)
        q = _scatter_sum(gid, vf * vf, n)
        if op in ("sumsq", "fsum"):
            return Column(FLOAT64, data=q if op == "sumsq" else s,
                          validity=has_any)
        nf = counts.to(torch.float64)
        var = (q - s * s / nf.clamp(min=1.0)) / (nf - 1.0).clamp(min=1.0)
        var = var.clamp(min=0.0)  # catastrophic cancellation
        return Column(FLOAT64, data=var.sqrt() if op == "std" else var,
                      validity=counts > 1)

    if op in ("min", "max"):
        key, decode, ident_min, ident_max = _minmax_key(col)
        ident = ident_min if op == "min" else ident_max
        red = _scatter_ext(gid, torch.where(valid, key,
                                            torch.full_like(key, ident)),
                           n, ident, "amin" if op == "min" else "amax")
        return Column(col.dtype, data=decode(red), validity=has_any)

    if op == "collect_list":
        raise ValueError("collect_list builds a LIST column; use groupby")
    raise ValueError(f"unknown aggregation {op!r}; expected one of {AGGS}")


@traced("groupby_padded")
def groupby_padded(table: Table, key_names: list, aggs: list[tuple],
                   keys_cols: list | None = None, row_mask=None,
                   device=_device.DEFAULT):
    """(out_keys, out_aggs, ngroups) with n-row outputs; rows >= ngroups
    are padding.  ``out_keys`` holds ("fixed", dtype, data, valid) or
    ("string", byte matrix, lengths, valid) per key, as in the JAX
    package; ``ngroups`` is a 0-d tensor.  ``row_mask`` marks the live
    rows of a padded input; dead rows are in no live group."""
    dev = _device.resolve(device)
    table = table.to(dev)
    key_cols = [c.to(dev) for c in keys_cols] if keys_cols is not None \
        else [table.column(k) for k in key_names]
    if row_mask is not None:
        row_mask = row_mask.to(dev)
    n = key_cols[0].size
    resolved = []
    for col_ref, op in aggs:
        col = col_ref.to(dev) if isinstance(col_ref, Column) else \
            (None if op == "count_all" else table.column(col_ref))
        resolved.append((col, op))

    with span("groupby.sort"):
        gid, ngroups = _groups(key_cols, row_mask, n, dev)
    with span("groupby.reduce"):
        idx = torch.arange(n, device=dev)
        first = _scatter_ext(gid, idx, n, n, "amin").clamp(0, max(n - 1, 0))
        out_keys = []
        for c in key_cols:
            valid = c.valid_mask()[first]
            if c.dtype.is_string:
                mat, lengths = to_padded_bytes(c)
                out_keys.append(("string", mat[first], lengths[first], valid))
            else:
                out_keys.append(("fixed", c.dtype, c.data[first], valid))
        out_aggs = [_agg_column(col, op, gid, n, row_mask)
                    for col, op in resolved]
    return out_keys, out_aggs, ngroups


def _key_segments(table: Table, key_names: list, value_col=None):
    """(order, key_bounds, pair_bounds) of one stable lexsort over the key
    words (then the value's, with ``value_col``).  Group i of the base
    groupby is key segment i here: both ascend in the key words.
    ``pair_bounds`` marks each distinct (key, value) run (else None)."""
    kwords = encode_keys([SortKey(table.column(k)) for k in key_names])
    vwords = [] if value_col is None else encode_keys([SortKey(value_col)])
    order = lexsort(kwords + vwords)
    kb = rows_differ_from_prev(kwords, order)
    pb = None if value_col is None else \
        kb | rows_differ_from_prev(vwords, order)
    return order, kb, pb


def _assemble_special_aggs(base: Table, nkeys: int, aggs: list,
                           names: list | None, is_special, build) -> Table:
    """Base scalar-agg columns interleaved with specially built columns in
    the caller's agg order."""
    out_cols = list(base.columns[:nkeys])
    oi = nkeys
    for ref, op in aggs:
        if is_special(op):
            out_cols.append(build(ref))
        else:
            out_cols.append(base.columns[oi])
            oi += 1
    agg_names = names or [f"{op}_{ref if isinstance(ref, str) else i}"
                          for i, (ref, op) in enumerate(aggs)]
    return Table(out_cols, list(base.names[:nkeys]) + list(agg_names))


def _base_groupby(table, key_names, aggs, special, device) -> Table:
    others = [(r, op) for r, op in aggs if op not in special]
    return groupby(table, key_names, others or [(key_names[0], "count_all")],
                   device=device)


def _groupby_with_collect(table: Table, key_names: list, aggs: list,
                          names: list | None, device) -> Table:
    """groupby with collect_list aggs: the list columns are assembled on
    the host over the key segments, as the JAX package assembles them, and
    placed on ``device``.  Spark semantics: null elements are dropped; a
    group of nulls gives [] not null."""
    table = table.to(device)
    base = _base_groupby(table, key_names, aggs, ("collect_list",), device)
    order, bounds, _ = _key_segments(table, key_names)
    with sync_point("groupby.collect_host"):
        order = order.cpu().numpy()
        starts = np.flatnonzero(bounds.cpu().numpy())
    n = len(order)
    ends = np.append(starts[1:], n)

    def collect(ref) -> Column:
        col = ref if isinstance(ref, Column) else table.column(ref)
        col = col.to(device)
        with sync_point("groupby.collect_host"):
            valid = col.validity_numpy()[order]
            vals = col.to_pylist() if col.dtype.is_string else \
                col.data.cpu().numpy()[order]
        if col.dtype.is_string:
            groups = [[vals[r] for r in order[a:b] if vals[r] is not None]
                      for a, b in zip(starts, ends)]
            child = Column.from_pylist([v for g in groups for v in g],
                                       dtype=col.dtype, device=device)
        else:
            groups = [vals[a:b][valid[a:b]] for a, b in zip(starts, ends)]
            flat = np.concatenate(groups) if groups else \
                np.zeros((0,) + vals.shape[1:], vals.dtype)
            child = Column(col.dtype, data=torch.from_numpy(flat).to(device))
        lens = np.fromiter((len(g) for g in groups), np.int64, len(starts))
        offsets = np.zeros(len(starts) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        if offsets[-1] > np.iinfo(np.int32).max:
            raise ValueError("collect_list output exceeds int32 offsets")
        return Column.list_(child, offsets.astype(np.int32), device=device)

    return _assemble_special_aggs(base, len(key_names), aggs, names,
                                  lambda op: op == "collect_list", collect)


def _groupby_with_nunique(table: Table, key_names: list, aggs: list,
                          names: list | None, device) -> Table:
    """groupby with count(DISTINCT col) aggs, on ``device``: one lexsort
    over (keys, value) per distinct column; each group counts the first
    row of every distinct non-null value (Spark: nulls are not counted,
    an all-null group counts 0)."""
    table = table.to(device)
    base = _base_groupby(table, key_names, aggs, _DISTINCT_OPS, device)
    ngroups = base.num_rows

    def nunique(ref) -> Column:
        col = table.column(ref)
        order, kb, pb = _key_segments(table, key_names, value_col=col)
        gid = torch.cumsum(kb.to(torch.int64), 0) - 1
        take = (pb & col.valid_mask()[order]).to(torch.int64)
        cnt = torch.zeros(ngroups, dtype=torch.int64, device=gid.device)
        return Column(INT64, data=cnt.index_add_(0, gid, take))

    return _assemble_special_aggs(base, len(key_names), aggs, names,
                                  lambda op: op in _DISTINCT_OPS, nunique)


@traced("groupby")
def groupby(table: Table, key_names: list, aggs: list[tuple],
            names: list | None = None, device=_device.DEFAULT) -> Table:
    """GROUP BY ``key_names`` with aggregations [(column, op), ...] ->
    compact Table on ``device``.

    op in {sum, min, max, mean, count, count_all, var, std, sumsq, fsum,
    first, last, collect_list} plus nunique / count_distinct (Spark
    count(DISTINCT col): null values not counted).  var/std are sample
    (ddof=1) moments; collect_list drops null elements and returns a LIST
    column, assembled on the host as in the JAX package.
    """
    for _, op in aggs:
        if op not in AGGS and op not in _DISTINCT_OPS:
            raise ValueError(
                f"unknown aggregation {op!r}; expected one of {AGGS}")
    if any(op in _DISTINCT_OPS for _, op in aggs):
        return _groupby_with_nunique(table, key_names, aggs, names,
                                     _device.resolve(device))
    if any(op == "collect_list" for _, op in aggs):
        return _groupby_with_collect(table, key_names, aggs, names,
                                     _device.resolve(device))
    out_keys, out_aggs, ngroups = groupby_padded(table, key_names, aggs,
                                                 device=device)
    with span("groupby.compact"):
        with sync_point("groupby.ngroups"):
            ng = int(ngroups)
        cols = []
        for spec in out_keys:
            valid = spec[3][:ng]
            with sync_point("groupby.key_nulls"):
                has_null = not bool(valid.all())
            if spec[0] == "string":
                cols.append(from_padded_bytes(spec[1][:ng], spec[2][:ng],
                                              valid if has_null else None))
            else:
                cols.append(Column(spec[1], data=spec[2][:ng],
                                   validity=valid if has_null else None))
        for c in out_aggs:
            cols.append(Column(c.dtype, data=c.data[:ng],
                               validity=None if c.validity is None
                               else c.validity[:ng]))
    key_names_out = [k if isinstance(k, str) else f"key{i}"
                     for i, k in enumerate(key_names)]
    agg_names = names or [f"{op}_{ref if isinstance(ref, str) else i}"
                          for i, (ref, op) in enumerate(aggs)]
    return Table(cols, key_names_out + list(agg_names))
