"""Row selection: gather (STRING, LIST and STRUCT aware), boolean-mask
filter, sort, concat, slice — the cudf primitives the op layer builds on,
with cudf's NULLIFY out-of-bounds gather policy."""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column, Table
from ..dtypes import TypeId
from ..utils.tracing import traced
from .order import (SortKey, encode_keys, lexsort, rows_differ_from_prev,
                    sort_indices)
from .strings_common import ragged_copy


def _gather_string(col: Column, indices: torch.Tensor,
                   indices_valid=None) -> Column:
    """Ragged STRING gather: each output row copies its source row's bytes
    (out-of-bounds rows become empty nulls)."""
    dev = col.device
    indices = indices.to(dev)
    n = col.size
    m = indices.shape[0]
    ok = (indices >= 0) & (indices < n)
    if n == 0:
        return Column.string(torch.zeros(0, dtype=torch.uint8, device=dev),
                             torch.zeros(m + 1, dtype=torch.int32,
                                         device=dev),
                             validity=torch.zeros(m, dtype=torch.bool,
                                                  device=dev), device=dev)
    safe = indices.clamp(0, n - 1)
    offs = col.offsets.to(torch.int64)
    lens = torch.where(ok, (offs[1:] - offs[:-1])[safe],
                       torch.zeros_like(safe))
    new_offs = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=new_offs[1:])
    total = int(new_offs[-1]) if m else 0
    if total > np.iinfo(np.int32).max:
        raise OverflowError("gathered STRING column exceeds int32 offsets")
    chars = torch.empty(total, dtype=torch.uint8, device=dev)
    ragged_copy(chars, new_offs[:-1], col.data, offs[safe], lens)
    valid = ok
    if col.validity is not None:
        valid = valid & col.validity[safe]
    if indices_valid is not None:
        valid = valid & indices_valid
    return Column.string(chars, new_offs.to(torch.int32), valid, device=dev)


def gather_column(col: Column, indices, indices_valid=None) -> Column:
    """Row gather with cudf NULLIFY semantics, for every column kind."""
    if col.dtype.is_string:
        return _gather_string(col, indices, indices_valid)
    return col.gather(indices, indices_valid)


def gather_table(table: Table, indices, indices_valid=None) -> Table:
    return Table([gather_column(c, indices, indices_valid)
                  for c in table.columns], table.names)


def _filter_mask(mask) -> torch.Tensor:
    """bool[n] keep-mask; null mask entries drop the row (Spark filter)."""
    if isinstance(mask, Column):
        return (mask.data != 0) & mask.valid_mask()
    return mask.to(torch.bool)


@traced("apply_boolean_mask")
def apply_boolean_mask(table: Table, mask) -> Table:
    """Keep the rows where ``mask`` is True (null counts as False)."""
    return gather_table(table, torch.nonzero(_filter_mask(mask),
                                             as_tuple=True)[0])


@traced("sort_table")
def sort_table(table: Table, keys: list[SortKey]) -> Table:
    """cudf sorted_order + gather as one call."""
    return gather_table(table, sort_indices(keys))


def concat_tables(tables: list[Table]) -> Table:
    """Vertical concatenation of same-schema Tables (cudf concatenate);
    STRING/LIST offsets are rebased."""
    if not tables:
        raise ValueError("concat_tables needs at least one table")
    if len(tables) == 1:
        return tables[0]
    first = tables[0]
    for t in tables[1:]:
        if t.num_columns != first.num_columns or any(
                not _schema_matches(a, b)
                for a, b in zip(first.columns, t.columns)):
            raise TypeError("concat_tables requires identical schemas "
                            "(including nested child types)")
    return Table([_concat_columns([t.columns[i] for t in tables])
                  for i in range(first.num_columns)], first.names)


def _schema_matches(a: Column, b: Column) -> bool:
    if a.dtype != b.dtype or len(a.children) != len(b.children):
        return False
    return all(_schema_matches(ca, cb)
               for ca, cb in zip(a.children, b.children))


def _concat_columns(parts: list[Column]) -> Column:
    d0 = parts[0].dtype
    dev = parts[0].device
    valid = None
    if any(p.validity is not None for p in parts):
        valid = torch.cat([p.valid_mask() for p in parts])
    if d0.id == TypeId.STRUCT:
        return Column(d0, validity=valid, children=tuple(
            _concat_columns([p.children[i] for p in parts])
            for i in range(len(parts[0].children))))
    if d0.is_string or d0.id == TypeId.LIST:
        offs = [parts[0].offsets.to(torch.int64)]
        base = offs[0][-1]
        for p in parts[1:]:
            o = p.offsets.to(torch.int64)
            offs.append(o[1:] + base)
            base = base + o[-1]
        offsets = torch.cat(offs)
        if int(offsets[-1]) > np.iinfo(np.int32).max:
            raise ValueError("concatenated column exceeds int32 offsets")
        if d0.is_string:
            return Column.string(torch.cat([p.data for p in parts]),
                                 offsets.to(torch.int32), valid, device=dev)
        child = _concat_columns([p.children[0] for p in parts])
        return Column.list_(child, offsets.to(torch.int32), valid, device=dev)
    return Column(d0, data=torch.cat([p.data for p in parts]), validity=valid)


@traced("distinct")
def distinct(table: Table, subset: list | None = None) -> Table:
    """Spark dropDuplicates: the first row of each key group, whole rows,
    in input order; keys are ``subset`` (default: every column) and null
    keys compare equal (one null group)."""
    keys = [SortKey(c) for c in (table.columns if subset is None
                                 else [table.column(k) for k in subset])]
    words = encode_keys(keys)
    order = lexsort(words)
    # the stable sort makes each group's boundary row its earliest row
    keep = torch.sort(order[rows_differ_from_prev(words, order)]).values
    return gather_table(table, keep)


def slice_table(table: Table, start: int, length: int) -> Table:
    """Row range [start, start+length) clamped to the table (cudf::slice)."""
    start = max(0, min(start, table.num_rows))
    length = max(0, min(length, table.num_rows - start))
    dev = table.columns[0].device if table.columns else None
    return gather_table(table, torch.arange(start, start + length,
                                            device=dev))
