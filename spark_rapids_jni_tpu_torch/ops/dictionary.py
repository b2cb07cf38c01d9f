"""Dictionary encoding: column <-> (int32 codes, distinct-value dictionary).

The port of ``spark_rapids_jni_tpu/ops/dictionary.py`` (cudf DICTIONARY32):
codes are INT32 rows that shuffle and aggregate like any fixed-width
column, while the dictionary holds each distinct non-null value once.
Encoding is sort-based like the groupby: lexsort the order-preserving key
words, segment at value boundaries, code = segment id.  Codes are ordinal,
so ORDER BY on codes equals ORDER BY on the values.
"""

from __future__ import annotations

import torch

from ..columnar import Column
from ..dtypes import INT32
from .order import SortKey, encode_keys, lexsort, rows_differ_from_prev
from .selection import gather_column


def dictionary_encode(col: Column):
    """(codes: INT32 Column, dictionary: Column of the distinct non-null
    values in ascending order).  Null rows get a null code."""
    n = col.size
    dev = col.device
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return (Column(INT32, data=empty.to(torch.int32),
                       validity=col.validity), gather_column(col, empty))
    words = encode_keys([SortKey(col)])  # null flag word first if nullable
    order = lexsort(words)
    bounds = rows_differ_from_prev(words, order)
    seg = torch.cumsum(bounds.to(torch.int64), 0) - 1
    seg_of_row = torch.empty_like(seg)
    seg_of_row[order] = seg
    rep_positions = torch.nonzero(bounds, as_tuple=True)[0]
    if col.validity is not None and bool((~col.validity).any()):
        # nulls sort first as segment 0: shift the codes down and keep the
        # null segment out of the dictionary
        seg_of_row = seg_of_row - 1
        rep_positions = rep_positions[1:]
    dictionary = gather_column(col, order[rep_positions])
    dictionary.validity = None  # dictionary rows are non-null
    return (Column(INT32, data=seg_of_row.to(torch.int32),
                   validity=col.validity), dictionary)


def dictionary_decode(codes: Column, dictionary: Column) -> Column:
    """Inverse of ``dictionary_encode``: gather dictionary rows by code."""
    return gather_column(dictionary, codes.data.to(torch.int64),
                         indices_valid=codes.validity)
