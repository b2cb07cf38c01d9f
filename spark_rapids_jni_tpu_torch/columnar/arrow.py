"""pyarrow interop: Arrow Tables <-> port Tables.

Supported types both ways: ints, floats, bool, string (+large_string in),
date32, timestamps (s/ms/us/ns), decimal128 (precision <= 38), list of the
above.  ``pyarrow`` is imported inside the functions: nothing else in the
port needs it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .. import dtypes as dt
from .column import Column
from .table import Table

_ARROW_TO_DTYPE = {
    "int8": dt.INT8, "int16": dt.INT16, "int32": dt.INT32, "int64": dt.INT64,
    "uint8": dt.UINT8, "uint16": dt.UINT16, "uint32": dt.UINT32,
    "uint64": dt.UINT64, "float": dt.FLOAT32, "double": dt.FLOAT64,
    "bool": dt.BOOL8, "date32[day]": dt.TIMESTAMP_DAYS,
}
_TS_UNIT = {"s": dt.TIMESTAMP_SECONDS, "ms": dt.TIMESTAMP_MILLISECONDS,
            "us": dt.TIMESTAMP_MICROSECONDS, "ns": dt.TIMESTAMP_NANOSECONDS}


def _valid_mask(arr) -> np.ndarray | None:
    if arr.null_count == 0:
        return None
    buf = arr.buffers()[0]
    if buf is None:
        return None
    mask = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    return mask[arr.offset:arr.offset + len(arr)].astype(np.bool_)


def from_arrow_column(arr, device=_device.DEFAULT) -> Column:
    """One pyarrow Array/ChunkedArray -> port Column on ``device``."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    valid = _valid_mask(arr)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        arr = arr.cast(pa.string()) if pa.types.is_large_string(t) else arr
        bufs = arr.buffers()
        offs = np.frombuffer(bufs[1], np.int32)[arr.offset:
                                                arr.offset + len(arr) + 1]
        chars = np.frombuffer(bufs[2], np.uint8) if bufs[2] is not None \
            else np.zeros(0, np.uint8)
        chars = chars[offs[0]:offs[-1]]
        return Column.string(chars, (offs - offs[0]).astype(np.int32), valid,
                             device=device)
    if pa.types.is_list(t):
        offs = np.asarray(arr.offsets)
        child = from_arrow_column(arr.values, device)
        if int(offs[0]) != 0:
            from ..ops.selection import gather_column
            idx = torch.arange(int(offs[0]), int(offs[-1]),
                               device=child.device)
            child = gather_column(child, idx)
            offs = offs - offs[0]
        return Column.list_(child, offs.astype(np.int32), valid,
                            device=device)
    if pa.types.is_decimal(t):
        if t.precision > 38:
            raise NotImplementedError("decimal precision > 38")
        ours = -t.scale
        n = len(arr)
        limbs = np.frombuffer(arr.buffers()[1], np.int64)
        limbs = limbs[arr.offset * 2:(arr.offset + n) * 2].reshape(n, 2)
        if t.precision <= 18:
            # in-range values are sign extensions of the low limb
            lo = limbs[:, 0].copy()
            if valid is not None:
                lo[~valid] = 0
            if t.precision <= 9:
                return Column.fixed(dt.decimal32(ours), lo.astype(np.int32),
                                    valid, device=device)
            return Column.fixed(dt.decimal64(ours), lo, valid, device=device)
        pairs = limbs.copy()
        if valid is not None:
            pairs[~valid] = 0
        return Column.fixed(dt.decimal128(ours), pairs, valid, device=device)
    if pa.types.is_timestamp(t):
        if t.tz not in (None, "UTC", "utc"):
            raise NotImplementedError(
                f"timezone-aware timestamps ({t.tz}) are not supported")
        vals = np.asarray(arr.cast(pa.int64()).fill_null(0))
        return Column.fixed(_TS_UNIT[t.unit], vals, valid, device=device)
    name = str(t)
    if name in _ARROW_TO_DTYPE:
        out = _ARROW_TO_DTYPE[name]
        # null slots are undefined in Arrow; zero-fill the dense buffer
        if out.id == dt.TypeId.BOOL8:
            vals = np.asarray(arr.cast(pa.uint8()).fill_null(0))
        else:
            vals = np.asarray(arr.fill_null(0) if valid is not None else arr)
        return Column.fixed(out, vals, valid, device=device)
    raise NotImplementedError(f"unsupported arrow type {t}")


def from_arrow(table, device=_device.DEFAULT) -> Table:
    """pyarrow.Table -> port Table on ``device``."""
    return Table([from_arrow_column(table.column(i), device)
                  for i in range(table.num_columns)],
                 list(table.column_names))


def to_arrow_column(col: Column):
    """Port Column -> pyarrow Array."""
    import pyarrow as pa
    valid = None if col.validity is None else col.validity_numpy()
    mask = None if valid is None else ~valid
    d = col.dtype
    if d.is_string:
        return pa.array(col.to_pylist(), pa.string())
    if d.id == dt.TypeId.LIST:
        child = to_arrow_column(col.children[0])
        offs = col.offsets.cpu().numpy().astype(np.int32)
        arr = pa.ListArray.from_arrays(pa.array(offs, pa.int32()), child)
        if mask is not None:
            pyl = arr.to_pylist()
            return pa.array([None if mask[i] else pyl[i]
                             for i in range(len(pyl))], pa.list_(child.type))
        return arr
    if d.is_decimal:
        prec = {dt.TypeId.DECIMAL32: 9, dt.TypeId.DECIMAL64: 18,
                dt.TypeId.DECIMAL128: 38}[d.id]
        return pa.array(col.to_pylist(), pa.decimal128(prec, max(-d.scale, 0)))
    vals = col.to_numpy()
    if d.id == dt.TypeId.TIMESTAMP_DAYS:
        return pa.array(vals, pa.date32(), mask=mask)
    if d.is_timestamp:
        unit = {dt.TypeId.TIMESTAMP_SECONDS: "s",
                dt.TypeId.TIMESTAMP_MILLISECONDS: "ms",
                dt.TypeId.TIMESTAMP_MICROSECONDS: "us",
                dt.TypeId.TIMESTAMP_NANOSECONDS: "ns"}[d.id]
        return pa.array(vals, pa.timestamp(unit), mask=mask)
    return pa.array(vals, mask=mask)


def to_arrow(table: Table):
    """Port Table -> pyarrow.Table."""
    import pyarrow as pa
    names = list(table.names or [f"c{i}" for i in range(table.num_columns)])
    return pa.table([to_arrow_column(c) for c in table.columns], names=names)
