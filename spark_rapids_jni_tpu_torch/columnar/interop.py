"""Plain numpy buffers <-> port Tables: how data crosses into the port.

A ``HostColumn`` is the host form of one column: its type id and scale and
its numpy buffers (``data``, ``validity``, ``offsets``, ``chars``).
``table_from_numpy`` puts a list of them on a device as a port ``Table``;
``table_to_numpy`` brings a port ``Table`` back.

FLOAT64 data may arrive as float64 values or as int64 IEEE bit patterns (the
JAX package's storage); bit patterns become float64 by ``view``, so no bit
of a NaN payload or a -0.0 is lost.  ``HostColumn.of`` reads the buffers of
any column object with ``dtype``/``data``/``validity``/``offsets`` fields
through ``np.asarray``, which is how a JAX column's bits are carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .. import device as _device
from ..dtypes import DType, TypeId
from .column import Column
from .table import Table


@dataclass(frozen=True)
class HostColumn:
    """One column as host buffers.  Fixed width: ``data`` (DECIMAL128 as
    ``int64[n, 2]`` limbs).  STRING: ``chars`` (uint8) and ``offsets``
    (int32[n+1]).  ``validity``: bool[n] or None (all valid)."""

    type_id: int
    scale: int = 0
    data: Optional[np.ndarray] = None
    validity: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    chars: Optional[np.ndarray] = None

    @property
    def dtype(self) -> DType:
        return DType(TypeId(self.type_id), self.scale)

    @staticmethod
    def of(col) -> "HostColumn":
        """Host buffers of a column object of either package (``np.asarray``
        on each field; a port column is brought to the host first)."""
        def host(x):
            if x is None:
                return None
            if hasattr(x, "cpu"):  # torch tensor
                x = x.cpu()
            return np.asarray(x)
        dt = col.dtype
        if dt.is_string:
            return HostColumn(int(dt.id), dt.scale, None, host(col.validity),
                              host(col.offsets).astype(np.int32),
                              host(col.data).astype(np.uint8))
        if not dt.is_fixed_width:
            raise TypeError(f"HostColumn holds fixed-width and STRING "
                            f"columns, got {dt!r}")
        return HostColumn(int(dt.id), dt.scale, host(col.data),
                          host(col.validity))


def column_from_numpy(hc: HostColumn, device=_device.DEFAULT) -> Column:
    dt = hc.dtype
    if dt.is_string:
        return Column.string(hc.chars, hc.offsets, hc.validity, device=device)
    return Column.fixed(dt, hc.data, hc.validity, device=device)


def table_from_numpy(cols: Sequence[HostColumn], names=None,
                     device=_device.DEFAULT) -> Table:
    """Host columns -> port ``Table`` on ``device``."""
    return Table([column_from_numpy(hc, device) for hc in cols], names)


def table_to_numpy(table: Table) -> list[HostColumn]:
    """Port ``Table`` -> host columns (FLOAT64 as float64 values, unsigned
    types in their numpy unsigned dtype)."""
    out = []
    for c in table.columns:
        if c.dtype.is_string:
            out.append(HostColumn.of(c))
            continue
        data = c.data.cpu().numpy()
        if c.dtype.is_unsigned:
            data = data.view(c.dtype.storage)
        out.append(HostColumn(int(c.dtype.id), c.dtype.scale, data,
                              None if c.validity is None
                              else c.validity.cpu().numpy()))
    return out
