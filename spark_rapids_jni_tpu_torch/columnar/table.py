"""Device table: an ordered set of equal-length columns (``cudf::table``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from .column import Column


class Table:
    __slots__ = ("columns", "names")

    def __init__(self, columns: Sequence[Column],
                 names: Optional[Sequence[str]] = None):
        self.columns = tuple(columns)
        sizes = {c.size for c in self.columns}
        if len(sizes) > 1:
            raise ValueError(
                f"columns have differing row counts: {sorted(sizes)}")
        if names is not None:
            names = tuple(names)
            if len(names) != len(self.columns):
                raise ValueError("names/columns length mismatch")
        self.names = names

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def num_rows(self) -> int:
        return self.columns[0].size if self.columns else 0

    def column(self, key) -> Column:
        if isinstance(key, str):
            if self.names is None:
                raise KeyError("table has no column names")
            return self.columns[self.names.index(key)]
        return self.columns[key]

    def __getitem__(self, key) -> Column:
        return self.column(key)

    def __iter__(self):
        return iter(self.columns)

    def __len__(self):
        return len(self.columns)

    def select(self, keys) -> "Table":
        cols = [self.column(k) for k in keys]
        names = [k if isinstance(k, str) else
                 (self.names[k] if self.names else None) for k in keys]
        return Table(cols, names if all(n is not None for n in names)
                     else None)

    def dtypes(self):
        return [c.dtype for c in self.columns]

    def gather(self, indices, indices_valid=None) -> "Table":
        return Table([c.gather(indices, indices_valid)
                      for c in self.columns], self.names)

    @staticmethod
    def from_pydict(d: dict, device=_device.DEFAULT) -> "Table":
        """Table from ``{name: values}``: each value a Column, a tensor, a
        numpy array or a Python list (None entries become nulls)."""
        from ..dtypes import NUMPY_OF_TORCH, from_numpy_dtype
        cols, names = [], []
        for k, v in d.items():
            names.append(k)
            if isinstance(v, Column):
                cols.append(v.to(device))
            elif isinstance(v, torch.Tensor):
                dtype = from_numpy_dtype(NUMPY_OF_TORCH[v.dtype])
                cols.append(Column.fixed(dtype, v, device=device))
            elif isinstance(v, np.ndarray):
                cols.append(Column.from_numpy(v, device=device))
            else:
                cols.append(Column.from_pylist(list(v), device=device))
        return Table(cols, names)

    def to_pydict(self) -> dict:
        names = self.names or [f"c{i}" for i in range(self.num_columns)]
        return {n: c.to_pylist() for n, c in zip(names, self.columns)}

    def to(self, device) -> "Table":
        """This table with every buffer on ``device`` (a no-op where a
        buffer is there already)."""
        return Table([c.to(device) for c in self.columns], self.names)

    def __repr__(self):
        return (f"Table(rows={self.num_rows}, "
                f"cols={[repr(c) for c in self.columns]})")
