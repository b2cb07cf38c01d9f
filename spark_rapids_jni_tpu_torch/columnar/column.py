"""Device column model: Arrow-layout columns held in torch tensors.

The analog of ``cudf::column``.  A column is:

- ``data``:      tensor of the storage dtype (``DType.torch_dtype``) for
                 fixed-width types, the ``uint8`` character buffer for
                 STRING, or None for LIST and STRUCT parents;
- ``validity``:  optional ``bool[n]`` tensor; None means all valid.  The cudf
                 one-bit-per-row form is produced only at wire boundaries
                 (``utils.bitmask``);
- ``offsets``:   optional ``int32[n+1]`` tensor for STRING/LIST;
- ``children``:  the LIST child column, or the STRUCT fields (unnamed: a
                 field's name lives in the file schema, as in cudf).

Constructors take ``device=`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from ..dtypes import (DType, TypeId, BOOL8, STRING, NUMPY_OF_TORCH,
                      from_numpy_dtype)
from ..utils import bitmask


def _host_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """numpy array holding the bits of ``dtype`` (same width) -> CPU tensor."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of another package's buffer
        arr = arr.copy()
    return torch.from_numpy(arr.view(NUMPY_OF_TORCH[dtype]))


def _validity_tensor(validity, dev: torch.device):
    if validity is None:
        return None
    if isinstance(validity, torch.Tensor):
        return validity.to(device=dev, dtype=torch.bool)
    return torch.from_numpy(np.array(validity, np.bool_)).to(dev)


def _decimal128_limbs(data, dev: torch.device) -> torch.Tensor:
    """Any reasonable 128-bit input -> int64[n, 2] limb pairs (lo, hi)."""
    if isinstance(data, torch.Tensor):
        if data.dim() != 2 or data.shape[-1] != 2:
            raise TypeError("tensor DECIMAL128 data must be int64[n, 2]")
        return data.to(device=dev, dtype=torch.int64)
    arr = np.asarray(data)
    if arr.dtype.kind == "V":  # structured (lo, hi) storage
        arr = arr.view(np.int64).reshape(-1, 2)
    elif arr.dtype == object or arr.dtype.kind in "iu" and arr.ndim == 1:
        ints = [int(v) for v in arr.tolist()]
        lo = np.array([v & ((1 << 64) - 1) for v in ints], np.uint64)
        hi = np.array([v >> 64 for v in ints], np.int64)
        arr = np.stack([lo.view(np.int64), hi], axis=1) if ints else \
            np.zeros((0, 2), np.int64)
    if arr.ndim != 2 or arr.shape[-1] != 2:
        raise TypeError("DECIMAL128 data must be int64[n, 2] limb pairs")
    return _host_tensor(arr.astype(np.int64, copy=False), torch.int64).to(dev)


class Column:
    __slots__ = ("dtype", "data", "validity", "offsets", "children")

    def __init__(self, dtype: DType, data: Optional[torch.Tensor] = None,
                 validity: Optional[torch.Tensor] = None,
                 offsets: Optional[torch.Tensor] = None,
                 children: Sequence["Column"] = ()):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.children = tuple(children)

    # -- construction ------------------------------------------------------
    @staticmethod
    def fixed(dtype: DType, data, validity=None,
              device=_device.DEFAULT) -> "Column":
        """Fixed-width column from a numpy array, sequence or tensor.

        FLOAT64: float input holds values; integer input holds IEEE bit
        patterns (the JAX package's FLOAT64 storage) and is viewed as
        float64.  Host input is converted to ``dtype``'s storage first, so
        UINT32 values become their int32 bit patterns.
        """
        dev = _device.resolve(device)
        tdt = dtype.torch_dtype
        if dtype.id == TypeId.DECIMAL128:
            t = _decimal128_limbs(data, dev)
        elif isinstance(data, torch.Tensor):
            if dtype.id == TypeId.FLOAT64 and not data.dtype.is_floating_point:
                t = data.to(device=dev, dtype=torch.int64).view(torch.float64)
            else:
                t = data.to(device=dev, dtype=tdt)
        else:
            arr = np.asarray(data)
            if dtype.id == TypeId.FLOAT64 and arr.dtype.kind in "iu":
                arr = arr.astype(np.int64).view(np.float64)
            t = _host_tensor(arr.astype(dtype.storage, copy=False),
                             tdt).to(dev)
        return Column(dtype, data=t, validity=_validity_tensor(validity, dev))

    @staticmethod
    def string(chars, offsets, validity=None,
               device=_device.DEFAULT) -> "Column":
        dev = _device.resolve(device)
        if isinstance(chars, torch.Tensor):
            chars = chars.to(device=dev, dtype=torch.uint8)
        else:
            chars = _host_tensor(np.asarray(chars, np.uint8),
                                 torch.uint8).to(dev)
        return Column(STRING, data=chars,
                      validity=_validity_tensor(validity, dev),
                      offsets=_offsets_tensor(offsets, dev))

    @staticmethod
    def list_(child: "Column", offsets, validity=None,
              device=_device.DEFAULT) -> "Column":
        dev = _device.resolve(device)
        return Column(DType(TypeId.LIST),
                      validity=_validity_tensor(validity, dev),
                      offsets=_offsets_tensor(offsets, dev),
                      children=(child,))

    @staticmethod
    def from_numpy(arr: np.ndarray, validity: Optional[np.ndarray] = None,
                   dtype: Optional[DType] = None,
                   device=_device.DEFAULT) -> "Column":
        if dtype is None:
            dtype = from_numpy_dtype(arr.dtype)
        if arr.dtype.kind == "M":
            # datetime64 is 8 bytes; TIMESTAMP_DAYS stores int32
            arr = arr.view(np.int64).astype(dtype.storage)
        if arr.dtype == np.bool_:
            arr = arr.astype(np.uint8)
        return Column.fixed(dtype, arr, validity, device=device)

    @staticmethod
    def from_pylist(values, dtype: Optional[DType] = None,
                    device=_device.DEFAULT) -> "Column":
        """Column from a Python list; None entries become nulls.

        str/bytes entries build a STRING column, list entries a LIST column,
        numbers a fixed-width column of ``dtype`` (inferred when None).
        """
        n = len(values)
        valid = np.array([v is not None for v in values], np.bool_)
        has_nulls = not valid.all()
        non_null = [v for v in values if v is not None]
        if (dtype is None or dtype.id == TypeId.LIST) and non_null and \
                isinstance(non_null[0], (list, tuple)):
            lens = np.fromiter((len(v) if v is not None else 0
                                for v in values), np.int64, n)
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
            if offsets[-1] > np.iinfo(np.int32).max:
                raise OverflowError("list column exceeds int32 offsets")
            flat = [e for v in values if v is not None for e in v]
            child = Column.from_pylist(flat, device=device)
            return Column.list_(child, offsets.astype(np.int32),
                                valid if has_nulls else None, device=device)
        if dtype is not None and dtype.is_string or (
                dtype is None and non_null
                and isinstance(non_null[0], (str, bytes))):
            enc = [v.encode() if isinstance(v, str) else (v or b"")
                   for v in (x if x is not None else b"" for x in values)]
            lens = np.fromiter((len(e) for e in enc), np.int32, n)
            offsets = np.zeros(n + 1, np.int32)
            np.cumsum(lens, out=offsets[1:])
            chars = np.frombuffer(b"".join(enc), np.uint8).copy()
            return Column.string(chars, offsets, valid if has_nulls else None,
                                 device=device)
        if dtype is None:
            from ..dtypes import FLOAT64, INT64
            if non_null and all(isinstance(v, bool) for v in non_null):
                dtype = BOOL8
            elif any(isinstance(v, float) for v in non_null):
                dtype = FLOAT64
            else:
                dtype = INT64
        fill = values[0] if n and values[0] is not None else 0
        filled = [v if v is not None else fill for v in values]
        if dtype.id == TypeId.DECIMAL128:
            return Column.fixed(dtype, np.array([int(v) for v in filled],
                                                object),
                                valid if has_nulls else None, device=device)
        dense = np.array(filled, dtype=dtype.storage)
        return Column.fixed(dtype, dense, valid if has_nulls else None,
                            device=device)

    # -- basic properties --------------------------------------------------
    @property
    def size(self) -> int:
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        if self.data is not None:
            return self.data.shape[0]
        if self.validity is not None:
            return self.validity.shape[0]
        if self.children:
            return self.children[0].size
        return 0

    def __len__(self) -> int:
        return self.size

    @property
    def device(self) -> torch.device:
        for t in (self.data, self.validity, self.offsets):
            if t is not None:
                return t.device
        return self.children[0].device

    def valid_mask(self) -> torch.Tensor:
        """bool[n] mask; materialises all-True when validity is None."""
        if self.validity is not None:
            return self.validity
        return torch.ones(self.size, dtype=torch.bool, device=self.device)

    def packed_validity(self) -> torch.Tensor:
        """cudf wire-format mask: 1 bit/row in LSB-first 32-bit words."""
        return bitmask.pack_bits(self.valid_mask())

    def to(self, device) -> "Column":
        """This column with every buffer on ``device``."""
        dev = _device.resolve(device)

        def mv(t):
            return None if t is None else t.to(dev)
        return type(self)(self.dtype, mv(self.data), mv(self.validity),
                          mv(self.offsets),
                          tuple(c.to(dev) for c in self.children))

    # -- host round trip ---------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Dense values (nulls undefined); pair with ``validity_numpy``."""
        if self.dtype.is_string:
            raise TypeError("use to_pylist() for STRING columns")
        arr = self.data.cpu().numpy()
        if self.dtype.id == TypeId.BOOL8:
            return arr.astype(np.bool_)
        if self.dtype.is_unsigned:
            return arr.view(self.dtype.storage)
        return arr

    def validity_numpy(self) -> np.ndarray:
        if self.validity is None:
            return np.ones((self.size,), np.bool_)
        return self.validity.cpu().numpy()

    def to_pylist(self):
        valid = self.validity_numpy()
        if self.dtype.id == TypeId.LIST:
            offs = self.offsets.cpu().numpy()
            child = self.children[0].to_pylist()
            return [child[offs[i]:offs[i + 1]] if valid[i] else None
                    for i in range(self.size)]
        if self.dtype.id == TypeId.STRUCT:
            fields = [c.to_pylist() for c in self.children]
            return [tuple(f[i] for f in fields) if valid[i] else None
                    for i in range(self.size)]
        if self.dtype.is_string:
            chars = self.data.cpu().numpy().tobytes()
            offs = self.offsets.cpu().tolist()
            return [chars[a:b].decode() if ok else None
                    for a, b, ok in zip(offs, offs[1:], valid.tolist())]
        if self.dtype.id == TypeId.DECIMAL128:
            import decimal
            ctx = decimal.Context(prec=50)
            limbs = self.data.cpu().numpy()
            return [decimal.Decimal(
                        (int(hi) << 64) | (int(lo) & ((1 << 64) - 1))
                    ).scaleb(self.dtype.scale, ctx) if ok else None
                    for (lo, hi), ok in zip(limbs.tolist(), valid)]
        if self.dtype.is_decimal:
            import decimal
            vals = self.data.cpu().numpy()
            return [decimal.Decimal(int(v)).scaleb(self.dtype.scale)
                    if ok else None for v, ok in zip(vals, valid)]
        vals = self.to_numpy()
        return [vals[i].item() if valid[i] else None for i in range(self.size)]

    # -- structural ops ----------------------------------------------------
    def gather(self, indices: torch.Tensor, indices_valid=None) -> "Column":
        """Row gather; out-of-bounds or invalid gather rows become null
        (cudf ``out_of_bounds_policy::NULLIFY``)."""
        if self.dtype.is_string:
            raise NotImplementedError("string gather lives in ops.selection")
        if self.dtype.id == TypeId.LIST:
            return self._gather_list(indices, indices_valid)
        if self.dtype.id == TypeId.STRUCT:
            return self._gather_struct(indices, indices_valid)
        indices = indices.to(self.device)
        size = self.size
        ok = (indices >= 0) & (indices < size)
        safe = indices.clamp(0, max(size - 1, 0))
        if size == 0:  # every gather row is null
            shape = (indices.shape[0],) + tuple(self.data.shape[1:])
            return Column(self.dtype,
                          data=torch.zeros(shape, dtype=self.data.dtype,
                                           device=self.device),
                          validity=torch.zeros(indices.shape[0],
                                               dtype=torch.bool,
                                               device=self.device))
        data = self.data[safe]
        valid = ok
        if self.validity is not None:
            valid = valid & self.validity[safe]
        if indices_valid is not None:
            valid = valid & indices_valid
        return Column(self.dtype, data=data, validity=valid)

    def _gather_struct(self, indices, indices_valid=None) -> "Column":
        """STRUCT row gather, field by field (STRING and LIST fields
        through ``ops.selection``); the struct's own validity follows the
        same NULLIFY rule as a flat column's."""
        from ..ops.selection import gather_column
        indices = indices.to(self.device)
        kids = tuple(gather_column(c, indices, indices_valid)
                     for c in self.children)
        size = self.size
        valid = (indices >= 0) & (indices < size)
        if self.validity is not None and size:
            valid = valid & self.validity[indices.clamp(0, size - 1)]
        if indices_valid is not None:
            valid = valid & indices_valid.to(self.device)
        return Column(self.dtype, validity=valid, children=kids)

    def _gather_list(self, indices, indices_valid=None) -> "Column":
        """LIST row gather on the column's device: each output row takes
        its source row's element range (an out-of-bounds row an empty
        one); the one host sync is the gathered element count."""
        from ..ops.selection import gather_column
        dev = self.device
        idx = indices.to(device=dev, dtype=torch.int64)
        m, n = idx.shape[0], self.size
        ok = (idx >= 0) & (idx < n)
        safe = idx.clamp(0, max(n - 1, 0))
        offs = self.offsets.to(torch.int64)
        starts = offs[safe] if n else torch.zeros_like(idx)
        lens = torch.where(ok, offs[safe + 1] - starts, 0) if n else \
            torch.zeros_like(idx)
        new_offs = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        torch.cumsum(lens, 0, out=new_offs[1:])
        total = int(new_offs[-1]) if m else 0
        if total > np.iinfo(np.int32).max:
            raise ValueError("gathered LIST column exceeds int32 offsets")
        child_idx = torch.repeat_interleave(
            starts - new_offs[:-1], lens, output_size=total) + \
            torch.arange(total, device=dev)
        child = gather_column(self.children[0], child_idx)
        valid = ok
        if self.validity is not None and n:
            valid = valid & self.validity[safe]
        if indices_valid is not None:
            valid = valid & indices_valid.to(dev)
        return Column(self.dtype, validity=valid,
                      offsets=new_offs.to(torch.int32), children=(child,))

    def __repr__(self):
        return (f"Column({self.dtype!r}, size={self.size}, "
                f"nulls={'?' if self.validity is not None else 0})")


def _offsets_tensor(offsets, dev: torch.device) -> torch.Tensor:
    if isinstance(offsets, torch.Tensor):
        return offsets.to(device=dev, dtype=torch.int32)
    return _host_tensor(np.asarray(offsets).astype(np.int32, copy=False),
                        torch.int32).to(dev)


class PackedByteColumn(Column):
    """INT8 row-blob child whose buffer holds little-endian 32-bit words.

    Row blobs stay as ``int32`` words on the device (the kernels move words,
    not bytes); bytes appear only at host boundaries, where a numpy
    ``view`` is free.  ``size`` reports BYTES, so the Arrow LIST invariant
    ``offsets[-1] == child.size`` holds.
    """

    __slots__ = ()

    @property
    def size(self) -> int:
        return 0 if self.data is None else 4 * self.data.shape[0]

    def bytes_numpy(self) -> np.ndarray:
        """Host byte view of the packed words."""
        return self.data.cpu().numpy().view(np.uint8)
