"""Logical type system: (type-id, scale) pairs with cudf's type ids.

The same ids and scale rules as ``spark_rapids_jni_tpu/dtypes.py`` (cudf's
``type_id`` enum, negative decimal scale meaning ``value * 10**(-scale)``),
so schemas cross between the two packages and the Java layer unchanged.

Storage in the port:

- FLOAT64 is stored natively as ``torch.float64``; its bits are a free
  ``.view(torch.int64)``.  (The JAX package keeps int64 bit patterns
  because the TPU has no f64.)
- DECIMAL128 is ``int64[n, 2]`` little-endian limb pairs (lo, hi), as in
  the JAX package: torch has no int128.
- UINT16/UINT32/UINT64 hold their bit patterns in the signed torch type of
  the same width, because torch's unsigned types above 8 bits lack most
  CPU kernels (shifts, sorts).  UINT8 and BOOL8 are ``torch.uint8``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """cudf-compatible type ids."""

    EMPTY = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOL8 = 11
    TIMESTAMP_DAYS = 12
    TIMESTAMP_SECONDS = 13
    TIMESTAMP_MILLISECONDS = 14
    TIMESTAMP_MICROSECONDS = 15
    TIMESTAMP_NANOSECONDS = 16
    DURATION_DAYS = 17
    DURATION_SECONDS = 18
    DURATION_MILLISECONDS = 19
    DURATION_MICROSECONDS = 20
    DURATION_NANOSECONDS = 21
    DICTIONARY32 = 22
    STRING = 23
    LIST = 24
    DECIMAL32 = 25
    DECIMAL64 = 26
    DECIMAL128 = 27
    STRUCT = 28


# numpy (host, wire) storage dtype per fixed-width type id
_STORAGE: dict[TypeId, np.dtype] = {
    TypeId.INT8: np.dtype(np.int8),
    TypeId.INT16: np.dtype(np.int16),
    TypeId.INT32: np.dtype(np.int32),
    TypeId.INT64: np.dtype(np.int64),
    TypeId.UINT8: np.dtype(np.uint8),
    TypeId.UINT16: np.dtype(np.uint16),
    TypeId.UINT32: np.dtype(np.uint32),
    TypeId.UINT64: np.dtype(np.uint64),
    TypeId.FLOAT32: np.dtype(np.float32),
    TypeId.FLOAT64: np.dtype(np.float64),
    TypeId.BOOL8: np.dtype(np.uint8),  # 1-byte bool, cudf BOOL8 storage
    TypeId.TIMESTAMP_DAYS: np.dtype(np.int32),
    TypeId.TIMESTAMP_SECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MILLISECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MICROSECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_NANOSECONDS: np.dtype(np.int64),
    TypeId.DURATION_DAYS: np.dtype(np.int32),
    TypeId.DURATION_SECONDS: np.dtype(np.int64),
    TypeId.DURATION_MILLISECONDS: np.dtype(np.int64),
    TypeId.DURATION_MICROSECONDS: np.dtype(np.int64),
    TypeId.DURATION_NANOSECONDS: np.dtype(np.int64),
    TypeId.DECIMAL32: np.dtype(np.int32),
    TypeId.DECIMAL64: np.dtype(np.int64),
    # two little-endian 64-bit limbs (lo unsigned, hi signed), byte-identical
    # to cudf's __int128 storage
    TypeId.DECIMAL128: np.dtype([("lo", "<u8"), ("hi", "<i8")]),
}

# torch dtype of the device buffer: the numpy storage, except that unsigned
# types above 8 bits keep their bits in the signed type of the same width
_TORCH_OF_NUMPY = {
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
    np.dtype(np.uint32): torch.int32, np.dtype(np.uint64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
}

# numpy dtype whose bits a torch buffer of the given dtype holds (for the
# signed-bits storage of UINT16/32/64 this is the signed twin; callers view
# the result as ``DType.storage``)
NUMPY_OF_TORCH = {
    torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
    torch.int64: np.int64, torch.uint8: np.uint8, torch.float32: np.float32,
    torch.float64: np.float64, torch.bool: np.bool_,
}

_NUMERIC_IDS = {
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
    TypeId.FLOAT32, TypeId.FLOAT64,
}


@dataclass(frozen=True)
class DType:
    """Logical column type: (type-id, decimal scale)."""

    id: TypeId
    scale: int = 0

    def __post_init__(self):
        if self.scale != 0 and not self.is_decimal:
            raise ValueError(f"non-zero scale on non-decimal type {self.id!r}")

    # -- classification ----------------------------------------------------
    @property
    def is_fixed_width(self) -> bool:
        return self.id in _STORAGE

    @property
    def is_decimal(self) -> bool:
        return self.id in (TypeId.DECIMAL32, TypeId.DECIMAL64,
                           TypeId.DECIMAL128)

    @property
    def is_numeric(self) -> bool:
        return self.id in _NUMERIC_IDS

    @property
    def is_integral(self) -> bool:
        return self.id in _NUMERIC_IDS and not self.is_floating

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_unsigned(self) -> bool:
        return self.id in (TypeId.UINT8, TypeId.UINT16, TypeId.UINT32,
                           TypeId.UINT64)

    @property
    def is_timestamp(self) -> bool:
        return TypeId.TIMESTAMP_DAYS <= self.id <= \
            TypeId.TIMESTAMP_NANOSECONDS

    @property
    def is_string(self) -> bool:
        return self.id == TypeId.STRING

    @property
    def is_nested(self) -> bool:
        return self.id in (TypeId.LIST, TypeId.STRUCT)

    # -- physical layout ---------------------------------------------------
    @property
    def storage(self) -> np.dtype:
        """numpy storage dtype of the values (fixed-width types only)."""
        try:
            return _STORAGE[self.id]
        except KeyError:
            raise TypeError(
                f"{self.id!r} has no fixed-width storage dtype") from None

    @property
    def torch_dtype(self) -> torch.dtype:
        """dtype of the device buffer (DECIMAL128: int64, as ``[n, 2]``)."""
        if self.id == TypeId.DECIMAL128:
            return torch.int64
        return _TORCH_OF_NUMPY[self.storage]

    @property
    def itemsize(self) -> int:
        """Bytes per element in the packed row wire format."""
        return self.storage.itemsize

    def __repr__(self):
        if self.is_decimal:
            return f"DType({self.id.name}, scale={self.scale})"
        return f"DType({self.id.name})"


INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
UINT8 = DType(TypeId.UINT8)
UINT16 = DType(TypeId.UINT16)
UINT32 = DType(TypeId.UINT32)
UINT64 = DType(TypeId.UINT64)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
BOOL8 = DType(TypeId.BOOL8)
STRING = DType(TypeId.STRING)
TIMESTAMP_DAYS = DType(TypeId.TIMESTAMP_DAYS)
TIMESTAMP_SECONDS = DType(TypeId.TIMESTAMP_SECONDS)
TIMESTAMP_MILLISECONDS = DType(TypeId.TIMESTAMP_MILLISECONDS)
TIMESTAMP_MICROSECONDS = DType(TypeId.TIMESTAMP_MICROSECONDS)
TIMESTAMP_NANOSECONDS = DType(TypeId.TIMESTAMP_NANOSECONDS)
LIST = DType(TypeId.LIST)
STRUCT = DType(TypeId.STRUCT)


def decimal32(scale: int) -> DType:
    return DType(TypeId.DECIMAL32, scale)


def decimal64(scale: int) -> DType:
    return DType(TypeId.DECIMAL64, scale)


def decimal128(scale: int) -> DType:
    return DType(TypeId.DECIMAL128, scale)


_ZERO_EXTEND_MASK = {TypeId.UINT16: 0xFFFF, TypeId.UINT32: 0xFFFFFFFF}


def int64_values(dtype: DType, data: torch.Tensor) -> torch.Tensor:
    """Integer values widened to int64: signed types sign-extend, unsigned
    types zero-extend (UINT16/32 buffers hold signed bits), UINT64 keeps
    its bits (wrapping, as a numpy cast to int64 does)."""
    v = data.to(torch.int64)
    mask = _ZERO_EXTEND_MASK.get(dtype.id)
    return v if mask is None else v & mask


def from_numpy_dtype(np_dtype) -> DType:
    """Map a numpy dtype to the engine DType (bool -> BOOL8, datetime64 ->
    timestamp)."""
    np_dtype = np.dtype(np_dtype)
    if np_dtype == np.bool_:
        return BOOL8
    if np_dtype.kind == "M":
        unit = np.datetime_data(np_dtype)[0]
        return {"D": TIMESTAMP_DAYS, "s": TIMESTAMP_SECONDS,
                "ms": TIMESTAMP_MILLISECONDS, "us": TIMESTAMP_MICROSECONDS,
                "ns": TIMESTAMP_NANOSECONDS}[unit]
    for tid, storage in _STORAGE.items():
        if storage == np_dtype and tid not in (
            TypeId.BOOL8, TypeId.DECIMAL32, TypeId.DECIMAL64,
            TypeId.DECIMAL128,
        ) and not (TypeId.TIMESTAMP_DAYS <= tid
                   <= TypeId.DURATION_NANOSECONDS):
            return DType(tid)
    raise TypeError(f"unsupported numpy dtype {np_dtype}")
