"""Total-order float bit encodings for sort keys and min/max.

The port stores FLOAT64 natively, so a float's IEEE-754 bits are a free
``view``; no arithmetic reconstruction of bit patterns is needed (the JAX
package's floatbits works around the TPU's missing f64 bitcast).  What the
slice needs is the total order on those bits, with Spark's normalization:
-0.0 equals 0.0 and all NaNs are one value, above +inf.

Encodings are returned as ``int64`` tensors holding the bits of the
unsigned 64-bit order word (the same bits as the JAX package's uint64
keys).  Unsigned order on them is signed order on ``key ^ SIGN64``.
"""

from __future__ import annotations

import torch

SIGN64 = -(1 << 63)          # int64 bit pattern of 0x8000000000000000
M32 = 0xFFFFFFFF
_F64_EXP = 0x7FF0000000000000
_F64_MANT = 0x000FFFFFFFFFFFFF
_F64_QNAN = 0x7FF8000000000000


def f32_bits_u(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bit patterns of float32 values, zero-extended to int64."""
    return x.view(torch.int32).to(torch.int64) & M32


def normalize_f64_bits(bits: torch.Tensor) -> torch.Tensor:
    """-0.0 -> 0.0 and every NaN -> the quiet NaN, on int64 bit patterns."""
    bits = torch.where(bits == SIGN64, torch.zeros_like(bits), bits)
    is_nan = ((bits & _F64_EXP) == _F64_EXP) & ((bits & _F64_MANT) != 0)
    return torch.where(is_nan, torch.full_like(bits, _F64_QNAN), bits)


def normalize_f32_bits(bits32: torch.Tensor) -> torch.Tensor:
    """The same on zero-extended float32 bit patterns (int64 holding u32)."""
    bits32 = torch.where(bits32 == 0x80000000, torch.zeros_like(bits32),
                         bits32)
    is_nan = ((bits32 & 0x7F800000) == 0x7F800000) & \
        ((bits32 & 0x007FFFFF) != 0)
    return torch.where(is_nan, torch.full_like(bits32, 0x7FC00000), bits32)


def f64_order_key(bits: torch.Tensor) -> torch.Tensor:
    """Unsigned total-order word of normalized float64 bits: negative
    floats reverse (~bits), the rest get the sign bit set."""
    return torch.where(bits < 0, ~bits, bits | SIGN64)


def f32_order_key(bits32: torch.Tensor) -> torch.Tensor:
    """Unsigned total-order word (< 2^32) of normalized float32 bits."""
    neg = (bits32 & 0x80000000) != 0
    return torch.where(neg, ~bits32 & M32, bits32 | 0x80000000)


def f64_from_order_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`f64_order_key`, as int64 bit patterns."""
    return torch.where(key < 0, key ^ SIGN64, ~key)


def f32_from_order_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`f32_order_key`, as float32 values."""
    sign = (key & 0x80000000) != 0
    bits32 = torch.where(sign, key ^ 0x80000000, ~key & M32)
    return bits32.to(torch.int32).view(torch.float32)
