"""Unsigned 64- and 128-bit integer arithmetic on int64 tensors.

The device backbone of DECIMAL128 casts and of the u64 mantissas of the
string casts (the cudf ``fixed_point<__int128>`` role).  torch has no
usable unsigned 64-bit type (no shifts, compares or division on the CPU),
so every unsigned word here is an ``int64`` tensor holding the u64 bits:

- add, subtract and multiply wrap mod 2^64 exactly as u64 arithmetic does;
- unsigned order is signed order on ``x ^ SIGN64`` (``ult``/``ule``);
- logical right shifts mask the arithmetic shift (``lsr``);
- division works over 32-bit limbs, so no intermediate exceeds 2^62.

A 128-bit magnitude is a (lo, hi) pair of such words; callers split the
sign with ``split_sign``/``apply_sign`` (two's-complement negate with
carry), as in the JAX package's ``utils/int128.py``.
"""

from __future__ import annotations

import torch

from .floatbits import SIGN64

M32 = 0xFFFFFFFF


def ult(a, b):
    """Unsigned a < b on u64 bit patterns (tensors or Python ints)."""
    return _flip(a) < _flip(b)


def ule(a, b):
    return _flip(a) <= _flip(b)


def _flip(x):
    if isinstance(x, int):  # a u64 value (or its int64 bits) -> flipped
        return (x & ((1 << 64) - 1)) - (1 << 63)
    return x ^ SIGN64


def lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of u64 bits by a static ``r`` in [0, 63]."""
    if r == 0:
        return x
    return (x >> r) & ((1 << (64 - r)) - 1)


def u64_const(v: int) -> int:
    """A u64 constant as the int64 value holding its bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """u64 bits -> float64, correctly rounded (one rounding of an exact
    sum of two exactly representable halves)."""
    return lsr(x, 32).to(torch.float64) * 4294967296.0 + \
        (x & M32).to(torch.float64)


def divmod_u64(x: torch.Tensor, c):
    """(x // c, x % c) for u64 ``x`` and 0 < c <= 2^30 (int or per-row
    int64 tensor)."""
    hi = lsr(x, 32)
    q_hi = hi // c
    r = hi - q_hi * c
    cur = (r << 32) | (x & M32)          # r < c <= 2^30: cur < 2^62
    q_lo = cur // c
    return (q_hi << 32) | q_lo, cur - q_lo * c


def split_sign(lo_i64, hi_i64):
    """int128 limb pairs -> (|x| lo, |x| hi, negative mask)."""
    neg = hi_i64 < 0
    nlo = ~lo_i64 + 1
    nhi = ~hi_i64 + (nlo == 0).to(torch.int64)
    return torch.where(neg, nlo, lo_i64), torch.where(neg, nhi, hi_i64), neg


def apply_sign(lo, hi, neg):
    """(magnitude, neg) -> signed int64 limb pairs (two's complement)."""
    nlo = ~lo + 1
    nhi = ~hi + (nlo == 0).to(torch.int64)
    return torch.where(neg, nlo, lo), torch.where(neg, nhi, hi)


def mul_small(lo, hi, c):
    """(lo, hi) * c for 0 < c <= 2^30 (int or per-row tensor); returns
    (lo, hi, overflow)."""
    limbs = [lo & M32, lsr(lo, 32), hi & M32, lsr(hi, 32)]
    out = []
    carry = torch.zeros_like(lo)
    for d in limbs:
        t = d * c + carry          # < 2^32 * 2^30 + 2^62 < 2^63
        out.append(t & M32)
        carry = t >> 32
    return out[0] | (out[1] << 32), out[2] | (out[3] << 32), carry != 0


def divmod_small(lo, hi, c):
    """(lo, hi) // c and remainder, for 0 < c <= 2^30."""
    limbs = [lsr(hi, 32), hi & M32, lsr(lo, 32), lo & M32]
    q = []
    r = torch.zeros_like(lo)
    for d in limbs:                  # r < c <= 2^30, so cur < 2^62
        cur = (r << 32) | d
        qd = cur // c
        q.append(qd)
        r = cur - qd * c
    return (q[2] << 32) | q[3], (q[0] << 32) | q[1], r


def mul_pow10(lo, hi, k: int):
    """(lo, hi) * 10^k (k >= 0 static); returns (lo, hi, overflow)."""
    ovf = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    while k > 0:
        step = min(k, 9)
        lo, hi, o = mul_small(lo, hi, 10 ** step)
        ovf = ovf | o
        k -= step
    return lo, hi, ovf


def _bump(lo, hi, bump):
    nlo = lo + bump.to(torch.int64)
    return nlo, hi + (bump & (nlo == 0)).to(torch.int64)


def div_pow10(lo, hi, k: int, half_up: bool):
    """(lo, hi) // 10^k (k > 0 static), truncating or HALF_UP (away from
    zero on the magnitude); returns (lo, hi, exact)."""
    exact = torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    kk = k - 1 if half_up else k
    while kk > 0:
        step = min(kk, 9)
        lo, hi, r = divmod_small(lo, hi, 10 ** step)
        exact = exact & (r == 0)
        kk -= step
    if half_up:
        lo, hi, d = divmod_small(lo, hi, 10)
        exact = exact & (d == 0)
        lo, hi = _bump(lo, hi, d >= 5)
    return lo, hi, exact


def fits_bits(lo, hi, bits: int):
    """Magnitude < 2^bits (bits in (0, 128])."""
    if bits >= 128:
        return torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    if bits > 64:
        return ult(hi, u64_const(1 << (bits - 64)))
    if bits == 64:
        return hi == 0
    return (hi == 0) & ult(lo, u64_const(1 << bits))


def le_u64(lo, hi, bound: int):
    """Magnitude <= bound (bound < 2^64)."""
    return (hi == 0) & ule(lo, u64_const(bound))


def to_f64(lo, hi):
    """Magnitude as float64 (each limb rounded once, as the JAX package's
    u64 -> f64 converts do, then combined)."""
    return u64_to_f64(hi) * (2.0 ** 64) + u64_to_f64(lo)


def from_u64(mag):
    """u64 magnitude -> (lo, hi)."""
    return mag, torch.zeros_like(mag)


def mul_pow10_dyn(lo, hi, k, kmax: int):
    """(lo, hi) * 10^k with PER-ROW k in [0, kmax] (static bound);
    returns (lo, hi, overflow)."""
    ovf = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    for t in range(kmax):
        nlo, nhi, o = mul_small(lo, hi, 10)
        act = t < k
        lo = torch.where(act, nlo, lo)
        hi = torch.where(act, nhi, hi)
        ovf = ovf | (act & o)
    return lo, hi, ovf


def div_pow10_dyn(lo, hi, k, kmax: int, half_up: bool):
    """(lo, hi) // 10^k with PER-ROW k in [0, kmax]; HALF_UP uses the most
    significant dropped digit (the remainder of the final step)."""
    last = torch.zeros_like(lo)
    for t in range(kmax):
        nlo, nhi, r = divmod_small(lo, hi, 10)
        act = t < k
        last = torch.where(act, r, last)
        lo = torch.where(act, nlo, lo)
        hi = torch.where(act, nhi, hi)
    if half_up:
        lo, hi = _bump(lo, hi, (last >= 5) & (k > 0))
    return lo, hi
