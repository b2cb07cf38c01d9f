"""Spark's Murmur3_x86_32 of an INT32 key, and HashPartitioning's pmod.

Vectorised from ``chip_smoke.py::_murmur_long_py`` / ``_murmur_py``:
``Murmur3_x86_32.hashInt(v, seed)`` is one mixed word finalised with
length 4.  Arithmetic in uint64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np

M = np.uint64(0xFFFFFFFF)


def _rotl(x, r: int):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & M


def hash_int(v: np.ndarray, seed: int = 42) -> np.ndarray:
    """Spark ``hash(col)`` of an INT32 column: int32 results."""
    k = np.asarray(v).astype(np.int64).astype(np.uint64) & M
    k = _rotl((k * np.uint64(0xCC9E2D51)) & M, 15)
    k = (k * np.uint64(0x1B873593)) & M
    h = np.full(k.shape, np.uint64(seed) & M) ^ k
    h = (_rotl(h, 13) * np.uint64(5) + np.uint64(0xE6546B64)) & M
    h ^= np.uint64(4)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & M
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & M
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32).view(np.int32)


def pmod(h: np.ndarray, n: int) -> np.ndarray:
    """Spark's ``pmod(h, n)``: the non-negative remainder."""
    return np.mod(h.astype(np.int64), n).astype(np.int32)
