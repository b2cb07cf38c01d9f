"""BloomFilter: Spark BloomFilterImpl-compatible build, merge and probe.

The port of ``spark_rapids_jni_tpu/ops/bloom_filter.py`` (the reference's
BloomFilter component behind Spark 3.3+ runtime filters:
BloomFilterAggregate builds, BloomFilterMightContain probes).  Spark's
BloomFilterImpl, double hashing, sign-folded:

    h1 = Murmur3_x86_32.hashLong(item, seed=0)
    h2 = Murmur3_x86_32.hashLong(item, seed=h1)
    for i in 1..k:  pos = fold(h1 + i*h2) % num_bits ; set bit pos
    fold(x) = ~x if x < 0 else x

The filter is a bool[num_bits] tensor on the items' device;
``spark_serialize``/``spark_deserialize`` convert to and from Spark's wire
bytes (V1 header + big-endian longs of the BitArray), copied from the JAX
package unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import BOOL8, TypeId
from .hash import M32, _murmur_long


def optimal_num_bits(expected_items: int, fpp: float = 0.03) -> int:
    """Spark BloomFilter.optimalNumOfBits."""
    return max(8, int(-expected_items * np.log(fpp) / (np.log(2) ** 2)))


def optimal_num_hashes(expected_items: int, num_bits: int) -> int:
    """Spark BloomFilter.optimalNumOfHashFunctions."""
    return max(1, int(round(num_bits / max(expected_items, 1) * np.log(2))))


def _s32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 ``x`` as a signed value (Java int wrap)."""
    x = x & M32
    return (x ^ 0x80000000) - 0x80000000


def _positions(col: Column, num_hashes: int, num_bits: int):
    """(int64[n, num_hashes] bit positions per item, validity)."""
    if not (col.dtype.is_integral or col.dtype.is_timestamp
            or col.dtype.is_decimal or col.dtype.id == TypeId.BOOL8):
        raise TypeError(
            f"bloom filter items must be long-typed, got {col.dtype!r}")
    v = col.data.to(torch.int64)
    h1 = _murmur_long(v, torch.zeros_like(v))
    h2 = _s32(_murmur_long(v, h1))
    h1 = _s32(h1)
    pos = []
    for i in range(1, num_hashes + 1):
        combined = _s32(h1 + i * h2)
        combined = torch.where(combined < 0, ~combined, combined)
        pos.append(combined % num_bits)
    return torch.stack(pos, dim=1), col.valid_mask()


def bloom_build(col: Column, num_bits: int, num_hashes: int) -> torch.Tensor:
    """A long column aggregated into a bool[num_bits] filter (null items
    skipped)."""
    pos, valid = _positions(col, num_hashes, num_bits)
    bits = torch.zeros(num_bits + 1, dtype=torch.bool, device=pos.device)
    bits[torch.where(valid[:, None], pos, num_bits).reshape(-1)] = True
    return bits[:num_bits]


def bloom_merge(filters: list[torch.Tensor]) -> torch.Tensor:
    """OR-combine filters built with identical (num_bits, num_hashes)."""
    out = filters[0]
    for f in filters[1:]:
        out = out | f
    return out


def bloom_might_contain(bits: torch.Tensor, col: Column,
                        num_hashes: int) -> Column:
    """BOOL8 probe column; null items probe to null (Spark MightContain)."""
    pos, valid = _positions(col, num_hashes, bits.shape[0])
    hit = bits[pos].all(dim=1)
    return Column(BOOL8, data=hit.to(torch.uint8),
                  validity=None if col.validity is None else valid)


# -- Spark wire format ------------------------------------------------------

def spark_serialize(bits, num_hashes: int) -> bytes:
    """Spark BloomFilterImpl.writeTo: V1, numHashFunctions, numWords, BE
    longs.  Bit i lives at words[i >> 6], bit (i & 63) from the long's LSB;
    longs serialize big-endian (DataOutputStream)."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    bits = np.asarray(bits).astype(bool)
    num_bits = bits.shape[0]
    nwords = (num_bits + 63) // 64
    padded = np.zeros(nwords * 64, bool)
    padded[:num_bits] = bits
    words = np.packbits(padded.reshape(nwords, 64), axis=1,
                        bitorder="little").view(np.uint64).reshape(nwords)
    head = np.array([1, num_hashes, nwords], ">i4").tobytes()
    return head + words.astype(">u8").tobytes()


def spark_deserialize(buf: bytes) -> tuple[np.ndarray, int]:
    """(bool bit array, num_hashes) from Spark BloomFilterImpl bytes."""
    head = np.frombuffer(buf[:12], ">i4")
    version, num_hashes, nwords = int(head[0]), int(head[1]), int(head[2])
    if version != 1:
        raise ValueError(f"unsupported bloom filter version {version}")
    words = np.frombuffer(buf[12:12 + nwords * 8], ">u8")
    bits = np.unpackbits(words.astype("<u8").view(np.uint8),
                         bitorder="little")  # LSB-first within each long
    return bits.astype(bool), num_hashes
