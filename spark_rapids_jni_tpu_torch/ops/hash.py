"""Spark-exact hash functions on int64 tensors.

- ``murmur3_hash``: Spark's ``hash()`` — Murmur3_x86_32, seed 42, chained
  across columns (each column's hash seeds the next; a null passes the
  running seed through unchanged).
- ``xxhash64``: Spark's ``xxhash64()`` — XXH64, seed 42, same chaining.

Type widening follows Spark's HashExpression: bool/byte/short/int/date ->
int lane; long/timestamp/decimal32/64 -> long lane (unscaled value); float
-> int bits and double -> long bits, with -0.0 -> 0.0 and NaNs made one;
strings hash their UTF-8 bytes.  Unsigned ints hash their bit pattern in
their natural lane.

Unsigned arithmetic runs in int64: 32-bit words live in [0, 2^32) and are
masked with ``& 0xFFFFFFFF`` after every multiply and shift; 64-bit words
use int64's two's-complement wrap, with logical right shifts emulated by a
mask.  (torch has no shifts for uint32/uint64 on the CPU.)
"""

from __future__ import annotations

import torch

from .. import device as _device
from ..columnar import Column, Table
from ..dtypes import DType, TypeId, INT32, INT64, int64_values
from ..utils.floatbits import M32, normalize_f64_bits
from ..utils.tracing import traced
from .strings_common import to_padded_bytes

DEFAULT_SEED = 42  # Spark's seed for both hash() and xxhash64()


def _s64(c: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _lsr64(x, r: int):
    """Logical right shift of int64-held u64 words."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x, r: int):
    return (x << r) | _lsr64(x, 64 - r)


# ---------------------------------------------------------------------------
# Murmur3_x86_32 (Spark hash())
# ---------------------------------------------------------------------------

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mix_k1(k1):
    k1 = (k1 * _C1) & M32
    k1 = _rotl32(k1, 15)
    return (k1 * _C2) & M32


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & M32
    return h1 ^ (h1 >> 16)


def _murmur_int(v, seed):
    """Spark Murmur3_x86_32.hashInt (v, seed: u32 in int64)."""
    return _fmix(_mix_h1(seed, _mix_k1(v)), 4)


def _murmur_long(v, seed):
    """Spark Murmur3_x86_32.hashLong: low word mixed first, then high."""
    h1 = _mix_h1(seed, _mix_k1(v & M32))
    h1 = _mix_h1(h1, _mix_k1(_lsr64(v, 32)))
    return _fmix(h1, 8)


def _murmur_bytes(mat: torch.Tensor, lengths: torch.Tensor, seed):
    """Spark Murmur3_x86_32.hashUnsafeBytes: 4-byte LE blocks, then each
    tail byte mixed on its own as a sign-extended int."""
    n, width = mat.shape
    lengths = lengths.to(torch.int64)
    nblocks = lengths // 4
    tail = lengths % 4
    b = mat.view(n, width // 4, 4).to(torch.int64)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | \
        (b[..., 3] << 24)
    h1 = seed
    for j in range(width // 4):
        h1 = torch.where(j < nblocks, _mix_h1(h1, _mix_k1(words[:, j])), h1)
    base = nblocks * 4
    for t in range(3):
        pos = (base + t).clamp(0, width - 1)
        byte = mat.gather(1, pos[:, None])[:, 0]
        k = byte.view(torch.int8).to(torch.int64) & M32  # Java byte
        h1 = torch.where(t < tail, _mix_h1(h1, _mix_k1(k)), h1)
    return _fmix(h1, lengths & M32)


# ---------------------------------------------------------------------------
# XXH64 (Spark xxhash64())
# ---------------------------------------------------------------------------

_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _xx_fmix(h):
    h = h ^ _lsr64(h, 33)
    h = h * _P2
    h = h ^ _lsr64(h, 29)
    h = h * _P3
    return h ^ _lsr64(h, 32)


def _xx_round(acc, k):
    return _rotl64(acc + k * _P2, 31) * _P1


def _xx_int(v, seed):
    """Spark XXH64.hashInt: 4-byte input, zero-extended."""
    h = seed + _P5 + 4
    h = h ^ ((v & M32) * _P1)
    return _xx_fmix(_rotl64(h, 23) * _P2 + _P3)


def _xx_long(v, seed):
    """Spark XXH64.hashLong."""
    h = seed + _P5 + 8
    h = h ^ _xx_round(torch.zeros_like(v), v)
    return _xx_fmix(_rotl64(h, 27) * _P1 + _P4)


def _xx_bytes(mat: torch.Tensor, lengths: torch.Tensor, seed):
    """Full XXH64 over per-row byte strings (Spark hashUnsafeBytes):
    32-byte stripes feed four accumulators; the rest is consumed as 8-byte
    words, one optional 4-byte word, then single bytes."""
    n, width = mat.shape
    lengths = lengths.to(torch.int64)
    w = max((width + 31) // 32 * 32, 32)  # every masked lane in bounds
    if w != width:
        mat = torch.nn.functional.pad(mat, (0, w - width))
    m8 = mat.view(n, w // 8, 8).to(torch.int64)
    words8 = m8[..., 0]
    for i in range(1, 8):
        words8 = words8 | (m8[..., i] << (8 * i))
    m4 = mat.view(n, w // 4, 4).to(torch.int64)
    words4 = m4[..., 0] | (m4[..., 1] << 8) | (m4[..., 2] << 16) | \
        (m4[..., 3] << 24)

    nstripes = lengths // 32
    v1 = seed + _P1 + _P2
    v2 = seed + _P2
    v3 = seed.clone()
    v4 = seed - _P1
    for s in range(w // 32):
        live = s < nstripes
        v1 = torch.where(live, _xx_round(v1, words8[:, 4 * s]), v1)
        v2 = torch.where(live, _xx_round(v2, words8[:, 4 * s + 1]), v2)
        v3 = torch.where(live, _xx_round(v3, words8[:, 4 * s + 2]), v3)
        v4 = torch.where(live, _xx_round(v4, words8[:, 4 * s + 3]), v4)

    zero = torch.zeros_like(seed)

    def merge(h, v):
        return (h ^ _xx_round(zero, v)) * _P1 + _P4

    h_long = _rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + \
        _rotl64(v4, 18)
    h_long = merge(merge(merge(merge(h_long, v1), v2), v3), v4)
    h = torch.where(lengths >= 32, h_long, seed + _P5) + lengths

    # remaining 8-byte words after the stripes: up to 3
    done8 = nstripes * 4
    n8 = lengths // 8
    for t in range(3):
        pos = (done8 + t).clamp(0, w // 8 - 1)
        k1 = words8.gather(1, pos[:, None])[:, 0]
        h = torch.where(done8 + t < n8,
                        _rotl64(h ^ _xx_round(zero, k1), 27) * _P1 + _P4, h)

    # optional 4-byte word
    pos4 = (n8 * 2).clamp(0, w // 4 - 1)
    k4 = words4.gather(1, pos4[:, None])[:, 0] & M32
    h = torch.where(lengths % 8 >= 4,
                    _rotl64(h ^ (k4 * _P1), 23) * _P2 + _P3, h)

    # trailing single bytes
    done_bytes = lengths // 4 * 4
    tail = lengths - done_bytes
    for t in range(3):
        pos = (done_bytes + t).clamp(0, w - 1)
        b = mat.gather(1, pos[:, None])[:, 0].to(torch.int64)
        h = torch.where(t < tail, _rotl64(h ^ (b * _P5), 11) * _P1, h)
    return _xx_fmix(h)


# ---------------------------------------------------------------------------
# column dispatch
# ---------------------------------------------------------------------------

# Spark widens bool/byte/short/int/date to the 4-byte lane; decimals of
# precision <= 18 hash their unscaled value as a long
_INT_LANE = {TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.BOOL8,
             TypeId.UINT8, TypeId.UINT16, TypeId.UINT32,
             TypeId.TIMESTAMP_DAYS, TypeId.DURATION_DAYS}


def _int_lane_u32(col: Column) -> torch.Tensor:
    """The 32-bit lane (sign-extended ints, zero-extended unsigned) as a u32
    word in int64."""
    d = col.data
    tid = col.dtype.id
    if tid == TypeId.BOOL8:
        return (d != 0).to(torch.int64)
    if tid == TypeId.FLOAT32:
        x = torch.where(d == 0.0, torch.zeros_like(d), d)  # -0.0 -> 0.0
        v = torch.where(torch.isnan(x), torch.full_like(x.view(torch.int32),
                                                        0x7FC00000),
                        x.view(torch.int32))
        return v.to(torch.int64) & M32
    return int64_values(col.dtype, d) & M32


def _long_lane_u64(col: Column) -> torch.Tensor:
    if col.dtype.id == TypeId.FLOAT64:
        return normalize_f64_bits(col.data.view(torch.int64))
    if col.dtype.id == TypeId.DECIMAL128:
        # the JAX package raises here too (a [n, 2] lane against [n] hashes)
        raise ValueError("hashing DECIMAL128 columns is not supported")
    return col.data.to(torch.int64)


def _lane_kind(dtype: DType) -> str:
    if dtype.is_string:
        return "bytes"
    if dtype.id in _INT_LANE or dtype.id == TypeId.FLOAT32:
        return "int"
    return "long"


def _hash_table(table, seed: int, int_fn, long_fn, bytes_fn, device):
    dev = _device.resolve(device)
    if isinstance(table, Column):
        table = Table([table])
    table = table.to(dev)
    h = torch.full((table.num_rows,), seed, dtype=torch.int64, device=dev)
    for col in table.columns:
        kind = _lane_kind(col.dtype)
        if kind == "bytes":
            mat, lengths = to_padded_bytes(col)
            nh = bytes_fn(mat, lengths, h)
        elif kind == "int":
            nh = int_fn(_int_lane_u32(col), h)
        else:
            nh = long_fn(_long_lane_u64(col), h)
        if col.validity is not None:
            nh = torch.where(col.validity, nh, h)  # nulls pass the seed on
        h = nh
    return h


def murmur3_hash_specs(cols, specs, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Spark ``hash()`` (u32 in int64) over a column list where some
    ORIGINAL columns appear exploded as (length, word...) groups
    (``parallel/stringplane.py``).

    ``specs``: per original column, ("fixed", idx) or
    ("string", len_idx, (word_idx, ...)).  Exploded string groups hash their
    UTF-8 bytes, rebuilt from the little-endian words: bit for bit the hash
    of the original STRING column (Spark UTF8String murmur3), not of the
    exploded form.  Null columns pass the running seed on, a string group's
    validity riding on its length column.
    """
    first = cols[specs[0][1]]
    n, dev = first.size, first.device
    h = torch.full((n,), seed & M32, dtype=torch.int64, device=dev)
    for spec in specs:
        if spec[0] == "fixed":
            col = cols[spec[1]]
            kind = _lane_kind(col.dtype)
            if kind == "bytes":
                mat, lengths = to_padded_bytes(col)
                nh = _murmur_bytes(mat, lengths, h)
            elif kind == "int":
                nh = _murmur_int(_int_lane_u32(col), h)
            else:
                nh = _murmur_long(_long_lane_u64(col), h)
            valid = col.validity
        else:
            len_col = cols[spec[1]]
            words = torch.stack([cols[i].data for i in spec[2]], dim=1)
            mat = words.contiguous().view(torch.uint8).reshape(
                n, 4 * len(spec[2]))
            nh = _murmur_bytes(mat, len_col.data, h)
            valid = len_col.validity
        if valid is not None:
            nh = torch.where(valid, nh, h)
        h = nh
    return h


@traced("murmur3_hash")
def murmur3_hash(table: Table | Column, seed: int = DEFAULT_SEED,
                 device=_device.DEFAULT) -> Column:
    """Spark ``hash(...)``: Murmur3_x86_32 chained across columns -> INT32."""
    h = _hash_table(table, seed & M32, _murmur_int, _murmur_long,
                    _murmur_bytes, device)
    return Column(INT32, data=h.to(torch.int32))


@traced("xxhash64")
def xxhash64(table: Table | Column, seed: int = DEFAULT_SEED,
             device=_device.DEFAULT) -> Column:
    """Spark ``xxhash64(...)``: XXH64 chained across columns -> INT64."""
    h = _hash_table(table, _s64(seed & ((1 << 64) - 1)), _xx_int, _xx_long,
                    _xx_bytes, device)
    return Column(INT64, data=h)
