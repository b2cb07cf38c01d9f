"""Order-preserving key encodings for sort / group-compare.

Every key column encodes to one or more 64-bit words whose UNSIGNED order
equals the column's SQL order (the same bits as the JAX package's uint64
keys, held in ``int64`` tensors).  A multi-column order is then a chain of
stable ``torch.sort`` passes, least significant word first, on
``word ^ SIGN64`` (signed order on that is unsigned order on the word).

Encodings:
- signed ints / timestamps / decimals: value XOR sign bit
- unsigned ints / bool: zero-extend
- FLOAT32/64: IEEE total order on the normalized bits (-0.0 = 0.0, one
  NaN, above +inf)
- strings: bytes packed big-endian into 8-byte words, then the length as a
  tiebreaker so prefixes sort first
- nulls: a leading flag word (Spark: NULLS FIRST for ASC, LAST for DESC)

Descending order = bitwise NOT of every key word.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..columnar import Column
from ..dtypes import TypeId, int64_values
from ..utils.floatbits import (SIGN64, f32_bits_u, f32_from_order_key,
                               f32_order_key, f64_from_order_key,
                               f64_order_key, normalize_f32_bits,
                               normalize_f64_bits)
from .strings_common import to_padded_bytes

__all__ = ["SortKey", "encode_key", "encode_keys", "sort_indices",
           "rows_differ_from_prev", "normalize_f64_bits",
           "normalize_f32_bits", "decode_minmax_bits"]

@dataclass(frozen=True)
class SortKey:
    col: object          # Column
    ascending: bool = True
    nulls_first: bool | None = None  # None -> Spark default (first iff asc)

    @property
    def effective_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None else \
            self.nulls_first


def _fixed_to_u64(col: Column) -> torch.Tensor:
    """Unsigned-order word (int64 bits) of a fixed-width column."""
    tid = col.dtype.id
    data = col.data
    if tid == TypeId.DECIMAL128:
        raise ValueError("a DECIMAL128 key is two words: use encode_key")
    if tid == TypeId.FLOAT64:
        return f64_order_key(normalize_f64_bits(data.view(torch.int64)))
    if tid == TypeId.FLOAT32:
        return f32_order_key(normalize_f32_bits(f32_bits_u(data)))
    if tid == TypeId.BOOL8:
        return (data != 0).to(torch.int64)
    if col.dtype.is_unsigned:
        return int64_values(col.dtype, data)
    # signed integral family (ints, timestamps, durations, decimal unscaled)
    return data.to(torch.int64) ^ SIGN64


def _decimal128_words(col: Column) -> list[torch.Tensor]:
    """(hi ^ sign, lo): the unsigned order of the pair is the int128 order.
    (The JAX package's encoding yields one [n, 2] word and no valid order.)"""
    return [col.data[:, 1] ^ SIGN64, col.data[:, 0]]


def _string_words(col: Column) -> list[torch.Tensor]:
    mat, lengths = to_padded_bytes(col)
    n, w = mat.shape
    nwords = max((w + 7) // 8, 1)
    if w < nwords * 8:
        mat = torch.nn.functional.pad(mat, (0, nwords * 8 - w))
    m = mat.view(n, nwords, 8).to(torch.int64)
    words = []
    for c in range(nwords):
        word = m[:, c, 0]
        for b in range(1, 8):
            word = (word << 8) | m[:, c, b]  # big-endian packing
        words.append(word)
    words.append(lengths.to(torch.int64))  # prefix-first tiebreak
    return words


def encode_key(key: SortKey) -> list[torch.Tensor]:
    """Primary-first list of unsigned-order words (int64) for one key."""
    col: Column = key.col
    if col.dtype.is_string:
        words = _string_words(col)
    elif col.dtype.id == TypeId.DECIMAL128:
        words = _decimal128_words(col)
    else:
        words = [_fixed_to_u64(col)]
    if not key.ascending:
        words = [~wd for wd in words]
    if col.validity is not None:
        # null rows' value words are neutral: whatever the buffer holds
        # there must not split the null group or order rows within it
        words = [torch.where(col.validity, wd, torch.zeros_like(wd))
                 for wd in words]
        flag = col.validity.to(torch.int64)  # valid=1: nulls first
        if not key.effective_nulls_first:
            flag = 1 - flag
        words.insert(0, flag)
    return words


def encode_keys(keys: list[SortKey]) -> list[torch.Tensor]:
    """Primary-first flat word list for a multi-column ordering."""
    out: list[torch.Tensor] = []
    for k in keys:
        out.extend(encode_key(k))
    return out


def decode_minmax_bits(red: torch.Tensor, dtype) -> torch.Tensor:
    """Invert ``_fixed_to_u64``'s float total-order transform: a reduced
    (min/max) word -> float column data (float64 or float32 values)."""
    if dtype.id == TypeId.FLOAT64:
        return f64_from_order_key(red).view(torch.float64)
    return f32_from_order_key(red)


def lexsort(words: list[torch.Tensor]) -> torch.Tensor:
    """Stable row permutation ordering rows by ``words`` (primary first,
    unsigned order), as a chain of stable sorts from the last word."""
    n = words[0].shape[0]
    order = torch.arange(n, device=words[0].device)
    for wd in reversed(words):
        idx = torch.sort(wd[order] ^ SIGN64, stable=True).indices
        order = order[idx]
    return order


def sort_indices(keys: list[SortKey]) -> torch.Tensor:
    """Row permutation realizing the requested ordering (always stable)."""
    return lexsort(encode_keys(keys))


def rows_differ_from_prev(words: list[torch.Tensor],
                          order: torch.Tensor) -> torch.Tensor:
    """bool[n]: sorted row i differs from row i-1 on any key word (row 0
    True).  Nulls compare equal to nulls (the flag word is in ``words``)."""
    # row 0 set by a comparison, not ``diff[0] = True``: storing a Python
    # scalar into a CUDA tensor is a synchronous host-to-device copy
    diff = torch.arange(order.shape[0], device=order.device) == 0
    for wd in words:
        s = wd[order]
        diff[1:] |= s[1:] != s[:-1]
    return diff
