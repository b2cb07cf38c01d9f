"""Validity bitmask packing at the wire edges.

Validity lives as ``bool[n]`` tensors; the cudf wire form is one bit per row,
LSB-first within 32-bit words (reference row_conversion.cu:158-165).  Packing
happens only at wire and host boundaries.  Words are returned as ``int32``
bit patterns (torch's uint32 has no shifts on the CPU).
"""

from __future__ import annotations

import torch


def pack_bits(valid: torch.Tensor, word_bits: int = 32) -> torch.Tensor:
    """bool[n] -> int32 (word_bits=32) or uint8 (word_bits=8) words,
    LSB-first; rows beyond n pad with 0 (invalid)."""
    if word_bits not in (8, 32):
        raise ValueError(f"word_bits must be 8 or 32, got {word_bits}")
    n = valid.shape[0]
    nwords = (n + word_bits - 1) // word_bits
    padded = torch.zeros(nwords * word_bits, dtype=torch.int64,
                         device=valid.device)
    padded[:n] = valid.to(torch.int64)
    shifts = torch.arange(word_bits, dtype=torch.int64, device=valid.device)
    words = (padded.view(nwords, word_bits) << shifts).sum(dim=1)
    if word_bits == 8:
        return words.to(torch.uint8)
    return words.to(torch.int32)  # low 32 bits, wraps into the sign bit


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """LSB-first packed words (uint8 or int32) -> bool[n]."""
    word_bits = words.element_size() * 8
    w = words.to(torch.int64)
    shifts = torch.arange(word_bits, dtype=torch.int64, device=words.device)
    bits = (w[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:n].to(torch.bool)
