"""Padded byte-matrix form of STRING columns.

STRING columns live in Arrow layout (uint8 chars + int32 offsets).  Hashing
and key encoding run over a padded matrix ``uint8[n, width]`` built here;
``width`` is a padding bucket (next power of two of the longest row), the
same rule as the JAX package, so both build the same matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column


def pad_width_bucket(max_len: int, minimum: int = 4) -> int:
    """Padding bucket: next power of two >= max(max_len, minimum)."""
    w = minimum
    while w < max_len:
        w *= 2
    return w


def string_width_bucket(col: Column) -> int:
    """The bucket width ``to_padded_bytes`` picks for a STRING column."""
    lens = col.offsets[1:] - col.offsets[:-1]
    return pad_width_bucket(int(lens.max()) if lens.numel() else 0)


def ragged_copy(dst: torch.Tensor, dst_start: torch.Tensor,
                src: torch.Tensor, src_start: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """``dst[dst_start[i] + j] = src[src_start[i] + j]`` for every row i and
    ``j < lengths[i]`` (int64 index vectors)."""
    total = int(lengths.sum())
    if total == 0:
        return
    dev = lengths.device
    rows = torch.repeat_interleave(torch.arange(lengths.shape[0], device=dev),
                                   lengths, output_size=total)
    j = torch.arange(total, device=dev) - (torch.cumsum(lengths, 0)
                                           - lengths)[rows]
    dst[dst_start[rows] + j] = src[src_start[rows] + j]


def to_padded_bytes(col: Column, width: int | None = None):
    """(uint8[n, width] zero-padded byte matrix, int32[n] lengths)."""
    if not col.dtype.is_string:
        raise TypeError(f"expected STRING column, got {col.dtype!r}")
    offsets = col.offsets.to(torch.int64)
    if width is None:
        width = string_width_bucket(col)
    chars = col.data if col.data is not None and col.data.shape[0] else \
        torch.zeros(1, dtype=torch.uint8, device=offsets.device)
    starts = offsets[:-1]
    lengths = (offsets[1:] - starts).to(torch.int32)
    pos = torch.arange(width, dtype=torch.int64, device=offsets.device)
    idx = (starts[:, None] + pos[None, :]).clamp(0, chars.shape[0] - 1)
    mat = chars[idx]
    keep = pos[None, :] < lengths[:, None]
    return torch.where(keep, mat, torch.zeros_like(mat)), lengths


def from_padded_bytes(mat: torch.Tensor, lengths: torch.Tensor,
                      validity=None) -> Column:
    """Rebuild an Arrow-layout STRING column from a padded byte matrix."""
    dev = mat.device
    lengths = lengths.to(torch.int64)
    n = mat.shape[0]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lengths, 0, out=offsets[1:])
    total = int(offsets[-1]) if n else 0
    if total > np.iinfo(np.int32).max:
        raise OverflowError(
            f"string column char buffer is {total} bytes; Arrow int32 "
            f"offsets cap at 2^31-1")
    keep = torch.arange(mat.shape[1], device=dev)[None, :] < lengths[:, None]
    chars = mat[keep]  # row-major boolean extraction == concatenated rows
    return Column.string(chars, offsets.to(torch.int32), validity, device=dev)
