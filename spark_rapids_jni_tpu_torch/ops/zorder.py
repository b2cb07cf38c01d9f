"""ZOrder: bit interleaving for multi-dimensional clustering.

The port of ``spark_rapids_jni_tpu/ops/zorder.py`` (the reference's ZOrder
component, ``interleave_bits`` behind Delta's OPTIMIZE ZORDER BY).  For k
integer columns of width w bits, output row r is a k*w-bit big-endian byte
string whose bit t (MSB first) carries bit (w-1 - t//k) of column (t % k),
identical to the Java/CUDA ``interleave_bits``.  The output is a
LIST<INT8> column of fixed k*w/8-byte rows.
"""

from __future__ import annotations

import torch

from ..columnar import Column, Table
from ..dtypes import INT8, TypeId

_WIDTH_OK = {1, 2, 4, 8}


def interleave_bits(table: Table) -> Column:
    """Interleave the bits of equal-width integer columns, MSB first.

    All columns must share one storage width (as cudf's interleave_bits
    requires).  Null values interleave their data bytes as they are (the
    reference kernel reads the data buffer unconditionally).
    """
    cols = list(table.columns)
    if not cols:
        raise ValueError("interleave_bits needs at least one column")
    widths = {c.dtype.itemsize for c in cols}
    if len(widths) != 1 or cols[0].dtype.itemsize not in _WIDTH_OK:
        raise TypeError(f"columns must share one integer width, got {widths}")
    for c in cols:
        if not (c.dtype.is_integral or c.dtype.is_timestamp
                or c.dtype.id == TypeId.BOOL8 or c.dtype.is_decimal):
            raise TypeError(
                f"non-integer column in interleave_bits: {c.dtype!r}")
    w = cols[0].dtype.itemsize * 8
    k = len(cols)
    n = cols[0].size
    dev = cols[0].device
    # bits 0..w-1 of the int64 widening are the storage bits whatever the
    # extension, and an arithmetic shift reads bit 63 as well as any
    vals = [c.data.to(torch.int64) for c in cols]
    out = torch.empty((n, k * w // 8), dtype=torch.uint8, device=dev)
    for byte_i in range(k * w // 8):
        acc = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(8):
            t = byte_i * 8 + j            # output bit, MSB first
            bit = w - 1 - t // k          # source bit, MSB first per column
            acc |= ((vals[t % k] >> bit) & 1) << (7 - j)
        out[:, byte_i] = acc.to(torch.uint8)
    offsets = torch.arange(n + 1, dtype=torch.int32, device=dev) * (k * w // 8)
    return Column.list_(Column(INT8, data=out.reshape(-1).view(torch.int8)),
                        offsets, device=dev)
