"""The JCUDF fixed-width row format in NumPy: layout, packer and unpacker.

The rules of spark-rapids-jni's RowConversion (row_conversion.cu,
``compute_fixed_width_layout``): each column's value at its natural
alignment in schema order, then one validity bit a column (bit i % 8 of
byte i // 8, set when valid) in the bytes after the values, the row padded
to a multiple of 8 bytes.  Padding bytes are zero.
"""

from __future__ import annotations

import numpy as np


def layout(itemsizes) -> tuple:
    """(value offsets, first validity byte, row size) of a schema given by
    its columns' byte widths."""
    off, offsets = 0, []
    for size in itemsizes:
        off = (off + size - 1) // size * size
        offsets.append(off)
        off += size
    validity = off
    off += (len(offsets) + 7) // 8
    return offsets, validity, (off + 7) // 8 * 8


def _row_dtype(dtypes) -> tuple:
    offsets, vbyte, size = layout([np.dtype(d).itemsize for d in dtypes])
    nv = (len(offsets) + 7) // 8
    names = [f"c{i}" for i in range(len(offsets))] + \
        [f"v{i}" for i in range(nv)]
    formats = [np.dtype(d).newbyteorder("<") for d in dtypes] + ["u1"] * nv
    offs = offsets + [vbyte + i for i in range(nv)]
    return np.dtype({"names": names, "formats": formats, "offsets": offs,
                     "itemsize": size}), nv


def pack(columns) -> np.ndarray:
    """``columns``: [(values, valid or None)] of numpy arrays; returns the
    rows as ``uint8[n * row_size]``."""
    dt, nv = _row_dtype([v.dtype for v, _ in columns])
    n = len(columns[0][0])
    rows = np.zeros(n, dt)
    for i, (v, _) in enumerate(columns):
        rows[f"c{i}"] = v
    for b in range(nv):
        byte = np.zeros(n, np.uint8)
        for i in range(8 * b, min(8 * b + 8, len(columns))):
            ok = columns[i][1]
            byte |= (np.uint8(1) if ok is None else
                     ok.astype(np.uint8)) << np.uint8(i % 8)
        rows[f"v{b}"] = byte
    return rows.view(np.uint8).reshape(-1)


def unpack(blob: np.ndarray, dtypes) -> list:
    """Inverse of ``pack``: [(values, valid)] (every validity given)."""
    dt, nv = _row_dtype(dtypes)
    rows = np.ascontiguousarray(blob).view(dt)
    out = []
    for i, d in enumerate(dtypes):
        byte = rows[f"v{i // 8}"]
        out.append((rows[f"c{i}"].astype(d),
                    ((byte >> (i % 8)) & 1).astype(np.bool_)))
    return out
