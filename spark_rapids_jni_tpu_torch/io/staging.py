"""Single-transfer device staging for fixed-width column sets.

The port of ``spark_rapids_jni_tpu/io/staging.py``.  Every column buffer
(values and validity) is packed into ONE pinned host buffer, copied to the
device in one ``non_blocking`` transfer, and unpacked there as views of that
buffer: a row bucket of each column is a slice at an 8-byte aligned offset,
viewed as the column's storage type.  Nothing compiles, so the JAX
package's background warm-up of the unpack program has no counterpart.

Rows are padded to a power-of-two bucket (at least 1024) as in the JAX
package; ``padded=True`` keeps that form (pad rows zeroed, validity False)
and returns ``(Table, n_rows)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .. import dtypes as dt
from ..columnar import Column, Table
from ..utils import faults

_ALIGN = 8  # every segment starts 8-byte aligned, so any view is legal


def _bucket(n: int) -> int:
    """Next power of two >= max(n, 1024)."""
    b = 1024
    while b < n:
        b *= 2
    return b


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def host_buffer(nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 host buffer to stage ``nbytes`` towards ``device``: pinned
    when the device is a card, so the copy can be asynchronous."""
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def to_device(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """ONE host-to-device copy of a staging buffer (asynchronous from
    pinned memory; the caching host allocator keeps ``buf`` alive until
    the copy is done)."""
    if device.type == "cpu":
        return buf
    return buf.to(device, non_blocking=True)


def stage_fixed_table(specs, padded: bool = False, device=_device.DEFAULT):
    """``specs``: list of (name, dtype, values_np, validity_np_or_None) for
    fixed-width dtypes only.  One host pack, ONE device transfer, views on
    the device; returns the Table (``(Table, n_rows)`` when ``padded``).
    """
    faults.check("staging.transfer")
    dev = _device.resolve(device)
    n_rows = len(specs[0][2]) if specs else 0
    rows = _bucket(n_rows)
    layout = []   # (name, dtype, value offset, validity offset or None)
    total = 0
    for name, dtype, values, validity in specs:
        if dtype.id == dt.TypeId.DECIMAL128:
            raise TypeError("DECIMAL128 staging unsupported; use the "
                            "column-at-a-time path")
        voff = total
        total += _aligned(rows * dtype.storage.itemsize)
        moff = None
        if validity is not None:
            moff = total
            total += _aligned(rows)
        layout.append((name, dtype, voff, moff))

    host = host_buffer(total, dev)
    hbuf = host.numpy()
    hbuf[:] = 0  # pad rows and alignment gaps are zero
    for (name, dtype, voff, moff), (_, _, values, validity) in zip(layout,
                                                                   specs):
        vals = np.ascontiguousarray(values, dtype.storage)
        hbuf[voff:voff + vals.nbytes] = vals.view(np.uint8)
        if moff is not None:
            hbuf[moff:moff + len(validity)] = np.asarray(validity, np.uint8)
    buf = to_device(host, dev)  # ONE transfer

    keep = rows if padded else n_rows
    cols, names = [], []
    for name, dtype, voff, moff in layout:
        size = dtype.storage.itemsize
        data = buf[voff:voff + rows * size].view(dtype.torch_dtype)[:keep]
        valid = None
        if moff is not None:
            valid = buf[moff:moff + rows].view(torch.bool)[:keep]
        cols.append(Column(dtype, data=data, validity=valid))
        names.append(name)
    out = Table(cols, names)
    return (out, n_rows) if padded else out
