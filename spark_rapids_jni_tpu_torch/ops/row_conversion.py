"""RowConversion: columnar Table <-> packed row-major blobs (LIST<INT8>).

The port of ``spark_rapids_jni_tpu/ops/row_conversion.py``; the wire format
is byte-identical to it and to the reference (reference
row_conversion.cu:432-456, RowConversion.java:50-99): natural C alignment
per column in schema order, one validity bit per column in bytes after the
values, rows padded to a multiple of 8 bytes.  Output splits into batches
of at most ``max_batch_bytes`` (int32 LIST offsets) whose row counts are
multiples of 32, except the last.

Fixed width runs in three steps:

1. ``_build_planes``: every row word becomes one ``int32[n]`` *plane*
   (column-major), built from the columns with shifts and ors;
2. ``_to_rows_wire``: kernel K1 (``kernels.row_wire.interleave_planes``)
   transposes the planes into the row-major wire ``int32[n * nwords]``;
3. ``convert_from_rows`` runs the inverse: K2
   (``kernels.row_wire.deinterleave_wire``), then ``_from_planes``.

The profiler ranges ``row_conversion.check``, ``.planes``, ``.wire`` and
``.columns`` mark these steps, apart from one another.

STRING columns make variable-width rows under the contract written above
``VarRowLayout``; that path writes each row's bytes at its offset with
plain tensor scatters and uses no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from ..columnar import Column, PackedByteColumn, Table
from ..dtypes import DType, TypeId, INT8, UINT8
from ..kernels import row_wire
from ..utils.tracing import span, sync_point, traced
from .strings_common import ragged_copy

# per-batch byte ceiling from cudf's int32 list offsets (reference
# row_conversion.cu:384-386) and 32-row batch alignment (:477-479)
MAX_BATCH_BYTES = (1 << 31) - 1
BATCH_ROW_ALIGN = 32
WIRE_GROUP = row_wire.GROUP


@dataclass(frozen=True)
class RowLayout:
    """Packed-row layout plan for one schema (reference
    ``compute_fixed_width_layout``, row_conversion.cu:432-456)."""

    schema: tuple[DType, ...]
    offsets: tuple[int, ...]  # byte offset of each column's value in the row
    validity_offset: int      # first validity byte
    row_size: int             # padded total bytes per row

    @property
    def num_validity_bytes(self) -> int:
        return (len(self.schema) + 7) // 8


def fixed_width_layout(schema: Sequence[DType]) -> RowLayout:
    schema = tuple(schema)
    for dt in schema:
        if not dt.is_fixed_width:
            # parity with CUDF_FAIL "only fixed-width types"
            raise TypeError(
                f"row conversion requires fixed-width types, got {dt!r}")
    off = 0
    offsets = []
    for dt in schema:
        size = dt.itemsize
        off = (off + size - 1) // size * size  # natural C alignment
        offsets.append(off)
        off += size
    validity_offset = off
    off += (len(schema) + 7) // 8
    row_size = (off + 7) // 8 * 8  # 64-bit row padding
    return RowLayout(schema, tuple(offsets), validity_offset, row_size)


# ---------------------------------------------------------------------------
# columns <-> word planes
# ---------------------------------------------------------------------------

def _col_to_u32_parts(dtype: DType, data: torch.Tensor
                      ) -> list[tuple[int, torch.Tensor]]:
    """One column as (byte width, int32 word holding the value in its low
    bytes) parts: four for DECIMAL128, (lo, hi) for 8-byte types, one
    otherwise.  Pure bit views: no float arithmetic touches the data."""
    size = dtype.itemsize
    if size == 16:  # int64[n, 2] limbs -> four little-endian words
        quad = data.contiguous().view(torch.int32).view(-1, 4)
        return [(4, quad[:, i]) for i in range(4)]
    if size == 8:  # FLOAT64 included: its bits are a view
        pair = data.contiguous().view(torch.int32).view(-1, 2)
        return [(4, pair[:, 0]), (4, pair[:, 1])]
    if size == 4:
        return [(4, data.view(torch.int32))]
    if size == 2:
        return [(2, data.view(torch.int16).to(torch.int32) & 0xFFFF)]
    return [(1, data.view(torch.uint8).to(torch.int32))]


@traced("row_conversion.planes")
def _build_planes(layout: RowLayout, datas: Sequence[Optional[torch.Tensor]],
                  masks: Sequence[Optional[torch.Tensor]], n: int,
                  device: torch.device, extra_parts=None,
                  padded: Optional[int] = None) -> torch.Tensor:
    """Word planes ``int32[nwords, padded]``: plane w holds row word w of
    every row; columns ``n..padded`` are zero.

    ``extra_parts``: optional {column index: [(byte width, int32 part)]}
    replacing the value parts of columns whose buffer is not the wire value
    (the variable-width path puts STRING slot words here).
    """
    nwords = layout.row_size // 4
    padded = n if padded is None else padded
    mat = torch.zeros((nwords, padded), dtype=torch.int32, device=device)

    def place(byte_off: int, width: int, value: torch.Tensor):
        w, b = divmod(byte_off, 4)
        assert b + width <= 4, "parts never straddle words (natural alignment)"
        mat[w, :n] |= value << (8 * b) if b else value

    for ci, (dt, off, data) in enumerate(zip(layout.schema, layout.offsets,
                                             datas)):
        parts = (extra_parts[ci] if extra_parts and ci in extra_parts
                 else _col_to_u32_parts(dt, data))
        for i, (width, part) in enumerate(parts):
            place(off + 4 * i, width, part)

    # validity: bit i%8 of byte i//8 is set when column i's row is valid
    for byte_idx in range(layout.num_validity_bytes):
        byte = torch.zeros(n, dtype=torch.int32, device=device)
        for bit in range(8):
            i = byte_idx * 8 + bit
            if i >= len(layout.schema):
                break
            m = masks[i]
            byte |= (1 << bit) if m is None else m.to(torch.int32) << bit
        place(layout.validity_offset + byte_idx, 1, byte)
    return mat


def _subword(planes: torch.Tensor, byte_off: int, width: int) -> torch.Tensor:
    w, b = divmod(byte_off, 4)
    v = planes[w]
    if b:
        v = v >> (8 * b)
    if width < 4:
        v = v & ((1 << (8 * width)) - 1)
    return v


def _column_data(dt: DType, off: int, planes: torch.Tensor) -> torch.Tensor:
    """Column ``dt`` at byte offset ``off`` of the rows, from the planes."""
    w = off // 4
    size = dt.itemsize
    if size in (8, 16):  # (lo, hi) word pairs -> int64 values / limbs
        words = torch.stack([planes[w + i] for i in range(size // 4)], dim=1)
        data = words.view(torch.int64)
        return data if size == 16 else data.view(-1).view(dt.torch_dtype)
    if size == 4:
        return planes[w].view(dt.torch_dtype)
    if size == 2:
        return _subword(planes, off, 2).to(torch.int16).view(dt.torch_dtype)
    u8 = _subword(planes, off, 1).to(torch.uint8)
    return u8 if dt.torch_dtype == torch.uint8 else u8.view(torch.int8)


def _masks(layout: RowLayout, planes: torch.Tensor) -> list[torch.Tensor]:
    out = []
    for i in range(len(layout.schema)):
        byte = _subword(planes, layout.validity_offset + i // 8, 1)
        out.append(((byte >> (i % 8)) & 1).to(torch.bool))
    return out


@traced("row_conversion.columns")
def _from_planes(layout: RowLayout, planes: torch.Tensor):
    """Word planes ``int32[nwords, n]`` -> (datas, masks)."""
    datas = [_column_data(dt, off, planes)
             for dt, off in zip(layout.schema, layout.offsets)]
    return datas, _masks(layout, planes)


# ---------------------------------------------------------------------------
# word planes <-> wire (kernels K1 and K2)
# ---------------------------------------------------------------------------

def _to_rows_wire(layout: RowLayout, datas, masks,
                  device: torch.device) -> torch.Tensor:
    """Packed wire image ``int32[n * row_size // 4]`` of one batch; its
    little-endian bytes are exactly the packed rows.  The planes are built
    32-row padded (K1's contract) and the padding cut off the wire."""
    nwords = layout.row_size // 4
    n = datas[0].shape[0] if datas else 0
    padded = -(-n // WIRE_GROUP) * WIRE_GROUP
    if padded == 0:
        return torch.zeros(0, dtype=torch.int32, device=device)
    mat = _build_planes(layout, datas, masks, n, device, padded=padded)
    with span("row_conversion.wire"):
        wire = row_wire.interleave_planes(mat)
        return wire if padded == n else wire[:n * nwords]


@traced("row_conversion.wire")
def _from_wire(layout: RowLayout, wire: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``_to_rows_wire``: wire -> planes ``int32[nwords, n]``."""
    nwords = layout.row_size // 4
    padded = -(-n // WIRE_GROUP) * WIRE_GROUP
    if padded == 0:
        return torch.zeros((nwords, 0), dtype=torch.int32, device=wire.device)
    wire = wire[:n * nwords]
    if padded != n:
        wire = torch.cat([wire, wire.new_zeros((padded - n) * nwords)])
    mat = row_wire.deinterleave_wire(wire.contiguous(), nwords)
    return mat if padded == n else mat[:, :n]


def _from_rows_bytes(layout: RowLayout, data_u8: torch.Tensor):
    """Byte blob (uint8/int8) of one batch -> (datas, masks)."""
    n = data_u8.shape[0] // layout.row_size
    wire = data_u8.contiguous().view(torch.int32)
    return _from_planes(layout, _from_wire(layout, wire, n))


# ---------------------------------------------------------------------------
# variable-width (STRING) rows
# ---------------------------------------------------------------------------
#
# The reference snapshot fails on variable width (row_conversion.cu:515,573);
# the contract here follows Spark's UnsafeRow grafted onto the fixed-width
# layout, byte for byte as the JAX package writes it:
#
#   | fixed region | validity bytes | pad to 8 | variable region | (8-aligned)
#
# - STRING columns occupy an 8-byte naturally-aligned slot in the fixed
#   region: u32 LE byte offset FROM ROW START to the field's bytes, then
#   u32 LE byte length.
# - validity bytes exactly as the fixed-width contract.
# - the variable region starts at align8(validity end); fields appear in
#   column order, each padded to an 8-byte multiple with zero bytes, so
#   every row size is 8-aligned.
# - NULL strings write length 0 at the offset the field would occupy and
#   contribute no variable bytes.


@dataclass(frozen=True)
class VarRowLayout:
    """Layout plan for rows with STRING columns; ``base.row_size`` is the
    variable region's start offset."""

    base: RowLayout
    string_idx: tuple[int, ...]


def variable_width_layout(schema: Sequence[DType]) -> VarRowLayout:
    schema = tuple(schema)
    off = 0
    offsets = []
    for dt in schema:
        if not (dt.is_string or dt.is_fixed_width):
            raise TypeError(
                f"row conversion supports fixed-width and STRING, got {dt!r}")
        size = 8 if dt.is_string else dt.itemsize
        off = (off + size - 1) // size * size
        offsets.append(off)
        off += size
    validity_offset = off
    off += (len(schema) + 7) // 8
    var_start = (off + 7) // 8 * 8
    base = RowLayout(schema, tuple(offsets), validity_offset, var_start)
    return VarRowLayout(base, tuple(i for i, dt in enumerate(schema)
                                    if dt.is_string))


def _to_rows_var_batch(vlayout: VarRowLayout, table: Table, slens, row_sizes,
                       row_ends, start: int, stop: int, base_off: int,
                       total_bytes: int, device: torch.device) -> Column:
    """Rows ``start..stop`` as one variable-width blob; ``base_off`` is the
    byte offset of row ``start`` in the unbatched image."""
    base = vlayout.base
    m = stop - start
    ends = row_ends[start:stop] - base_off
    row_start = ends - row_sizes[start:stop]
    wire = torch.zeros(total_bytes // 4, dtype=torch.int32, device=device)

    extra = {}
    field_start = []
    acc = torch.zeros(m, dtype=torch.int64, device=device)
    for k, idx in enumerate(vlayout.string_idx):
        ln = slens[k][start:stop]
        off_bytes = base.row_size + acc  # from the row's start
        extra[idx] = [(4, off_bytes.to(torch.int32)), (4, ln.to(torch.int32))]
        field_start.append(row_start + off_bytes)
        acc = acc + (ln + 7) // 8 * 8
    datas = [None if dt.is_string else c.data[start:stop]
             for dt, c in zip(base.schema, table.columns)]
    masks = [None if c.validity is None else c.validity[start:stop]
             for c in table.columns]
    planes = _build_planes(base, datas, masks, m, device, extra_parts=extra)
    base_words = base.row_size // 4
    word_idx = (row_start // 4)[:, None] + \
        torch.arange(base_words, device=device)[None, :]
    wire[word_idx.reshape(-1)] = planes.t().reshape(-1)

    wire_u8 = wire.view(torch.uint8)
    for k, idx in enumerate(vlayout.string_idx):
        col = table.columns[idx]
        ragged_copy(wire_u8, field_start[k], col.data,
                     col.offsets[start:stop].to(torch.int64),
                     slens[k][start:stop])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                         ends.to(torch.int32)])
    return Column.list_(PackedByteColumn(INT8, data=wire), offsets,
                        device=device)


def _convert_to_rows_var(table: Table, max_batch_bytes: int,
                         device: torch.device) -> list[Column]:
    vlayout = variable_width_layout(table.dtypes())
    base = vlayout.base
    n = table.num_rows
    slens = []
    row_sizes = torch.full((n,), base.row_size, dtype=torch.int64,
                           device=device)
    for idx in vlayout.string_idx:
        c = table.columns[idx]
        ln = (c.offsets[1:] - c.offsets[:-1]).to(torch.int64)
        if c.validity is not None:
            ln = torch.where(c.validity, ln, torch.zeros_like(ln))
        slens.append(ln)
        row_sizes = row_sizes + (ln + 7) // 8 * 8
    row_ends = torch.cumsum(row_sizes, 0)
    total = 0
    if n:
        with sync_point("row_conversion.var_sizes.total"):
            total = int(row_ends[-1])

    def emit(start, stop, base_off, nbytes):
        return _to_rows_var_batch(vlayout, table, slens, row_sizes, row_ends,
                                  start, stop, base_off, nbytes, device)

    if total <= max_batch_bytes:  # common case: one batch
        return [emit(0, n, 0, total)]

    # several batches: row boundary planning needs the sizes on the host
    with sync_point("row_conversion.var_sizes.batches"):
        ends_np = row_ends.cpu().numpy()
        sizes_np = row_sizes.cpu().numpy()
    if int(sizes_np.max()) > max_batch_bytes:
        raise ValueError(
            f"a single row packs to {int(sizes_np.max())} bytes, above "
            f"max_batch_bytes={max_batch_bytes}")
    out = []
    start = 0
    while start < n:
        # greedy by bytes, cut 32-row aligned whenever one whole aligned
        # group fits (reference row_conversion.cu:476-511)
        base_off = int(ends_np[start - 1]) if start else 0
        stop = int(np.searchsorted(ends_np, base_off + max_batch_bytes,
                                   side="right"))
        if stop < n:
            fit = stop - start
            if fit >= BATCH_ROW_ALIGN:
                stop = start + fit // BATCH_ROW_ALIGN * BATCH_ROW_ALIGN
            else:
                # fewer than 32 rows fit: one aligned group genuinely
                # exceeds max_batch_bytes, the one case cut unaligned
                group_end = min(start + BATCH_ROW_ALIGN, n)
                assert int(ends_np[group_end - 1]) - base_off \
                    > max_batch_bytes, "unaligned middle batch despite a " \
                    "fitting aligned group"
        out.append(emit(start, stop, base_off,
                        int(ends_np[stop - 1]) - base_off))
        start = stop
    return out


def _convert_from_rows_var(rows: Column, schema: Sequence[DType]) -> Table:
    vlayout = variable_width_layout(schema)
    base = vlayout.base
    child = rows.children[0]
    dev = rows.offsets.device
    offs = rows.offsets.to(torch.int64)
    n = offs.shape[0] - 1
    with span("row_conversion.check"):
        sizes = offs[1:] - offs[:-1]
        if n:
            with sync_point("row_conversion.var_sizes.check"):
                bad = bool(((sizes < base.row_size) | (sizes % 8 != 0)).any())
            if bad:
                raise ValueError(
                    f"variable-width row blobs must be 8-byte aligned and at "
                    f"least the fixed region ({base.row_size} B)")
    wire = child.data if child.data.dtype == torch.int32 else \
        child.data.contiguous().view(torch.int32)
    base_words = base.row_size // 4
    idx = (offs[:-1] // 4)[:, None] + \
        torch.arange(base_words, device=dev)[None, :]
    planes = wire[idx.clamp(0, max(wire.shape[0] - 1, 0))].t().contiguous() \
        if n else torch.zeros((base_words, 0), dtype=torch.int32, device=dev)
    masks = _masks(base, planes)
    wire_u8 = wire.view(torch.uint8)
    cols = []
    for ci, (dt, off) in enumerate(zip(base.schema, base.offsets)):
        if not dt.is_string:
            cols.append(Column(dt, data=_column_data(dt, off, planes),
                               validity=masks[ci]))
            continue
        foff = planes[off // 4].to(torch.int64)
        flen = planes[off // 4 + 1].to(torch.int64)
        str_offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(flen, 0, out=str_offs[1:])
        with sync_point("row_conversion.var_sizes.chars"):
            nchars = int(str_offs[-1])
        chars = torch.empty(nchars, dtype=torch.uint8, device=dev)
        ragged_copy(chars, str_offs[:-1], wire_u8, offs[:-1] + foff, flen)
        cols.append(Column.string(chars, str_offs.to(torch.int32),
                                  validity=masks[ci], device=dev))
    return Table(cols)


# ---------------------------------------------------------------------------
# public API (mirrors RowConversion.java:101-121)
# ---------------------------------------------------------------------------

@traced("convert_to_rows")
def convert_to_rows(table: Table, max_batch_bytes: int = MAX_BATCH_BYTES,
                    device=_device.DEFAULT) -> list[Column]:
    """Columnar table -> list of LIST<INT8> row-blob columns, on ``device``.

    Analog of ``RowConversion.convertToRows``.  Several columns come back
    when the packed output would exceed ``max_batch_bytes``; batch row
    counts are a multiple of 32 except possibly the last.  The fixed-width
    path raises when one 32-row group exceeds ``max_batch_bytes``; the
    STRING path cuts a middle batch unaligned only in that case.  Blob
    children are ``PackedByteColumn``s of int32 words.
    """
    dev = _device.resolve(device)
    table = table.to(dev)
    if any(dt.is_string for dt in table.dtypes()):
        return _convert_to_rows_var(table, max_batch_bytes, dev)
    layout = fixed_width_layout(table.dtypes())
    n = table.num_rows
    rows_per_batch = max(1, max_batch_bytes // layout.row_size)
    if rows_per_batch < n:
        if layout.row_size * BATCH_ROW_ALIGN > max_batch_bytes:
            raise ValueError(
                f"row size {layout.row_size} too large: a {BATCH_ROW_ALIGN}"
                f"-row aligned batch exceeds "
                f"max_batch_bytes={max_batch_bytes}")
        rows_per_batch = rows_per_batch // BATCH_ROW_ALIGN * BATCH_ROW_ALIGN
    out = []
    start = 0
    while True:
        stop = min(n, start + rows_per_batch)
        datas = [c.data[start:stop] for c in table.columns]
        masks = [None if c.validity is None else c.validity[start:stop]
                 for c in table.columns]
        wire = _to_rows_wire(layout, datas, masks, dev)
        offsets = torch.arange(stop - start + 1, dtype=torch.int32,
                               device=dev) * layout.row_size
        out.append(Column.list_(PackedByteColumn(INT8, data=wire), offsets,
                                device=dev))
        start = stop
        if start >= n:
            return out


@traced("convert_from_rows")
def convert_from_rows(rows: Column, schema: Sequence[DType],
                      device=_device.DEFAULT) -> Table:
    """LIST<INT8> row blobs -> columnar table on ``device``.

    Analog of ``RowConversion.convertFromRows``; ``schema`` plays the role
    of the (type-id, scale) pairs the Java layer marshals.  The row width
    check costs one scalar host sync, counted on
    ``ops.host_sync.row_conversion.row_width``.
    """
    if rows.dtype.id != TypeId.LIST or not rows.children:
        raise TypeError("expected a LIST<INT8> row-blob column")
    child = rows.children[0]
    if child.dtype not in (INT8, UINT8):
        raise TypeError(
            f"row blobs must be LIST<INT8>, child is {child.dtype!r}")
    rows = rows.to(device)
    child = rows.children[0]
    if any(dt.is_string for dt in schema):
        return _convert_from_rows_var(rows, schema)
    layout = fixed_width_layout(schema)
    n = rows.offsets.shape[0] - 1
    with span("row_conversion.check"):
        widths = rows.offsets[1:] - rows.offsets[:-1]
        if n:
            with sync_point("row_conversion.row_width"):
                ok = bool((widths == layout.row_size).all())
            if not ok:
                raise ValueError(
                    f"row width mismatch: blobs have "
                    f"{set(widths.unique().tolist())} bytes/row, schema "
                    f"packs to {layout.row_size}")
    if child.data.dtype == torch.int32:  # packed-word blob (convert_to_rows)
        datas, masks = _from_planes(layout, _from_wire(layout, child.data, n))
    else:
        datas, masks = _from_rows_bytes(layout, child.data)
    return Table([Column(dt, data=d, validity=m)
                  for dt, d, m in zip(layout.schema, datas, masks)])
