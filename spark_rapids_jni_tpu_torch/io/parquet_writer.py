"""Parquet writer: Tables -> standard Parquet files.

The port of ``spark_rapids_jni_tpu/io/parquet_writer.py``: where the JAX
writer writes a table, the port writes the same bytes.  Data page V1, one
page a column chunk, PLAIN values, RLE/bit-packed definition and
repetition levels, min/max/null_count statistics on fixed-width columns,
the footer through ``io/thrift.py``.

Columns: the fixed-width types of ``_PHYS``, STRING, STRUCT of those (the
standard group of leaf fields, nulls at both levels) and LIST of those in
the standard 3-level shape, to any depth (the JAX writer takes one level).
Nullability is decided once, on the whole table: a column, struct field or
list level is optional iff its validity is not None.

Codecs: none; gzip (Python's ``gzip``); snappy through pyarrow's codec
where pyarrow can be imported (the JAX writer's bytes) and through the
port's own encoder (``io/snappy.py::compress``) where it cannot; zstd
through pyarrow's codec only, else ``CodecUnavailableError``.  The table
is copied to the host first: encoding is host work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import dtypes as dt
from ..columnar import Table
from ..utils.errors import CodecUnavailableError
from . import snappy
from .parquet import arrow_codec
from .thrift import (T_BINARY, T_I32, T_I64, T_LIST, T_STRUCT,
                     _enc_varint, encode_struct)

_MAGIC = b"PAR1"

# physical types
_PT_BOOLEAN, _PT_INT32, _PT_INT64 = 0, 1, 2
_PT_FLOAT, _PT_DOUBLE, _PT_BYTE_ARRAY = 4, 5, 6

# (physical, converted_type, widen_np) per supported dtype id
_PHYS = {
    dt.TypeId.BOOL8: (_PT_BOOLEAN, None, None),
    dt.TypeId.INT8: (_PT_INT32, 15, np.int32),
    dt.TypeId.INT16: (_PT_INT32, 16, np.int32),
    dt.TypeId.INT32: (_PT_INT32, None, None),
    dt.TypeId.INT64: (_PT_INT64, None, None),
    dt.TypeId.UINT8: (_PT_INT32, 11, np.int32),
    dt.TypeId.UINT16: (_PT_INT32, 12, np.int32),
    dt.TypeId.UINT32: (_PT_INT32, 13, np.int32),
    dt.TypeId.UINT64: (_PT_INT64, 14, np.int64),
    dt.TypeId.FLOAT32: (_PT_FLOAT, None, None),
    dt.TypeId.FLOAT64: (_PT_DOUBLE, None, None),
    dt.TypeId.TIMESTAMP_DAYS: (_PT_INT32, 6, None),
    dt.TypeId.TIMESTAMP_MILLISECONDS: (_PT_INT64, 9, None),
    dt.TypeId.TIMESTAMP_MICROSECONDS: (_PT_INT64, 10, None),
    dt.TypeId.STRING: (_PT_BYTE_ARRAY, 0, None),  # ConvertedType UTF8
    dt.TypeId.DECIMAL32: (_PT_INT32, 5, None),
    dt.TypeId.DECIMAL64: (_PT_INT64, 5, None),
}


@dataclass
class _Host:
    """One column as numpy buffers: ``data`` holds fixed-width values
    (unsigned types in their unsigned dtype) or STRING chars; ``offsets``
    (int64) belong to STRING and LIST."""
    dtype: dt.DType
    data: np.ndarray | None
    validity: np.ndarray | None
    offsets: np.ndarray | None
    children: tuple

    @staticmethod
    def of(col) -> "_Host":
        def host(t):
            return None if t is None else t.cpu().numpy()
        data = host(col.data)
        if data is not None and col.dtype.is_unsigned:
            data = data.view(col.dtype.storage)
        offs = host(col.offsets)
        return _Host(col.dtype, data, host(col.validity),
                     None if offs is None else offs.astype(np.int64),
                     tuple(_Host.of(c) for c in col.children))

    @property
    def size(self) -> int:
        if self.offsets is not None:
            return len(self.offsets) - 1
        if self.data is not None:
            return len(self.data)
        return self.children[0].size

    def slice(self, a: int, b: int) -> "_Host":
        """Rows [a, b), offsets rebased to 0."""
        valid = None if self.validity is None else self.validity[a:b]
        if self.offsets is None:
            return _Host(self.dtype,
                         None if self.data is None else self.data[a:b],
                         valid, None, tuple(c.slice(a, b)
                                            for c in self.children))
        offs = self.offsets[a:b + 1]
        lo, hi = int(offs[0]), int(offs[-1])
        return _Host(self.dtype,
                     None if self.data is None else self.data[lo:hi], valid,
                     offs - lo, tuple(c.slice(lo, hi)
                                      for c in self.children))


def _rle_levels(levels: np.ndarray, bit_width: int) -> bytes:
    """Level stream at ``bit_width`` bits as one bit-packed hybrid run
    (LSB-first within each value, groups of 8 values)."""
    n = len(levels)
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, np.uint8)
    padded[:n] = levels.astype(np.uint8)
    bits = (padded[:, None] >> np.arange(bit_width, dtype=np.uint8)) & 1
    packed = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    header = bytearray()
    _enc_varint(header, (groups << 1) | 1)
    return bytes(header) + packed


def _plain_strings(h: _Host, keep: np.ndarray | None) -> tuple[bytes, int]:
    """PLAIN BYTE_ARRAY records (4-byte length, then the bytes) of the rows
    ``keep`` marks (every row when None)."""
    offs = h.offsets
    lens = np.diff(offs)
    chars = h.data[offs[0]:offs[-1]]
    if keep is not None:
        chars = chars[np.repeat(keep, lens)]
        lens = lens[keep]
    m = len(lens)
    rec = lens + 4
    start = np.cumsum(rec) - rec
    out = np.empty(int(rec.sum()), np.uint8)
    is_char = np.ones(len(out), np.bool_)
    head = (start[:, None] + np.arange(4)).reshape(-1)
    is_char[head] = False
    out[head] = lens.astype("<u4").view(np.uint8)
    out[is_char] = chars
    return out.tobytes(), m


def _plain_values(h: _Host, valid) -> tuple[bytes, int]:
    """(PLAIN-encoded non-null values, non-null count)."""
    dtype = h.dtype
    if dtype.is_string:
        return _plain_strings(h, valid)
    vals = h.data
    widen = _PHYS[dtype.id][2]
    if widen is not None:
        vals = vals.astype(widen)
    if valid is not None:
        vals = vals[valid]
    if dtype.id == dt.TypeId.BOOL8:
        return np.packbits(vals.astype(np.uint8),
                           bitorder="little").tobytes(), len(vals)
    return vals.tobytes(), len(vals)


def _stats(h: _Host, valid):
    """(min_bytes, max_bytes, null_count) or (None, None, null_count)."""
    nulls = 0 if valid is None else int(len(valid) - valid.sum())
    dtype = h.dtype
    if dtype.is_string or dtype.id == dt.TypeId.BOOL8:
        return None, None, nulls
    vals = h.data
    if valid is not None:
        vals = vals[valid]
    if len(vals) == 0:
        return None, None, nulls
    if vals.dtype.kind == "f" and np.isnan(vals).any():
        # the spec forbids NaN in min/max; stats-trusting readers would
        # mis-prune (NaN compares false): omit min/max, keep null_count
        return None, None, nulls
    # order in the ORIGINAL dtype (unsigned stays unsigned), then encode the
    # scalars at the physical width (readers decode physical-type bytes)
    widen = _PHYS[dtype.id][2]
    lo, hi = vals.min(), vals.max()
    if widen is not None:
        lo, hi = lo.astype(widen), hi.astype(widen)
    return lo.tobytes(), hi.tobytes(), nulls


def _leaf_element(dtype: dt.DType, name, nl) -> list:
    if dtype.id not in _PHYS:
        raise NotImplementedError(
            f"parquet write for {dtype!r} is not supported")
    phys, conv, _ = _PHYS[dtype.id]
    fields = [(1, T_I32, phys), (3, T_I32, 1 if nl else 0),
              (4, T_BINARY, name)]
    if conv is not None:
        fields.append((6, T_I32, conv))
    if dtype.is_decimal:
        # engine scale is the power-of-ten exponent (cudf convention);
        # parquet scale counts digits right of the point
        fields.append((7, T_I32, -dtype.scale))
        fields.append((8, T_I32, 9 if dtype.id == dt.TypeId.DECIMAL32
                       else 18))
    return fields


def _field_names(struct_fields, name, col):
    fns = (struct_fields or {}).get(name)
    if fns is None:
        return [f"f{fi}" for fi in range(len(col.children))]
    if len(fns) != len(col.children):
        raise ValueError(f"struct_fields[{name!r}] has {len(fns)} names "
                         f"for {len(col.children)} fields")
    return list(fns)


def _list_shape(col) -> tuple[list, object]:
    """(optionality of each LIST level, outermost first; the leaf column)
    of a LIST column, read from the input table's validity."""
    levels = []
    while col.dtype.id == dt.TypeId.LIST:
        levels.append(col.validity is not None)
        col = col.children[0]
    if col.dtype.is_nested:
        raise NotImplementedError(
            f"parquet write of a LIST of {col.dtype!r} is not supported")
    return levels, col


def _schema_elements(table: Table, names, struct_fields) -> list:
    root = [(4, T_BINARY, "schema"), (5, T_I32, table.num_columns)]
    elements = [root]
    for col, name in zip(table.columns, names):
        nl = col.validity is not None
        if col.dtype.id == dt.TypeId.STRUCT:
            elements.append([(3, T_I32, 1 if nl else 0),
                             (4, T_BINARY, name),
                             (5, T_I32, len(col.children))])
            fns = _field_names(struct_fields, name, col)
            for fi, child in enumerate(col.children):
                if child.dtype.is_nested:
                    raise NotImplementedError(
                        f"parquet write of a {child.dtype!r} field inside "
                        f"struct {name!r} is not supported")
                elements.append(_leaf_element(
                    child.dtype, fns[fi], child.validity is not None))
            continue
        if col.dtype.id == dt.TypeId.LIST:
            # standard 3-level LIST at every level: optional group (LIST) >
            # repeated group list > element (a leaf, or the next LIST group)
            levels, leaf = _list_shape(col)
            group = name
            for opt in levels:
                elements.append([(3, T_I32, 1 if opt else 0),
                                 (4, T_BINARY, group), (5, T_I32, 1),
                                 (6, T_I32, 3)])      # ConvertedType LIST
                elements.append([(3, T_I32, 2),       # REPEATED
                                 (4, T_BINARY, "list"), (5, T_I32, 1)])
                group = "element"
            elements.append(_leaf_element(leaf.dtype, "element",
                                          leaf.validity is not None))
            continue
        elements.append(_leaf_element(col.dtype, name, nl))
    return elements


def _list_levels(h: _Host, opts: list, opt_e: bool):
    """Repetition and definition levels of a LIST column of any depth.

    Walks the levels outermost first over "entries": at first one a row.
    An entry at an element slot of level k expands into one entry per
    element of its list (the first keeps the parent's rep level, the
    others get rep k); a null list ends at def C_{k-1}, an empty one at
    C_{k-1} + o_k, where C_k = sum_{j<=k}(1 + o_j).  Returns
    ``(def levels, rep levels, leaf column, leaf write mask, max_def)``.
    """
    n = h.size
    ref = np.arange(n, dtype=np.int64)      # row / element index of entry
    rep = np.zeros(n, np.uint8)
    deff = np.zeros(n, np.uint8)
    active = np.ones(n, np.bool_)           # entry sits at an element slot
    base = 0                                # C_{k-1}
    node = h
    for k, opt in enumerate(opts, 1):
        at = np.flatnonzero(active)
        r = ref[at]
        ok = (np.ones(len(r), np.bool_) if node.validity is None
              else node.validity[r])
        lens = np.where(ok, node.offsets[r + 1] - node.offsets[r], 0)
        deff[at[~ok]] = base
        deff[at[ok & (lens == 0)]] = base + int(opt)
        counts = np.ones(len(ref), np.int64)
        counts[at] = np.maximum(lens, 1)
        grows = np.zeros(len(ref), np.bool_)
        grows[at] = lens > 0
        first = np.zeros(len(ref), np.int64)
        first[at] = node.offsets[r]
        ent_start = np.cumsum(counts) - counts
        within = np.arange(int(counts.sum()), dtype=np.int64) - \
            np.repeat(ent_start, counts)
        rep = np.where(within == 0, np.repeat(rep, counts),
                       np.uint8(k)).astype(np.uint8)
        deff = np.repeat(deff, counts)
        active = np.repeat(grows, counts)
        ref = np.repeat(first, counts) + within
        base += 1 + int(opt)
        node = node.children[0]
    md = base + int(opt_e)
    el = ref[active]
    ev = (node.validity[el] if opt_e and node.validity is not None
          else np.ones(len(el), np.bool_))
    deff[active] = base + (ev if opt_e else 0)
    emask = np.zeros(node.size, np.bool_)
    emask[el] = ev
    return deff, rep, node, emask, md


def _codec(compression):
    """(parquet codec id, compress(bytes) -> bytes or None)."""
    if compression in (None, "none"):
        return 0, None
    if compression == "snappy":
        native, pool = arrow_codec("snappy")
        if native is None:
            return 1, snappy.compress
        return 1, lambda b: native.compress(b, asbytes=True,
                                            memory_pool=pool)
    if compression == "gzip":
        import gzip
        return 2, lambda b: gzip.compress(b, 6)
    if compression == "zstd":
        native, pool = arrow_codec("zstd")
        if native is None:
            raise CodecUnavailableError(
                "parquet zstd compression needs pyarrow's codec, which this "
                "host does not have; use snappy, gzip or none")
        return 6, lambda b: native.compress(b, asbytes=True,
                                            memory_pool=pool)
    raise ValueError(f"unsupported compression {compression!r} "
                     "(none, snappy, gzip, zstd)")


def write_parquet(table: Table, path, compression: str = "snappy",
                  row_group_size: int = 1 << 20,
                  struct_fields: dict | None = None) -> None:
    """Write a Table to ``path`` as a standard Parquet file.

    ``struct_fields`` maps a STRUCT column name to its field names (a
    Column's children are unnamed; default f0, f1, ...).  A read-modify-
    write round trip keeps them through ``ParquetFile(path).schema[i]
    .fields``."""
    names = list(table.names or
                 [f"c{i}" for i in range(table.num_columns)])
    codec_id, compress = _codec(compression)
    schema = _schema_elements(table, names, struct_fields)
    nullable = [c.validity is not None for c in table.columns]
    shapes = {ci: _list_shape(c) for ci, c in enumerate(table.columns)
              if c.dtype.id == dt.TypeId.LIST}
    hosts = [_Host.of(c) for c in table.columns]
    out = bytearray(_MAGIC)
    row_groups = []
    n = table.num_rows
    for start in range(0, max(n, 1), row_group_size):
        stop = min(n, start + row_group_size)
        g_rows = stop - start
        part = [h.slice(start, stop) if (start, stop) != (0, n) else h
                for h in hosts]
        # leaf chunks: (path, leaf column, max_def, def levels, write mask,
        # rep levels, max_rep, number of level entries)
        leaves = []
        for ci, (h, name) in enumerate(zip(part, names)):
            if h.dtype.id == dt.TypeId.LIST:
                opts, leaf = shapes[ci]
                deff, rep, node, emask, md = _list_levels(
                    h, opts, leaf.validity is not None)
                leaves.append(([name] + ["list", "element"] * len(opts),
                               node, md, deff, emask, rep, len(opts),
                               len(deff)))
                continue
            if h.dtype.id == dt.TypeId.STRUCT:
                col = table.columns[ci]
                s_opt = nullable[ci]
                svalid = (np.ones(g_rows, np.bool_) if h.validity is None
                          else h.validity)
                for fname, child, fcol in zip(
                        _field_names(struct_fields, name, col), h.children,
                        col.children):
                    f_opt = fcol.validity is not None
                    md = int(s_opt) + int(f_opt)
                    fvalid = (child.validity if f_opt and
                              child.validity is not None
                              else np.ones(g_rows, np.bool_))
                    levels = np.zeros(g_rows, np.uint8)
                    if s_opt:
                        levels += svalid
                    if f_opt:
                        levels += svalid & fvalid
                    leaves.append(([name, fname], child, md,
                                   levels if md else None,
                                   svalid & fvalid if md else None, None, 0,
                                   g_rows))
                continue
            if nullable[ci]:
                valid = (np.ones(g_rows, np.bool_) if h.validity is None
                         else h.validity)
                leaves.append(([name], h, 1, valid.astype(np.uint8), valid,
                               None, 0, g_rows))
            else:
                leaves.append(([name], h, 0, None, None, None, 0, g_rows))

        chunks, g_bytes = [], 0
        for cpath, h, md, levels, present, rep, mr, nvalues in leaves:
            body = b""
            if rep is not None:  # V1 page: rep levels, then def levels
                rv = _rle_levels(rep, mr.bit_length())
                body += len(rv).to_bytes(4, "little") + rv
            if md:
                lv = _rle_levels(levels, md.bit_length())
                body += len(lv).to_bytes(4, "little") + lv
            vals, _ = _plain_values(h, present)
            body += vals
            comp = compress(body) if compress else body
            if rep is not None:
                # list leaf: parquet-mr and arrow count every entry below
                # max_def as a leaf null (null lists, null elements and
                # empty lists all lack a leaf value); min/max omitted
                smin, smax, nulls = None, None, int((levels < md).sum())
            else:
                smin, smax, nulls = _stats(h, present)
            stats_fields = [(3, T_I64, nulls)]
            if smin is not None:
                stats_fields += [(5, T_BINARY, smax), (6, T_BINARY, smin)]
            header = encode_struct([
                (1, T_I32, 0),                      # DATA_PAGE
                (2, T_I32, len(body)),
                (3, T_I32, len(comp)),
                (5, T_STRUCT, [                     # DataPageHeader
                    (1, T_I32, nvalues),
                    (2, T_I32, 0),                  # PLAIN
                    (3, T_I32, 3),                  # def levels RLE
                    (4, T_I32, 3),                  # rep levels RLE
                ]),
            ])
            page_off = len(out)
            out += header
            out += comp
            meta = [
                (1, T_I32, _PHYS[h.dtype.id][0]),
                (2, T_LIST, (T_I32, [0, 3])),       # PLAIN, RLE
                (3, T_LIST, (T_BINARY, list(cpath))),
                (4, T_I32, codec_id),
                (5, T_I64, nvalues),
                (6, T_I64, len(header) + len(body)),
                (7, T_I64, len(header) + len(comp)),
                (9, T_I64, page_off),
                (12, T_STRUCT, stats_fields),
            ]
            chunks.append([(2, T_I64, page_off), (3, T_STRUCT, meta)])
            g_bytes += len(header) + len(body)  # spec: uncompressed size
        row_groups.append([(1, T_LIST, (T_STRUCT, chunks)),
                           (2, T_I64, g_bytes), (3, T_I64, g_rows)])
        if n == 0:
            break

    footer = encode_struct([
        (1, T_I32, 1),                              # version
        (2, T_LIST, (T_STRUCT, schema)),
        (3, T_I64, n),
        (4, T_LIST, (T_STRUCT, row_groups)),
        (6, T_BINARY, "spark-rapids-jni-tpu"),
    ])
    out += footer
    out += len(footer).to_bytes(4, "little")
    out += _MAGIC
    with open(os.fspath(path), "wb") as f:
        f.write(out)
