"""Parquet scan path: footer -> row groups -> device columns, in bounded chunks.

The port of ``spark_rapids_jni_tpu/io/parquet.py``.  Two routes:

- the host route decodes pages in numpy (snappy, RLE/bit-packed hybrid,
  PLAIN and dictionary values) and ships the decoded buffers, one staged
  transfer per chunk for fixed-width schemas (``io/staging.py``);
- the device route (``plan_device_group``, ``ParquetChunkedReader.
  iter_device``) walks only the page headers on the host, ships each row
  group's *compressed* pages as padded planes, and decodes them on the
  device (``ops/parquet_decode.py::decode_table``, with the CUDA kernels of
  ``kernels/parquet_decode.py``).  Groups it cannot take fall back to the
  host route with a reason.

Supported surface (the Spark-SQL scan shape):
- physical types: BOOLEAN, INT32, INT64, INT96 (legacy timestamps), FLOAT,
  DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY (decimals)
- logical/converted: UTF8->STRING, DATE, TIMESTAMP millis/micros/nanos,
  signed/unsigned int widths, DECIMAL on int32/int64/FLBA (precision <= 18)
- encodings: PLAIN, RLE (booleans + levels), PLAIN_DICTIONARY /
  RLE_DICTIONARY, data pages V1 + V2
- codecs: UNCOMPRESSED, SNAPPY (GZIP and ZSTD on the host route)
- nesting: standard 3-level LIST groups to any depth, and STRUCT groups of
  leaf fields (nulls at both levels); both assemble on the host route from
  the repetition and definition levels.  A row group whose projection
  holds one re-plans from the device route to the host route with the
  reason ``"nested"``.  A group nested inside a struct and legacy 2-level
  lists are refused, as in the JAX package.

Counters (``utils.tracing``) keep the JAX package's names:
``io.parquet.*``, ``io.device_decode.*``, ``io.footer_parses``.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as _device
from .. import dtypes as dt
from ..columnar import Column, Table
from ..utils import faults, timeline, tracing
from ..utils.errors import retry_call
from . import snappy
from .thrift import decode_struct

_MAGIC = b"PAR1"

# parquet physical types (parquet.thrift Type)
PT_BOOLEAN, PT_INT32, PT_INT64, PT_INT96 = 0, 1, 2, 3
PT_FLOAT, PT_DOUBLE, PT_BYTE_ARRAY, PT_FLBA = 4, 5, 6, 7

# encodings (parquet.thrift Encoding)
ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_RLE_DICTIONARY = 8

# codecs (parquet.thrift CompressionCodec)
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP, CODEC_ZSTD = 0, 1, 2, 6

# page types (parquet.thrift PageType)
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = 0, 1, 2, 3

_PLAIN_NP = {
    PT_INT32: np.dtype("<i4"),
    PT_INT64: np.dtype("<i8"),
    PT_FLOAT: np.dtype("<f4"),
    PT_DOUBLE: np.dtype("<f8"),
}


_uvarint = snappy._uvarint  # one LEB128 decoder for the whole io package


def arrow_codec(name: str):
    """``(pyarrow Codec, memory pool)`` where pyarrow is importable, else
    ``(None, None)``; imported on first use, never at module import.

    pyarrow's codecs give the same bytes as io.snappy, faster.  Their
    output buffers come from the system allocator: in a process that also
    holds torch, pyarrow's default (jemalloc) pool segfaulted now and then
    inside ``decompress`` on a bridge server's connection thread.
    """
    try:
        import pyarrow as pa
        return pa.Codec(name), pa.system_memory_pool()
    except Exception:  # no pyarrow on this host
        return None, None


def _decompress(page: bytes, codec: int, uncompressed_size: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return page
    if codec == CODEC_SNAPPY:
        native, pool = arrow_codec("snappy")
        if native is not None:
            out = native.decompress(
                page, decompressed_size=uncompressed_size,
                memory_pool=pool).to_pybytes()
        else:
            # literal-only pages (high-entropy / dict-encoded data) collapse
            # to slice copies; anything else hits the byte-exact decoder
            out = snappy.decompress_fast(page)
        if len(out) != uncompressed_size:
            raise ValueError("snappy page size mismatch")
        return out
    if codec == CODEC_GZIP:
        import zlib
        out = zlib.decompress(page, 16 + 15)  # gzip-framed
        if len(out) != uncompressed_size:
            raise ValueError("gzip page size mismatch")
        return out
    if codec == CODEC_ZSTD:
        native, pool = arrow_codec("zstd")
        if native is None:
            from ..utils.errors import CodecUnavailableError
            raise CodecUnavailableError(
                "a ZSTD parquet page needs pyarrow's codec, which this host "
                "does not have")
        out = native.decompress(
            page, decompressed_size=uncompressed_size,
            memory_pool=pool).to_pybytes()
        if len(out) != uncompressed_size:
            raise ValueError("zstd page size mismatch")
        return out
    raise NotImplementedError(
        f"unsupported parquet codec {codec} "
        "(UNCOMPRESSED, SNAPPY, GZIP and ZSTD are supported)")


def _rle_bitpacked_hybrid(buf, bit_width: int, num_values: int) -> np.ndarray:
    """Decode parquet's RLE/bit-packed hybrid to int32[num_values].

    Bit-packed runs unpack via np.unpackbits (LSB-first groups of 8), RLE
    runs become np.full — both vectorized; python touches one iteration per
    *run*, not per value.
    """
    if bit_width == 0:
        return np.zeros(num_values, np.int32)
    byte_width = (bit_width + 7) // 8
    weights = (np.int64(1) << np.arange(bit_width, dtype=np.int64))
    out = []
    total = 0
    pos = 0
    n = len(buf)
    while total < num_values and pos < n:
        header, pos = _uvarint(buf, pos)
        if header & 1:  # bit-packed run: (header>>1) groups of 8 values
            groups = header >> 1
            nbytes = groups * bit_width
            chunk = np.frombuffer(buf, np.uint8, min(nbytes, n - pos), pos)
            if len(chunk) < nbytes:  # writers may truncate the last group
                chunk = np.concatenate(
                    [chunk, np.zeros(nbytes - len(chunk), np.uint8)])
            pos += nbytes
            bits = np.unpackbits(chunk, bitorder="little")
            vals = bits.reshape(-1, bit_width).astype(np.int64) @ weights
            out.append(vals.astype(np.int32))
            total += groups * 8
        else:  # RLE run
            count = header >> 1
            val = int.from_bytes(buf[pos:pos + byte_width], "little")
            pos += byte_width
            out.append(np.full(count, val, np.int32))
            total += count
    if not out:
        return np.zeros(num_values, np.int32)
    res = out[0] if len(out) == 1 else np.concatenate(out)
    if len(res) < num_values:
        raise ValueError("truncated RLE/bit-packed run")
    return res[:num_values]


def _parse_byte_array(buf, num_values: int):
    """PLAIN BYTE_ARRAY: [u32 len][bytes]... → (chars u8[], lens i32[]).

    The walk from length to length is sequential; it collects only the
    lengths, and the bytes are gathered at once afterwards."""
    unpack = struct.Struct("<I").unpack_from
    lens = []
    pos = 0
    for _ in range(num_values):
        ln = unpack(buf, pos)[0]
        lens.append(ln)
        pos += 4 + ln
    ln = np.array(lens, np.int64)
    rec = ln + 4
    starts = np.cumsum(rec) - rec + 4          # each value's first byte
    total = int(ln.sum())
    src = np.repeat(starts - (np.cumsum(ln) - ln), ln) + \
        np.arange(total, dtype=np.int64)
    chars = np.frombuffer(buf, np.uint8, pos)[src] if total else \
        np.zeros(0, np.uint8)
    return chars, ln.astype(np.int32)


def _int96_to_ns(raw: np.ndarray) -> np.ndarray:
    """INT96 legacy timestamps: [u64 nanos-of-day][u32 julian day] → epoch ns."""
    nanos = raw[:, :8].copy().view("<u8").reshape(-1).astype(np.int64)
    jday = raw[:, 8:].copy().view("<u4").reshape(-1).astype(np.int64)
    return (jday - 2440588) * 86_400_000_000_000 + nanos


# ---------------------------------------------------------------------------
# metadata interpretation (thrift field ids from parquet-format parquet.thrift)
# ---------------------------------------------------------------------------

@dataclass
class ColumnSchema:
    name: str
    physical: int          # element physical type for LIST columns
    type_length: int
    optional: bool         # element nullability for LIST columns
    dtype: dt.DType        # element dtype for LIST columns
    is_list: bool = False  # standard 3-level LIST<element>
    list_optional: bool = False  # outer list group nullability
    is_struct: bool = False      # flat STRUCT group of leaf fields
    struct_optional: bool = False
    fields: tuple = ()           # STRUCT: leaf ColumnSchemas
    extra_def: int = 0           # def levels contributed by ancestors
                                 # (a leaf inside an optional struct has 1)
    list_levels: tuple = ()      # nested LIST: per-level group optionality,
                                 # outermost first (len >= 2 when nested;
                                 # depth-1 lists keep the legacy fields)

    @property
    def max_def(self) -> int:
        if self.list_levels:
            return sum(1 for o in self.list_levels if o) + \
                len(self.list_levels) + (1 if self.optional else 0)
        if self.is_list:
            return (1 if self.list_optional else 0) + 1 + \
                (1 if self.optional else 0)
        return self.extra_def + (1 if self.optional else 0)

    @property
    def max_rep(self) -> int:
        if self.list_levels:
            return len(self.list_levels)
        return 1 if self.is_list else 0


@dataclass
class ChunkMeta:
    schema: ColumnSchema
    codec: int
    num_values: int
    start_offset: int       # min(data_page_offset, dictionary_page_offset)
    total_compressed: int
    total_uncompressed: int
    statistics: dict | None


@dataclass
class RowGroupMeta:
    num_rows: int
    total_byte_size: int
    chunks: list = field(default_factory=list)   # parallel to file schema


def _interpret_schema_element(elem: dict) -> ColumnSchema | None:
    """SchemaElement fields: 1 type, 2 type_length, 3 repetition, 4 name,
    5 num_children, 6 converted_type, 7 scale, 8 precision, 10 logicalType."""
    name = elem.get(4, b"").decode()
    if elem.get(5):  # group node → handled by the _parse_footer tree walk
        raise NotImplementedError(
            f"nested parquet schemas are not supported (group {name!r})")
    rep = elem.get(3, 0)
    if rep == 2:  # bare REPEATED leaf: legacy 2-level list, not supported
        raise NotImplementedError(
            f"legacy unannotated repeated field {name!r} unsupported")
    phys = elem[1]
    conv = elem.get(6)
    logical = elem.get(10) or {}
    tl = elem.get(2, 0)

    def decimal_dtype():
        scale = elem.get(7, 0)
        precision = elem.get(8, 0)
        if 5 in logical:  # LogicalType.DECIMAL{1:scale, 2:precision}
            scale = logical[5].get(1, scale)
            precision = logical[5].get(2, precision)
        if precision > 18:
            raise NotImplementedError(
                f"decimal precision {precision} > 18 on {name!r}")
        # parquet scale counts digits right of the point; engine scale is the
        # power-of-ten exponent of the stored integer (cudf convention)
        ours = -scale
        return (dt.decimal32(ours) if phys == PT_INT32 and precision <= 9
                else dt.decimal64(ours))

    if phys == PT_BOOLEAN:
        out = dt.BOOL8
    elif phys == PT_INT32:
        if conv == 5 or 5 in logical:
            out = decimal_dtype()
        elif conv == 6 or 6 in logical:  # DATE
            out = dt.TIMESTAMP_DAYS
        elif conv in (15, 16):  # INT_8 / INT_16
            out = dt.INT8 if conv == 15 else dt.INT16
        elif conv in (11, 12, 13):  # UINT_8/16/32
            out = {11: dt.UINT8, 12: dt.UINT16, 13: dt.UINT32}[conv]
        elif 10 in logical:  # LogicalType.INTEGER{1:bitWidth, 2:isSigned}
            bw, signed = logical[10].get(1, 32), logical[10].get(2, True)
            out = {(8, True): dt.INT8, (16, True): dt.INT16,
                   (32, True): dt.INT32, (8, False): dt.UINT8,
                   (16, False): dt.UINT16, (32, False): dt.UINT32}[(bw, signed)]
        else:
            out = dt.INT32
    elif phys == PT_INT64:
        if conv == 5 or 5 in logical:
            out = decimal_dtype()
        elif conv == 9:  # TIMESTAMP_MILLIS
            out = dt.TIMESTAMP_MILLISECONDS
        elif conv == 10:  # TIMESTAMP_MICROS
            out = dt.TIMESTAMP_MICROSECONDS
        elif 8 in logical:  # LogicalType.TIMESTAMP{2: unit{1|2|3: {}}}
            unit = logical[8].get(2, {})
            out = (dt.TIMESTAMP_MILLISECONDS if 1 in unit
                   else dt.TIMESTAMP_NANOSECONDS if 3 in unit
                   else dt.TIMESTAMP_MICROSECONDS)
        elif conv == 14 or (10 in logical and not logical[10].get(2, True)):
            out = dt.UINT64
        else:
            out = dt.INT64
    elif phys == PT_INT96:
        out = dt.TIMESTAMP_NANOSECONDS
    elif phys == PT_FLOAT:
        out = dt.FLOAT32
    elif phys == PT_DOUBLE:
        out = dt.FLOAT64
    elif phys == PT_BYTE_ARRAY:
        out = dt.STRING
    elif phys == PT_FLBA:
        if conv == 5 or 5 in logical:
            out = decimal_dtype()
        else:
            raise NotImplementedError(
                f"FIXED_LEN_BYTE_ARRAY without DECIMAL on {name!r}")
    else:
        raise NotImplementedError(f"parquet physical type {phys}")
    return ColumnSchema(name, phys, tl, rep == 1, out)


def _parse_list_group(elems, i: int) -> tuple[ColumnSchema, int]:
    """Standard 3-level LIST at elems[i]: optional group (LIST) { repeated
    group g { <element> } } → (list ColumnSchema, next index).

    The element may itself be a LIST group (nested lists to any depth);
    per-level group optionality is collected into ``list_levels``."""
    levels = []
    name = elems[i].get(4, b"").decode()
    while True:
        outer = elems[i]
        if outer.get(5) != 1 or i + 2 >= len(elems):
            raise NotImplementedError(f"unsupported LIST shape at {name!r}")
        mid = elems[i + 1]
        if mid.get(3, 0) != 2 or mid.get(5) != 1:
            raise NotImplementedError(
                f"LIST {name!r} without the standard repeated middle group")
        levels.append(outer.get(3, 0) == 1)
        elem = elems[i + 2]
        if not elem.get(5):
            break
        conv, logical = elem.get(6), elem.get(10) or {}
        if not (conv == 3 or 3 in logical):
            raise NotImplementedError(
                f"non-LIST group element under {name!r}")
        i += 2  # descend into the nested LIST group
    es = _interpret_schema_element(elem)
    return ColumnSchema(
        name, es.physical, es.type_length, optional=es.optional,
        dtype=es.dtype, is_list=True, list_optional=levels[0],
        list_levels=tuple(levels) if len(levels) > 1 else ()), i + 3


def _parse_struct_group(elems, i: int) -> tuple[ColumnSchema, int]:
    """Flat STRUCT group at elems[i]: group { <leaf fields> } -> schema.

    Each leaf field carries ``extra_def`` = 1 when the struct itself is
    optional (its definition levels then distinguish struct-null from
    field-null).  Nested groups inside the struct are not supported."""
    outer = elems[i]
    name = outer.get(4, b"").decode()
    if outer.get(3, 0) == 2:
        # legacy 2-level REPEATED group (old Hive/Impala list-of-struct):
        # silently reading it as a flat struct would decode garbage — the
        # repetition levels would never be stripped
        raise NotImplementedError(
            f"legacy repeated group {name!r} (unannotated list) unsupported")
    s_opt = outer.get(3, 0) == 1
    nfields = outer.get(5, 0)
    fields = []
    i += 1
    for _ in range(nfields):
        e = elems[i]
        if e.get(5):
            raise NotImplementedError(
                f"nested group inside struct {name!r} unsupported")
        fs = _interpret_schema_element(e)
        fields.append(ColumnSchema(
            fs.name, fs.physical, fs.type_length, optional=fs.optional,
            dtype=fs.dtype, extra_def=1 if s_opt else 0))
        i += 1
    return ColumnSchema(name, 0, 0, optional=False,
                        dtype=dt.DType(dt.TypeId.STRUCT), is_struct=True,
                        struct_optional=s_opt, fields=tuple(fields)), i


def _parse_footer(meta: dict):
    """FileMetaData: 2 schema, 3 num_rows, 4 row_groups."""
    elems = meta[2]
    root = elems[0]
    schema = []
    i, nchildren = 1, root.get(5, 0)
    for _ in range(nchildren):
        e = elems[i]
        if e.get(5):  # group node: LIST or flat STRUCT
            conv, logical = e.get(6), e.get(10) or {}
            if conv == 3 or 3 in logical:  # ConvertedType/LogicalType LIST
                cs, i = _parse_list_group(elems, i)
                schema.append(cs)
                continue
            cs, i = _parse_struct_group(elems, i)
            schema.append(cs)
            continue
        schema.append(_interpret_schema_element(e))
        i += 1
    by_name = {s.name: i for i, s in enumerate(schema)}
    groups = []
    for rg in meta.get(4, []):
        g = RowGroupMeta(num_rows=rg[3], total_byte_size=rg.get(2, 0),
                         chunks=[None] * len(schema))
        for cc in rg[1]:
            cm = cc[3]  # ColumnMetaData
            path = [p.decode() for p in cm[3]]
            if path[0] not in by_name:
                raise NotImplementedError(f"column path {path} unsupported")
            idx = by_name[path[0]]
            if schema[idx].is_struct:
                if len(path) != 2:
                    raise NotImplementedError(
                        f"column path {path} unsupported")
                fi = [f.name for f in schema[idx].fields].index(path[1])
                if g.chunks[idx] is None:
                    g.chunks[idx] = [None] * len(schema[idx].fields)
                dict_off = cm.get(11)
                data_off = cm[9]
                start = (data_off if dict_off is None
                         else min(dict_off, data_off))
                g.chunks[idx][fi] = ChunkMeta(
                    schema=schema[idx].fields[fi], codec=cm[4],
                    num_values=cm[5], start_offset=start,
                    total_compressed=cm[7], total_uncompressed=cm[6],
                    statistics=cm.get(12))
                continue
            if (len(path) != 1) != schema[idx].is_list:
                raise NotImplementedError(f"column path {path} unsupported")
            dict_off = cm.get(11)
            data_off = cm[9]
            start = data_off if dict_off is None else min(dict_off, data_off)
            g.chunks[idx] = ChunkMeta(
                schema=schema[idx], codec=cm[4], num_values=cm[5],
                start_offset=start, total_compressed=cm[7],
                total_uncompressed=cm.get(6, 0), statistics=cm.get(12))
        if any(c is None for c in g.chunks):
            raise ValueError("row group missing a column chunk")
        groups.append(g)
    return schema, int(meta[3]), groups


# ---------------------------------------------------------------------------
# page + chunk decode (host side)
# ---------------------------------------------------------------------------

@dataclass
class _HostColumn:
    """Decoded chunk in host form, sliceable without touching the device."""
    schema: ColumnSchema
    values: np.ndarray | None      # fixed-width dense values (nulls zeroed)
    chars: np.ndarray | None       # STRING: char buffer (nulls contribute 0 B)
    offsets: np.ndarray | None     # STRING: int32[n+1]
    validity: np.ndarray | None    # bool[n] or None
    child: "_HostColumn | None" = None   # LIST: element chunk
    loffsets: np.ndarray | None = None   # LIST: int32[n+1] row offsets
    children: "list | None" = None       # STRUCT: field chunks

    @property
    def num_rows(self):
        if self.children is not None:
            return self.children[0].num_rows
        if self.loffsets is not None:
            return len(self.loffsets) - 1
        return (len(self.offsets) - 1 if self.offsets is not None
                else len(self.values))

    def nbytes_estimate(self):
        if self.children is not None:
            per = sum(c.nbytes_estimate() for c in self.children)
        elif self.loffsets is not None:
            per = self.child.nbytes_estimate() + self.loffsets.nbytes
        else:
            per = (self.chars.nbytes + self.offsets.nbytes
                   if self.chars is not None else self.values.nbytes)
        if self.validity is not None:
            per += self.validity.nbytes
        return per

    def slice(self, a: int, b: int) -> "_HostColumn":
        valid = None if self.validity is None else self.validity[a:b]
        if self.children is not None:
            return _HostColumn(self.schema, None, None, None, valid,
                               children=[c.slice(a, b)
                                         for c in self.children])
        if self.loffsets is not None:
            lo = self.loffsets[a:b + 1]
            return _HostColumn(self.schema, None, None, None, valid,
                               child=self.child.slice(int(lo[0]),
                                                      int(lo[-1])),
                               loffsets=(lo - lo[0]).astype(np.int32))
        if self.offsets is not None:
            offs = self.offsets[a:b + 1]
            chars = self.chars[offs[0]:offs[-1]]
            return _HostColumn(self.schema, None, chars,
                               (offs - offs[0]).astype(np.int32),
                               None if self.validity is None
                               else self.validity[a:b])
        return _HostColumn(self.schema, self.values[a:b], None, None,
                           None if self.validity is None
                           else self.validity[a:b])

    def to_column(self, device=_device.DEFAULT) -> Column:
        s = self.schema
        if self.children is not None:
            dev = _device.resolve(device)
            return Column(dt.DType(dt.TypeId.STRUCT),
                          validity=None if self.validity is None
                          else torch.from_numpy(self.validity).to(dev),
                          children=tuple(c.to_column(dev)
                                         for c in self.children))
        if self.loffsets is not None:
            return Column.list_(self.child.to_column(device), self.loffsets,
                                self.validity, device=device)
        if s.dtype.is_string:
            return Column.string(self.chars, self.offsets, self.validity,
                                 device=device)
        return Column.fixed(s.dtype, self.values, self.validity,
                            device=device)


def _decode_plain(schema: ColumnSchema, buf: bytes, nvals: int):
    """PLAIN-encoded values → fixed np array or (chars, lens) for strings."""
    phys = schema.physical
    if phys == PT_BOOLEAN:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, (nvals + 7) // 8),
                             bitorder="little")
        return bits[:nvals].astype(np.uint8)
    if phys in _PLAIN_NP:
        return np.frombuffer(buf, _PLAIN_NP[phys], nvals)
    if phys == PT_INT96:
        raw = np.frombuffer(buf, np.uint8, nvals * 12).reshape(nvals, 12)
        return _int96_to_ns(raw)
    if phys == PT_BYTE_ARRAY:
        return _parse_byte_array(buf, nvals)
    if phys == PT_FLBA:
        w = schema.type_length
        raw = np.frombuffer(buf, np.uint8, nvals * w).reshape(nvals, w)
        # parquet decimals are big-endian two's-complement
        acc = np.zeros(nvals, np.int64)
        for col in range(w):
            acc = (acc << 8) | raw[:, col]
        if w < 8:  # sign-extend
            sign_bit = np.int64(1) << (8 * w - 1)
            acc = (acc ^ sign_bit) - sign_bit
        return acc
    raise NotImplementedError(f"PLAIN decode for physical type {phys}")


def _gather_dict(schema: ColumnSchema, dict_vals, idx: np.ndarray):
    if schema.physical == PT_BYTE_ARRAY:
        chars, lens = dict_vals
        if idx.size == 0:  # all-null page: nothing to gather
            return np.zeros(0, np.uint8), np.zeros(0, lens.dtype)
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        # vectorized string gather: out[i] spans chars[offs[idx[i]] : +len]
        sel_lens = lens[idx].astype(np.int64)
        total = int(sel_lens.sum())
        out_starts = np.concatenate(([0], np.cumsum(sel_lens)[:-1]))
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(out_starts, sel_lens)
               + np.repeat(offs[idx], sel_lens))
        return chars[pos], lens[idx]
    return dict_vals[idx]


def _scatter_values(s: ColumnSchema, n: int, vals, mask):
    """Scatter the non-null value stream into ``n`` slots (nulls zeroed).

    ``mask`` (bool[n] or None) marks slots that carry a real value.
    Returns the (values, chars, offsets) triple of a _HostColumn.
    """
    if s.physical == PT_BYTE_ARRAY:
        chars = np.concatenate([v[0] for v in vals]) if vals else \
            np.zeros(0, np.uint8)
        nn_lens = np.concatenate([v[1] for v in vals]) if vals else \
            np.zeros(0, np.int32)
        lens = np.zeros(n, np.int64)
        if mask is None:
            lens[:] = nn_lens
        else:
            lens[mask] = nn_lens
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        if offsets[-1] > np.iinfo(np.int32).max:
            raise ValueError("string chunk exceeds int32 offsets; "
                             "use a smaller row-group size")
        return None, chars, offsets.astype(np.int32)
    storage = s.dtype.storage
    dense = np.zeros(n, storage)
    nn = np.concatenate([np.asarray(v, storage) for v in vals]) if vals \
        else np.zeros(0, storage)
    if mask is None:
        dense[:] = nn
    else:
        dense[mask] = nn
    return dense, None, None


class _ChunkDecoder:
    """Decode one column chunk's page stream into a _HostColumn."""

    def __init__(self, fbuf, meta: ChunkMeta):
        self.fbuf = fbuf
        self.meta = meta
        self.schema = meta.schema
        self.dict_vals = None

    def run(self) -> _HostColumn:
        meta = self.meta
        pos = meta.start_offset
        end = meta.start_offset + meta.total_compressed
        remaining = meta.num_values
        reps, defs, vals = [], [], []
        while remaining > 0 and pos < end:
            header, pos = decode_struct(self.fbuf, pos)
            ptype = header[1]
            comp = header[3]
            page = bytes(self.fbuf[pos:pos + comp])
            pos += comp
            if ptype == PAGE_DICTIONARY:
                data = _decompress(page, meta.codec, header[2])
                nd = header[7][1]  # DictionaryPageHeader.num_values
                self.dict_vals = _decode_plain(self.schema, data, nd)
            elif ptype == PAGE_DATA:
                r, d, v, nv = self._data_page_v1(page, header)
                reps.append(r)
                defs.append(d)
                vals.append(v)
                remaining -= nv
            elif ptype == PAGE_DATA_V2:
                r, d, v, nv = self._data_page_v2(page, header)
                reps.append(r)
                defs.append(d)
                vals.append(v)
                remaining -= nv
            elif ptype == PAGE_INDEX:
                continue
            else:
                raise NotImplementedError(f"page type {ptype}")
        # a struct's validity (in _decode_group) comes from its first
        # field's raw def levels; only struct members (extra_def > 0) keep
        # them
        self.def_stream = (np.concatenate(defs)
                           if self.schema.extra_def and defs
                           and defs[0] is not None else None)
        if self.schema.list_levels:
            return self._assemble_list_nested(reps, defs, vals)
        if self.schema.is_list:
            return self._assemble_list(reps, defs, vals)
        return self._assemble(defs, vals)

    # DataPageHeader: 1 num_values, 2 encoding, 3 def-level enc, 4 rep enc
    def _data_page_v1(self, page: bytes, header: dict):
        data = _decompress(page, self.meta.codec, header[2])
        ph = header[5]
        nv = ph[1]
        enc = ph[2]
        pos = 0
        r = None
        if self.schema.max_rep:
            if ph.get(4, ENC_RLE) != ENC_RLE:
                raise NotImplementedError("non-RLE repetition levels")
            ln = int.from_bytes(data[0:4], "little")
            r = _rle_bitpacked_hybrid(data[4:4 + ln],
                                      self.schema.max_rep.bit_length(), nv)
            pos = 4 + ln
        d = None
        md = self.schema.max_def
        if md:
            if ph.get(3, ENC_RLE) != ENC_RLE:
                raise NotImplementedError("non-RLE definition levels")
            ln = int.from_bytes(data[pos:pos + 4], "little")
            d = _rle_bitpacked_hybrid(data[pos + 4:pos + 4 + ln],
                                      md.bit_length(), nv)
            pos += 4 + ln
        nnon = nv if d is None else int((d == md).sum())
        v = self._values(data[pos:], enc, nnon)
        return r, d, v, nv

    # DataPageHeaderV2: 1 num_values, 2 num_nulls, 3 num_rows, 4 encoding,
    # 5 def-levels byte len, 6 rep-levels byte len, 7 is_compressed
    def _data_page_v2(self, page: bytes, header: dict):
        ph = header[8]
        nv, nnulls, enc = ph[1], ph[2], ph[4]
        dlen, rlen = ph.get(5, 0), ph.get(6, 0)
        # V2 layout: repetition levels first, then definition levels
        r = None
        if self.schema.max_rep:
            r = _rle_bitpacked_hybrid(page[0:rlen],
                                      self.schema.max_rep.bit_length(), nv)
        d = None
        md = self.schema.max_def
        if md:
            d = _rle_bitpacked_hybrid(page[rlen:rlen + dlen],
                                      md.bit_length(), nv)
        body = page[dlen + rlen:]
        if ph.get(7, True):
            body = _decompress(body, self.meta.codec,
                               header[2] - dlen - rlen)
        nnon = (nv - nnulls) if d is None else int((d == md).sum())
        v = self._values(body, enc, nnon)
        return r, d, v, nv

    def _values(self, data: bytes, enc: int, nnon: int):
        if enc in (ENC_PLAIN_DICTIONARY, ENC_RLE_DICTIONARY):
            if self.dict_vals is None:
                raise ValueError("dictionary-encoded page before dictionary")
            bw = data[0]
            idx = _rle_bitpacked_hybrid(data[1:], bw, nnon)
            return _gather_dict(self.schema, self.dict_vals, idx)
        if enc == ENC_PLAIN:
            return _decode_plain(self.schema, data, nnon)
        if enc == ENC_RLE and self.schema.physical == PT_BOOLEAN:
            ln = int.from_bytes(data[0:4], "little")
            return _rle_bitpacked_hybrid(data[4:4 + ln], 1, nnon) \
                .astype(np.uint8)
        raise NotImplementedError(f"value encoding {enc}")

    def _assemble(self, defs, vals) -> _HostColumn:
        s = self.schema
        md = s.max_def
        nrows = sum((len(d) if d is not None else
                     (len(v[1]) if isinstance(v, tuple) else len(v)))
                    for d, v in zip(defs, vals))
        if all(d is None for d in defs):
            valid = None
        else:
            valid = np.concatenate(
                [d == md if d is not None else
                 np.ones(len(v[1]) if isinstance(v, tuple) else len(v),
                         np.bool_)
                 for d, v in zip(defs, vals)])
        values, chars, offsets = _scatter_values(s, nrows, vals, valid)
        return _HostColumn(s, values, chars, offsets, valid)

    def _element(self, deff, slot, vals) -> _HostColumn:
        """The leaf elements of a LIST chunk: one per element slot, null
        where the slot's def level is below the maximum."""
        s = self.schema
        elem_valid = None
        if s.optional:
            elem_valid = (deff == s.max_def)[slot]
            if bool(elem_valid.all()):
                elem_valid = None
        ecs = ColumnSchema(s.name + ".element", s.physical, s.type_length,
                           optional=s.optional, dtype=s.dtype)
        values, chars, offsets = _scatter_values(s, int(slot.sum()), vals,
                                                 elem_valid)
        return _HostColumn(ecs, values, chars, offsets, elem_valid)

    def _assemble_list(self, reps, defs, vals) -> _HostColumn:
        """LIST<element> rows from the rep/def level streams of the standard
        3-level shape (max_def = md): rep 0 starts a row; def >= the
        element-slot level means a slot exists (a null element iff
        def < md); lower defs encode an empty list or a null row."""
        s = self.schema
        slot_def = s.max_def - (1 if s.optional else 0)
        rep = np.concatenate(reps) if reps else np.zeros(0, np.int32)
        deff = np.concatenate(defs) if defs else np.zeros(0, np.int32)
        starts = np.flatnonzero(rep == 0)
        nrows = len(starts)
        row_valid = None
        if s.list_optional:
            row_valid = deff[starts] >= 1
            if bool(row_valid.all()):
                row_valid = None
        slot = deff >= slot_def
        cum = np.concatenate(([0], np.cumsum(slot.astype(np.int64))))
        seg_end = np.concatenate((starts[1:], [len(rep)])) if nrows else \
            np.zeros(0, np.int64)
        loffsets = np.zeros(nrows + 1, np.int64)
        np.cumsum(cum[seg_end] - cum[starts], out=loffsets[1:])
        if loffsets[-1] > np.iinfo(np.int32).max:
            raise ValueError("list chunk exceeds int32 offsets; "
                             "use a smaller row-group size")
        return _HostColumn(s, None, None, None, row_valid,
                           child=self._element(deff, slot, vals),
                           loffsets=loffsets.astype(np.int32))

    def _assemble_list_nested(self, reps, defs, vals) -> _HostColumn:
        """LIST rows of any depth from the rep/def level streams.

        With per-level group optionality o_1..o_D, C_k = sum_{j<=k}(1 + o_j)
        is the def level at which an element SLOT exists at depth k; the
        level-k list hanging at a depth-(k-1) slot is null iff
        def < C_{k-1} + o_k, and every event with rep < k opens a level-k
        segment (dead segments, whose first def < C_{k-1}, belong to no
        parent slot and are dropped)."""
        s = self.schema
        o = [1 if x else 0 for x in s.list_levels]
        C = [0]
        for ok in o:
            C.append(C[-1] + 1 + ok)
        rep = np.concatenate(reps) if reps else np.zeros(0, np.int32)
        deff = np.concatenate(defs) if defs else np.zeros(0, np.int32)
        nev = len(rep)
        top = prev = None
        for k in range(1, len(o) + 1):
            seg = np.flatnonzero(rep < k)
            first_def = deff[seg]
            keep = first_def >= C[k - 1]       # parent slot exists
            # a new level-k element starts only where rep <= k (deeper rep
            # values continue a slot of this level)
            slot = (rep <= k) & (deff >= C[k])
            cs = np.concatenate(([0], np.cumsum(slot, dtype=np.int64)))
            seg_end = np.concatenate((seg[1:], [nev])) if len(seg) else \
                np.zeros(0, np.int64)
            lens = (cs[seg_end] - cs[seg])[keep]
            valid_k = (first_def >= C[k - 1] + o[k - 1])[keep]
            loff = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=loff[1:])
            if loff[-1] > np.iinfo(np.int32).max:
                raise ValueError("nested list chunk exceeds int32 offsets")
            lcs = ColumnSchema(s.name + ".list" * (k - 1), s.physical,
                               s.type_length, optional=s.optional,
                               dtype=s.dtype, is_list=True,
                               list_optional=bool(o[k - 1]))
            hc = _HostColumn(lcs, None, None, None,
                             None if bool(valid_k.all()) else valid_k,
                             loffsets=loff.astype(np.int32))
            if prev is None:
                top = hc
            else:
                prev.child = hc
            prev = hc
        prev.child = self._element(deff, deff >= C[-1], vals)
        return top

# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

# Parsed-footer cache: the streaming path opens the same file more than
# once (the chunked reader for data, the executor's empty-stream fallback
# for schema), and repeated scans of one file are the NDS norm — parse the
# footer ONCE per (file identity, version).  The cached value is pure
# metadata (schema + ChunkMeta offsets), safely shared across mmaps; the
# key's mtime/size pin it to the exact file version.  ``io.footer_parses``
# counts actual parses so tests can prove one parse per file.
_FOOTER_CACHE: dict = {}
_FOOTER_CACHE_MAX = 64
_footer_lock = __import__("threading").Lock()


class ParquetFile:
    """Metadata handle over one parquet file; decodes row groups on demand."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        # mmap, not read(): host memory stays proportional to the pages a
        # pass actually touches, which is what ParquetChunkedReader promises
        with open(self.path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if buf[:4] != _MAGIC or buf[-4:] != _MAGIC:
            raise ValueError(f"{self.path}: not a parquet file")
        self._buf = buf
        key = None
        try:
            st = os.stat(self.path)
            key = (os.path.realpath(self.path), st.st_mtime_ns, st.st_size)
        except OSError:
            pass
        with _footer_lock:
            cached = _FOOTER_CACHE.get(key) if key is not None else None
        if cached is None:
            flen = int.from_bytes(buf[-8:-4], "little")
            meta, _ = decode_struct(buf[-8 - flen:-8])
            tracing.count("io.footer_parses")
            cached = _parse_footer(meta)
            if key is not None:
                with _footer_lock:
                    if len(_FOOTER_CACHE) >= _FOOTER_CACHE_MAX:
                        _FOOTER_CACHE.pop(next(iter(_FOOTER_CACHE)))
                    _FOOTER_CACHE[key] = cached
        self.schema, self.num_rows, self.row_groups = cached
        self.names = [s.name for s in self.schema]

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)

    def _column_indices(self, columns):
        if columns is None:
            return list(range(len(self.schema)))
        return [self.names.index(c) for c in columns]

    def _decode_group(self, gi: int, columns=None) -> list[_HostColumn]:
        g = self.row_groups[gi]
        out = []
        for i in self._column_indices(columns):
            s = self.schema[i]
            if not s.is_struct:
                out.append(_ChunkDecoder(self._buf, g.chunks[i]).run())
                continue
            kids, svalid = [], None
            for ck in g.chunks[i]:
                dec = _ChunkDecoder(self._buf, ck)
                kids.append(dec.run())
                if (svalid is None and s.struct_optional
                        and dec.def_stream is not None):
                    svalid = dec.def_stream >= 1
            if svalid is not None and bool(svalid.all()):
                svalid = None
            out.append(_HostColumn(s, None, None, None, svalid,
                                   children=kids))
        return out

    def group_stats(self, gi: int, column: str):
        """(min, max, null_count) from row-group statistics, or None.

        Drives scan-level row-group pruning (the predicate-pushdown role of
        the reference's chunked reader).  Only fixed-width stats decode.
        """
        idx = self.names.index(column)
        if self.schema[idx].is_struct:
            return None
        ck = self.row_groups[gi].chunks[idx]
        st = ck.statistics
        if not st:
            return None
        lo = st.get(6, st.get(2))
        hi = st.get(5, st.get(1))
        if lo is None or hi is None or ck.schema.physical not in _PLAIN_NP:
            return None
        if ck.schema.dtype.is_decimal:
            # stats carry the unscaled integer; predicates are user-space
            return None
        npdt = _PLAIN_NP[ck.schema.physical]
        if ck.schema.dtype.storage.kind == "u":
            npdt = np.dtype(f"<u{npdt.itemsize}")
        return (np.frombuffer(lo, npdt, 1)[0].item(),
                np.frombuffer(hi, npdt, 1)[0].item(),
                st.get(3))

    def read_row_group(self, gi: int, columns=None,
                       device=_device.DEFAULT) -> Table:
        cols = self._decode_group(gi, columns)
        return Table([h.to_column(device) for h in cols],
                     [h.schema.name for h in cols])

    def empty_table(self, columns=None, device=_device.DEFAULT) -> Table:
        """Zero-row Table with this file's schema (empty-scan result)."""
        empty = [_empty_host(self.schema[i])
                 for i in self._column_indices(columns)]
        return Table([h.to_column(device) for h in empty],
                     [h.schema.name for h in empty])

    def read(self, columns=None, device=_device.DEFAULT) -> Table:
        """Read into a Table on ``device``.

        Fixed-width schemas take the staged path (ONE packed transfer,
        unpacked as views on the device, ``io/staging.py``); other schemas
        ship column by column."""
        idxs = self._column_indices(columns)
        eligible = (self.num_row_groups >= 1 and
                    all(self.schema[i].dtype is not None and
                        self.schema[i].dtype.is_fixed_width and
                        self.schema[i].dtype.id != dt.TypeId.DECIMAL128 and
                        not self.schema[i].is_list and
                        not self.schema[i].is_struct for i in idxs))
        hosts = self._decode_all_groups(columns)
        if not hosts:  # valid file, zero row groups (empty partition)
            return self.empty_table(columns, device)
        merged = hosts[0] if len(hosts) == 1 else \
            [_concat_host([g[i] for g in hosts])
             for i in range(len(hosts[0]))]
        if eligible:
            from .staging import stage_fixed_table
            return stage_fixed_table(
                [(h.schema.name, h.schema.dtype, h.values, h.validity)
                 for h in merged], device=device)
        return Table([h.to_column(device) for h in merged],
                     [h.schema.name for h in merged])

    def _decode_all_groups(self, columns=None) -> list:
        """All row groups decoded host-side; >1 group fans out on a thread
        pool (numpy decode kernels drop the GIL)."""
        if self.num_row_groups > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(
                    self.num_row_groups, os.cpu_count() or 4)) as ex:
                return list(ex.map(
                    lambda gi: self._decode_group(gi, columns),
                    range(self.num_row_groups)))
        return [self._decode_group(gi, columns)
                for gi in range(self.num_row_groups)]


def _empty_host(s: ColumnSchema) -> _HostColumn:
    if s.is_struct:
        return _HostColumn(s, None, None, None, None,
                           children=[_empty_host(f) for f in s.fields])
    if s.is_list:
        ecs = ColumnSchema(s.name + ".element", s.physical, s.type_length,
                           optional=s.optional, dtype=s.dtype)
        return _HostColumn(s, None, None, None, None,
                           child=_empty_host(ecs),
                           loffsets=np.zeros(1, np.int32))
    if s.dtype.is_string:
        return _HostColumn(s, None, np.zeros(0, np.uint8),
                           np.zeros(1, np.int32), None)
    return _HostColumn(s, np.zeros(0, s.dtype.storage), None, None, None)


def _concat_host(parts: list[_HostColumn]) -> _HostColumn:
    s = parts[0].schema
    has_valid = any(p.validity is not None for p in parts)
    valid = np.concatenate(
        [p.validity if p.validity is not None
         else np.ones(p.num_rows, np.bool_) for p in parts]) \
        if has_valid else None
    if s.is_struct:
        kids = [_concat_host([p.children[i] for p in parts])
                for i in range(len(s.fields))]
        return _HostColumn(s, None, None, None, valid, children=kids)
    if s.is_list:
        loffsets = _rebased([p.loffsets for p in parts], "list")
        return _HostColumn(s, None, None, None, valid,
                           child=_concat_host([p.child for p in parts]),
                           loffsets=loffsets)
    if s.dtype.is_string:
        return _HostColumn(s, None, np.concatenate([p.chars for p in parts]),
                           _rebased([p.offsets for p in parts], "string"),
                           valid)
    return _HostColumn(s, np.concatenate([p.values for p in parts]),
                       None, None, valid)


def _rebased(offsets: list, what: str) -> np.ndarray:
    """The int32 offsets of parts laid end to end."""
    offs = [offsets[0].astype(np.int64)]
    base = int(offsets[0][-1])
    for o in offsets[1:]:
        offs.append(o[1:].astype(np.int64) + base)
        base += int(o[-1])
    out = np.concatenate(offs)
    if out[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"concatenated {what} column exceeds int32 offsets")
    return out.astype(np.int32)


def read_parquet(path, columns=None, device=_device.DEFAULT) -> Table:
    """Read a whole parquet file into a Table on ``device`` (see
    ``ParquetFile.read``)."""
    return ParquetFile(path).read(columns, device=device)


# ---------------------------------------------------------------------------
# device-decode page planning
# ---------------------------------------------------------------------------

from ..utils.errors import TransientError as _TransientError  # noqa: E402


class TruncatedPageError(_TransientError, OSError):
    """A page header or body runs past its chunk/file bounds.

    Typed ``io_error`` (transient OSError): storage-layer truncation is
    indistinguishable from a torn read, so the bounded retry ladder gets a
    chance before the failure propagates."""


class DevicePageChunk:
    """One row group's raw compressed pages, packed as host numpy planes.

    The device-decode wire unit: ``to_device()`` ships the planes (the
    *compressed* page bytes plus the tiny per-page count sidecars) and
    ops/parquet_decode.decode_table turns them into columns on-device.
    Every plane is a view of ONE host buffer (``host``, pinned when the
    planned device is a card), packed by ``plan_device_group`` — in the
    prefetch producer thread when the pipeline is double-buffered — so only
    the transfer + decode land on the consumer's critical path.
    """

    __slots__ = ("gi", "geom", "planes", "nrows", "comp_bytes", "unc_bytes",
                 "host", "layout")

    def __init__(self, gi, geom, planes, nrows, comp_bytes, unc_bytes,
                 host, layout):
        self.gi = gi
        self.geom = geom
        self.planes = planes          # {col: {plane: np.ndarray view}}
        self.nrows = nrows
        self.comp_bytes = comp_bytes  # padded plane bytes (the link cost)
        self.unc_bytes = unc_bytes    # what the host path's transfer ships
        self.host = host              # torch uint8 buffer behind the planes
        self.layout = layout          # [(col, plane, byte offset)]

    def to_device(self, device=_device.DEFAULT) -> dict:
        """Transfer the planes; returns the ``{column: {plane: tensor}}``
        dict ``decode_table`` takes.

        ONE ``non_blocking`` copy of the host buffer (asynchronous from
        pinned memory; a pageable copy would be synchronous and stall the
        prefetch pipeline); the planes are views of the device buffer."""
        from .staging import to_device
        dev = _device.resolve(device)
        faults.check("parquet.device_decode")
        tracing.count("io.device_decode.chunks")
        tracing.count("io.device_decode.link_bytes", int(self.comp_bytes))
        tracing.count("io.device_decode.uncompressed_bytes",
                      int(self.unc_bytes))
        buf = to_device(self.host, dev)
        out: dict = {name: {} for name in self.planes}
        for name, k, off in self.layout:
            v = self.planes[name][k]
            t = buf[off:off + v.nbytes].view(
                torch.uint8 if v.dtype == np.uint8 else torch.int32)
            out[name][k] = t.view(v.shape)
        return out


def _walk_pages(fbuf, meta: ChunkMeta):
    """Host page-header walk of one column chunk (payloads untouched).

    Returns ``(data_pages, dict_page, encoding)`` with data_pages =
    [(body_off, comp_len, unc_len, num_values)], dict_page the same tuple
    shape with num_values = dictionary size, and encoding the chunk's data
    encoding class ("plain" | "dict") — or ``(None, None, reason)`` when an
    encoding/page shape needs the host decoder.  Truncation raises the
    typed :class:`TruncatedPageError`.
    """
    pos = meta.start_offset
    end = pos + meta.total_compressed
    remaining = meta.num_values
    flen = len(fbuf)
    data_pages, dict_page, encs = [], None, set()
    while remaining > 0 and pos < end:
        try:
            header, body = decode_struct(fbuf, pos)
        except Exception as e:
            raise TruncatedPageError(
                f"{meta.schema.name}: page header at {pos} unreadable") \
                from e
        comp = header.get(3)
        if comp is None or body + comp > end or body + comp > flen:
            raise TruncatedPageError(
                f"{meta.schema.name}: page body at {body} overruns chunk")
        ptype = header[1]
        if ptype == PAGE_DICTIONARY:
            dict_page = (body, comp, header[2], header[7][1])
        elif ptype == PAGE_DATA:
            ph = header[5]
            if ph.get(3, ENC_RLE) != ENC_RLE:
                return None, None, "level_encoding"
            enc = ph[2]
            if enc == ENC_PLAIN:
                encs.add("plain")
            elif enc in (ENC_PLAIN_DICTIONARY, ENC_RLE_DICTIONARY):
                encs.add("dict")
            else:
                return None, None, "value_encoding"
            data_pages.append((body, comp, header[2], ph[1]))
            remaining -= ph[1]
        elif ptype == PAGE_DATA_V2:
            return None, None, "v2_pages"
        elif ptype != PAGE_INDEX:
            return None, None, "page_type"
        pos = body + comp
    if len(encs) != 1:
        return None, None, ("no_pages" if not encs else "mixed_encoding")
    encoding = encs.pop()
    if encoding == "dict" and dict_page is None:
        return None, None, "no_dictionary"
    return data_pages, dict_page, encoding


def _device_eligible_schema(s: ColumnSchema):
    """Fallback reason for schema shapes the device decoder won't take,
    or None when eligible (flat fixed-width, at most one def level)."""
    if s.is_struct or s.is_list or s.list_levels or s.extra_def:
        return "nested"
    if s.max_rep:
        return "repeated"
    if s.max_def > 1:
        return "multi_def"
    if s.physical == PT_BOOLEAN:
        return None
    if s.physical not in _PLAIN_NP or s.dtype.is_string:
        return "physical_type"
    if np.dtype(s.dtype.storage).itemsize != _PLAIN_NP[s.physical].itemsize:
        return "narrowed_type"  # e.g. INT32 physical read as int16
    return None


def plan_device_group(pf: ParquetFile, gi: int, columns=None,
                      limit: int | None = None, device=_device.DEFAULT):
    """Plan one row group for device decode: ``(DevicePageChunk, None)`` or
    ``(None, reason)`` when the group re-plans to the host decoder.

    Pure host metadata work: footer eligibility, a page-header walk
    (io/thrift.py), a snappy token scan per page (header bytes only), and
    plane packing into one host buffer staged towards ``device``.  No page
    payload is decoded here.
    """
    from ..ops import parquet_decode as pqd
    from .staging import host_buffer
    dev = _device.resolve(device)
    g = pf.row_groups[gi]
    idxs = pf._column_indices(columns)
    for i in idxs:
        reason = _device_eligible_schema(pf.schema[i])
        if reason is None and g.chunks[i].codec not in (CODEC_SNAPPY,
                                                        CODEC_UNCOMPRESSED):
            reason = "codec"
        if reason is not None:
            return None, reason
    if limit is not None:
        total_unc = sum(int(g.chunks[i].total_uncompressed or 0)
                        for i in idxs)
        if total_unc > limit:
            # one group must stay one chunk on the device path (pages are
            # not row-sliceable without decode); oversized groups keep the
            # host path's budgeted slicing
            return None, "oversized_group"
    nrows = int(g.num_rows)
    rb = pqd.bucket(max(nrows, 1), 1024)
    fbuf = pf._buf
    cols, walked = [], []
    unc_bytes = 0
    for i in idxs:
        meta = g.chunks[i]
        s = meta.schema
        data_pages, dict_page, enc = _walk_pages(fbuf, meta)
        if data_pages is None:
            return None, enc
        np_, cmax, umax, vmax = len(data_pages), 0, 0, 0
        rows_seen = 0
        for _, c, u, nv in data_pages:
            cmax, umax, vmax = max(cmax, c), max(umax, u), max(vmax, nv)
            rows_seen += nv
        if rows_seen != nrows:
            return None, "row_count"
        if dict_page is not None:
            cmax = max(cmax, dict_page[1])
            umax = max(umax, dict_page[2])
        pcount = pqd.bucket(max(np_, 1), 1)
        cb, ub = pqd.bucket(cmax), pqd.bucket(umax)
        vb = pqd.bucket(vmax)
        db = pqd.bucket(dict_page[3]) if enc == "dict" else pqd.MIN_BUCKET
        has_copies, tmax = False, 1
        if meta.codec == CODEC_SNAPPY:
            view = memoryview(fbuf)
            bodies = list(data_pages) + \
                ([dict_page] if dict_page is not None else [])
            for off, c, _, _ in bodies:
                ntok, lit_only = snappy.scan_tokens(view[off:off + c])
                tmax = max(tmax, ntok)
                if not lit_only:
                    has_copies = True
        cols.append(pqd.ColumnGeom(
            name=s.name, dtype=s.dtype, physical=s.physical,
            codec=meta.codec, encoding=enc, max_def=s.max_def,
            has_copies=has_copies, npages=pcount, cb=cb, ub=ub, vb=vb,
            db=db, tb=pqd.bucket(tmax, 16)))
        walked.append((data_pages, dict_page))
        unc_bytes += int(meta.total_uncompressed or 0)

    # one buffer, every plane an 8-byte aligned view of it: comp (pcount+1,
    # cb) u8, then the clen/ulen/nv i32 sidecars.  Row -> (page, slot) is
    # NOT shipped: the kernel derives it from the nv cumsum, so the link
    # carries only pages + page counts
    layout, total = [], 0
    for geo in cols:
        for k, nbytes in (("comp", (geo.npages + 1) * geo.cb),
                          ("clen", 4 * (geo.npages + 1)),
                          ("ulen", 4 * (geo.npages + 1)),
                          ("nv", 4 * (geo.npages + 1))):
            layout.append((geo.name, k, total))
            total += -(-nbytes // 8) * 8
    host = host_buffer(total, dev)
    hbuf = host.numpy()
    hbuf[:] = 0  # page padding and alignment gaps are zero
    at = {(name, k): off for name, k, off in layout}
    planes = {}
    for geo, (data_pages, dict_page) in zip(cols, walked):
        rows = geo.npages + 1
        o = at[geo.name, "comp"]
        comp = hbuf[o:o + rows * geo.cb].reshape(rows, geo.cb)
        clen, ulen, nv_arr = (
            hbuf[at[geo.name, k]:at[geo.name, k] + 4 * rows].view(np.int32)
            for k in ("clen", "ulen", "nv"))
        if dict_page is not None:
            off, c, u, nd = dict_page
            comp[0, :c] = np.frombuffer(fbuf, np.uint8, c, off)
            clen[0], ulen[0], nv_arr[0] = c, u, nd
        for k, (off, c, u, nv) in enumerate(data_pages):
            comp[k + 1, :c] = np.frombuffer(fbuf, np.uint8, c, off)
            clen[k + 1], ulen[k + 1], nv_arr[k + 1] = c, u, nv
        planes[geo.name] = {"comp": comp, "clen": clen, "ulen": ulen,
                            "nv": nv_arr}
    comp_bytes = sum(v.nbytes for p in planes.values() for v in p.values())
    geom = pqd.ChunkGeom(columns=tuple(cols), rb=rb)
    return DevicePageChunk(gi, geom, planes, nrows, comp_bytes, unc_bytes,
                           host, layout), None


class ParquetChunkedReader:
    """Iterate a parquet file as Tables bounded by a byte budget.

    ``pass_read_limit`` bounds the decoded bytes per emitted Table so the
    device working set stays fixed no matter the file size.  Row groups
    decode host-side one at a time and are sliced to the budget before any
    device transfer.

        for tbl in ParquetChunkedReader(p, pass_read_limit=64 << 20):
            ... # tbl.num_rows * row_bytes <= pass_read_limit

    ``predicate=(column, lo, hi)`` prunes whole row groups via footer
    statistics before any page decode.  ``iter_device`` is the device-decode
    route; ``iter_staged`` the host route with one staged transfer per
    chunk; iterating the reader itself ships column by column.  Tables land
    on ``device``.  ``split=(rank, world)`` reads only the row groups
    ``rank, rank + world, ...``, a rank's split of the file.
    """

    def __init__(self, path, pass_read_limit: int = 64 << 20, columns=None,
                 predicate: tuple | None = None, prefetch: int = 0,
                 cancel=None, device=_device.DEFAULT, split=None):
        self.file = ParquetFile(path)
        self.split = split
        self.limit = int(pass_read_limit)
        self.columns = columns
        self.predicate = predicate
        self.prefetch = int(prefetch)
        self.device = _device.resolve(device)
        # cooperative cancellation (utils.errors.CancelToken, duck-typed):
        # checked per row group and polled by the prefetch producer
        self.cancel = cancel
        self.groups_pruned = 0
        self.groups_read = 0
        # live prefetch generators, reaped by ``close()``
        self._active: list = []
        if self.limit <= 0:
            raise ValueError("pass_read_limit must be positive")

    def close(self) -> None:
        """Stop any live prefetch producer threads (idempotent)."""
        while self._active:
            self._active.pop().close()

    def __enter__(self) -> "ParquetChunkedReader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def footer_chunk_estimate(self) -> int:
        """Expected chunk count from footer metadata alone: per non-pruned
        row group, at least one chunk, plus one per ``pass_read_limit`` of
        the group's footer ``total_byte_size``.  An estimate."""
        total = 0
        for gi in self._groups():
            if self._group_pruned(gi):
                continue
            nbytes = int(self.file.row_groups[gi].total_byte_size or 0)
            total += max(1, -(-nbytes // self.limit))
        return total

    def _groups(self) -> range:
        """The row groups this reader walks (its split of the file)."""
        if self.split is None:
            return range(self.file.num_row_groups)
        rank, world = self.split
        return range(rank, self.file.num_row_groups, world)

    def _group_pruned(self, gi: int) -> bool:
        if self.predicate is None:
            return False
        col, lo, hi = self.predicate
        st = self.file.group_stats(gi, col)
        if st is None:
            return False
        gmin, gmax, _ = st
        return (hi is not None and gmin > hi) or \
               (lo is not None and gmax < lo)

    def _decode_group_checked(self, gi: int):
        faults.check("parquet.chunk")
        return self.file._decode_group(gi, self.columns)

    def _host_slices_group(self, gi: int):
        """Budget-bounded host-side slices of ONE row group."""
        # transient decode failures (flaky storage) retry per row group
        hosts = retry_call(lambda gi=gi: self._decode_group_checked(gi),
                           "parquet.chunk", cancel=self.cancel)
        nrows = hosts[0].num_rows
        if nrows == 0:
            return
        total = sum(h.nbytes_estimate() for h in hosts)
        tracing.count("io.parquet.bytes_decoded", int(total))
        per_row = max(1, total // max(nrows, 1))
        step = max(1, self.limit // per_row)
        for a in range(0, nrows, step):
            b = min(a + step, nrows)
            yield [h.slice(a, b) for h in hosts]

    def _host_slices(self):
        """Budget-bounded host-side chunk slices, pre device transfer."""
        for gi in self._groups():
            if self.cancel is not None:
                self.cancel.check()
            if self._group_pruned(gi):
                self.groups_pruned += 1
                continue
            self.groups_read += 1
            yield from self._host_slices_group(gi)

    def _chunks(self):
        from ..utils.config import config
        if not config.mem_debug:
            yield from self._chunks_raw()
            return
        from ..utils.memory import MemoryScope
        with MemoryScope("parquet_chunked", device=self.device) as scope:
            for tbl in self._chunks_raw():
                yield tbl
                # refresh the working set's high-water mark at the batch
                # boundary
                scope.checkpoint()

    def _chunks_raw(self):
        for sl in self._host_slices():
            tracing.count("io.parquet.chunks")
            tracing.count("io.parquet.chunk_rows", sl[0].num_rows)
            yield Table([h.to_column(self.device) for h in sl],
                        [h.schema.name for h in sl])

    def _staged_chunks(self):
        """(Table, n_rows) chunks on the packed-transfer path: fixed-width
        chunks ship as ONE staged transfer kept padded to the power-of-two
        row bucket; other schemas ship per column at natural size."""
        for sl in self._host_slices():
            yield self._stage_one(sl)

    def _stage_one(self, sl):
        """One host slice -> (padded Table, n_rows) on the staged path."""
        from .staging import stage_fixed_table
        nrows = sl[0].num_rows
        tracing.count("io.parquet.chunks")
        tracing.count("io.parquet.chunk_rows", nrows)
        if all(h.values is not None and
               h.schema.dtype.id != dt.TypeId.DECIMAL128 for h in sl):
            specs = [(h.schema.name, h.schema.dtype, h.values,
                      h.validity) for h in sl]
            return stage_fixed_table(specs, padded=True, device=self.device)
        return (Table([h.to_column(self.device) for h in sl],
                      [h.schema.name for h in sl]), nrows)

    def _device_stream(self):
        """Mixed device/host chunk stream.

        Yields ``("dev", DevicePageChunk, None)`` for groups the device
        decoder takes (planes packed host-side, payloads NOT decoded) and
        ``("host", (Table, n_rows), reason)`` for per-group fallbacks.
        Group order is preserved, so results match the host route row for
        row.
        """
        for gi in self._groups():
            if self.cancel is not None:
                self.cancel.check()
            if self._group_pruned(gi):
                self.groups_pruned += 1
                continue
            self.groups_read += 1
            if int(self.file.row_groups[gi].num_rows) == 0:
                continue
            chunk, reason = plan_device_group(
                self.file, gi, self.columns, self.limit, self.device)
            if chunk is not None:
                tracing.count("io.parquet.chunks")
                tracing.count("io.parquet.chunk_rows", chunk.nrows)
                yield ("dev", chunk, None)
            else:
                tracing.count("io.device_decode.fallbacks")
                # one counter a reason too: the port's ledger of why a
                # group went to the host ("nested", "codec", ...)
                tracing.count("io.device_decode.fallback." + reason)
                for sl in self._host_slices_group(gi):
                    yield ("host", self._stage_one(sl), reason)

    def iter_device(self, prefetch: int | None = None):
        """Iterate the device-decode stream, optionally double-buffered:
        with depth >= 1 a producer thread does the page-header walk and
        plane packing (or the host decode, for fallback groups) of chunk
        k+1 while the consumer transfers and decodes chunk k."""
        depth = self.prefetch if prefetch is None else int(prefetch)
        gen = self._device_stream()
        if depth <= 0:
            yield from gen
        else:
            yield from self._tracked(_prefetched(gen, depth, self.cancel))

    def iter_staged(self, prefetch: int | None = None):
        """Iterate ``(padded Table, n_rows)`` chunks, double-buffered: with
        depth >= 1 a producer thread host-decodes and stages chunk k+1 while
        the consumer computes on chunk k.  Depth defaults to the reader's
        ``prefetch``; 0 means serial."""
        depth = self.prefetch if prefetch is None else int(prefetch)
        gen = self._staged_chunks()
        if depth <= 0:
            yield from gen
        else:
            yield from self._tracked(_prefetched(gen, depth, self.cancel))

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._chunks()
            return
        yield from self._tracked(_prefetched(self._chunks(), self.prefetch,
                                             self.cancel))

    def _tracked(self, pf):
        """Register a prefetch generator for ``close()`` while it runs."""
        self._active.append(pf)
        try:
            yield from pf
        finally:
            try:
                self._active.remove(pf)
            except ValueError:
                pass  # close() already reaped it


def _prefetched(gen, depth: int, cancel=None):
    """A worker thread produces items i+1..i+depth while the caller consumes
    item i: it overlaps the host half (page walk or decode, packing, the
    transfer's enqueue) with the consumer's device work.  The queue bound
    keeps at most ``depth`` items of extra memory in flight."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    DONE, FAIL = object(), object()
    # cross-thread flow arrows on the event timeline: the producer's
    # staging of chunk n links to the consumer's dispatch of chunk n by
    # id.  Both sides count the same in-order sequence, so fid_base + n
    # matches without threading ids through the queue items.
    tl = timeline.enabled()
    fid_base = timeline.new_flow_base() if tl else 0

    def put(item) -> bool:  # False once the consumer abandoned us
        while not stop.is_set():
            if cancel is not None and cancel.should_stop():
                return False  # stuck query: release the reader thread
            try:
                q.put(item, timeout=0.1)
            except queue.Full:
                continue
            return True
        return False

    def put_ctrl(item) -> None:
        # DONE/FAIL must always land (the consumer blocks on q.get until
        # one arrives); only consumer abandonment releases this loop
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # the producer re-enters the consumer's query, so its metrics, timeline
    # events and flight-recorder records carry that query (and its trace)
    from ..utils import metrics
    qm = metrics.current()

    def producer():
        with metrics.bind(qm):
            produce()

    def produce():
        try:
            it = iter(gen)
            n = 0
            while True:
                # the span covers producing chunk n; the flow tail starts
                # inside it, so the arrow binds to the producer slice
                with timeline.span("io.parquet.produce_chunk",
                                   {"chunk": n}) if tl \
                        else contextlib.nullcontext():
                    faults.check("parquet.prefetch")
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    if tl:
                        timeline.flow_start("io.parquet.chunk", fid_base + n)
                if not put(item):
                    if not stop.is_set() and cancel is not None:
                        cancel.check()  # -> typed error via FAIL
                    return
                n += 1
            put_ctrl(DONE)
        except BaseException as e:  # surface decode errors to the consumer
            put_ctrl((FAIL, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    k = 0
    try:
        while True:
            item = q.get()
            if item is DONE:
                break
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is FAIL:
                raise item[1]
            if tl:
                # the arrow head: chunk k leaves the queue for dispatch on
                # the consumer thread
                with timeline.span("io.parquet.consume_chunk", {"chunk": k}):
                    timeline.flow_finish("io.parquet.chunk", fid_base + k)
                k += 1
            yield item
    finally:
        # early abandonment (LIMIT queries, consumer errors) must not leave
        # the producer pinned on the bounded queue
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)
        if t.is_alive():
            tracing.count("io.prefetch.reap_timeouts")
