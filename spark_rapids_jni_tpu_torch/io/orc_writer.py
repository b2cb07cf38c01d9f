"""ORC writer: Tables -> standard ORC files.

The port of ``spark_rapids_jni_tpu/io/orc_writer.py``, byte for byte the
same files.  Emits version 0.12 files with DIRECT (RLEv1) encodings, the
simplest encoding every ORC reader supports, covering the scalar surface
the reader decodes (ints, floats, bools, strings, dates, timestamps,
decimals), LIST and STRUCT columns.  Codecs: none and ZLIB (stdlib), SNAPPY and
ZSTD through pyarrow's compressors where pyarrow can be imported; without
it they raise ``CodecUnavailableError``.  LIST and STRUCT columns nest to
any depth.  The table is copied to the host first: encoding is host work.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .. import dtypes as dt
from ..columnar import Table
from ..ops.selection import gather_column
from ..utils.errors import CodecUnavailableError
from .parquet import arrow_codec
from .orc import (COMP_NONE, COMP_SNAPPY, COMP_ZLIB, COMP_ZSTD, SK_DATA, SK_LENGTH, SK_PRESENT,
                  SK_SECONDARY, TK_BOOLEAN, TK_BYTE, TK_DATE, TK_DECIMAL,
                  TK_DOUBLE, TK_FLOAT, TK_INT, TK_LIST, TK_LONG, TK_SHORT,
                  TK_STRING, TK_STRUCT, TK_TIMESTAMP, _ORC_EPOCH_S)
from .thrift import _enc_varint  # one LEB128 encoder for the whole io package

_MAGIC = b"ORC"


# ---------------------------------------------------------------------------
# protobuf wire encoding (proto2, write-side twin of orc._pb_fields)


def _pb_varint(out: bytearray, field: int, v: int):
    _enc_varint(out, field << 3)
    _enc_varint(out, int(v))


def _pb_bytes(out: bytearray, field: int, blob: bytes):
    _enc_varint(out, (field << 3) | 2)
    _enc_varint(out, len(blob))
    out += blob


# ---------------------------------------------------------------------------
# run-length encoders (write-side twins of the io.orc decoders)

def _byte_rle(vals: np.ndarray) -> bytes:
    """Byte RLE: constant runs of 3..130, literal groups of 1..128."""
    out = bytearray()
    n = len(vals)
    i = 0
    while i < n:
        run = 1
        while i + run < n and run < 130 and vals[i + run] == vals[i]:
            run += 1
        if run >= 3:
            out.append(run - 3)
            out.append(int(vals[i]))
            i += run
            continue
        lit_start = i
        while i < n and i - lit_start < 128:
            nxt = 1
            while i + nxt < n and nxt < 3 and vals[i + nxt] == vals[i]:
                nxt += 1
            if nxt >= 3:
                break
            i += 1
        cnt = i - lit_start
        out.append(256 - cnt)
        out += bytes(np.asarray(vals[lit_start:i], np.uint8))
    return bytes(out)


def _bool_rle(bits: np.ndarray) -> bytes:
    by = np.packbits(bits.astype(np.uint8))  # MSB-first
    return _byte_rle(by)


def _zigzag_enc(v: int) -> int:
    """Zigzag for arbitrary-precision python ints (ORC signed varints)."""
    return (v << 1) if v >= 0 else ((-v) << 1) - 1


def _varints(u: np.ndarray) -> tuple[np.ndarray, list]:
    """LEB128 bytes of uint64 values laid end to end, and each value's
    first byte (n + 1 offsets)."""
    nb = np.ones(len(u), np.int64)
    x = u >> np.uint64(7)
    while x.any():
        nb += x != 0
        x >>= np.uint64(7)
    offs = np.zeros(len(u) + 1, np.int64)
    np.cumsum(nb, out=offs[1:])
    j = np.arange(int(offs[-1]), dtype=np.int64) - np.repeat(offs[:-1], nb)
    out = ((np.repeat(u, nb) >> (7 * j).astype(np.uint64)) &
           np.uint64(0x7F)).astype(np.uint8)
    out[j < np.repeat(nb, nb) - 1] |= 0x80
    return out, offs.tolist()


def _int_rle_v1(vals, signed: bool) -> bytes:
    """RLEv1: constant runs (delta 0) of 3..130, literal varints else.

    The segmentation is the greedy one, walked a segment (not a value) at
    a time; every value's varint is encoded at once beforehand."""
    a = np.asarray(vals)
    a = a.astype(np.uint64).view(np.int64) if a.dtype.kind == "u" \
        else a.astype(np.int64)
    n = len(a)
    if n == 0:
        return b""
    u = a.view(np.uint64)
    if signed:  # zigzag
        u = (u << np.uint64(1)) ^ (a >> np.int64(63)).view(np.uint64)
    enc, offs = _varints(u)
    enc = enc.tobytes()
    same = a[1:] == a[:-1]
    bounds = np.concatenate(([0], np.flatnonzero(~same) + 1, [n]))
    streak_end = np.repeat(bounds[1:], np.diff(bounds)).tolist()
    r3 = np.flatnonzero(same[:-1] & same[1:])  # a[p] == a[p+1] == a[p+2]
    pieces = []
    i = 0
    while i < n:
        run = min(130, streak_end[i] - i)
        if run >= 3:
            pieces += [bytes((run - 3, 0)), enc[offs[i]:offs[i + 1]]]
            i += run
            continue
        k = int(np.searchsorted(r3, i))
        cnt = min(128, (int(r3[k]) if k < len(r3) else n) - i)
        pieces += [bytes((256 - cnt,)), enc[offs[i]:offs[i + cnt]]]
        i += cnt
    return b"".join(pieces)


def _varint_bigint(out: bytearray, v: int):
    """Unbounded zigzag varint (DECIMAL mantissa)."""
    _enc_varint(out, _zigzag_enc(v))


# ---------------------------------------------------------------------------
# per-column stream production

def _orc_type(dtype: dt.DType) -> tuple[int, dict]:
    extra = {}
    tid = dtype.id
    if tid == dt.TypeId.BOOL8:
        return TK_BOOLEAN, extra
    if tid == dt.TypeId.INT8:
        return TK_BYTE, extra
    if tid == dt.TypeId.INT16:
        return TK_SHORT, extra
    if tid == dt.TypeId.INT32:
        return TK_INT, extra
    if tid in (dt.TypeId.INT64, dt.TypeId.UINT32):
        return TK_LONG, extra  # uint32 fits signed LONG losslessly
    if tid == dt.TypeId.UINT64:
        raise NotImplementedError(
            "ORC has no unsigned 64-bit type; values >= 2**63 cannot be "
            "represented losslessly — cast to INT64 or DECIMAL first")
    if tid in (dt.TypeId.UINT8, dt.TypeId.UINT16):
        return TK_SHORT if tid == dt.TypeId.UINT8 else TK_INT, extra
    if tid == dt.TypeId.FLOAT32:
        return TK_FLOAT, extra
    if tid == dt.TypeId.FLOAT64:
        return TK_DOUBLE, extra
    if tid == dt.TypeId.STRING:
        return TK_STRING, extra
    if tid == dt.TypeId.TIMESTAMP_DAYS:
        return TK_DATE, extra
    if tid in (dt.TypeId.TIMESTAMP_SECONDS, dt.TypeId.TIMESTAMP_MILLISECONDS,
               dt.TypeId.TIMESTAMP_MICROSECONDS,
               dt.TypeId.TIMESTAMP_NANOSECONDS):
        return TK_TIMESTAMP, extra
    if dtype.is_decimal:
        if dtype.scale > 0:
            raise NotImplementedError(
                "ORC decimal scale is non-negative; a positive engine scale "
                f"(x10^{dtype.scale} multiplier) cannot be represented — "
                "rescale the column first")
        digits = {dt.TypeId.DECIMAL32: 9, dt.TypeId.DECIMAL64: 18,
                  dt.TypeId.DECIMAL128: 38}[tid]
        extra = {"precision": digits, "scale": -dtype.scale}
        return TK_DECIMAL, extra
    raise NotImplementedError(f"ORC writer does not support {dtype!r}")


_TS_UNIT_NS = {
    dt.TypeId.TIMESTAMP_SECONDS: 1_000_000_000,
    dt.TypeId.TIMESTAMP_MILLISECONDS: 1_000_000,
    dt.TypeId.TIMESTAMP_MICROSECONDS: 1_000,
    dt.TypeId.TIMESTAMP_NANOSECONDS: 1,
}


def _encode_nanos(nanos) -> list:
    """ORC nano encoding: strip trailing decimal zeros, record the count.

    nanos are the *signed* sub-second remainder (the ORC-C++ convention:
    seconds truncate toward zero, remainder keeps the sign); python's
    two's-complement bitwise ops make ``(nb << 3) | zbits`` correct for
    negative values, matching what the C++ writer emits."""
    out = []
    for nv in nanos:
        nv = int(nv)
        if nv == 0:
            out.append(0)
            continue
        a = abs(nv)
        zeros = 0
        while zeros < 7 and a % 10 == 0:
            a //= 10
            zeros += 1
        if zeros >= 2:
            nb = a if nv > 0 else -a
            out.append((nb << 3) | (zeros - 1))
        else:
            out.append(nv << 3)
    return out


def _subtree_size(col) -> int:
    """Number of ORC column ids this column's type subtree occupies."""
    if col.dtype.id == dt.TypeId.LIST:
        return 1 + _subtree_size(col.children[0])
    if col.dtype.id == dt.TypeId.STRUCT:
        return 1 + sum(_subtree_size(c) for c in col.children)
    return 1


def _append_types(types: bytearray, col, next_id: int,
                  field_names=None) -> int:
    """Pre-order Type messages for one column's subtree (matches the id
    assignment `_emit_streams` uses); ``next_id`` is this column's id,
    returns the next free id."""
    d = col.dtype
    tmsg = bytearray()
    if d.id == dt.TypeId.LIST:
        _pb_varint(tmsg, 1, TK_LIST)
        _pb_varint(tmsg, 2, next_id + 1)  # element is the next pre-order id
        _pb_bytes(types, 4, bytes(tmsg))
        return _append_types(types, col.children[0], next_id + 1)
    if d.id == dt.TypeId.STRUCT:
        _pb_varint(tmsg, 1, TK_STRUCT)
        fid = next_id + 1
        for c in col.children:
            _pb_varint(tmsg, 2, fid)
            fid += _subtree_size(c)
        names = field_names or [f"f{i}" for i in range(len(col.children))]
        for nm in names:
            _pb_bytes(tmsg, 3, nm.encode())
        _pb_bytes(types, 4, bytes(tmsg))
        nid = next_id + 1
        for c in col.children:
            nid = _append_types(types, c, nid)
        return nid
    kind, extra = _orc_type(d)
    _pb_varint(tmsg, 1, kind)
    if "precision" in extra:
        _pb_varint(tmsg, 5, extra["precision"])
        _pb_varint(tmsg, 6, extra["scale"])
    _pb_bytes(types, 4, bytes(tmsg))
    return next_id + 1


def _emit_streams(col, cid: int, out: list) -> int:
    """Append (cid, stream_kind, raw) entries for this column subtree in
    pre-order id order; returns the next free column id.

    ORC nesting contract (mirrored from the reader,
    io/orc.py _decode_column TK_LIST/TK_STRUCT): a LIST's LENGTH stream and
    a STRUCT's children carry entries only for PRESENT parent rows, and a
    LIST's element column covers the concatenated elements of present rows.
    """
    d = col.dtype
    valid = None
    if col.validity is not None:
        v = np.asarray(col.validity)
        if not v.all():
            valid = v
    if d.id == dt.TypeId.LIST:
        if valid is not None:
            out.append((cid, SK_PRESENT, _bool_rle(valid)))
        offs = np.asarray(col.offsets, np.int64)
        lens = np.diff(offs)
        child = col.children[0]
        if valid is not None:
            # elements of non-present rows must not reach the child column;
            # vectorized repeat/cumsum index (same pattern as strings.split)
            lens = lens[valid]
            starts = offs[:-1][valid]
            total = int(lens.sum())
            pos = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=pos[1:])
            el_idx = (np.repeat(starts, lens) + np.arange(total)
                      - np.repeat(pos[:-1], lens)).astype(np.int32)
            child = gather_column(child, torch.from_numpy(el_idx))
        out.append((cid, SK_LENGTH, _int_rle_v1(lens, signed=False)))
        return _emit_streams(child, cid + 1, out)
    if d.id == dt.TypeId.STRUCT:
        if valid is not None:
            out.append((cid, SK_PRESENT, _bool_rle(valid)))
        nid = cid + 1
        for c in col.children:
            if valid is not None:
                c = gather_column(c, torch.from_numpy(
                    np.flatnonzero(valid).astype(np.int64)))
            nid = _emit_streams(c, nid, out)
        return nid
    for kind, raw in _column_streams(col, d):
        out.append((cid, kind, raw))
    return cid + 1


_INT_TIDS = (dt.TypeId.INT16, dt.TypeId.INT32, dt.TypeId.INT64,
             dt.TypeId.UINT8, dt.TypeId.UINT16, dt.TypeId.UINT32,
             dt.TypeId.UINT64, dt.TypeId.TIMESTAMP_DAYS)


def _column_streams(col, dtype: dt.DType) -> list[tuple[int, bytes]]:
    """-> [(stream_kind, raw bytes)] for one column over one stripe."""
    streams = []
    valid = None
    if col.validity is not None:
        valid = np.asarray(col.validity)
        if valid.all():
            valid = None
    if valid is not None:
        streams.append((SK_PRESENT, _bool_rle(valid)))

    tid = dtype.id
    if dtype.is_string:
        chars = np.asarray(col.data, np.uint8).tobytes()
        offs = np.asarray(col.offsets, np.int64)
        lens = np.diff(offs)
        if valid is None:
            data = chars
            use_lens = lens
        else:
            keep = np.flatnonzero(valid)
            data = b"".join(chars[offs[i]:offs[i + 1]] for i in keep)
            use_lens = lens[keep]
        streams.append((SK_DATA, data))
        streams.append((SK_LENGTH, _int_rle_v1(use_lens, signed=False)))
        return streams

    if tid in _INT_TIDS:  # unsigned buffers hold signed bits: widen first
        vals = dt.int64_values(dtype, col.data).numpy()
    else:
        vals = np.asarray(col.data)
    if valid is not None and tid != dt.TypeId.DECIMAL128:
        vals = vals[valid]

    if tid == dt.TypeId.BOOL8:
        streams.append((SK_DATA, _bool_rle(vals.astype(np.bool_))))
    elif tid == dt.TypeId.INT8:
        streams.append((SK_DATA, _byte_rle(vals.view(np.uint8))))
    elif tid in _INT_TIDS:
        streams.append((SK_DATA, _int_rle_v1(vals, signed=True)))
    elif tid == dt.TypeId.FLOAT32:
        streams.append((SK_DATA, vals.astype("<f4").tobytes()))
    elif tid == dt.TypeId.FLOAT64:
        streams.append((SK_DATA, vals.view(np.float64).astype("<f8")
                        .tobytes()))
    elif dtype.is_timestamp:
        unit = _TS_UNIT_NS[tid]
        secs, nanos = [], []
        for v in vals:
            t_ns = int(v) * unit
            q, r = divmod(abs(t_ns), 1_000_000_000)  # trunc toward zero
            if t_ns < 0:
                q, r = -q, -r
            secs.append(q - _ORC_EPOCH_S)
            nanos.append(r)
        streams.append((SK_DATA, _int_rle_v1(secs, signed=True)))
        streams.append((SK_SECONDARY, _int_rle_v1(
            _encode_nanos(nanos), signed=False)))
    elif dtype.is_decimal:
        scale = -dtype.scale  # _orc_type rejected positive engine scales
        if tid == dt.TypeId.DECIMAL128:
            limbs = vals.reshape(-1, 2)
            mants = [(int(hi) << 64) | (int(lo) & ((1 << 64) - 1))
                     for lo, hi in limbs]
            if valid is not None:
                mants = [m for m, ok in zip(mants, valid) if ok]
        else:
            mants = [int(v) for v in vals]
        blob = bytearray()
        for m in mants:
            _varint_bigint(blob, m)
        streams.append((SK_DATA, bytes(blob)))
        streams.append((SK_SECONDARY, _int_rle_v1(
            np.full(len(mants), scale, np.int64), signed=True)))
    else:
        raise NotImplementedError(f"ORC writer does not support {dtype!r}")
    return streams


# SNAPPY and ZSTD compress through pyarrow's codecs, looked up when a
# stream needs one (never at import); None means this host has no such
# compressor (a host without pyarrow: none and zlib only)
_FROM_ARROW = object()
_SNAPPY_C = _ZSTD_C = _FROM_ARROW


def _compressor(kind: int):
    """(pyarrow compressor or None, memory pool) for SNAPPY or ZSTD."""
    c = _SNAPPY_C if kind == COMP_SNAPPY else _ZSTD_C
    if c is not _FROM_ARROW:
        return c, None
    return arrow_codec("snappy" if kind == COMP_SNAPPY else "zstd")


def _compress_stream(raw: bytes, kind: int, block: int) -> bytes:
    if kind == COMP_NONE:
        return raw
    codec, pool = (None, None) if kind == COMP_ZLIB else _compressor(kind)
    out = bytearray()
    for i in range(0, len(raw), block):
        chunk = raw[i:i + block]
        if kind == COMP_ZLIB:
            comp = zlib.compressobj(6, zlib.DEFLATED, -15)
            cb = comp.compress(chunk) + comp.flush()
        else:  # COMP_ZSTD, COMP_SNAPPY
            cb = codec.compress(chunk, memory_pool=pool).to_pybytes()
        if len(cb) < len(chunk):
            h = len(cb) << 1
            out += bytes([h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF])
            out += cb
        else:  # store original
            h = (len(chunk) << 1) | 1
            out += bytes([h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF])
            out += chunk
    return bytes(out)


def write_orc(table: Table, path, compression: str = "none",
              stripe_rows: int = 1 << 20,
              struct_fields: dict | None = None):
    """Write a Table as an ORC 0.12 file readable by any ORC reader.

    LIST and STRUCT columns write the standard nested ORC encoding
    (pre-order column ids, LENGTH streams and present-row-filtered
    children).  ``struct_fields`` maps a STRUCT column name to its field
    names (a Column's children are unnamed; default f0, f1, ...).
    ``compression``: "none", "zlib", or "snappy"/"zstd" (pyarrow's
    compressors).  ``stripe_rows`` rows a stripe."""
    kinds = {"none": COMP_NONE, "uncompressed": COMP_NONE,
             "zlib": COMP_ZLIB, "snappy": COMP_SNAPPY, "zstd": COMP_ZSTD}
    comp = kinds[compression.lower()]
    if comp in (COMP_SNAPPY, COMP_ZSTD) and _compressor(comp)[0] is None:
        raise CodecUnavailableError(
            f"ORC {compression} compression needs pyarrow's compressor, "
            "which this host does not have; use zlib or none")
    table = table.to("cpu")
    block = 64 * 1024
    names = [nm or f"c{i}" for i, nm in enumerate(
        table.names or [f"c{i}" for i in range(table.num_columns)])]
    n = table.num_rows

    # types: struct root (id 0) + pre-order subtree per column (LIST and
    # STRUCT columns occupy one id per nested node, like ORC-C++)
    types = bytearray()
    root = bytearray()
    _pb_varint(root, 1, TK_STRUCT)
    cid = 1
    top_ids = []
    for c in table.columns:
        top_ids.append(cid)
        cid += _subtree_size(c)
    total_ids = cid  # including root
    for i in top_ids:
        _pb_varint(root, 2, i)
    for nm in names:
        _pb_bytes(root, 3, nm.encode())
    _pb_bytes(types, 4, bytes(root))  # footer field 4 = repeated Type
    nid = 1
    for c, nm in zip(table.columns, names):
        nid = _append_types(types, c, nid,
                            (struct_fields or {}).get(nm))

    body = bytearray()
    body += _MAGIC  # header
    stripes_meta = []
    for a in range(0, n, stripe_rows):
        b = min(a + stripe_rows, n)
        nrows = b - a
        sliced = [gather_column(c, torch.arange(a, b)) if (a, b) != (0, n)
                  else c for c in table.columns]
        offset = len(body)
        sfooter = bytearray()
        data_blobs = []
        entries = []
        for c, top_id in zip(sliced, top_ids):
            _emit_streams(c, top_id, entries)
        for scid, kind, raw in entries:
            blob = _compress_stream(raw, comp, block)
            smsg = bytearray()
            _pb_varint(smsg, 1, kind)
            _pb_varint(smsg, 2, scid)
            _pb_varint(smsg, 3, len(blob))
            _pb_bytes(sfooter, 1, bytes(smsg))
            data_blobs.append(blob)
        for _ in range(total_ids):  # encodings: DIRECT for every id
            emsg = bytearray()
            _pb_varint(emsg, 1, 0)
            _pb_bytes(sfooter, 2, bytes(emsg))
        _pb_bytes(sfooter, 3, b"UTC")  # writer timezone
        data = b"".join(data_blobs)
        sf = _compress_stream(bytes(sfooter), comp, block)
        body += data + sf
        smeta = bytearray()
        _pb_varint(smeta, 1, offset)
        _pb_varint(smeta, 2, 0)            # index length (no row index)
        _pb_varint(smeta, 3, len(data))
        _pb_varint(smeta, 4, len(sf))
        _pb_varint(smeta, 5, nrows)
        stripes_meta.append(bytes(smeta))

    footer = bytearray()
    _pb_varint(footer, 1, 3)               # headerLength = len("ORC")
    _pb_varint(footer, 2, len(body))       # contentLength
    for sm in stripes_meta:
        _pb_bytes(footer, 3, sm)
    footer += types
    _pb_varint(footer, 6, n)               # numberOfRows
    _pb_varint(footer, 8, 0)               # rowIndexStride: none
    fblob = _compress_stream(bytes(footer), comp, block)

    ps = bytearray()
    _pb_varint(ps, 1, len(fblob))          # footerLength
    _pb_varint(ps, 2, comp)                # compression
    _pb_varint(ps, 3, block)               # compressionBlockSize
    _enc_varint(ps, (4 << 3) | 2)          # version: packed [0, 12]
    _enc_varint(ps, 2)
    ps += bytes([0, 12])
    _pb_varint(ps, 5, 0)                   # metadataLength
    _pb_varint(ps, 6, 1)                   # writerVersion
    _pb_bytes(ps, 8000, _MAGIC)            # magic
    if len(ps) > 255:
        raise AssertionError("postscript too long")

    with open(path, "wb") as f:
        f.write(bytes(body) + fblob + bytes(ps) + bytes([len(ps)]))
