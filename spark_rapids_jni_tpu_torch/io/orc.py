"""ORC scan path: postscript/footer -> stripes -> device columns.

The port of ``spark_rapids_jni_tpu/io/orc.py``.  Entropy decode (protobuf
metadata, RLEv1/v2 runs, compression chunks) runs on the host in numpy, one
Python step per *run*, not per value, as in the JAX package; the decoded
buffers are built as host tensors and land on ``device`` in one copy per
buffer.  Stripes are the natural chunk unit: ``ORCChunkedReader`` bounds
device memory per pass by file layout, and a scan predicate prunes whole
stripes by the metadata section's statistics.

Supported surface:
- types: BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, CHAR,
  VARCHAR, BINARY (as LIST<UINT8>), DATE, TIMESTAMP(_INSTANT),
  DECIMAL (<=18 digits -> DECIMAL32/64, >18 -> DECIMAL128), LIST and
  STRUCT of the above, to any depth; MAP and UNION raise
  ``NotImplementedError``.
- encodings: DIRECT, DIRECT_V2, DICTIONARY, DICTIONARY_V2; integer runs in
  both RLEv1 and RLEv2 (SHORT_REPEAT / DIRECT / PATCHED_BASE / DELTA)
- codecs: NONE, ZLIB (raw deflate), SNAPPY (``io/snappy.py``), and ZSTD
  where pyarrow can be imported; without pyarrow a ZSTD stream raises
  ``CodecUnavailableError``.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device
from .. import dtypes as dt
from ..columnar import Column, Table
from ..ops.selection import _concat_columns, gather_column
from ..utils.errors import CodecUnavailableError
from . import snappy as _snappy_py

#: decode builds host tensors; a whole stripe or file moves to the device
#: at the end
_HOST = "cpu"

_MAGIC = b"ORC"

# orc_proto CompressionKind
COMP_NONE, COMP_ZLIB, COMP_SNAPPY, COMP_LZO, COMP_LZ4, COMP_ZSTD = range(6)

# orc_proto Type.Kind
(TK_BOOLEAN, TK_BYTE, TK_SHORT, TK_INT, TK_LONG, TK_FLOAT, TK_DOUBLE,
 TK_STRING, TK_BINARY, TK_TIMESTAMP, TK_LIST, TK_MAP, TK_STRUCT, TK_UNION,
 TK_DECIMAL, TK_DATE, TK_VARCHAR, TK_CHAR) = range(18)
TK_TIMESTAMP_INSTANT = 18

# orc_proto Stream.Kind
SK_PRESENT, SK_DATA, SK_LENGTH, SK_DICTIONARY_DATA = 0, 1, 2, 3
SK_SECONDARY, SK_ROW_INDEX = 5, 6

# orc_proto ColumnEncoding.Kind
ENC_DIRECT, ENC_DICTIONARY, ENC_DIRECT_V2, ENC_DICTIONARY_V2 = range(4)

# seconds from the unix epoch to the ORC timestamp epoch (2015-01-01 UTC)
_ORC_EPOCH_S = 1420070400

# ---------------------------------------------------------------------------
# minimal protobuf wire decoder (ORC metadata is proto2; we read by field id,
# mirroring how io.thrift reads parquet's compact-protocol structs)

_uvarint = _snappy_py._uvarint  # one LEB128 decoder for the whole io package


def _pb_fields(buf) -> dict:
    """Decode one message to {field_number: [raw values]}.

    varint fields decode to int; length-delimited to bytes (nested messages
    re-parsed on demand); 64/32-bit to int.
    """
    out: dict = {}
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _uvarint(buf, pos)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _uvarint(buf, pos)
        elif wire == 2:
            ln, pos = _uvarint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 1:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == 5:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.setdefault(fnum, []).append(val)
    return out


def _pb_u(f, n, default=0):
    return f[n][0] if n in f else default


def _pb_packed(f, n) -> list:
    """repeated varint field: packed (one bytes blob) or unpacked."""
    vals = []
    for v in f.get(n, ()):
        if isinstance(v, (bytes, memoryview)):
            pos = 0
            while pos < len(v):
                x, pos = _uvarint(v, pos)
                vals.append(x)
        else:
            vals.append(v)
    return vals


# ---------------------------------------------------------------------------
# compression framing: each stream is a sequence of chunks with a 3-byte
# little-endian header (length << 1 | is_original)

def _decompress_chunk(chunk: bytes, kind: int) -> bytes:
    if kind == COMP_ZLIB:  # raw deflate, no zlib header
        return zlib.decompressobj(-15).decompress(chunk)
    if kind == COMP_SNAPPY:
        # raw-format snappy carries its decompressed length in the preamble;
        # pyarrow's Codec insists on being told, so use the in-repo decoder
        return _snappy_py.decompress(chunk)
    if kind == COMP_ZSTD:
        try:
            import pyarrow as _pa
        except ImportError:
            raise CodecUnavailableError(
                "ORC stream is ZSTD-compressed and this host has no "
                "pyarrow to decode it") from None
        # stream-decode: pyarrow's one-shot Codec.decompress demands an
        # explicit decompressed size, which ORC chunk framing doesn't carry
        with _pa.input_stream(_pa.BufferReader(chunk),
                              compression="zstd") as st:
            return st.read()
    raise NotImplementedError(
        f"unsupported ORC compression kind {kind} "
        "(NONE, ZLIB, SNAPPY and ZSTD are supported)")


def _decode_stream(raw: bytes, kind: int) -> bytes:
    if kind == COMP_NONE:
        return raw
    out = []
    pos, n = 0, len(raw)
    while pos + 3 <= n:
        h = raw[pos] | (raw[pos + 1] << 8) | (raw[pos + 2] << 16)
        pos += 3
        ln, original = h >> 1, h & 1
        chunk = raw[pos:pos + ln]
        pos += ln
        out.append(bytes(chunk) if original else
                   _decompress_chunk(bytes(chunk), kind))
    return b"".join(out)


# ---------------------------------------------------------------------------
# run-length decoders.  Python touches one iteration per run; values inside
# a run are produced by numpy.

def _byte_rle(buf: bytes, n: int) -> np.ndarray:
    out = np.empty(n + 131, np.uint8)  # headroom: one run may overshoot
    total = pos = 0
    while total < n:
        h = buf[pos]
        pos += 1
        if h < 128:  # run of h+3 copies of the next byte
            run = h + 3
            out[total:total + run] = buf[pos]
            pos += 1
            total += run
        else:  # 256-h literal bytes
            cnt = 256 - h
            out[total:total + cnt] = np.frombuffer(buf, np.uint8, cnt, pos)
            pos += cnt
            total += cnt
    return out[:n]


def _bool_rle(buf: bytes, n: int) -> np.ndarray:
    """Boolean run: byte-RLE bytes expanded to MSB-first bits."""
    nbytes = (n + 7) // 8
    by = _byte_rle(buf, nbytes)
    return np.unpackbits(by)[:n].astype(np.bool_)


def _zigzag(v: np.ndarray) -> np.ndarray:
    u = v.astype(np.uint64)
    return ((u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1)))) \
        .view(np.int64)


def _int_rle_v1(buf: bytes, n: int, signed: bool) -> np.ndarray:
    """RLEv1 integers: the headers walk in Python, one step a run; the
    varints of every literal block decode together afterwards (a block's
    end is its count-th varint terminator, found by binary search)."""
    out = np.empty(n + 131, np.int64)
    raw = np.frombuffer(buf, np.uint8)
    term = np.flatnonzero(raw < 128)    # last byte of any varint
    lits = []                           # (first byte, last byte, out slot)
    total = pos = 0
    while total < n:
        h = buf[pos]
        pos += 1
        if h < 128:  # run: length h+3, signed byte delta, varint base
            run = h + 3
            delta = buf[pos] - 256 if buf[pos] > 127 else buf[pos]
            pos += 1
            base, pos = _uvarint(buf, pos)
            if signed:
                base = (base >> 1) ^ -(base & 1)
            # wrap to int64 exactly like the literal path: an unsigned
            # varint base >= 2**63 (e.g. two's-complement negative nanos
            # emitted as a run) must not overflow the int64 assignment
            base = int(np.int64(np.uint64(base & (2**64 - 1))))
            out[total:total + run] = base + delta * np.arange(run, dtype=np.int64)
            total += run
        else:  # 256-h literal varints
            cnt = 256 - h
            k = int(np.searchsorted(term, pos))
            last = int(term[k + cnt - 1])
            lits.append((pos, last, total, cnt))
            pos = last + 1
            total += cnt
    if lits:
        first = np.array([a for a, _, _, _ in lits], np.int64)
        nbytes = np.array([b - a + 1 for a, b, _, _ in lits], np.int64)
        at = np.repeat(first - (np.cumsum(nbytes) - nbytes), nbytes) + \
            np.arange(int(nbytes.sum()), dtype=np.int64)
        body = raw[at]
        ends = np.flatnonzero(body < 128)
        vstart = np.concatenate(([0], ends[:-1] + 1))
        shift = (np.arange(len(body), dtype=np.int64)
                 - np.repeat(vstart, ends - vstart + 1)) * 7
        parts = (body.astype(np.uint64) & np.uint64(0x7F)) << \
            np.minimum(shift, 63).astype(np.uint64)
        parts[shift > 63] = 0
        vals = np.add.reduceat(parts, vstart) if len(body) else \
            np.zeros(0, np.uint64)
        if signed:
            vals = (vals >> np.uint64(1)) ^ (np.uint64(0) - (vals & np.uint64(1)))
        vals = vals.view(np.int64)
        slots = np.concatenate([np.arange(t, t + c) for _, _, t, c in lits])
        out[slots] = vals
    return out[:n]


# RLEv2 5-bit width code → bit width ("fixed bit sizes" table)
_FBS = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]


def _closest_fbs(bits: int) -> int:
    for w in _FBS:
        if w >= bits:
            return w
    return 64


def _unpack_be(buf: bytes, pos: int, count: int, width: int):
    """Big-endian (MSB-first) bit-unpack of `count` values at `width` bits."""
    if width == 0:
        return np.zeros(count, np.uint64), pos
    nbytes = (count * width + 7) // 8
    raw = np.frombuffer(buf, np.uint8, nbytes, pos)
    bits = np.unpackbits(raw)[:count * width].reshape(count, width)
    w = (np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64))
    vals = (bits.astype(np.uint64) * w).sum(axis=1, dtype=np.uint64)
    return vals, pos + nbytes


def _int_rle_v2(buf: bytes, n: int, signed: bool) -> np.ndarray:
    out = np.empty(n + 512, np.int64)
    total = pos = 0
    while total < n:
        b0 = buf[pos]
        enc = (b0 >> 6) & 3
        if enc == 0:  # SHORT_REPEAT
            width = ((b0 >> 3) & 7) + 1
            run = (b0 & 7) + 3
            pos += 1
            val = int.from_bytes(buf[pos:pos + width], "big")
            pos += width
            if signed:
                val = (val >> 1) ^ -(val & 1)
            out[total:total + run] = np.int64(np.uint64(val & (2**64 - 1)))
            total += run
        elif enc == 1:  # DIRECT
            width = _FBS[(b0 >> 1) & 0x1F]
            run = ((b0 & 1) << 8 | buf[pos + 1]) + 1
            pos += 2
            vals, pos = _unpack_be(buf, pos, run, width)
            if signed:
                vals = _zigzag(vals)
            out[total:total + run] = vals.view(np.int64) if not signed else vals
            total += run
        elif enc == 2:  # PATCHED_BASE
            width = _FBS[(b0 >> 1) & 0x1F]
            run = ((b0 & 1) << 8 | buf[pos + 1]) + 1
            b2, b3 = buf[pos + 2], buf[pos + 3]
            bw = ((b2 >> 5) & 7) + 1          # base width, bytes
            pw = _FBS[b2 & 0x1F]              # patch value width, bits
            pgw = ((b3 >> 5) & 7) + 1         # patch gap width, bits
            pll = b3 & 0x1F                   # patch list length
            pos += 4
            raw_base = int.from_bytes(buf[pos:pos + bw], "big")
            pos += bw
            sign_mask = 1 << (bw * 8 - 1)     # base is sign-magnitude
            base = -(raw_base & (sign_mask - 1)) if raw_base & sign_mask \
                else raw_base
            vals, pos = _unpack_be(buf, pos, run, width)
            if pll:
                cw = _closest_fbs(pgw + pw)
                patches, pos = _unpack_be(buf, pos, pll, cw)
                idx = 0
                pmask = np.uint64((1 << pw) - 1)
                for p in patches:
                    idx += int(p) >> pw
                    vals[idx] |= (p & pmask) << np.uint64(width)
            out[total:total + run] = vals.view(np.int64) + base
            total += run
        else:  # DELTA
            wcode = (b0 >> 1) & 0x1F
            width = 0 if wcode == 0 else _FBS[wcode]
            run = ((b0 & 1) << 8 | buf[pos + 1]) + 1
            pos += 2
            base, pos = _uvarint(buf, pos)
            if signed:
                base = (base >> 1) ^ -(base & 1)
            else:
                base = np.int64(np.uint64(base & (2**64 - 1)))
            dbase, pos = _uvarint(buf, pos)
            dbase = (dbase >> 1) ^ -(dbase & 1)  # delta base always signed
            if width == 0:  # fixed-delta run
                out[total:total + run] = \
                    int(base) + int(dbase) * np.arange(run, dtype=np.int64)
            else:
                deltas, pos = _unpack_be(buf, pos, max(run - 2, 0), width)
                seq = np.empty(run, np.int64)
                seq[0] = base
                if run > 1:
                    seq[1] = int(base) + int(dbase)
                    if run > 2:
                        d = deltas.view(np.int64)
                        step = d if dbase >= 0 else -d
                        seq[2:] = seq[1] + np.cumsum(step)
                out[total:total + run] = seq
            total += run
    return out[:n]


def _int_rle(buf, n, signed, v2: bool) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int64)
    return _int_rle_v2(buf, n, signed) if v2 else _int_rle_v1(buf, n, signed)


def _rescale_mantissa(m: int, s: int, tgt: int) -> int:
    d = tgt - s
    if d >= 0:
        return m * 10 ** d
    p = 10 ** -d
    q, r = divmod(abs(m), p)
    if r:
        raise ValueError(
            f"ORC decimal value scale {s} does not fit column scale {tgt}")
    return q if m >= 0 else -q


def _varint_bigints(buf: bytes, n: int) -> list:
    """n unbounded zigzag varints (DECIMAL mantissas) as python ints."""
    out = []
    pos = 0
    for _ in range(n):
        result = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        out.append((result >> 1) ^ -(result & 1))
    return out


# ---------------------------------------------------------------------------
# file metadata

@dataclass
class _OrcType:
    kind: int
    subtypes: list
    field_names: list
    precision: int
    scale: int


@dataclass
class _Stripe:
    offset: int
    index_length: int
    data_length: int
    footer_length: int
    num_rows: int


def _map_dtype(t: _OrcType) -> dt.DType:
    if t.kind == TK_BOOLEAN:
        return dt.BOOL8
    if t.kind == TK_BYTE:
        return dt.INT8
    if t.kind == TK_SHORT:
        return dt.INT16
    if t.kind == TK_INT:
        return dt.INT32
    if t.kind == TK_LONG:
        return dt.INT64
    if t.kind == TK_FLOAT:
        return dt.FLOAT32
    if t.kind == TK_DOUBLE:
        return dt.FLOAT64
    if t.kind in (TK_STRING, TK_VARCHAR, TK_CHAR):
        return dt.STRING
    if t.kind == TK_DATE:
        return dt.TIMESTAMP_DAYS
    if t.kind in (TK_TIMESTAMP, TK_TIMESTAMP_INSTANT):
        return dt.TIMESTAMP_NANOSECONDS
    if t.kind == TK_DECIMAL:
        ours = -t.scale  # engine scale is the cudf convention (negated)
        if t.precision <= 9:
            return dt.decimal32(ours)
        if t.precision <= 18:
            return dt.decimal64(ours)
        return dt.decimal128(ours)
    if t.kind == TK_BINARY:
        return dt.DType(dt.TypeId.LIST)
    if t.kind == TK_LIST:
        return dt.DType(dt.TypeId.LIST)
    if t.kind == TK_STRUCT:
        return dt.DType(dt.TypeId.STRUCT)
    raise NotImplementedError(f"unsupported ORC type kind {t.kind}")


class ORCFile:
    """Parsed ORC file: schema + stripe metadata + per-stripe decode."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            f.seek(0, 2)
            fsize = f.tell()
            tail_len = min(fsize, 16 * 1024)
            f.seek(fsize - tail_len)
            tail = f.read(tail_len)
        if fsize < 16:
            raise ValueError("not an ORC file (truncated)")
        ps_len = tail[-1]
        ps = _pb_fields(tail[-1 - ps_len:-1])
        if _pb_u(ps, 8000, b"") not in (b"ORC", b""):
            raise ValueError("not an ORC file (bad postscript magic)")
        self.compression = _pb_u(ps, 2, COMP_NONE)
        self.compression_block = _pb_u(ps, 3, 256 * 1024)
        footer_len = _pb_u(ps, 1)
        meta_len = _pb_u(ps, 5)
        need = 1 + ps_len + footer_len + meta_len
        if need > tail_len:
            with open(path, "rb") as f:
                f.seek(fsize - need)
                tail = f.read(need)
        footer_raw = tail[len(tail) - 1 - ps_len - footer_len:
                          len(tail) - 1 - ps_len]
        meta_raw = tail[len(tail) - 1 - ps_len - footer_len - meta_len:
                        len(tail) - 1 - ps_len - footer_len]
        footer = _pb_fields(_decode_stream(footer_raw, self.compression))
        # Metadata section: per-stripe, per-column statistics (min/max) —
        # the stripe-pruning analog of parquet row-group footer stats
        self._stripe_stats: list = []
        if meta_len:
            meta = _pb_fields(_decode_stream(meta_raw, self.compression))
            for ss in meta.get(1, ()):  # repeated StripeStatistics
                cols = [_pb_fields(cs) for cs in _pb_fields(ss).get(1, ())]
                self._stripe_stats.append(cols)
        self.num_rows = _pb_u(footer, 6)
        self.types = [
            _OrcType(kind=_pb_u(tf, 1), subtypes=_pb_packed(tf, 2),
                     field_names=[bytes(x).decode() for x in tf.get(3, ())],
                     precision=_pb_u(tf, 5), scale=_pb_u(tf, 6))
            for tf in (_pb_fields(t) for t in footer.get(4, ()))
        ]
        self.stripes = [
            _Stripe(offset=_pb_u(sf, 1), index_length=_pb_u(sf, 2),
                    data_length=_pb_u(sf, 3), footer_length=_pb_u(sf, 4),
                    num_rows=_pb_u(sf, 5))
            for sf in (_pb_fields(s) for s in footer.get(3, ()))
        ]
        root = self.types[0] if self.types else None
        if root is None or root.kind != TK_STRUCT:
            raise NotImplementedError("ORC root type must be a struct")
        self.column_names = root.field_names
        self.column_ids = root.subtypes
        self.schema = [(nm, _map_dtype(self.types[cid]))
                       for nm, cid in zip(self.column_names, self.column_ids)]

    @property
    def num_stripes(self) -> int:
        return len(self.stripes)

    def stripe_stat_range(self, stripe: int, column: str):
        """(min, max) for a column over one stripe, or None if absent.

        Int/date stats are zigzag varints; double stats are fixed64 IEEE;
        string stats are raw bytes (returned as str)."""
        if stripe >= len(self._stripe_stats):
            return None
        try:
            cid = self.column_ids[self.column_names.index(column)]
        except ValueError:
            return None
        cols = self._stripe_stats[stripe]
        if cid >= len(cols):
            return None
        cs = cols[cid]

        def zz(v):
            return (v >> 1) ^ -(v & 1)

        if 2 in cs:  # IntStatistics {1 min, 2 max} (sint64)
            f = _pb_fields(cs[2][0])
            if 1 in f and 2 in f:
                return zz(f[1][0]), zz(f[2][0])
        if 3 in cs:  # DoubleStatistics {1 min, 2 max} (fixed64 doubles)
            import struct as _struct
            f = _pb_fields(cs[3][0])
            if 1 in f and 2 in f:
                return (_struct.unpack("<d", int(f[1][0]).to_bytes(8, "little"))[0],
                        _struct.unpack("<d", int(f[2][0]).to_bytes(8, "little"))[0])
        if 4 in cs:  # StringStatistics {1 min, 2 max} (bytes)
            f = _pb_fields(cs[4][0])
            if 1 in f and 2 in f:
                return bytes(f[1][0]).decode(), bytes(f[2][0]).decode()
        if 7 in cs:  # DateStatistics {1 min, 2 max} (sint32 days)
            f = _pb_fields(cs[7][0])
            if 1 in f and 2 in f:
                return zz(f[1][0]), zz(f[2][0])
        return None

    # -- stripe decode -----------------------------------------------------
    def _stripe_streams(self, st: _Stripe):
        """→ ({(column, kind): bytes}, {column: (encoding, dict_size)})"""
        with open(self.path, "rb") as f:
            f.seek(st.offset)
            blob = f.read(st.index_length + st.data_length + st.footer_length)
        sf = _pb_fields(_decode_stream(
            blob[st.index_length + st.data_length:], self.compression))
        streams = []
        for s in sf.get(1, ()):
            fields = _pb_fields(s)
            streams.append((_pb_u(fields, 1), _pb_u(fields, 2),
                            _pb_u(fields, 3)))
        encodings = {}
        for col, e in enumerate(sf.get(2, ())):
            fields = _pb_fields(e)
            encodings[col] = (_pb_u(fields, 1), _pb_u(fields, 2))
        bufs = {}
        off = 0
        for kind, col, length in streams:
            if kind not in (SK_ROW_INDEX, SK_PRESENT, SK_DATA, SK_LENGTH,
                            SK_DICTIONARY_DATA, SK_SECONDARY):
                off += length
                continue
            if kind != SK_ROW_INDEX:
                bufs[(col, kind)] = _decode_stream(
                    blob[off:off + length], self.compression)
            off += length
        return bufs, encodings

    def _decode_column(self, cid: int, bufs, encodings, n: int):
        """Decode column `cid` over `n` rows → Column (host numpy inside)."""
        t = self.types[cid]
        enc, dict_size = encodings.get(cid, (ENC_DIRECT, 0))
        v2 = enc in (ENC_DIRECT_V2, ENC_DICTIONARY_V2)
        present = bufs.get((cid, SK_PRESENT))
        valid = _bool_rle(present, n) if present is not None else None
        nvals = int(valid.sum()) if valid is not None else n
        data = bufs.get((cid, SK_DATA), b"")

        def expand(dense: np.ndarray, fill=0) -> np.ndarray:
            """Scatter per-present values back to row positions."""
            if valid is None:
                return dense
            out = np.full(n, fill, dense.dtype)
            out[valid] = dense
            return out

        k = t.kind
        if k == TK_BOOLEAN:
            vals = _bool_rle(data, nvals).astype(np.uint8)
            return Column.fixed(dt.BOOL8, expand(vals), valid, device=_HOST)
        if k in (TK_BYTE,):
            vals = _byte_rle(data, nvals).view(np.int8)
            return Column.fixed(dt.INT8, expand(vals), valid, device=_HOST)
        if k in (TK_SHORT, TK_INT, TK_LONG):
            vals = _int_rle(data, nvals, signed=True, v2=v2)
            odt = {TK_SHORT: dt.INT16, TK_INT: dt.INT32, TK_LONG: dt.INT64}[k]
            return Column.fixed(odt, expand(vals).astype(odt.storage), valid,
                                device=_HOST)
        if k == TK_FLOAT:
            vals = np.frombuffer(data, "<f4", nvals)
            return Column.fixed(dt.FLOAT32, expand(vals), valid,
                                device=_HOST)
        if k == TK_DOUBLE:
            vals = np.frombuffer(data, "<f8", nvals)
            return Column.fixed(dt.FLOAT64, expand(vals), valid,
                                device=_HOST)
        if k == TK_DATE:
            vals = _int_rle(data, nvals, signed=True, v2=v2)
            return Column.fixed(dt.TIMESTAMP_DAYS,
                                expand(vals).astype(np.int32), valid,
                                device=_HOST)
        if k in (TK_TIMESTAMP, TK_TIMESTAMP_INSTANT):
            secs = _int_rle(data, nvals, signed=True, v2=v2)
            nraw = _int_rle(bufs.get((cid, SK_SECONDARY), b""), nvals,
                            signed=False, v2=v2)
            zeros = (nraw & 7).astype(np.int64)
            nanos = (nraw >> 3) * np.where(zeros != 0, 10 ** (zeros + 1), 1)
            # seconds are the floor relative to the ORC epoch and nanos the
            # positive sub-second remainder (verified against the
            # pyarrow/ORC-C++ oracle incl. pre-2015 and pre-1970 instants)
            total = (secs + _ORC_EPOCH_S) * 1_000_000_000 + nanos
            return Column.fixed(dt.TIMESTAMP_NANOSECONDS, expand(total),
                                valid, device=_HOST)
        if k in (TK_STRING, TK_VARCHAR, TK_CHAR):
            if enc in (ENC_DICTIONARY, ENC_DICTIONARY_V2):
                lengths = _int_rle(bufs.get((cid, SK_LENGTH), b""), dict_size,
                                   signed=False, v2=v2)
                dchars = np.frombuffer(
                    bufs.get((cid, SK_DICTIONARY_DATA), b""), np.uint8)
                doffs = np.zeros(dict_size + 1, np.int64)
                np.cumsum(lengths, out=doffs[1:])
                idx = _int_rle(data, nvals, signed=False, v2=v2)
                vlens = lengths[idx] if dict_size else np.zeros(nvals, np.int64)
                row_lens = expand(vlens)
                offsets = np.zeros(n + 1, np.int64)
                np.cumsum(row_lens, out=offsets[1:])
                # vectorized dict materialization: for each output byte, its
                # source index = dict start of its row + offset within the row
                # (cumsum-reset arange, the same pattern as the offsets)
                starts = doffs[idx] if dict_size else np.zeros(nvals, np.int64)
                total_chars = int(vlens.sum())
                pos_in_val = np.arange(total_chars, dtype=np.int64) - \
                    np.repeat(np.concatenate([[0], np.cumsum(vlens)[:-1]]),
                              vlens)
                src = np.repeat(starts, vlens) + pos_in_val
                chars = dchars[src] if total_chars else np.zeros(0, np.uint8)
            else:
                lengths = _int_rle(bufs.get((cid, SK_LENGTH), b""), nvals,
                                   signed=False, v2=v2)
                row_lens = expand(lengths)
                offsets = np.zeros(n + 1, np.int64)
                np.cumsum(row_lens, out=offsets[1:])
                chars = np.frombuffer(data, np.uint8, int(offsets[-1]))
            if offsets[-1] > np.iinfo(np.int32).max:
                raise ValueError("ORC string column exceeds int32 offsets")
            return Column.string(chars, offsets.astype(np.int32), valid,
                                 device=_HOST)
        if k == TK_DECIMAL:
            mants = _varint_bigints(data, nvals)
            scales = _int_rle(bufs.get((cid, SK_SECONDARY), b""), nvals,
                              signed=True, v2=v2)
            # rescale each value to the column scale — integer math only: a
            # value with more fractional digits than the column scale can
            # only be kept if the extra digits are zero
            tgt = t.scale
            mants = [_rescale_mantissa(m, int(s), tgt) if s != tgt else m
                     for m, s in zip(mants, scales)]
            odt = _map_dtype(t)
            if odt.id == dt.TypeId.DECIMAL128:
                dense = np.array(mants, object)
                if valid is not None:
                    full = np.zeros(n, object)
                    full[valid] = dense
                    dense = full
                return Column.fixed(odt, dense, valid, device=_HOST)
            dense = np.array(mants, np.int64)
            return Column.fixed(odt, expand(dense).astype(odt.storage), valid,
                                device=_HOST)
        if k == TK_BINARY:
            lengths = _int_rle(bufs.get((cid, SK_LENGTH), b""), nvals,
                               signed=False, v2=v2)
            row_lens = expand(lengths)
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(row_lens, out=offsets[1:])
            raw = np.frombuffer(data, np.uint8, int(offsets[-1]))
            child = Column.fixed(dt.UINT8, raw, device=_HOST)
            return Column.list_(child, offsets.astype(np.int32), valid,
                                device=_HOST)
        if k == TK_LIST:
            lengths = _int_rle(bufs.get((cid, SK_LENGTH), b""), nvals,
                               signed=False, v2=v2)
            row_lens = expand(lengths)
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(row_lens, out=offsets[1:])
            child = self._decode_column(t.subtypes[0], bufs, encodings,
                                        int(offsets[-1]))
            return Column.list_(child, offsets.astype(np.int32), valid,
                                device=_HOST)
        if k == TK_STRUCT:
            # struct fields carry one entry per PRESENT struct row: decode
            # each over nvals rows, then spread them to the n-row frame
            # (a null struct row is a null row of every field)
            kids = [self._decode_column(sub, bufs, encodings, nvals)
                    for sub in t.subtypes]
            if valid is not None:
                idx = np.full(n, -1, np.int64)
                idx[valid] = np.arange(nvals, dtype=np.int64)
                kids = [gather_column(c, torch.from_numpy(idx))
                        for c in kids]
            return Column(dt.DType(dt.TypeId.STRUCT),
                          validity=None if valid is None
                          else torch.from_numpy(np.asarray(valid, np.bool_)),
                          children=tuple(kids))
        raise NotImplementedError(f"unsupported ORC type kind {k}")

    def _empty_column(self, cid: int) -> Column:
        t = self.types[cid]
        odt = _map_dtype(t)
        if odt.is_string:
            return Column.string(np.zeros(0, np.uint8), np.zeros(1, np.int32),
                                 device=_HOST)
        if odt.id == dt.TypeId.LIST:
            child = (Column.fixed(dt.UINT8, np.zeros(0, np.uint8),
                                  device=_HOST)
                     if t.kind == TK_BINARY
                     else self._empty_column(t.subtypes[0]))
            return Column.list_(child, np.zeros(1, np.int32), device=_HOST)
        if odt.id == dt.TypeId.DECIMAL128:
            return Column.fixed(odt, np.zeros((0, 2), np.int64), device=_HOST)
        if odt.id == dt.TypeId.STRUCT:
            return Column(odt, children=tuple(self._empty_column(s)
                                              for s in t.subtypes))
        return Column.fixed(odt, np.zeros(0, odt.storage), device=_HOST)

    def _read_stripe_host(self, i: int, columns=None) -> Table:
        st = self.stripes[i]
        bufs, encodings = self._stripe_streams(st)
        names, cols = [], []
        for nm, cid in zip(self.column_names, self.column_ids):
            if columns is not None and nm not in columns:
                continue
            names.append(nm)
            cols.append(self._decode_column(cid, bufs, encodings,
                                            st.num_rows))
        return Table(cols, names)

    def read_stripe(self, i: int, columns=None,
                    device=_device.DEFAULT) -> Table:
        return self._read_stripe_host(i, columns).to(device)

    def empty_table(self, columns=None, device=_device.DEFAULT) -> Table:
        """Zero rows of the (projected) schema."""
        names, cols = [], []
        for nm, cid in zip(self.column_names, self.column_ids):
            if columns is not None and nm not in columns:
                continue
            names.append(nm)
            cols.append(self._empty_column(cid))
        return Table(cols, names).to(device)

    def read(self, columns=None, device=_device.DEFAULT) -> Table:
        dev = _device.resolve(device)
        parts = [self._read_stripe_host(i, columns)
                 for i in range(self.num_stripes)]
        if not parts:
            return self.empty_table(columns, dev)
        if len(parts) == 1:
            return parts[0].to(dev)
        names = parts[0].names
        cols = [_concat_columns([p.columns[i] for p in parts])
                for i in range(len(names))]
        return Table(cols, names).to(dev)


def read_orc(path, columns=None, device=_device.DEFAULT) -> Table:
    """Read a whole ORC file into a Table on ``device``."""
    return ORCFile(path).read(columns, device=device)


class ORCChunkedReader:
    """Iterate an ORC file stripe-at-a-time as Tables on ``device``.

    Stripes are ORC's native bounded unit (the writer sizes them to
    `stripe_size`), so the per-pass device working set is bounded by file
    layout exactly like ParquetChunkedReader bounds it by byte budget.
    ``predicate=(column, lo, hi)`` prunes whole stripes via the metadata
    section's stripe statistics before any stream decode (the parquet
    footer-stats analog); either bound may be None.
    """

    def __init__(self, path, columns=None, predicate: tuple | None = None,
                 device=_device.DEFAULT):
        self.file = ORCFile(path)
        self.columns = columns
        self.predicate = predicate
        self.device = _device.resolve(device)
        if predicate is not None:
            col, lo, hi = predicate
            if col not in self.file.column_names:
                raise KeyError(f"predicate column {col!r} not in "
                               f"{list(self.file.column_names)}")
            # bound types must be comparable with the column's stat kind
            rng = next((r for r in (self.file.stripe_stat_range(i, col)
                                    for i in range(self.file.num_stripes))
                        if r is not None), None)
            if rng is not None:
                for b in (lo, hi):
                    if b is not None:
                        try:
                            b < rng[0]  # noqa: B015 — comparability probe
                        except TypeError:
                            raise TypeError(
                                f"predicate bound {b!r} is not comparable "
                                f"with {col!r} statistics ({type(rng[0]).__name__})")

    def _pruned(self, i: int) -> bool:
        if self.predicate is None:
            return False
        col, lo, hi = self.predicate
        rng = self.file.stripe_stat_range(i, col)
        if rng is None:
            return False
        smin, smax = rng
        return (hi is not None and smin > hi) or \
               (lo is not None and smax < lo)

    def __iter__(self):
        for i in range(self.file.num_stripes):
            if self._pruned(i):
                continue
            yield self.file.read_stripe(i, self.columns, self.device)
