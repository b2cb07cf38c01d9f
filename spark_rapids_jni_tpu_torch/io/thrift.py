"""Minimal Thrift *compact protocol* decoder for Parquet metadata.

A copy of ``spark_rapids_jni_tpu/io/thrift.py`` (the port imports nothing of
that package).

Parquet's footer, page headers and column metadata are thrift-compact
structs (parquet-format's parquet.thrift).  The engine only ever *reads*
them, and only by field id, so instead of generating classes we decode any
struct to ``{field_id: value}`` dicts and let io.parquet interpret the ids.
This is the host-side analog of the metadata path the reference gets from
libcudf's parquet reader (build-libcudf.xml:37-50).

Wire grammar implemented (thrift compact protocol spec):
- varint (ULEB128) + zigzag ints
- field header: ``(delta << 4) | compact_type``; delta==0 -> explicit
  zigzag-varint field id; type 0 terminates the struct
- BOOLEAN_TRUE/FALSE carried in the type nibble
- BINARY: varint length + bytes;  DOUBLE: 8-byte little-endian
- LIST/SET header: ``(size << 4) | elem_type``, size==15 -> varint follows
"""

from __future__ import annotations

import struct

# compact-protocol type ids
T_STOP = 0
T_TRUE = 1
T_FALSE = 2
T_BYTE = 3
T_I16 = 4
T_I32 = 5
T_I64 = 6
T_DOUBLE = 7
T_BINARY = 8
T_LIST = 9
T_SET = 10
T_MAP = 11
T_STRUCT = 12


class ThriftReader:
    """Cursor over a buffer of thrift-compact bytes."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    # -- primitives --------------------------------------------------------
    def varint(self) -> int:
        result = 0
        shift = 0
        buf, pos = self.buf, self.pos
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        self.pos = pos
        return result

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def _binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated thrift binary")
        self.pos += n
        return out

    def _double(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    # -- containers --------------------------------------------------------
    def _value(self, ctype: int):
        if ctype == T_TRUE:
            return True
        if ctype == T_FALSE:
            return False
        if ctype in (T_BYTE, T_I16, T_I32, T_I64):
            return self.zigzag()
        if ctype == T_DOUBLE:
            return self._double()
        if ctype == T_BINARY:
            return self._binary()
        if ctype in (T_LIST, T_SET):
            return self._list()
        if ctype == T_MAP:
            return self._map()
        if ctype == T_STRUCT:
            return self.struct()
        raise ValueError(f"unsupported thrift compact type {ctype}")

    def _list(self) -> list:
        head = self.buf[self.pos]
        self.pos += 1
        size = head >> 4
        etype = head & 0x0F
        if size == 15:
            size = self.varint()
        return [self._value(etype) for _ in range(size)]

    def _map(self) -> dict:
        size = self.varint()
        if size == 0:
            return {}
        kv = self.buf[self.pos]
        self.pos += 1
        ktype, vtype = kv >> 4, kv & 0x0F
        return {self._value(ktype): self._value(vtype) for _ in range(size)}

    def struct(self) -> dict:
        """Decode one struct to {field_id: python value}.

        Booleans arrive as True/False; nested structs as dicts; lists as
        lists; binary as bytes.  Unknown fields decode fine (generic).
        """
        out = {}
        last_id = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            ctype = head & 0x0F
            if ctype == T_STOP:
                return out
            delta = head >> 4
            fid = last_id + delta if delta else self.zigzag()
            last_id = fid
            out[fid] = self._value(ctype)


def decode_struct(buf: bytes, pos: int = 0):
    """Decode a struct at ``pos``; returns (fields dict, end position)."""
    r = ThriftReader(buf, pos)
    fields = r.struct()
    return fields, r.pos


# ---------------------------------------------------------------------------
# encoder (the write side of the same wire grammar)
# ---------------------------------------------------------------------------

def _enc_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return


def _enc_zigzag(out: bytearray, n: int) -> None:
    _enc_varint(out, (n << 1) ^ (n >> 63) if n < 0 else n << 1)


def _enc_value(out: bytearray, ttype: int, value) -> None:
    if ttype in (T_BYTE, T_I16, T_I32, T_I64):
        _enc_zigzag(out, int(value))
    elif ttype == T_BINARY:
        data = value.encode() if isinstance(value, str) else bytes(value)
        _enc_varint(out, len(data))
        out.extend(data)
    elif ttype == T_DOUBLE:
        out.extend(struct.pack("<d", value))
    elif ttype == T_LIST:
        etype, items = value
        if len(items) < 15:
            out.append((len(items) << 4) | etype)
        else:
            out.append(0xF0 | etype)
            _enc_varint(out, len(items))
        for it in items:
            _enc_value(out, etype, it)
    elif ttype == T_STRUCT:
        out.extend(encode_struct(value))
    else:
        raise ValueError(f"unsupported thrift encode type {ttype}")


def encode_struct(fields) -> bytes:
    """Encode [(field_id, type, value), ...] (ids ascending) to compact bytes.

    Booleans pass ``T_TRUE`` with a bool value (the value rides in the type
    nibble); lists pass ``(elem_type, [items])``; structs pass nested field
    lists.  The mirror of ``ThriftReader.struct``.
    """
    out = bytearray()
    last_id = 0
    for fid, ttype, value in fields:
        if value is None:
            continue
        wire_type = ttype
        if ttype in (T_TRUE, T_FALSE):
            wire_type = T_TRUE if value else T_FALSE
        delta = fid - last_id
        if 0 < delta <= 15:
            out.append((delta << 4) | wire_type)
        else:
            out.append(wire_type)
            _enc_zigzag(out, fid)
        last_id = fid
        if ttype not in (T_TRUE, T_FALSE):
            _enc_value(out, ttype, value)
    out.append(T_STOP)
    return bytes(out)
