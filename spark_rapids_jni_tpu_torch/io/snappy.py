"""Snappy raw blocks (Parquet's default codec): decompression, and a
compressor for hosts without pyarrow.

The decoder is a copy of ``spark_rapids_jni_tpu/io/snappy.py`` (the port
imports nothing of that package).  :func:`compress` is the port's own: the
Parquet writer takes pyarrow's snappy codec where pyarrow can be imported
(the JAX writer's bytes) and this encoder where it cannot.

Pure-Python decoder for the snappy *raw* format pyarrow/parquet-mr emit per
page: a varint uncompressed length, then a tag stream of literals and
back-references.  The byte-granular back-references are inherently
sequential, so this is host code operating on page-sized buffers (~1 MiB)
before the decoded columns are handed to the device — the same division of
labor as the reference, whose nvcomp/snappy decode also happens before cudf
column assembly (libcudf parquet reader role, build-libcudf.xml:37-50).

Performance notes: literals and non-overlapping copies are slice copies
into a preallocated bytearray; overlapping copies (run-length patterns) are
materialized by pattern doubling, so even pathological RLE data costs
O(n log n) slice ops, not O(n) python-level byte writes.
"""

from __future__ import annotations

import numpy as np

FRAGMENT = 1 << 16  # snappy compresses 64 KiB fragments
COPY_BLOCK = 64     # the block compress(copies=True) matches


def _uvarint(buf, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def scan_tokens(src) -> tuple:
    """Walk the token *headers* only: ``(n_tokens, literal_only)``.

    The cheap structural probe behind two fast paths: the device decoder
    (ops/parquet_decode.py) skips its pointer-doubling chase when every
    page of a chunk is literal-only, and :func:`decompress_fast` collapses
    a literal-only block to slice copies.  High-entropy data and
    already-dict-encoded columns compress to a handful of large literals,
    so this is a few-iteration loop, not a byte-level walk.

    Never raises on corrupt input — callers probing eligibility want a
    verdict, not an exception; the real decoder reports corruption.
    """
    _, pos = _uvarint(src, 0)
    slen = len(src)
    n_tokens = 0
    literal_only = True
    while pos < slen:
        tag = src[pos]
        pos += 1
        n_tokens += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                nbytes = length - 60
                length = int.from_bytes(src[pos:pos + nbytes],
                                        "little") + 1
                pos += nbytes
            pos += length
        else:
            literal_only = False
            pos += (2, 3, 5)[kind - 1] - 1
    return n_tokens, literal_only


def decompress_fast(src: bytes) -> bytes:
    """`decompress` with a zero-parse fast path for literal-only blocks.

    A block whose token scan finds no back-references is just its literals
    concatenated — each token becomes one slice copy (typically ONE for
    page-sized data, since a literal can span 4 GiB).  Anything else falls
    back to the byte-exact sequential decoder.
    """
    n_tokens, literal_only = scan_tokens(src)
    if not literal_only:
        return decompress(src)
    n, pos = _uvarint(src, 0)
    slen = len(src)
    parts = []
    total = 0
    for _ in range(n_tokens):
        tag = src[pos]
        pos += 1
        length = (tag >> 2) + 1
        if length > 60:
            nbytes = length - 60
            length = int.from_bytes(src[pos:pos + nbytes], "little") + 1
            pos += nbytes
        if pos + length > slen:
            raise ValueError("corrupt snappy stream: truncated literal")
        parts.append(src[pos:pos + length])
        pos += length
        total += length
    if total != n:
        raise ValueError(
            f"corrupt snappy stream: wrote {total}, header said {n}")
    return bytes(parts[0]) if len(parts) == 1 else b"".join(parts)


def decompress(src: bytes) -> bytes:
    """Decode one snappy raw block (the whole-page unit Parquet uses)."""
    n, pos = _uvarint(src, 0)
    dst = bytearray(n)
    dpos = 0
    slen = len(src)
    while pos < slen:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                nbytes = length - 60
                length = int.from_bytes(src[pos:pos + nbytes], "little") + 1
                pos += nbytes
            if pos + length > slen:
                raise ValueError("corrupt snappy stream: truncated literal")
            dst[dpos:dpos + length] = src[pos:pos + length]
            pos += length
            dpos += length
            continue
        if kind == 1:  # copy, 1-byte offset, 4..11 length
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag & 0xE0) << 3) | src[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > dpos:
            raise ValueError("corrupt snappy stream: bad copy offset")
        start = dpos - offset
        if offset >= length:
            dst[dpos:dpos + length] = dst[start:start + length]
            dpos += length
        else:
            # overlapping copy: repeat the window by doubling
            pattern = bytes(dst[start:dpos])
            while len(pattern) < length:
                pattern += pattern
            dst[dpos:dpos + length] = pattern[:length]
            dpos += length
    if dpos != n:
        raise ValueError(f"corrupt snappy stream: wrote {dpos}, header said {n}")
    return bytes(dst)


def _varint_bytes(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def compress(data: bytes, copies: bool = False) -> bytes:
    """A snappy raw block of ``data``: literal tokens of at most one 64 KiB
    fragment, plus (``copies``) a copy token wherever a 64-byte block
    repeats an earlier block of its fragment.

    Literal-only output is a valid block that any snappy reader takes, in
    one pass of slice copies; ``copies`` finds the repeats with one
    ``np.unique`` a fragment, so it costs far more time.
    """
    out = [_varint_bytes(len(data))]

    def literal(b):
        n = len(b) - 1
        if n < 60:
            out.append(bytes([n << 2]))
        else:
            nb = (n.bit_length() + 7) // 8
            out.append(bytes([(59 + nb) << 2]) + n.to_bytes(nb, "little"))
        out.append(b)

    u = np.frombuffer(data, np.uint8)
    for f0 in range(0, len(data), FRAGMENT):
        frag = data[f0:f0 + FRAGMENT]
        nb = len(frag) // COPY_BLOCK if copies else 0
        rep, rep_src = [], []
        if nb > 1:
            blocks = u[f0:f0 + nb * COPY_BLOCK].reshape(nb, COPY_BLOCK)
            _, first, inv = np.unique(
                np.ascontiguousarray(blocks).view(f"V{COPY_BLOCK}")[:, 0],
                return_index=True, return_inverse=True)
            src = first[inv.reshape(-1)]
            at = np.flatnonzero(src < np.arange(nb))
            rep, rep_src = at.tolist(), src[at].tolist()
        pos = 0
        for j, sj in zip(rep, rep_src):
            at = j * COPY_BLOCK
            if at > pos:
                literal(frag[pos:at])
            off = (j - sj) * COPY_BLOCK
            out.append(bytes([((COPY_BLOCK - 1) << 2) | 2])
                       + off.to_bytes(2, "little"))
            pos = at + COPY_BLOCK
        if pos < len(frag):
            literal(frag[pos:])
    return b"".join(out)
