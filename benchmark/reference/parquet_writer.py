"""A flat Parquet writer in NumPy, frozen for the benchmark.

A copy of the writer that ``chip_smoke.py`` carries, with the thrift
compact encoder of ``io/thrift.py`` and the literal-only snappy of
``io/snappy.py`` folded in, so that nothing here imports the program and a
change to the program cannot move the files the benchmark scans.

``write_parquet`` writes V1 data pages: dictionary columns as a PLAIN
dictionary page plus RLE_DICTIONARY data pages, the rest PLAIN; nulls as
RLE definition levels; snappy as literal tokens of at most one 64 KiB
fragment.  It returns the layout it wrote (rows, and per column chunk its
bytes on disk and its min/max), from which the benchmark counts the bytes a
scan has to move.
"""

from __future__ import annotations

import os

import numpy as np

# parquet.thrift ids
PHYS = {"bool": 0, "int32": 1, "int64": 2, "float32": 4, "float64": 5,
        "string": 6}
ENC_PLAIN, ENC_RLE, ENC_RLE_DICT = 0, 3, 8
CODEC = {"none": 0, "snappy": 1}
PAGE_BYTES = 1 << 20  # largest uncompressed data page
FRAGMENT = 1 << 16    # snappy compresses 64 KiB fragments

# thrift compact-protocol type ids
T_I32, T_I64, T_BINARY, T_LIST, T_STRUCT = 5, 6, 8, 9, 12


def uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _zigzag(n: int) -> bytes:
    return uvarint((n << 1) ^ (n >> 63) if n < 0 else n << 1)


def _enc_value(out: bytearray, ttype: int, value) -> None:
    if ttype in (T_I32, T_I64):
        out.extend(_zigzag(int(value)))
    elif ttype == T_BINARY:
        data = value.encode() if isinstance(value, str) else bytes(value)
        out.extend(uvarint(len(data)))
        out.extend(data)
    elif ttype == T_LIST:
        etype, items = value
        if len(items) < 15:
            out.append((len(items) << 4) | etype)
        else:
            out.append(0xF0 | etype)
            out.extend(uvarint(len(items)))
        for it in items:
            _enc_value(out, etype, it)
    elif ttype == T_STRUCT:
        out.extend(encode_struct(value))
    else:
        raise ValueError(f"unsupported thrift encode type {ttype}")


def encode_struct(fields) -> bytes:
    """[(field_id, type, value), ...] (ids ascending; None values skipped)
    as thrift compact bytes."""
    out = bytearray()
    last_id = 0
    for fid, ttype, value in fields:
        if value is None:
            continue
        delta = fid - last_id
        if 0 < delta <= 15:
            out.append((delta << 4) | ttype)
        else:
            out.append(ttype)
            out.extend(_zigzag(fid))
        last_id = fid
        _enc_value(out, ttype, value)
    out.append(0)
    return bytes(out)


def snappy_literals(data: bytes) -> bytes:
    """A snappy raw block of ``data`` made of literal tokens, one a 64 KiB
    fragment: a valid block that any snappy reader takes."""
    out = [uvarint(len(data))]
    for f0 in range(0, len(data), FRAGMENT):
        frag = data[f0:f0 + FRAGMENT]
        n = len(frag) - 1
        if n < 60:
            out.append(bytes([n << 2]))
        else:
            nb = (n.bit_length() + 7) // 8
            out.append(bytes([(59 + nb) << 2]) + n.to_bytes(nb, "little"))
        out.append(frag)
    return b"".join(out)


def rle_hybrid_encode(values: np.ndarray, bw: int) -> bytes:
    """Parquet's RLE/bit-packed hybrid of ``values`` (ints < 2^bw): runs of
    whole 8-value groups that repeat one value become RLE runs, every other
    stretch of groups one bit-packed run (the last group zero-padded)."""
    n = len(values)
    ng = -(-n // 8)
    v = np.zeros(ng * 8, np.uint32)  # bw <= 32
    v[:n] = values
    grp = v.reshape(ng, 8)
    const = (grp == grp[:, :1]).all(axis=1)
    if n % 8:
        const[-1] = False
    gval = grp[:, 0]
    new = np.ones(ng, np.bool_)
    new[1:] = (const[1:] != const[:-1]) | (const[1:] & (gval[1:] != gval[:-1]))
    starts = np.flatnonzero(new)
    k = np.diff(np.append(starts, ng))
    rle = const[starts]
    bits = v.astype(np.uint8) if bw == 1 else \
        ((v[:, None] >> np.arange(bw, dtype=np.uint32)) & 1).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little")
    bwb = (bw + 7) // 8
    # each run: its header (a uvarint) and its payload, cut from one buffer
    # of [headers, RLE values, bit-packed groups] by a gather
    gval = gval.astype(np.int64)
    hdr = np.where(rle, (8 * k) << 1, (k << 1) | 1)
    nb = 1 + sum((hdr >> (7 * i) > 0).astype(np.int64) for i in range(1, 5))
    i5 = np.arange(5)
    heads = ((hdr[:, None] >> (7 * i5)) & 0x7F) | np.where(
        i5 < nb[:, None] - 1, 0x80, 0)
    vals = (gval[starts][:, None] >> (8 * np.arange(bwb))) & 0xFF
    src = np.concatenate([heads.astype(np.uint8).reshape(-1),
                          vals.astype(np.uint8).reshape(-1), packed])
    r = np.arange(len(starts))
    pay = np.where(rle, 5 * len(r) + r * bwb,
                   5 * len(r) + bwb * len(r) + starts * bw)
    seg_src = np.stack([5 * r, pay], 1).reshape(-1)
    seg_len = np.stack([nb, np.where(rle, bwb, k * bw)], 1).reshape(-1)
    first = np.cumsum(seg_len) - seg_len
    idx = np.repeat(seg_src - first, seg_len) + np.arange(seg_len.sum())
    return src[idx].tobytes()


def _plain_bytes(kind: str, vals) -> bytes:
    if kind == "bool":
        return np.packbits(np.asarray(vals, np.uint8),
                           bitorder="little").tobytes()
    if kind == "string":
        return b"".join(len(b).to_bytes(4, "little") + b for b in vals)
    return np.ascontiguousarray(vals).tobytes()


def _page(ptype: int, body: bytes, codec: str, sub: tuple) -> bytes:
    """(header + compressed body) of one page."""
    comp = snappy_literals(body) if codec == "snappy" else body
    hdr = encode_struct([(1, T_I32, ptype), (2, T_I32, len(body)),
                         (3, T_I32, len(comp)), sub])
    return hdr + comp


def write_parquet(path, columns, group_rows: int, codec: str = "snappy",
                  page_bytes: int = PAGE_BYTES) -> list:
    """Write a flat Parquet file; return its layout.

    ``columns``: [(name, kind, values, valid, dictionary)] with kind one of
    int32/int64/float32/float64/bool (numpy arrays) or string (a list of
    bytes); ``valid`` is a bool array or None (a REQUIRED column).  Data
    pages hold at most ``page_bytes`` uncompressed; every fixed-width chunk
    carries min/max statistics.

    The layout is one dict a row group: ``{"rows": n, "columns": {name:
    {"disk_bytes", "uncompressed_bytes", "min", "max"}}}``.
    """
    with open(path, "wb") as f:
        layout = _write(f, columns, group_rows, codec, page_bytes)
        f.flush()
        os.fsync(f.fileno())  # on disk before the caller times anything
    return layout


def _write(f, columns, group_rows: int, codec: str, page_bytes: int) -> list:
    n = len(columns[0][2])
    f.write(b"PAR1")
    at = 4
    groups, layout = [], []
    for g0 in range(0, max(n, 1), group_rows):
        g1 = min(n, g0 + group_rows)
        chunks, gbytes, glay = [], 0, {}
        for name, kind, values, valid, dictionary in columns:
            vals = values[g0:g1]
            ok = None if valid is None else np.asarray(valid[g0:g1], np.bool_)
            nn = vals if ok is None else (
                [b for b, o in zip(vals, ok) if o] if kind == "string"
                else vals[ok])
            start, parts, unc = at, [], 0
            dict_off = None
            if dictionary:
                dvals, idx = np.unique(nn, return_inverse=True)
                bw = max(1, int(len(dvals) - 1).bit_length())
                body = _plain_bytes(kind, dvals)
                parts.append(_page(2, body, codec,
                                   (7, T_STRUCT, [(1, T_I32, len(dvals)),
                                                  (2, T_I32, ENC_PLAIN)])))
                unc += len(body)
                dict_off = at
                per_value = bw + 2  # worst case: alternating short runs
            else:
                idx = None
                per_value = 1 if kind == "bool" else (
                    8 * (4 + max(map(len, nn), default=0))
                    if kind == "string" else 8 * np.dtype(kind).itemsize)
            per_row = per_value + (2 if ok is not None else 0)
            rows_pp = max(8, (page_bytes - min(4096, page_bytes // 8)) * 8
                          // per_row)
            data_off = at + sum(len(p) for p in parts)
            k = 0  # non-null values written so far
            for p0 in range(0, g1 - g0, rows_pp):
                p1 = min(g1 - g0, p0 + rows_pp)
                body = b""
                m = p1 - p0
                if ok is not None:
                    lv = rle_hybrid_encode(ok[p0:p1].astype(np.int64), 1)
                    body = len(lv).to_bytes(4, "little") + lv
                    m = int(ok[p0:p1].sum())
                if dictionary:
                    body += bytes([bw]) + rle_hybrid_encode(idx[k:k + m], bw)
                else:
                    body += _plain_bytes(kind, nn[k:k + m])
                k += m
                if len(body) > page_bytes:
                    raise AssertionError("data page over its byte budget")
                parts.append(_page(0, body, codec, (5, T_STRUCT, [
                    (1, T_I32, p1 - p0),
                    (2, T_I32, ENC_RLE_DICT if dictionary else ENC_PLAIN),
                    (3, T_I32, ENC_RLE), (4, T_I32, ENC_RLE)])))
                unc += len(body)
            blob = b"".join(parts)
            f.write(blob)
            at += len(blob)
            stats = None
            lo = hi = None
            if kind not in ("bool", "string") and len(nn):
                lo, hi = np.asarray(nn).min(), np.asarray(nn).max()
                stats = [(3, T_I64, 0 if ok is None else int((~ok).sum())),
                         (5, T_BINARY, hi.tobytes()),
                         (6, T_BINARY, lo.tobytes())]
            encs = [ENC_PLAIN, ENC_RLE] + ([ENC_RLE_DICT] if dictionary
                                           else [])
            meta = [(1, T_I32, PHYS[kind]), (2, T_LIST, (T_I32, encs)),
                    (3, T_LIST, (T_BINARY, [name])),
                    (4, T_I32, CODEC[codec]), (5, T_I64, g1 - g0),
                    (6, T_I64, unc), (7, T_I64, len(blob)),
                    (9, T_I64, data_off), (11, T_I64, dict_off),
                    (12, T_STRUCT, stats)]
            chunks.append([(2, T_I64, start), (3, T_STRUCT, meta)])
            gbytes += unc
            glay[name] = {"disk_bytes": len(blob), "uncompressed_bytes": unc,
                          "min": None if lo is None else lo.item(),
                          "max": None if hi is None else hi.item()}
        groups.append([(1, T_LIST, (T_STRUCT, chunks)),
                       (2, T_I64, gbytes), (3, T_I64, g1 - g0)])
        layout.append({"rows": g1 - g0, "columns": glay})
        if n == 0:
            break
    schema = [[(4, T_BINARY, "schema"), (5, T_I32, len(columns))]]
    for name, kind, _, valid, _ in columns:
        schema.append([(1, T_I32, PHYS[kind]),
                       (3, T_I32, 0 if valid is None else 1),
                       (4, T_BINARY, name),
                       (6, T_I32, 0 if kind == "string" else None)])
    footer = encode_struct([(1, T_I32, 1),
                            (2, T_LIST, (T_STRUCT, schema)),
                            (3, T_I64, n),
                            (4, T_LIST, (T_STRUCT, groups))])
    f.write(footer + len(footer).to_bytes(4, "little") + b"PAR1")
    return layout

