"""String ops over Arrow-layout STRING columns.

The port of ``spark_rapids_jni_tpu/ops/strings.py``.  The compute form is
the padded byte matrix (``strings_common.to_padded_bytes``); results are
BOOL8/INT32 columns (predicates) or new STRING columns, built on the
column's device (``from_padded_bytes``; ``split`` builds its LIST<STRING>
there too, where the JAX package assembles it on the host).  Character
semantics follow Spark: ``char_length``/``substring``/pads count UTF-8
characters, not bytes.

These are the building blocks RegexRewrite lowers regexes onto
(startsWith/endsWith/contains, ``regex_rewrite.py``) plus the string
functions NDS queries need.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..columnar import Column
from ..dtypes import BOOL8, INT32
from .strings_common import from_padded_bytes, to_padded_bytes


def _literal(pat) -> bytes:
    return pat.encode() if isinstance(pat, str) else bytes(pat)


def _prop_valid(col: Column, extra=None):
    v = col.validity
    if extra is not None:
        v = extra if v is None else (v & extra)
    return v


def _bool_col(hit: torch.Tensor, validity) -> Column:
    return Column(BOOL8, data=hit.to(torch.uint8), validity=validity)


def _lanes(mat: torch.Tensor, width: int | None = None) -> torch.Tensor:
    w = mat.shape[1] if width is None else width
    return torch.arange(w, device=mat.device)[None, :]


def _char_starts(mat, lengths):
    """bool[n, w]: byte j starts a UTF-8 character of the row."""
    return ((mat & 0xC0) != 0x80) & (_lanes(mat) < lengths[:, None])


def byte_length(col: Column) -> Column:
    """Byte length per row, straight off the offsets."""
    return Column(INT32, data=(col.offsets[1:] - col.offsets[:-1])
                  .to(torch.int32), validity=_prop_valid(col))


def char_length(col: Column) -> Column:
    """Spark ``length()``: UTF-8 character count."""
    mat, lengths = to_padded_bytes(col)
    return Column(INT32, data=_char_starts(mat, lengths).sum(1, dtype=torch
                                                             .int32),
                  validity=_prop_valid(col))


def upper(col: Column) -> Column:
    """ASCII uppercase (multi-byte code points pass through unchanged)."""
    mat, lengths = to_padded_bytes(col)
    out = torch.where((mat >= 97) & (mat <= 122), mat - 32, mat)
    return from_padded_bytes(out, lengths, _prop_valid(col))


def lower(col: Column) -> Column:
    """ASCII lowercase (multi-byte code points pass through unchanged)."""
    mat, lengths = to_padded_bytes(col)
    out = torch.where((mat >= 65) & (mat <= 90), mat + 32, mat)
    return from_padded_bytes(out, lengths, _prop_valid(col))


# ---------------------------------------------------------------------------
# literal search predicates (the RegexRewrite lowering targets)
# ---------------------------------------------------------------------------

def _match_positions(mat, lengths, pat: bytes):
    """bool[n, w]: the window at shift s equals ``pat`` and fits the row."""
    n, w = mat.shape
    if len(pat) == 0:
        return _lanes(mat) <= lengths[:, None]
    padded = F.pad(mat, (0, len(pat)))
    eq = torch.ones((n, w), dtype=torch.bool, device=mat.device)
    for i, b in enumerate(pat):
        eq &= padded[:, i:i + w] == b
    return eq & (_lanes(mat) <= (lengths[:, None] - len(pat)))


def starts_with(col: Column, pat) -> Column:
    pat = _literal(pat)
    mat, lengths = to_padded_bytes(col)
    if len(pat) == 0:
        hit = torch.ones(col.size, dtype=torch.bool, device=mat.device)
    else:
        hit = _match_positions(mat, lengths, pat)[:, 0]
    return _bool_col(hit, _prop_valid(col))


def ends_with(col: Column, pat) -> Column:
    pat = _literal(pat)
    mat, lengths = to_padded_bytes(col)
    if len(pat) == 0:
        hit = torch.ones(col.size, dtype=torch.bool, device=mat.device)
    else:
        pos = _match_positions(mat, lengths, pat)
        tail = (lengths.to(torch.int64) - len(pat)).clamp(0, mat.shape[1] - 1)
        hit = torch.gather(pos, 1, tail[:, None])[:, 0] & \
            (lengths >= len(pat))
    return _bool_col(hit, _prop_valid(col))


def contains(col: Column, pat) -> Column:
    pat = _literal(pat)
    mat, lengths = to_padded_bytes(col)
    if len(pat) == 0:
        hit = torch.ones(col.size, dtype=torch.bool, device=mat.device)
    else:
        hit = _match_positions(mat, lengths, pat).any(dim=1)
    return _bool_col(hit, _prop_valid(col))


def equal(col: Column, other) -> Column:
    """Elementwise ``==`` against a Python string or another STRING column
    (raw ``col.data`` is a chars buffer, so a plain tensor comparison is
    meaningless for strings).  The kernel the engine lowers ``==``/``!=``
    filter predicates over STRING columns onto."""
    mat, lengths = to_padded_bytes(col)
    if isinstance(other, Column):
        omat, olengths = to_padded_bytes(other)
        w = max(mat.shape[1], omat.shape[1])
        mat = F.pad(mat, (0, w - mat.shape[1]))
        omat = F.pad(omat, (0, w - omat.shape[1]))
        hit = (lengths == olengths) & (mat == omat).all(dim=1)
        return _bool_col(hit, _prop_valid(col, other.validity))
    pat = _literal(other)
    if len(pat) == 0:
        hit = lengths == 0
    elif len(pat) > mat.shape[1]:
        hit = torch.zeros(col.size, dtype=torch.bool, device=mat.device)
    else:
        target = torch.from_numpy(np.frombuffer(pat, np.uint8).copy()) \
            .to(mat.device)
        hit = (lengths == len(pat)) & (mat[:, :len(pat)] == target).all(dim=1)
    return _bool_col(hit, _prop_valid(col))


def find(col: Column, pat) -> Column:
    """First byte index of ``pat`` per row, -1 when absent (cudf find())."""
    pat = _literal(pat)
    mat, lengths = to_padded_bytes(col)
    if len(pat) == 0:
        idx = torch.zeros(col.size, dtype=torch.int32, device=mat.device)
    else:
        pos = _match_positions(mat, lengths, pat)
        first = torch.argmax(pos.to(torch.uint8), dim=1)
        idx = torch.where(pos.any(dim=1), first, -1).to(torch.int32)
    return Column(INT32, data=idx, validity=_prop_valid(col))


# ---------------------------------------------------------------------------
# substring (character-based, Spark semantics)
# ---------------------------------------------------------------------------

def _take_bytes(mat, start, out_len):
    """Rows' bytes [start, start + out_len) as a zero-padded matrix of the
    input's width."""
    n, w = mat.shape
    lane = _lanes(mat)
    idx = (start[:, None] + lane).clamp(0, w)
    gathered = torch.gather(F.pad(mat, (0, 1)), 1, idx)
    return torch.where(lane < out_len[:, None], gathered,
                       torch.zeros_like(gathered))


def _substring_matrix(mat, lengths, start: int, length: int | None):
    n, w = mat.shape
    lengths = lengths.to(torch.int64)
    is_start = _char_starts(mat, lengths)
    nchars = is_start.sum(1)
    # byte offset of each character: byte positions scattered into char
    # slots (non-starts park in the spare slot w)
    char_no = torch.where(is_start, torch.cumsum(is_start, 1) - 1, w)
    char_byte = torch.zeros((n, w + 1), dtype=torch.int64, device=mat.device)
    char_byte.scatter_(1, char_no, _lanes(mat).expand(n, w).contiguous())
    # a char index c >= nchars maps to the row's byte length
    char_byte = torch.where(_lanes(mat, w + 1) >= nchars[:, None],
                            lengths[:, None], char_byte)
    # Spark substring: 1-based, 0 treated as 1, negative counts from the end
    if start > 0:
        first = torch.full_like(nchars, start - 1)
    elif start == 0:
        first = torch.zeros_like(nchars)
    else:
        first = (nchars + start).clamp(min=0)
    first = torch.minimum(first, nchars)
    last = nchars if length is None else \
        torch.minimum(first + max(length, 0), nchars)
    sb = torch.gather(char_byte, 1, first[:, None])[:, 0]
    eb = torch.gather(char_byte, 1, last[:, None])[:, 0]
    return _take_bytes(mat, sb, eb - sb), eb - sb


def substring(col: Column, start: int, length: int | None = None) -> Column:
    """Spark ``substring(str, pos[, len])``, character-based."""
    mat, lengths = to_padded_bytes(col)
    out, out_len = _substring_matrix(mat, lengths, int(start),
                                     None if length is None else int(length))
    return from_padded_bytes(out, out_len, _prop_valid(col))


def concat_padded(mats, lens, valids=None):
    """Spark ``concat`` over padded byte matrices: each input row lands at
    its running start offset in an output of width sum(w_k).  Returns
    (u8[n, W] matrix, lengths, valid); null if any input row is null."""
    n = mats[0].shape[0]
    dev = mats[0].device
    W = int(sum(m.shape[1] for m in mats))
    out = torch.zeros((n, W + 1), dtype=torch.uint8, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    for m, ln in zip(mats, lens):
        ln = ln.to(torch.int64)
        lane = _lanes(m)
        tgt = torch.where(lane < ln[:, None], pos[:, None] + lane, W)
        out.scatter_(1, tgt, m)   # dead lanes land in the spare column W
        pos = pos + ln
    valid = None
    for v in valids or ():
        if v is not None:
            valid = v if valid is None else (valid & v)
    return out[:, :W], pos, valid


def concat(*cols: Column) -> Column:
    """Spark ``concat``: null if any input is null."""
    mats, lens, valids = [], [], []
    for c in cols:
        m, ln = to_padded_bytes(c)
        mats.append(m)
        lens.append(ln)
        valids.append(c.validity)
    out, out_len, valid = concat_padded(mats, lens, valids)
    if valid is not None and bool(valid.all()):
        valid = None
    return from_padded_bytes(out, out_len, valid)


# ---------------------------------------------------------------------------
# replace / split: greedy non-overlapping literal matches
# ---------------------------------------------------------------------------

def _greedy_matches(pos, L: int):
    """Left-to-right non-overlapping selection of candidate starts: a start
    is active iff no active start began within the previous L-1 bytes
    (Spark/cudf replace semantics).  One step per byte column."""
    if L <= 1:
        return pos
    n, w = pos.shape
    cool = torch.zeros(n, dtype=torch.int64, device=pos.device)
    act = torch.zeros_like(pos)
    for j in range(w):
        can = (cool == 0) & pos[:, j]
        act[:, j] = can
        cool = torch.where(can, L - 1, (cool - 1).clamp(min=0))
    return act


def _replace_matrix(mat, lengths, pat: bytes, rep: bytes):
    """(out matrix, out lengths) for literal replace-all."""
    n, w = mat.shape
    L, R = len(pat), len(rep)
    lengths = lengths.to(torch.int64)
    act = _greedy_matches(_match_positions(mat, lengths, pat), L)
    c = torch.cumsum(act, 1)                        # inclusive active count
    count = c[:, -1]
    cpad = F.pad(c, (L, 0))
    covered = (c - cpad[:, :w]) > 0                 # byte inside a match
    prior = cpad[:, :w]                             # matches ended before j
    W = w + (w // max(L, 1)) * max(R - L, 0)
    out = torch.zeros((n, W + 1), dtype=torch.uint8, device=mat.device)
    j = _lanes(mat)
    in_str = j < lengths[:, None]
    # pass 1: bytes outside matches, shifted by earlier size deltas
    tgt = torch.where(in_str & ~covered, j + prior * (R - L), W)
    out.scatter_(1, tgt.clamp(0, W), mat)
    # pass 2: the replacement at each active start's shifted position
    start_out = j + (c - 1) * (R - L)
    for r, b in enumerate(rep):
        tr = torch.where(act, start_out + r, W).clamp(0, W)
        out.scatter_(1, tr, torch.full_like(mat, b))
    return out[:, :W], lengths + count * (R - L)


def replace(col: Column, search, replacement) -> Column:
    """Spark ``replace(str, search, replace)``: every non-overlapping
    literal occurrence, left to right; an empty search returns the input."""
    pat = _literal(search)
    rep = _literal(replacement)
    if len(pat) == 0:
        return col
    mat, lengths = to_padded_bytes(col)
    out, out_len = _replace_matrix(mat, lengths, pat, rep)
    return from_padded_bytes(out, out_len, _prop_valid(col))


def _delim_layout(mat, lengths, delim: bytes):
    """(active starts, inclusive count cumsum, total count) of a delimiter."""
    act = _greedy_matches(_match_positions(mat, lengths, delim), len(delim))
    c = torch.cumsum(act, 1)
    return act, c, c[:, -1]


def split_part(col: Column, delim, index: int) -> Column:
    """Spark ``split_part(str, delim, partNum)``: 1-based; negative counts
    from the end; 0 is an error.  Out-of-range parts are empty strings."""
    d = _literal(delim)
    if len(d) == 0 or index == 0:
        raise ValueError("split_part needs a non-empty delimiter and a "
                         "non-zero part number (negative counts from "
                         "the end)")
    mat, lengths = to_padded_bytes(col)
    lengths = lengths.to(torch.int64)
    n, w = mat.shape
    act, c, total = _delim_layout(mat, lengths, d)
    k = torch.full((n,), index - 1, dtype=torch.int64, device=mat.device) \
        if index > 0 else total + 1 + index  # may go negative: out of range

    def nth_start(m):
        """Byte position of the (m+1)-th active delimiter per row."""
        hit = act & (c == m[:, None] + 1)
        any_hit = hit.any(dim=1)
        p = torch.argmax(hit.to(torch.uint8), dim=1)
        return torch.where(any_hit, p, lengths), any_hit

    p, prev_ok = nth_start(k - 1)
    sb = torch.where(k > 0, torch.where(prev_ok, p + len(d), lengths), 0)
    ok = (k == 0) | (prev_ok & (k > 0))
    e, e_ok = nth_start(k)
    eb = torch.where(e_ok, e, lengths)
    have = ok & (k >= 0) & (sb <= lengths)
    out_len = torch.where(have, (eb - sb).clamp(min=0), 0)
    return from_padded_bytes(_take_bytes(mat, sb, out_len), out_len,
                             _prop_valid(col))


def split(col: Column, delim) -> Column:
    """Spark ``split(str, delim)`` with a literal delimiter ->
    LIST<STRING>.  Null rows get empty list ranges (the Arrow convention
    of the engine), not a phantom one-part list."""
    d = _literal(delim)
    if len(d) == 0:
        raise ValueError("split needs a non-empty delimiter")
    mat, lengths = to_padded_bytes(col)
    dev = mat.device
    n, w = mat.shape
    lengths = lengths.to(torch.int64)
    act, _, total = _delim_layout(mat, lengths, d)
    nparts_row = total + 1
    if col.validity is not None:
        v = col.validity
        nparts_row = torch.where(v, nparts_row, 0)
        act = act & v[:, None]
        lengths = torch.where(v, lengths, 0)
    loffsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(nparts_row, 0, out=loffsets[1:])
    # delimiter starts in row-major order split each row into parts; a
    # part's bytes are [previous delimiter end, next delimiter start)
    rows_d, starts_d = torch.nonzero(act, as_tuple=True)
    nparts = int(loffsets[-1])
    part_row = torch.repeat_interleave(torch.arange(n, device=dev),
                                       nparts_row, output_size=nparts)
    nonempty = nparts_row > 0
    first = torch.zeros(nparts, dtype=torch.bool, device=dev)
    first[loffsets[:-1][nonempty]] = True
    last = torch.zeros(nparts, dtype=torch.bool, device=dev)
    last[loffsets[1:][nonempty] - 1] = True
    part_start = torch.zeros(nparts, dtype=torch.int64, device=dev)
    part_start[~first] = starts_d + len(d)
    part_end = lengths[part_row]
    part_end[~last] = starts_d
    plens = (part_end - part_start).clamp(min=0)
    offsets = torch.zeros(nparts + 1, dtype=torch.int64, device=dev)
    torch.cumsum(plens, 0, out=offsets[1:])
    total_bytes = int(offsets[-1])
    if total_bytes > np.iinfo(np.int32).max:
        raise OverflowError("split output exceeds int32 char offsets")
    byte_part = torch.repeat_interleave(torch.arange(nparts, device=dev),
                                        plens, output_size=total_bytes)
    byte_col = part_start[byte_part] + torch.arange(total_bytes, device=dev) \
        - offsets[:-1][byte_part]
    chars = mat[part_row[byte_part], byte_col]
    child = Column.string(chars, offsets.to(torch.int32), device=dev)
    return Column.list_(child, loffsets.to(torch.int32),
                        validity=_prop_valid(col), device=dev)


# ---------------------------------------------------------------------------
# trim / pad
# ---------------------------------------------------------------------------

def _trim_matrix(mat, lengths, trimset: bytes, left: bool, right: bool):
    n, w = mat.shape
    lengths = lengths.to(torch.int64)
    in_str = _lanes(mat) < lengths[:, None]
    is_t = torch.zeros((n, w), dtype=torch.bool, device=mat.device)
    for b in trimset:
        is_t |= mat == b
    is_t &= in_str
    zero = torch.zeros(n, dtype=torch.int64, device=mat.device)
    lead = torch.cumprod(is_t.to(torch.int64), 1).sum(1) if left else zero
    if right:
        tail_t = is_t | ~in_str  # padding counts as trimmable from the right
        trail = (torch.cumprod(tail_t.flip(1).to(torch.int64), 1).sum(1)
                 - (w - lengths)).clamp(min=0)
    else:
        trail = zero
    out_len = (lengths - lead - trail).clamp(min=0)
    return _take_bytes(mat, lead, out_len), out_len


def _trim(col: Column, chars, left: bool, right: bool) -> Column:
    if chars == "" or (isinstance(chars, (bytes, bytearray))
                       and len(chars) == 0):
        return col  # Spark: TRIM('' FROM s) is a no-op
    trimset = chars.encode() if isinstance(chars, str) else \
        b" " if chars is None else bytes(chars)
    if any(b >= 0x80 for b in trimset):
        # a byte-wise match of a multi-byte trim character would strip
        # single UTF-8 bytes and corrupt the row
        raise ValueError("only ASCII trim characters are supported")
    mat, lengths = to_padded_bytes(col)
    out, out_len = _trim_matrix(mat, lengths, trimset, left, right)
    return from_padded_bytes(out, out_len, _prop_valid(col))


def trim(col: Column, chars: str | None = None) -> Column:
    """Spark ``trim``: strip leading and trailing characters (default
    space).  The trim set must be ASCII; an empty set is a no-op."""
    return _trim(col, chars, True, True)


def ltrim(col: Column, chars: str | None = None) -> Column:
    return _trim(col, chars, True, False)


def rtrim(col: Column, chars: str | None = None) -> Column:
    return _trim(col, chars, False, True)


def _pad_matrix(mat, lengths, width: int, pad: bytes, left: bool):
    dev = mat.device
    nchars = _char_starts(mat, lengths).sum(1)
    pad_count = (width - nchars).clamp(0, width)
    cyc = torch.tensor([pad[i % len(pad)] for i in range(width)],
                       dtype=torch.uint8, device=dev)
    padmat = torch.where(_lanes(mat, width) < pad_count[:, None],
                         cyc[None, :], torch.zeros_like(cyc)[None, :])
    tmat, tlen = _substring_matrix(mat, lengths, 1, width)  # <= width chars
    parts = [(padmat, pad_count), (tmat, tlen)]
    if not left:
        parts.reverse()
    out, out_len, _ = concat_padded([p[0] for p in parts],
                                    [p[1] for p in parts])
    return out, out_len


def _pad(col: Column, width: int, pad: str, left: bool) -> Column:
    pb = pad.encode()
    if not pb:
        raise ValueError("pad string must be non-empty")
    if any(b >= 0x80 for b in pb):
        raise ValueError("only ASCII pad strings are supported")
    mat, lengths = to_padded_bytes(col)
    out, out_len = _pad_matrix(mat, lengths, int(width), pb, left)
    return from_padded_bytes(out, out_len, _prop_valid(col))


def lpad(col: Column, width: int, pad: str = " ") -> Column:
    """Spark ``lpad``: left-pad (cycling ``pad``) to ``width`` characters;
    longer strings truncate to their first ``width`` characters."""
    return _pad(col, width, pad, True)


def rpad(col: Column, width: int, pad: str = " ") -> Column:
    return _pad(col, width, pad, False)


# ---------------------------------------------------------------------------
# SQL LIKE (%, _)
# ---------------------------------------------------------------------------

def _parse_like(pattern: str, escape: str = "\\"):
    toks = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            toks.append(("lit", pattern[i + 1].encode()))
            i += 2
        elif ch == "%":
            toks.append(("any", None))
            i += 1
        elif ch == "_":
            toks.append(("one", None))
            i += 1
        else:
            toks.append(("lit", ch.encode()))
            i += 1
    return tuple(toks)


def like(col: Column, pattern: str, escape: str = "\\") -> Column:
    """SQL LIKE: an NFA over byte positions, one vectorized step per
    token.  ``_`` matches one byte (multi-byte characters under ``_`` are
    a known divergence, as in cudf's byte-based like)."""
    toks = _parse_like(pattern, escape)
    mat, lengths = to_padded_bytes(col)
    n, w = mat.shape
    lengths = lengths.to(torch.int64)
    # reach[i, j]: the pattern prefix consumed exactly j bytes of row i
    reach = (_lanes(mat, w + 1) == 0).expand(n, w + 1)
    inb = _lanes(mat) < lengths[:, None]
    for kind, lit in toks:
        if kind == "lit":
            for b in lit:  # multi-byte UTF-8 pattern chars consume per byte
                reach = F.pad(reach[:, :-1] & (mat == b) & inb, (1, 0))
        elif kind == "one":
            reach = F.pad(reach[:, :-1] & inb, (1, 0))
        else:  # '%': any number of bytes, a prefix-or to the right
            reach = torch.cumsum(reach.to(torch.int32), 1) > 0
    hit = torch.gather(reach, 1, lengths[:, None])[:, 0]
    return _bool_col(hit, _prop_valid(col))
