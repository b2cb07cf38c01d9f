"""RegexRewrite: lower simple regex patterns onto literal string predicates.

The port of ``spark_rapids_jni_tpu/ops/regex_rewrite.py`` (the reference's
RegexRewrite component): recognize regex patterns that are really literal
prefix/suffix/contains/equality tests and dispatch them to the literal
kernels of ``ops/strings.py`` instead of a regex engine.

    rewrite(pattern)            -> ("startswith"|"endswith"|"contains"|
                                    "equals", literal) or None
    regex_matches(col, pattern) -> BOOL8 column

Recognized shapes (anchors + literal + unbounded wildcards only):
    ^lit$   -> equals        ^lit / ^lit.*  -> startswith
    lit$ / .*lit$ -> endswith    lit / .*lit.* -> contains
Escaped metacharacters (\\.) inside the literal are unescaped.  Other
patterns take the host escape (Python ``re`` over the host strings), as
in the JAX package, counted under the same counter names.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch

from ..columnar import Column
from ..dtypes import BOOL8
from ..utils import tracing
from . import strings as _s

_META = set(".^$*+?()[]{}|\\")


def _scan_literal(pattern: str, i: int) -> tuple[str, int]:
    """Longest literal run starting at i; handles backslash escapes."""
    out = []
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern) and pattern[i + 1] in _META:
            out.append(pattern[i + 1])
            i += 2
        elif ch in _META:
            break
        else:
            out.append(ch)
            i += 1
    return "".join(out), i


def rewrite(pattern: str):
    """Classify ``pattern``; (kind, literal) or None if not rewritable."""
    i, n = 0, len(pattern)
    anchored_start = i < n and pattern[i] == "^"
    if anchored_start:
        i += 1
    if pattern.startswith(".*", i):
        i += 2
        anchored_start = False  # ^.*lit == .*lit
    lit, i = _scan_literal(pattern, i)
    trailing_any = False
    if pattern.startswith(".*", i):
        i += 2
        trailing_any = True
    anchored_end = i < n and pattern[i] == "$"
    if anchored_end:
        i += 1
        if trailing_any:
            anchored_end = False  # lit.*$ == lit.*
    if i != n or not lit:
        return None
    if anchored_start and anchored_end:
        return ("equals", lit)
    if anchored_start:
        return ("startswith", lit)
    if anchored_end:
        return ("endswith", lit)
    return ("contains", lit)


def regex_matches(col: Column, pattern: str,
                  fallback: bool = True) -> Column:
    """RLIKE: the literal kernels when the pattern lowers, else the host
    escape so predicates outside the subset still run (the plugin's CPU
    fallback).  ``fallback=False`` raises instead."""
    rw = rewrite(pattern)
    if rw is None:
        if not fallback:
            raise ValueError(
                f"pattern {pattern!r} is outside the rewritable subset "
                "(literal prefix/suffix/contains/equals)")
        tracing.count("ops.regex.host_fallback")
        tracing.count(f"ops.regex.host_fallback.pattern.{pattern}")
        logging.getLogger(__name__).warning(
            "regex_matches pattern %r is outside the rewritable subset; "
            "falling back to the per-row host loop over %d rows",
            pattern, col.size)
        return _regex_matches_host(col, pattern)
    kind, lit = rw
    if kind == "startswith":
        return _s.starts_with(col, lit)
    if kind == "endswith":
        return _s.ends_with(col, lit)
    if kind == "contains":
        return _s.contains(col, lit)
    sw = _s.starts_with(col, lit)
    eq = (sw.data != 0) & (_s.byte_length(col).data == len(lit.encode()))
    return Column(BOOL8, data=eq.to(torch.uint8), validity=sw.validity)


def _regex_matches_host(col: Column, pattern: str) -> Column:
    """Host RLIKE (Python ``re`` over the Arrow buffers, ``re.ASCII`` as
    Java's classes are), an unanchored search like Spark's; the result goes
    back to the column's device."""
    rx = re.compile(pattern, re.ASCII)
    offs = col.offsets.cpu().numpy().astype(np.int64)
    chars = col.data.cpu().numpy().tobytes() if col.data is not None else b""
    n = offs.shape[0] - 1
    hit = np.zeros(n, np.bool_)
    valid = np.ones(n, np.bool_) if col.validity is None else \
        col.validity.cpu().numpy()
    for i in range(n):
        if valid[i]:
            s = chars[offs[i]:offs[i + 1]].decode("utf-8", "surrogatepass")
            hit[i] = rx.search(s) is not None
    return Column(BOOL8, data=torch.from_numpy(hit.astype(np.uint8))
                  .to(col.device), validity=col.validity)
