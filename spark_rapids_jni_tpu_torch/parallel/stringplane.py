"""Strings in the exchange's data plane: padded-bucket explosion.

The port of ``spark_rapids_jni_tpu/parallel/stringplane.py``.  Row blobs
move fixed-width words, and an Arrow STRING column (chars + n+1 offsets)
has neither a per-row width nor a row-shardable layout.  Before a table
enters the mesh every STRING column *explodes* into fixed-width columns:

    s  ->  s#len : INT32   (byte length, carries the validity)
           s#w0.. : UINT32 (the padded bytes, 4 a word little-endian,
                            zero beyond the row's length)

which shard, ride the row words through the exchange, group and join like
any other fixed-width columns.  Zero padding and the length column make
multi-key equality over (len, words...) exactly string equality.
``reassemble_strings`` inverts it.  The bucket width is the longest row
rounded up to a power of two (``strings_common.pad_width_bucket``), fixed
at explode time for every shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..columnar import Column, Table
from ..dtypes import INT32, UINT32
from ..ops.strings_common import from_padded_bytes, to_padded_bytes

LEN_SUFFIX = "#len"
WORD_SUFFIX = "#w"


@dataclass(frozen=True)
class StringPlan:
    """Static recipe mapping original columns <-> exploded fixed columns."""

    names: tuple  # original column names
    specs: tuple  # per column: ("fixed",) | ("string", nwords)

    def exploded_keys(self, key_names) -> list:
        """Map column names to their exploded column names."""
        spec_of = dict(zip(self.names, self.specs))
        out = []
        for k in key_names:
            spec = spec_of[k]
            if spec[0] == "fixed":
                out.append(k)
            else:
                out.append(f"{k}{LEN_SUFFIX}")
                out.extend(f"{k}{WORD_SUFFIX}{i}" for i in range(spec[1]))
        return out


def explode_strings(table: Table, width_overrides: dict | None = None
                    ) -> tuple[Table, StringPlan]:
    """Replace every STRING column with its fixed-width padded-bucket form.

    ``width_overrides`` maps a column name to a minimum byte width: join
    paths explode both sides of a string key at one width, since the word
    count is part of the multi-key identity.
    """
    names = tuple(table.names or [f"c{i}" for i in range(table.num_columns)])
    cols, out_names, specs = [], [], []
    for nm, c in zip(names, table.columns):
        if not c.dtype.is_string:
            cols.append(c)
            out_names.append(nm)
            specs.append(("fixed",))
            continue
        mat, lengths = to_padded_bytes(
            c, width=(width_overrides or {}).get(nm))
        n, w = mat.shape
        nwords = max((w + 3) // 4, 1)
        if w < nwords * 4:
            mat = torch.nn.functional.pad(mat, (0, nwords * 4 - w))
        # null rows must not carry stray bytes into group/join equality
        if c.validity is not None:
            mat = torch.where(c.validity[:, None], mat, torch.zeros_like(mat))
            lengths = torch.where(c.validity, lengths,
                                  torch.zeros_like(lengths))
        words = mat.contiguous().view(torch.int32).reshape(n, nwords)
        cols.append(Column(INT32, data=lengths.to(torch.int32),
                           validity=c.validity))
        out_names.append(f"{nm}{LEN_SUFFIX}")
        for i in range(nwords):
            cols.append(Column(UINT32, data=words[:, i].contiguous(),
                               validity=c.validity))
            out_names.append(f"{nm}{WORD_SUFFIX}{i}")
        specs.append(("string", nwords))
    return Table(cols, out_names), StringPlan(names, tuple(specs))


def reassemble_strings(table: Table, plan: StringPlan) -> Table:
    """Invert ``explode_strings``."""
    cols, idx = [], 0
    for nm, spec in zip(plan.names, plan.specs):
        if spec[0] == "fixed":
            cols.append(table.columns[idx])
            idx += 1
            continue
        nwords = spec[1]
        len_col = table.columns[idx]
        word_cols = table.columns[idx + 1:idx + 1 + nwords]
        idx += 1 + nwords
        words = torch.stack([c.data.view(torch.int32) for c in word_cols],
                            dim=1)
        mat = words.contiguous().view(torch.uint8).reshape(
            words.shape[0], nwords * 4)
        valid = len_col.validity
        lengths = len_col.data
        if valid is not None:
            lengths = torch.where(valid, lengths, torch.zeros_like(lengths))
        has_null = valid is not None and not bool(valid.all())
        cols.append(from_padded_bytes(mat, lengths,
                                      valid if has_null else None))
    return Table(cols, list(plan.names))
