"""Equi-joins: inner, left-semi and left-anti (plus the prepared-build probe).

The port of ``spark_rapids_jni_tpu/ops/join.py``, in its five steps:

    1. key each side with xxhash64 over the join columns (``ops/hash.py``)
    2. stable-sort the build side by the low 32 bits of its hash
    3. candidate range [lo, hi) per probe row in the sorted build side
    4. expand the ranges to (probe row, build row) pairs
    5. verify true key equality per pair (hash collisions filtered exactly)

The JAX package replaces ``searchsorted`` by a merge-rank sort and expands
pairs with a marker/filler sort, because binary search and data-dependent
repeats serialize on a TPU.  On a GPU both are native: step 3 is two
``torch.searchsorted`` calls and step 4 is ``repeat_interleave``.  The pair
order is the JAX package's: probe rows ascending, and within a probe row the
build rows in stable hash order.  The expansion size is data-dependent (it
is the candidate count), so it costs one host sync, where cudf returns its
gather-map size; compacting the verified pairs costs the second.

Null join keys never match (SQL equi-join semantics); ``null_equal=True``
is null-safe equality (``<=>``).  The outer joins append the unmatched rows
after the matched pairs, with the other side null, as the JAX package does;
``cross_join`` pairs every left row with every right row, left-major.
Entry points take ``device=`` (default ``"cuda"``) and move their inputs
there.  ``sort_merge_join`` (the bridge's surface) is not ported yet.
"""

from __future__ import annotations

import torch

from .. import device as _device
from ..columnar import Column, Table
from ..dtypes import TypeId
from ..utils.floatbits import f32_bits_u, normalize_f32_bits, \
    normalize_f64_bits
from ..utils.tracing import traced
from .hash import xxhash64
from .order import SortKey, encode_keys, lexsort, rows_differ_from_prev
from .selection import gather_table
from .strings_common import to_padded_bytes

_I32 = torch.int32
_I64 = torch.int64


def _key_table(table: Table, on) -> Table:
    return Table([table.column(k) for k in on])


def _pair_equal(lcol: Column, rcol: Column, li, ri, null_equal: bool):
    """Per-pair true equality of key values at rows (li, ri)."""
    lv = lcol.valid_mask()[li]
    rv = rcol.valid_mask()[ri]
    if lcol.dtype.is_string:
        lmat, llen = to_padded_bytes(lcol)
        rmat, rlen = to_padded_bytes(rcol)
        w = max(lmat.shape[1], rmat.shape[1])
        lmat = torch.nn.functional.pad(lmat, (0, w - lmat.shape[1]))
        rmat = torch.nn.functional.pad(rmat, (0, w - rmat.shape[1]))
        eq = (llen[li] == rlen[ri]) & (lmat[li] == rmat[ri]).all(dim=1)
    elif lcol.dtype.id == TypeId.FLOAT64:
        # normalized bit patterns: -0.0 = 0.0, NaN matches NaN (Spark
        # join-key float normalization)
        ln = normalize_f64_bits(lcol.data.view(_I64))
        rn = normalize_f64_bits(rcol.data.view(_I64))
        eq = ln[li] == rn[ri]
    elif lcol.dtype.id == TypeId.FLOAT32:
        ln = normalize_f32_bits(f32_bits_u(lcol.data))
        rn = normalize_f32_bits(f32_bits_u(rcol.data))
        eq = ln[li] == rn[ri]
    else:
        eq = lcol.data[li] == rcol.data[ri]
        if eq.dim() > 1:  # DECIMAL128 limb pairs
            eq = eq.all(dim=1)
    if null_equal:
        return torch.where(lv & rv, eq, lv == rv)
    return eq & lv & rv


def _sentinel_hashes(h, live, odd: bool):
    """Dead rows get per-row sentinels (even on the build side, odd on the
    probe side) so a block of dead rows cannot match itself."""
    if live is None:
        return h
    iota = torch.arange(h.shape[0], dtype=h.dtype, device=h.device)
    return torch.where(live, h, iota * 2 + (1 if odd else 0))


def _build_sort(rh):
    """Cast to the 32-bit rank domain and stable-sort once: (rh32,
    rh_sorted, r_order)."""
    rh = rh.to(_I32)
    rh_sorted, r_order = torch.sort(rh, stable=True)
    return rh, rh_sorted, r_order


def _rank_bounds(rh_sorted, lh32):
    """(lo, hi): count of build hashes < / <= each probe hash."""
    lo = torch.searchsorted(rh_sorted, lh32)
    hi = torch.searchsorted(rh_sorted, lh32, right=True)
    return lo, hi


def _probe_ranges(lh, rh):
    """Sorted-probe prelude.  Returns (r_order, lo, counts, expansion):
    probe row i's candidates are the sorted build positions
    [lo[i], lo[i] + counts[i]); ``expansion`` (a 0-d tensor) is their sum.

    Ranking runs on the LOW 32 BITS of the hashes, as in the JAX package: a
    32-bit collision only widens a candidate range, and the exact per-pair
    verification filters it like a full hash collision."""
    _, rh_sorted, r_order = _build_sort(rh)
    lo, hi = _rank_bounds(rh_sorted, lh.to(_I32))
    counts = hi - lo
    return r_order, lo, counts, counts.sum()


def _expand_pairs(r_order, lo, counts, total: int):
    """All candidate pairs, probe-row-major: (li, ri) int64[total]."""
    dev = lo.device
    nl = lo.shape[0]
    li = torch.repeat_interleave(torch.arange(nl, device=dev), counts,
                                 output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(total, device=dev) - starts[li]
    return li, r_order[lo[li] + within]


def _candidates(left: Table, right: Table, on_left, on_right):
    """Verified candidate pairs (li, ri, eq) — one host sync, for the
    candidate count."""
    lk = _key_table(left, on_left)
    rk = _key_table(right, on_right)
    dev = left.columns[0].device if left.columns else \
        right.columns[0].device
    lh = xxhash64(lk, device=dev).data
    rh = xxhash64(rk, device=dev).data
    r_order, lo, counts, expansion = _probe_ranges(lh, rh)
    total = int(expansion) if left.num_rows else 0
    if total == 0:
        z = torch.zeros(0, dtype=_I64, device=dev)
        return z, z, torch.zeros(0, dtype=torch.bool, device=dev)
    li, ri = _expand_pairs(r_order, lo, counts, total)
    eq = torch.ones(total, dtype=torch.bool, device=dev)
    for lc, rc in zip(lk.columns, rk.columns):
        eq = eq & _pair_equal(lc, rc, li, ri, null_equal=False)
    return li, ri, eq


def _compact_pairs(li, ri, eq):
    """Keep the true-equal pairs, in order (one host sync)."""
    sel = torch.nonzero(eq, as_tuple=True)[0]
    return li[sel], ri[sel]


def _matched(idx, eq, n: int):
    """bool[n]: which of ``n`` rows appear in a verified pair."""
    hit = torch.zeros(n, dtype=_I64, device=eq.device)
    if idx.shape[0]:
        hit.scatter_reduce_(0, idx, eq.to(_I64), "amax")
    return hit > 0


def _unmatched(idx, eq, n: int):
    """Indices of the rows of ``n`` that match nothing, ascending."""
    return torch.nonzero(~_matched(idx, eq, n), as_tuple=True)[0]


def _on_device(table: Table, dev: torch.device) -> Table:
    return table if not table.columns else table.to(dev)


@traced("inner_join")
def inner_join(left: Table, right: Table, on_left, on_right=None,
               suffixes=("", "_r"), device=_device.DEFAULT) -> Table:
    """Inner equi-join; returns left columns then right non-key columns."""
    dev = _device.resolve(device)
    left, right = _on_device(left, dev), _on_device(right, dev)
    on_right = on_right or on_left
    li, ri, eq = _candidates(left, right, on_left, on_right)
    li, ri = _compact_pairs(li, ri, eq)
    return _assemble(left, right, li, ri, on_right, suffixes)


@traced("left_join")
def left_join(left: Table, right: Table, on_left, on_right=None,
              suffixes=("", "_r"), device=_device.DEFAULT) -> Table:
    """Left outer equi-join: the matched pairs, then each unmatched left
    row with its right columns null."""
    dev = _device.resolve(device)
    left, right = _on_device(left, dev), _on_device(right, dev)
    on_right = on_right or on_left
    li, ri, eq = _candidates(left, right, on_left, on_right)
    un = _unmatched(li, eq, left.num_rows)
    li_m, ri_m = _compact_pairs(li, ri, eq)
    li_all = torch.cat([li_m, un])
    ri_all = torch.cat([ri_m, torch.full_like(un, -1)])
    return _assemble(left, right, li_all, ri_all, on_right, suffixes,
                     right_valid=ri_all >= 0)


@traced("right_join")
def right_join(left: Table, right: Table, on_left, on_right=None,
               suffixes=("", "_r"), device=_device.DEFAULT) -> Table:
    """Right outer equi-join: the matched pairs, then each unmatched right
    row with its left columns null.  Left columns then right non-key
    columns, as every join here; the key columns take the right side's
    values on the unmatched rows."""
    dev = _device.resolve(device)
    left, right = _on_device(left, dev), _on_device(right, dev)
    on_right = on_right or on_left
    li, ri, eq = _candidates(left, right, on_left, on_right)
    un = _unmatched(ri, eq, right.num_rows)
    li_m, ri_m = _compact_pairs(li, ri, eq)
    li_all = torch.cat([li_m, torch.full_like(un, -1)])
    ri_all = torch.cat([ri_m, un])
    return _assemble_outer(left, right, li_all, ri_all, on_left, on_right,
                           suffixes, left_valid=li_all >= 0,
                           right_valid=None)


@traced("full_join")
def full_join(left: Table, right: Table, on_left, on_right=None,
              suffixes=("", "_r"), device=_device.DEFAULT) -> Table:
    """Full outer equi-join: the matched pairs, the unmatched left rows
    (right side null), then the unmatched right rows (left side null, keys
    from the right)."""
    dev = _device.resolve(device)
    left, right = _on_device(left, dev), _on_device(right, dev)
    on_right = on_right or on_left
    li, ri, eq = _candidates(left, right, on_left, on_right)
    ul = _unmatched(li, eq, left.num_rows)
    ur = _unmatched(ri, eq, right.num_rows)
    li_m, ri_m = _compact_pairs(li, ri, eq)
    li_all = torch.cat([li_m, ul, torch.full_like(ur, -1)])
    ri_all = torch.cat([ri_m, torch.full_like(ul, -1), ur])
    return _assemble_outer(left, right, li_all, ri_all, on_left, on_right,
                           suffixes, left_valid=li_all >= 0,
                           right_valid=ri_all >= 0)


@traced("cross_join")
def cross_join(left: Table, right: Table, suffixes=("", "_r"),
               device=_device.DEFAULT) -> Table:
    """Cartesian product: every left row paired with every right row,
    left-major order; all columns of both sides kept."""
    dev = _device.resolve(device)
    left, right = _on_device(left, dev), _on_device(right, dev)
    nl, nr = left.num_rows, right.num_rows
    li = torch.arange(nl, device=dev).repeat_interleave(nr)
    ri = torch.arange(nr, device=dev).repeat(nl)
    return _assemble(left, right, li, ri, (), suffixes)


def inner_join_padded(left: Table, right: Table, on_left, on_right,
                      capacity: int, left_live=None, right_live=None,
                      pack: bool = True, device=_device.DEFAULT):
    """Inner join at a static pair ``capacity``, without a host sync.

    Returns (li, ri, live, npairs, overflow): int32 pair indices padded to
    ``capacity``, the live mask, the live pair count, and the count of
    candidate pairs that did not fit (an upper bound on lost true pairs).
    With ``pack=True`` the live pairs come first, in candidate order;
    ``pack=False`` leaves them in candidate order with ``live`` as a mask.
    Candidate order is the JAX package's: when ``capacity >= len(left)``
    each probe row's first candidate sits at slot i (the foreign-key fast
    path) and the surplus candidates of duplicate keys follow.
    ``left_live``/``right_live`` mark live rows of padded inputs.
    """
    dev = _device.resolve(device)
    left, right = _on_device(left, dev), _on_device(right, dev)
    on_right = on_right or on_left
    lk = _key_table(left, on_left)
    rk = _key_table(right, on_right)
    if left_live is not None:
        left_live = left_live.to(dev)
    if right_live is not None:
        right_live = right_live.to(dev)
    lh = _sentinel_hashes(xxhash64(lk, device=dev).data, left_live, True)
    rh = _sentinel_hashes(xxhash64(rk, device=dev).data, right_live, False)
    r_order, lo, counts, expansion = _probe_ranges(lh, rh)
    nl, nr = lh.shape[0], rh.shape[0]
    r_last = max(nr - 1, 0)

    def expand(first, cnt, cap):
        """``cap`` candidate slots: (li, ri, in_range), no sync."""
        offsets = torch.cumsum(cnt, 0)
        starts = offsets - cnt
        j = torch.arange(cap, device=dev)
        if nl == 0:
            z = torch.zeros(cap, dtype=_I64, device=dev)
            return z, z, torch.zeros(cap, dtype=torch.bool, device=dev)
        # owner of slot j: the last row whose run starts at or before j
        li = torch.searchsorted(offsets, j, right=True).clamp(max=nl - 1)
        in_range = j < offsets[-1]
        pos = (first[li] + j - starts[li]).clamp(0, r_last)
        ri = r_order[pos] if nr else torch.zeros_like(pos)
        return li, ri, in_range

    if capacity >= nl:
        ri_d = r_order[lo.clamp(0, r_last)] if nr else \
            torch.zeros(nl, dtype=_I64, device=dev)
        xcounts = (counts - 1).clamp(min=0)
        xcap = capacity - nl
        li_x, ri_x, ok_x = expand(lo + 1, xcounts, xcap)
        li = torch.cat([torch.arange(nl, device=dev), li_x])
        ri = torch.cat([ri_d.to(_I64), ri_x.to(_I64)])
        in_range = torch.cat([counts > 0, ok_x])
        overflow = (xcounts.sum() - xcap).clamp(min=0)
    else:
        li, ri, in_range = expand(lo, counts, capacity)
        overflow = (expansion - capacity).clamp(min=0)
    eq = in_range
    if left_live is not None:
        eq = eq & left_live[li]
    if right_live is not None and nr:
        eq = eq & right_live[ri]
    for lc, rc in zip(lk.columns, rk.columns):
        if rc.size == 0:
            eq = torch.zeros_like(eq)
            break
        eq = eq & _pair_equal(lc, rc, li, ri, null_equal=False)
    npairs = eq.sum().to(_I32)
    li, ri = li.to(_I32), ri.to(_I32)
    if not pack:
        return li, ri, eq, npairs, overflow
    order = torch.sort((~eq).to(torch.uint8), stable=True).indices
    live = torch.arange(capacity, device=dev) < npairs
    return li[order], ri[order], live, npairs, overflow


class PreparedBuild:
    """Join build side hashed and sorted once, reusable across probe chunks
    (the JAX package's ``PreparedBuild``).  ``unique`` (host bool, the one
    sync ``prepare_build`` pays) says the sorted 32-bit hashes are
    duplicate-free: each probe row then has at most one candidate."""

    __slots__ = ("rk", "payload", "rh", "rh_sorted", "r_order",
                 "right_live", "unique", "nr")

    def __init__(self, rk, payload, rh, rh_sorted, r_order, right_live,
                 unique, nr):
        self.rk = rk
        self.payload = payload
        self.rh = rh
        self.rh_sorted = rh_sorted
        self.r_order = r_order
        self.right_live = right_live
        self.unique = unique
        self.nr = nr


def prepare_build(right: Table, on_right, right_live=None,
                  payload: Table | None = None,
                  device=_device.DEFAULT) -> PreparedBuild:
    """Hash + sort the join build side once; see ``PreparedBuild``."""
    dev = _device.resolve(device)
    right = _on_device(right, dev)
    rk = _key_table(right, on_right)
    if right_live is not None:
        right_live = right_live.to(dev)
    rh = _sentinel_hashes(xxhash64(rk, device=dev).data, right_live, False)
    rh32, rh_sorted, r_order = _build_sort(rh)
    nr = int(rh32.shape[0])
    unique = True if nr <= 1 else \
        bool((rh_sorted[1:] != rh_sorted[:-1]).all())
    return PreparedBuild(rk, right if payload is None else payload,
                         rh32, rh_sorted, r_order, right_live, unique, nr)


def probe_join_prepared(left_keys: Table, pb: PreparedBuild, left_live=None,
                        null_equal: bool = False):
    """Probe a ``PreparedBuild`` whose hashes are unique: ``(ri, matched)``
    per probe row (int32 build row, arbitrary where unmatched; bool match
    mask).  No host sync."""
    dev = pb.rh.device
    left_keys = _on_device(left_keys, dev)
    if left_live is not None:
        left_live = left_live.to(dev)
    lh = _sentinel_hashes(xxhash64(left_keys, device=dev).data, left_live,
                          True).to(_I32)
    nl = lh.shape[0]
    if pb.nr == 0:
        return (torch.zeros(nl, dtype=_I32, device=dev),
                torch.zeros(nl, dtype=torch.bool, device=dev))
    lo, hi = _rank_bounds(pb.rh_sorted, lh)
    ri = pb.r_order[lo.clamp(0, pb.nr - 1)]
    li = torch.arange(nl, device=dev)
    eq = hi > lo
    for lc, rc in zip(left_keys.columns, pb.rk.columns):
        eq = eq & _pair_equal(lc, rc, li, ri, null_equal=null_equal)
    if pb.right_live is not None:
        eq = eq & pb.right_live[ri]
    if left_live is not None:
        eq = eq & left_live
    return ri.to(_I32), eq


def _distinct_reps(table: Table, on):
    """(representative row of each distinct key, group of every row):
    semi/anti joins work on distinct keys, so a hot key costs one pair,
    not a quadratic expansion.  One host sync, for the distinct count."""
    words = encode_keys([SortKey(table.column(k)) for k in on])
    order = lexsort(words)
    bounds = rows_differ_from_prev(words, order)
    seg = torch.cumsum(bounds.to(_I64), 0) - 1
    seg_of_row = torch.empty_like(seg)
    seg_of_row[order] = seg
    reps = order[torch.nonzero(bounds, as_tuple=True)[0]]
    return reps, seg_of_row


def _matched_left_rows(left: Table, right: Table, on_left, on_right):
    lreps, lseg_of_row = _distinct_reps(left, on_left)
    rreps, _ = _distinct_reps(right, on_right)
    knames = [f"k{i}" for i in range(len(on_left))]
    lrep_t = gather_table(Table([left.column(k) for k in on_left], knames),
                          lreps)
    rrep_t = gather_table(Table([right.column(k) for k in on_right], knames),
                          rreps)
    li, _, eq = _candidates(lrep_t, rrep_t, knames, knames)
    return _matched(li, eq, lreps.shape[0])[lseg_of_row]


def _semi_anti(left, right, on_left, on_right, device, anti: bool):
    dev = _device.resolve(device)
    left, right = _on_device(left, dev), _on_device(right, dev)
    on_right = on_right or on_left
    if left.num_rows == 0:
        return left
    if right.num_rows == 0:
        matched = torch.zeros(left.num_rows, dtype=torch.bool, device=dev)
    else:
        matched = _matched_left_rows(left, right, on_left, on_right)
    keep = ~matched if anti else matched
    return gather_table(left, torch.nonzero(keep, as_tuple=True)[0])


@traced("left_semi_join")
def left_semi_join(left: Table, right: Table, on_left, on_right=None,
                   device=_device.DEFAULT) -> Table:
    """Left rows that have a match on the right (left row order kept)."""
    return _semi_anti(left, right, on_left, on_right, device, anti=False)


@traced("left_anti_join")
def left_anti_join(left: Table, right: Table, on_left, on_right=None,
                   device=_device.DEFAULT) -> Table:
    """Left rows that have no match on the right (left row order kept)."""
    return _semi_anti(left, right, on_left, on_right, device, anti=True)


def _assemble(left, right, li, ri, on_right, suffixes, right_valid=None):
    on_r = tuple(on_right) if isinstance(on_right, (list, tuple)) \
        else on_right
    lcols = gather_table(left, li)
    rnames = right.names or [f"c{i}" for i in range(right.num_columns)]
    keep_r = [i for i, nm in enumerate(rnames)
              if not (isinstance(on_r, tuple) and nm in on_r)]
    rsub = Table([right.columns[i] for i in keep_r],
                 [rnames[i] for i in keep_r])
    rcols = gather_table(rsub, ri, indices_valid=right_valid)
    lnames = lcols.names or [f"l{i}" for i in range(lcols.num_columns)]
    names = list(lnames) + [
        nm + (suffixes[1] if nm in lnames else "") for nm in rsub.names]
    return Table(list(lcols.columns) + list(rcols.columns), names)


def _assemble_outer(left, right, li, ri, on_left, on_right, suffixes,
                    left_valid, right_valid):
    """Assemble an outer join where either side's row index may be -1.

    Key columns are coalesced: a row missing on the left takes the right
    side's key value (one gather over the two sides concatenated, so STRING
    keys work the same as fixed-width)."""
    from .selection import _concat_columns, gather_column
    on_left = list(on_left)
    on_right = list(on_right if on_right is not None else on_left)
    lnames = list(left.names or [f"l{i}" for i in range(left.num_columns)])
    rnames = list(right.names or [f"c{i}" for i in range(right.num_columns)])
    nl, nr = left.num_rows, right.num_rows
    lsafe = li.clamp(0, max(nl - 1, 0))
    rsafe = ri.clamp(0, max(nr - 1, 0))
    out_cols, out_names = [], []
    for nm, col in zip(lnames, left.columns):
        if nm in on_left and left_valid is not None:
            rk = right.column(on_right[on_left.index(nm)])
            both = _concat_columns([col, rk])
            out_cols.append(gather_column(
                both, torch.where(left_valid, lsafe, nl + rsafe)))
        else:
            out_cols.append(gather_column(col, lsafe,
                                          indices_valid=left_valid))
        out_names.append(nm)
    for nm, col in zip(rnames, right.columns):
        if nm in on_right:
            continue
        out_cols.append(gather_column(col, rsafe, indices_valid=right_valid))
        out_names.append(nm + (suffixes[1] if nm in lnames else ""))
    return Table(out_cols, out_names)


@traced("sort_merge_join")
def sort_merge_join(left: Table, right: Table, on_left, on_right=None,
                    how: str = "inner", suffixes=("", "_r"),
                    device=_device.DEFAULT) -> Table:
    """SortMergeJoin surface: the exchange plans of BASELINE configs[3] name
    this; physically the same sorted-probe expansion as the other joins.
    ``suffixes`` name colliding right columns (semi/anti keep the left)."""
    on_right = on_right or on_left
    kw = {"suffixes": suffixes, "device": device}
    if how == "inner":
        return inner_join(left, right, on_left, on_right, **kw)
    if how == "left":
        return left_join(left, right, on_left, on_right, **kw)
    if how == "right":
        return right_join(left, right, on_left, on_right, **kw)
    if how in ("full", "outer", "full_outer"):
        return full_join(left, right, on_left, on_right, **kw)
    if how == "cross":
        return cross_join(left, right, **kw)
    if how == "semi":
        return left_semi_join(left, right, on_left, on_right, device=device)
    if how == "anti":
        return left_anti_join(left, right, on_left, on_right, device=device)
    raise ValueError(f"unsupported join type {how!r}")
