"""Seeded plan-space fuzzer and differential rewrite-soundness harness.

The port of ``spark_rapids_jni_tpu/engine/fuzz.py``: every optimizer rule
gets adversarial coverage over random valid plans, run on ``device``
(default ``"cuda"``).  Four pieces:

1. **Warehouse generator** (``gen_warehouse``): a tiny seeded Parquet star
   schema written by the port's own writer: one fact table with integer
   keys of differing cardinality, a string key, quarter-valued float64
   measures (every value is ``n/4``, so sums, mins and maxes stay exactly
   representable and executor parity holds bit for bit in any reduction
   order), and dimension tables keyed by each family.  The numpy columns
   stay in memory as the oracle's base relations.  The rng is drawn in the
   JAX package's order, so one seed gives the JAX package's rows.

2. **Plan generator** (``gen_plan``): a random valid plan over all 9 plan
   node types: scans with column subsets, filters over a random predicate
   tree, projects, joins in every key family (int/string) and how
   (inner/left/semi/anti/cross), aggregates (with the order-sensitive
   ``first``/``last`` over order-deterministic chains), sorts and top-k
   with a unique tiebreak suffix (a LIMIT cutoff is then the same in every
   executor), and now and then a hand-placed hash Exchange in the two
   partitioning-sound positions.  One rng state gives the plan the JAX
   package's generator gives, byte for byte.

3. **Differential harness** (``run_case``): one plan through the variant
   matrix (interpreted, fused, distributed shuffle, broadcast, AQE and
   fused exchange on a mesh of 8 shards), checking after every variant:
   ``verify()`` passes on the optimized plan, the decision ledger equals
   ``verify.decision_census`` (plans without hand-placed structure), the
   static sync budget stays inside ``SYNC_WHITELIST``, the static exchange
   census equals the executed counter, AQE's rewrites match their stats
   counters, the variants agree bit for bit, and all agree with a numpy
   oracle over the in-memory columns.

4. **Shrinker** (``shrink``): greedy minimization of a failing plan
   (replace a node by its child, drop filter conjuncts, aggregates, sort
   keys) while the same check keeps failing.

The oracle is numpy, not pandas: it reproduces the pandas oracle of the JAX
package (merge column naming and suffixes, ``groupby(sort=False,
dropna=False)``, stable multi-key sorts) and calls nothing of ``ops/`` or
the executor.  Everything is driven by ``numpy.random.default_rng([seed,
case])``: the same seed replays the same corpus.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Callable, Optional

import numpy as np

from .. import device as _device
from ..utils.config import config
from .plan import (Aggregate, Exchange, Filter, Join, Limit, PlanNode,
                   Project, Scan, Sort, TopK, col, lit, rebuild, topo_nodes)

#: string pool for the string key family (small cardinality, fixed order)
_STRINGS = ("ash", "birch", "cedar", "dome", "elm", "fir")

#: low-cardinality columns eligible as group/sort keys, by table
_LOW_CARD = ("k1", "k2", "sk", "dgrp", "skey")

#: aggregate ops the fuzzer emits (var/std/collect_list excluded: their
#: results are not bit-comparable across reduction orders / executors)
_AGG_OPS = ("sum", "count", "count_all", "min", "max", "mean")
_ORDER_OPS = ("first", "last")

#: ledger kinds that leave structure behind (mirror verify.decision_census)
_STRUCTURAL_KINDS = frozenset(
    {"broadcast", "shuffle", "partial_agg", "topk", "order_sensitive_revert"})


# -- frames ------------------------------------------------------------------

class Frame:
    """A relation of the oracle: ordered column names and one numpy array
    each (numbers with NaN for nulls, strings as objects with None)."""

    __slots__ = ("names", "cols")

    def __init__(self, names, cols):
        self.names = list(names)
        self.cols = list(cols)

    def __len__(self) -> int:
        return len(self.cols[0]) if self.cols else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self.cols[self.names.index(name)]

    def select(self, names) -> "Frame":
        for n in names:
            if n not in self.names:
                raise KeyError(f"column {n!r} not in {self.names}")
        return Frame(names, [self[n] for n in names])

    def take(self, idx) -> "Frame":
        idx = np.asarray(idx, np.int64)
        return Frame(self.names, [c[idx] for c in self.cols])

    def copy(self) -> "Frame":
        return Frame(self.names, [c.copy() for c in self.cols])


def _is_null(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _null_mask(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return np.isnan(a)
    if a.dtype == object:
        return np.fromiter((_is_null(v) for v in a), np.bool_, len(a))
    return np.zeros(len(a), np.bool_)


def _codes(a: np.ndarray) -> tuple:
    """``(codes, nulls)``: each value's rank among the distinct non-null
    values, and the null mask."""
    nulls = _null_mask(a)
    codes = np.zeros(len(a), np.int64)
    live = ~nulls
    if live.any():
        if a.dtype == object:
            vals = a[live].tolist()
            uniq = {v: i for i, v in enumerate(sorted(set(vals)))}
            codes[live] = [uniq[v] for v in vals]
        else:
            codes[live] = np.unique(a[live], return_inverse=True)[1]
    return codes, nulls


def _order(cols, ascending) -> np.ndarray:
    """Stable sort order by ``cols`` (the first the most significant), nulls
    last in either direction: pandas' ``sort_values(kind="mergesort")``."""
    keys = []
    for a, asc in zip(cols, ascending):
        codes, nulls = _codes(a)
        keys.append((codes if asc else -codes, nulls))
    n = len(cols[0]) if cols else 0
    if not keys:
        return np.arange(n)
    flat = []
    for codes, nulls in reversed(keys):
        flat += [codes, nulls]
    return np.lexsort(flat)


# -- warehouse ---------------------------------------------------------------

def _quarters(rng, n, lo=-400, hi=400) -> np.ndarray:
    """float64 values on the 1/4 grid: exactly representable, and their
    sums stay exact, so cross-executor comparison can demand equality."""
    return rng.integers(lo, hi, n).astype(np.int64) / 4.0


def _write(frame: Frame, path: str, row_group_size: int) -> None:
    from ..columnar import Column, Table
    from ..io.parquet_writer import write_parquet
    cols = [Column.from_pylist(c.tolist(), device="cpu") if c.dtype == object
            else Column.from_numpy(c, device="cpu") for c in frame.cols]
    write_parquet(Table(cols, frame.names), path,
                  row_group_size=row_group_size)


def gen_warehouse(root, rng) -> dict:
    """Write the seeded star schema under ``root`` (the port's Parquet
    writer, snappy, ``max(8, rows // 4)``-row groups); returns the catalog
    ``{name: {"path", "frame"}}`` with the oracle's in-memory columns."""
    os.makedirs(str(root), exist_ok=True)
    n = int(rng.integers(48, 160))
    fact = Frame(("k1", "k2", "sk", "v", "w", "rid"), (
        rng.integers(0, 8, n).astype(np.int64),
        rng.integers(0, 5, n).astype(np.int64),
        np.array(_STRINGS, dtype=object)[rng.integers(0, len(_STRINGS), n)],
        _quarters(rng, n),
        rng.integers(-50, 50, n).astype(np.int32),
        np.arange(n, dtype=np.int64)))
    dk1 = np.arange(8, dtype=np.int64)
    # covers every k1: left joins stay null-free against it
    dimfull = Frame(("dk1", "dv", "dgrp"),
                    (dk1, _quarters(rng, len(dk1)),
                     (dk1 % 3).astype(np.int64)))
    # covers ~60% of k2: semi/anti have real survivors AND real drops
    dk2 = np.sort(rng.choice(5, size=3, replace=False)).astype(np.int64)
    dimpart = Frame(("dk2", "du"),
                    (dk2, rng.integers(0, 100, len(dk2)).astype(np.int64)))
    # string key family, full coverage
    dimstr = Frame(("skey", "sv"), (np.array(_STRINGS, dtype=object),
                                    _quarters(rng, len(_STRINGS))))
    cat = {}
    for name, fr in (("fact", fact), ("dimfull", dimfull),
                     ("dimpart", dimpart), ("dimstr", dimstr)):
        path = str(root / f"{name}.parquet")
        _write(fr, path, max(8, len(fr) // 4))
        cat[name] = {"path": path, "frame": fr}
    return cat


# -- plan generation ---------------------------------------------------------

class _Rel:
    """Generator state for one relation under construction: the plan
    node plus the facts later stages need to stay valid — column kinds,
    a column set whose combination is unique (None once lost), and
    whether row order is still scan-deterministic (a prerequisite for
    order-sensitive aggregates to be oracle-comparable)."""

    __slots__ = ("node", "kinds", "unique", "ordered")

    def __init__(self, node, kinds, unique, ordered):
        self.node = node
        self.kinds = kinds      # {name: "i64"|"i32"|"f64"|"str"}
        self.unique = unique    # tuple of column names, or None
        self.ordered = ordered  # bool


#: literal domain per generated column (lo, hi) for numerics; the
#: generator occasionally draws just outside to produce empty results
_DOMAINS = {
    "k1": (0, 8), "k2": (0, 5), "w": (-50, 50), "v": (-100.0, 100.0),
    "rid": (0, 160), "dk1": (0, 8), "dgrp": (0, 3), "dk2": (0, 5),
    "du": (0, 100), "dv": (-100.0, 100.0), "sv": (-100.0, 100.0),
}


def _gen_lit(rng, c: str, kind: str):
    if kind == "str":
        return str(_STRINGS[int(rng.integers(0, len(_STRINGS)))])
    lo, hi = _DOMAINS.get(c, (0, 100))
    span = hi - lo
    if kind == "f64":
        return float(int(rng.integers((lo - span // 8) * 4,
                                      (hi + span // 8) * 4 + 1)) / 4.0)
    return int(rng.integers(lo - max(1, span // 8),
                            hi + max(1, span // 8) + 1))


def _gen_pred(rng, kinds: dict, depth: int = 0) -> tuple:
    """Random predicate tree over the current columns."""
    r = rng.random()
    if depth < 2 and r < 0.35:
        op = ("&", "|")[int(rng.integers(0, 2))]
        return (op, _gen_pred(rng, kinds, depth + 1),
                _gen_pred(rng, kinds, depth + 1))
    if depth < 2 and r < 0.45:
        return ("not", _gen_pred(rng, kinds, depth + 1))
    cols = sorted(kinds)
    c = cols[int(rng.integers(0, len(cols)))]
    kind = kinds[c]
    if kind == "str":
        cmp = ("==", "!=")[int(rng.integers(0, 2))]
    else:
        cmp = (">=", "<=", ">", "<", "==", "!=")[int(rng.integers(0, 6))]
    return (cmp, col(c), lit(_gen_lit(rng, c, kind)))


#: join specs: key column on the current relation -> (dim table, dim key,
#: dim column kinds, allowed hows).  dimpart's partial key coverage means
#: left joins against it would manufacture nulls, so it only offers the
#: null-free hows.
_JOINS = {
    "k1": ("dimfull", "dk1", {"dv": "f64", "dgrp": "i64"},
           ("inner", "left", "semi", "anti")),
    "k2": ("dimpart", "dk2", {"du": "i64"}, ("inner", "semi", "anti")),
    "sk": ("dimstr", "skey", {"sv": "f64"},
           ("inner", "left", "semi", "anti")),
}


def _stage_filter(rng, rel: _Rel, cat) -> _Rel:
    rel.node = Filter(rel.node, _gen_pred(rng, rel.kinds))
    return rel


def _stage_project(rng, rel: _Rel, cat) -> _Rel:
    keep = set(rel.unique or ())
    rest = [c for c in rel.kinds if c not in keep]
    for c in rest:
        if rng.random() < 0.7:
            keep.add(c)
    cols = [c for c in rel.kinds if c in keep]  # preserve order
    if not cols:
        return rel
    rel.node = Project(rel.node, tuple(cols))
    rel.kinds = {c: rel.kinds[c] for c in cols}
    return rel


def _stage_join(rng, rel: _Rel, cat) -> _Rel:
    # a dim whose payload columns are already present was joined before;
    # skipping it keeps output names collision-free for the oracle
    avail = [k for k in _JOINS if k in rel.kinds
             and not any(c in rel.kinds for c in _JOINS[k][2])]
    if not avail:
        return rel
    key = avail[int(rng.integers(0, len(avail)))]
    dim, dkey, dkinds, hows = _JOINS[key]
    how = hows[int(rng.integers(0, len(hows)))]
    right = Scan(cat[dim]["path"])
    rel.node = Join(rel.node, right, (key,), (dkey,), how)
    if how in ("inner", "left"):
        # dim keys are unique, so multiplicity stays 1 and left-side
        # uniqueness survives; row order is no longer oracle-comparable
        rel.kinds = {**rel.kinds, **dkinds}
        rel.ordered = False
    return rel


def _stage_cross(rng, rel: _Rel, cat) -> _Rel:
    # cross joins only against the 3-row dimpart, to bound blowup
    if "du" in rel.kinds:
        return rel
    rel.node = Join(rel.node, Scan(cat["dimpart"]["path"]), (), (), "cross")
    rel.kinds = {**rel.kinds, "dk2": "i64", "du": "i64"}
    u = rel.unique
    rel.unique = tuple(u) + ("dk2",) if u else None
    rel.ordered = False
    return rel


def _stage_aggregate(rng, rel: _Rel, cat) -> _Rel:
    keycand = [c for c in rel.kinds if c in _LOW_CARD]
    if not keycand:
        return rel
    nk = int(rng.integers(1, min(2, len(keycand)) + 1))
    keys = sorted(rng.choice(keycand, size=nk, replace=False).tolist())
    numeric = [c for c in rel.kinds
               if rel.kinds[c] != "str" and c not in keys]
    ops = list(_AGG_OPS)
    if rel.ordered and rng.random() < 0.35:
        ops += list(_ORDER_OPS)
    aggs, names, kinds = [], [], {k: rel.kinds[k] for k in keys}
    has_order = False
    for i in range(int(rng.integers(1, 4))):
        op = ops[int(rng.integers(0, len(ops)))]
        if op == "count_all":
            aggs.append((None, op))
        else:
            if not numeric:
                continue
            c = numeric[int(rng.integers(0, len(numeric)))]
            aggs.append((c, op))
        nm = f"a{i}"
        names.append(nm)
        has_order = has_order or op in _ORDER_OPS
        if op in ("count", "count_all"):
            kinds[nm] = "i64"
        elif op == "mean":
            kinds[nm] = "f64"
        elif op == "sum":
            kinds[nm] = "f64" if rel.kinds.get(aggs[-1][0]) == "f64" \
                else "i64"
        else:
            kinds[nm] = rel.kinds.get(aggs[-1][0], "i64")
    if not aggs:
        aggs, names = [(None, "count_all")], ["a0"]
        kinds["a0"] = "i64"
    child = rel.node
    manual = False
    if not has_order and rng.random() < 0.18:
        # partitioning-sound hand-placed shuffle: hash keys must be a
        # subset of the group keys (verify.check_partitioning)
        nx = int(rng.integers(1, len(keys) + 1))
        xkeys = sorted(rng.choice(keys, size=nx, replace=False).tolist())
        child = Exchange(child, tuple(xkeys), "hash")
        manual = True
    rel.node = Aggregate(child, tuple(keys), tuple(aggs), tuple(names))
    rel.kinds = kinds
    rel.unique = tuple(keys)
    rel.ordered = False
    if manual:
        object.__setattr__(rel.node, "_fuzz_manual_exchange", True)
    return rel


def _sort_keys(rng, rel: _Rel) -> tuple:
    """Random sort keys with the unique-combination suffix appended, so
    any LIMIT cutoff above is a total order (deterministic across
    executors and the oracle)."""
    cols = sorted(rel.kinds)
    n = int(rng.integers(1, min(2, len(cols)) + 1))
    picked = rng.choice(cols, size=n, replace=False).tolist()
    keys = [(c, bool(rng.integers(0, 2))) for c in picked]
    for u in rel.unique or ():
        if u not in picked:
            keys.append((u, True))
    return tuple(keys)


def _stage_order(rng, rel: _Rel, cat) -> _Rel:
    """Terminal ordering stage: Sort, Limit(Sort) (the fuse_topk shape),
    a direct TopK, or a Sort over a hand-placed hash exchange."""
    if rel.unique is None:
        return rel
    keys = _sort_keys(rng, rel)
    r = rng.random()
    if r < 0.30:
        rel.node = Sort(rel.node, keys)
    elif r < 0.55:
        rel.node = Limit(Sort(rel.node, keys), int(rng.integers(1, 24)))
    elif r < 0.75:
        rel.node = TopK(rel.node, keys, int(rng.integers(1, 24)))
    elif r < 0.85:
        inner = Exchange(rel.node, (keys[0][0],), "hash")
        object.__setattr__(inner, "_fuzz_manual_exchange", True)
        rel.node = Sort(inner, keys)
    rel.ordered = True
    return rel


def gen_plan(rng, cat) -> PlanNode:
    """One random valid plan over the catalog (all 9 node types
    reachable).  Same rng state -> same plan, always."""
    kinds = {"k1": "i64", "k2": "i64", "sk": "str", "v": "f64",
             "w": "i32", "rid": "i64"}
    scan_cols = None
    if rng.random() < 0.3:
        drop = ("v", "w")[int(rng.integers(0, 2))]
        scan_cols = tuple(c for c in kinds if c != drop)
        kinds = {c: kinds[c] for c in scan_cols}
    rel = _Rel(Scan(cat["fact"]["path"], columns=scan_cols),
               kinds, ("rid",), True)
    stages = (_stage_filter, _stage_join, _stage_project, _stage_cross)
    weights = (0.42, 0.30, 0.18, 0.10)
    for _ in range(int(rng.integers(1, 5))):
        rel = rng.choice(stages, p=weights)(rng, rel, cat)
    if rng.random() < 0.55:
        rel = _stage_aggregate(rng, rel, cat)
        if rng.random() < 0.35:
            rel = _stage_filter(rng, rel, cat)
    return _stage_order(rng, rel, cat).node


def has_manual_structure(plan: PlanNode) -> bool:
    """True when the UNOPTIMIZED plan carries hand-placed Exchange or
    TopK nodes — shapes whose structure predates the planner, so the
    ledger==census invariant (which models planner-made structure only)
    does not apply."""
    return any(isinstance(n, (Exchange, TopK)) for n in topo_nodes(plan))


# -- numpy oracle ------------------------------------------------------------

_CMP = {">=": np.greater_equal, "<=": np.less_equal, ">": np.greater,
        "<": np.less, "==": np.equal, "!=": np.not_equal}


def _eval_np(expr, fr: Frame):
    head = expr[0]
    if head == "col":
        return fr[expr[1]]
    if head == "lit":
        return expr[1]
    if head == "not":
        return ~np.asarray(_eval_np(expr[1], fr), dtype=bool)
    a, b = _eval_np(expr[1], fr), _eval_np(expr[2], fr)
    if head == "&":
        return np.asarray(a, dtype=bool) & np.asarray(b, dtype=bool)
    if head == "|":
        return np.asarray(a, dtype=bool) | np.asarray(b, dtype=bool)
    return np.asarray(_CMP[head](a, b), dtype=bool)


def _oracle_scan(node: Scan, env):
    fr = env[str(node.path)]
    if node.columns is not None:
        fr = fr.select(list(node.columns))
    return fr.copy()  # scan.predicate only prunes row groups


def _oracle_filter(node: Filter, env):
    fr = _oracle(node.child, env)
    mask = np.broadcast_to(np.asarray(_eval_np(node.predicate, fr),
                                      dtype=bool), (len(fr),))
    return fr.take(np.flatnonzero(mask))


def _oracle_project(node: Project, env):
    return _oracle(node.child, env).select(list(node.columns))


def _key_rows(fr: Frame, keys) -> list:
    """Each row's key tuple, NaN and None as one null key (pandas merges
    and groups nulls together)."""
    cols = [fr[k].tolist() for k in keys]
    return [tuple(None if _is_null(v) else v for v in row)
            for row in zip(*cols)]


def _with_nulls(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``a`` gathered at ``idx``, -1 giving a null (ints widen to float,
    as a pandas left merge does)."""
    miss = idx < 0
    if not miss.any():
        return a[idx]
    if a.dtype == object:
        out = a[np.where(miss, 0, idx)] if len(a) else \
            np.empty(len(idx), object)
        out = out.astype(object)
        out[miss] = np.nan
        return out
    out = a.astype(np.float64)[np.where(miss, 0, idx)] if len(a) else \
        np.empty(len(idx), np.float64)
    out[miss] = np.nan
    return out


def _merged_names(left: Frame, right: Frame, lk, rk, suffixes) -> tuple:
    """pandas' merge naming: a right key named as its left key merges into
    it; other names in both frames take the suffixes."""
    same = {l for l, r in zip(lk, rk) if l == r}
    overlap = (set(left.names) & set(right.names)) - same
    lnames = [n + suffixes[0] if n in overlap else n for n in left.names]
    keep = [i for i, n in enumerate(right.names) if n not in same]
    rnames = [right.names[i] + suffixes[1] if right.names[i] in overlap
              else right.names[i] for i in keep]
    return lnames, keep, rnames


def _oracle_join(node: Join, env):
    left = _oracle(node.left, env)
    right = _oracle(node.right, env)
    lk, rk = list(node.left_keys), list(node.right_keys)
    if node.how in ("semi", "anti"):
        seen = set(_key_rows(right, rk))
        hit = np.fromiter((k in seen for k in _key_rows(left, lk)),
                          np.bool_, len(left))
        return left.take(np.flatnonzero(hit if node.how == "semi"
                                        else ~hit))
    if node.how == "cross":
        li = np.repeat(np.arange(len(left)), len(right))
        ri = np.tile(np.arange(len(right)), len(left))
        lnames, keep, rnames = _merged_names(left, right, (), (),
                                             ("_x", "_y"))
    else:
        index: dict = {}
        for j, k in enumerate(_key_rows(right, rk)):
            index.setdefault(k, []).append(j)
        li, ri = [], []
        for i, k in enumerate(_key_rows(left, lk)):
            js = index.get(k)
            if js:
                li += [i] * len(js)
                ri += js
            elif node.how == "left":
                li.append(i)
                ri.append(-1)
        li, ri = np.asarray(li, np.int64), np.asarray(ri, np.int64)
        lnames, keep, rnames = _merged_names(left, right, lk, rk,
                                             ("", "_r"))
    out = Frame(lnames + rnames,
                [c[li] for c in left.cols]
                + [_with_nulls(right.cols[i], ri) for i in keep])
    drop = [k for k in rk if k not in left.names]
    names = [n for n in out.names if n not in drop]
    return out.select(names)


def _agg_group(op: str, vals: np.ndarray):
    """One group's reduction, nulls skipped (pandas' groupby)."""
    if op == "count_all":
        return len(vals)
    live = vals[~_null_mask(vals)]
    if op == "count":
        return len(live)
    if op == "sum":
        return live.sum() if len(live) else vals.dtype.type(0)
    if not len(live):
        return np.nan
    if op == "min":
        return live.min()
    if op == "max":
        return live.max()
    if op == "mean":
        return live.astype(np.float64).sum() / len(live)
    if op == "first":
        return live[0]
    if op == "last":
        return live[-1]
    raise ValueError(f"no oracle for aggregate {op!r}")


def _agg_dtype(op: str, src: Optional[np.ndarray]):
    if op in ("count", "count_all"):
        return np.int64
    if op == "mean":
        return np.float64
    if op == "sum":
        return np.float64 if src.dtype.kind == "f" else np.int64
    return src.dtype


def _oracle_aggregate(node: Aggregate, env):
    fr = _oracle(node.child, env)
    keys = list(node.keys)
    groups: dict = {}      # key tuple -> row indices, first-seen order
    for i, k in enumerate(_key_rows(fr, keys)):
        groups.setdefault(k, []).append(i)
    firsts = np.asarray([rows[0] for rows in groups.values()], np.int64)
    cols = [fr[k][firsts] if len(firsts) else fr[k][:0] for k in keys]
    for cname, op in node.aggs:
        src = None if op == "count_all" else fr[cname]
        vals = [_agg_group(op, src[np.asarray(rows)] if src is not None
                           else np.empty(len(rows)))
                for rows in groups.values()]
        dtype = _agg_dtype(op, src)
        if any(_is_null(v) for v in vals) and np.dtype(dtype).kind in "iu":
            dtype = np.float64
        cols.append(np.asarray(vals, dtype=dtype))
    return Frame(keys + list(node.names), cols)


def _sorted(fr: Frame, keys) -> Frame:
    return fr.take(_order([fr[c] for c, _ in keys], [a for _, a in keys]))


def _oracle_sort(node: Sort, env):
    return _sorted(_oracle(node.child, env), node.keys)


def _oracle_limit(node: Limit, env):
    fr = _oracle(node.child, env)
    return fr.take(np.arange(min(node.n, len(fr))))


def _oracle_topk(node: TopK, env):
    fr = _sorted(_oracle(node.child, env), node.keys)
    return fr.take(np.arange(min(node.n, len(fr))))


def _oracle_exchange(node: Exchange, env):
    return _oracle(node.child, env)  # repartitioning preserves the multiset


#: plan-node class -> reference semantics; kept exhaustive over the plan's
#: node types, like verify._INFER
_ORACLE = {
    Scan: _oracle_scan,
    Filter: _oracle_filter,
    Project: _oracle_project,
    Join: _oracle_join,
    Aggregate: _oracle_aggregate,
    Sort: _oracle_sort,
    Limit: _oracle_limit,
    TopK: _oracle_topk,
    Exchange: _oracle_exchange,
}


def _oracle(node: PlanNode, env):
    fn = _ORACLE.get(type(node))
    if fn is None:
        raise TypeError(f"no oracle rule for {type(node).__name__} "
                        f"(register it in fuzz._ORACLE)")
    return fn(node, env)


def oracle(plan: PlanNode, cat) -> Frame:
    """Reference result of the UNOPTIMIZED plan over the in-memory
    columns, as a :class:`Frame`."""
    env = {e["path"]: e["frame"] for e in cat.values()}
    return _oracle(plan, env)


# -- differential harness ----------------------------------------------------

#: the flag matrix: every generated plan runs under each of these;
#: broadcast_rows=0 forces shuffle joins, the huge threshold forces
#: broadcast, so both distributed join strategies are exercised per plan.
#: The distributed variants run on a mesh of 8 shards of the one device
#: (the JAX package's 8-device virtual mesh)
VARIANTS = (
    {"name": "interp", "fuse": False, "distribute": False},
    {"name": "fused", "fuse": True, "distribute": False},
    {"name": "dist-shuffle", "fuse": True, "distribute": True,
     "broadcast_rows": 0, "shards": 8},
    {"name": "dist-broadcast", "fuse": True, "distribute": True,
     "broadcast_rows": 1_000_000, "shards": 8},
    # AQE adversary: plan every join as a shuffle (broadcast_rows=0), then
    # let the runtime rules rewrite mid-query — every eligible build flips
    # to broadcast (aqe_broadcast_rows) and every measurable skew splits
    # (aqe_skew at the 1.0 floor).  Parity vs the non-AQE variants asserts
    # the rewrites are content-exact; the adaptive-ledger check asserts
    # every applied rewrite left a triggered entry behind
    {"name": "dist-aqe", "fuse": True, "distribute": True,
     "broadcast_rows": 0, "aqe": True, "aqe_broadcast_rows": 1_000_000,
     "aqe_skew": 1.0, "shards": 8},
    # whole-stage fusion: the partial/final aggregate sandwich runs as one
    # fused stage (config.fuse_exchange).  Bit-exact parity vs every other
    # variant asserts the in-stage exchange is content-exact; the
    # exchange-census check asserts it still ticks stats["exchanges"]; the
    # sync-whitelist check covers the fused-stage budget entries
    {"name": "dist-fused", "fuse": True, "distribute": True,
     "broadcast_rows": 0, "fuse_exchange": True, "shards": 8},
)

#: extra variants the nightly sweep adds on top of VARIANTS
FULL_VARIANTS = VARIANTS + (
    {"name": "dist-nofuse", "fuse": False, "distribute": True,
     "broadcast_rows": 0, "shards": 8},
    {"name": "interp-notopk", "fuse": False, "distribute": False,
     "topk": False},
    # fusion composed with the AQE adversary: the counts probe routes hot
    # stages to the host path where the skew split still fires, cold ones
    # into the fused stage — parity and the adaptive-ledger invariant hold
    # either way
    {"name": "dist-fused-aqe", "fuse": True, "distribute": True,
     "broadcast_rows": 0, "fuse_exchange": True, "aqe": True,
     "aqe_broadcast_rows": 1_000_000, "aqe_skew": 1.0, "shards": 8},
)


@contextlib.contextmanager
def _flags(**kw):
    """Temporarily set config fields (the sweep axis)."""
    saved = {k: getattr(config, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(config, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


class SoundnessFailure(Exception):
    """One differential-harness check failed for one (plan, variant)."""

    def __init__(self, check: str, variant: str, message: str):
        self.check = check
        self.variant = variant
        super().__init__(f"[{check}] under {variant}: {message}")


class OracleRefusal(Exception):
    """The numpy oracle cannot evaluate a generated plan (as the JAX
    package's pandas oracle cannot: seed 7's case 234, a second cross
    join, leaves no ``dk2`` column); the plan is no evidence either way,
    so the corpus records it as skipped and goes on."""


def _as_frame(table) -> Frame:
    """An engine result on the host: numbers with NaN for nulls, strings
    as objects with None."""
    names = table.names or [f"c{i}" for i in range(table.num_columns)]
    cols = []
    for c in table.columns:
        if c.dtype.is_string:
            cols.append(np.array(c.to_pylist(), dtype=object))
            continue
        vals = c.to_numpy()
        valid = c.validity_numpy()
        if not valid.all():
            vals = vals.astype(np.float64)
            vals[~valid] = np.nan
        cols.append(vals)
    return Frame(names, cols)


def _canonical(fr: Frame) -> Frame:
    """Row-multiset canonical form: stable-sorted by every column."""
    if not fr.names:
        return fr
    return fr.take(_order(fr.cols, [True] * len(fr.cols)))


def _first_mismatch(a: np.ndarray, b: np.ndarray, exact: bool):
    """Index of the first unequal row (nulls equal nulls), or None."""
    na, nb = _null_mask(a), _null_mask(b)
    for i in np.flatnonzero(na != nb):
        return int(i)
    live = ~na
    if a.dtype == object or b.dtype == object:
        for i in np.flatnonzero(live):
            if a[i] != b[i]:
                return int(i)
        return None
    x = a[live].astype(np.float64) if not exact else a[live]
    y = b[live].astype(np.float64) if not exact else b[live]
    if exact:
        bad = x != y
    else:
        # math.isclose(rel_tol=1e-9, abs_tol=1e-9), as pandas' inexact
        # assert_frame_equal compares
        bad = ~(np.abs(x - y) <= np.maximum(
            1e-9 * np.maximum(np.abs(x), np.abs(y)), 1e-9))
    idx = np.flatnonzero(live)[np.flatnonzero(bad)]
    return int(idx[0]) if len(idx) else None


def _frames_match(a: Frame, b: Frame, exact: bool) -> Optional[str]:
    """None when equal as row multisets (same column order), exactly or
    within rel and abs 1e-9, else a short description of the first
    difference."""
    if list(a.names) != list(b.names):
        return f"column order {list(a.names)} != {list(b.names)}"
    if len(a) != len(b):
        return f"row count {len(a)} != {len(b)}"
    ca, cb = _canonical(a), _canonical(b)
    for name, x, y in zip(ca.names, ca.cols, cb.cols):
        i = _first_mismatch(x, y, exact)
        if i is not None:
            return (f"column {name!r} differs at sorted row {i}: "
                    f"{x[i]!r} != {y[i]!r}")[:200]
    return None


def _check_ledger(opt, dist: bool) -> Optional[str]:
    """Structural ledger entries must equal decision_census, kind for
    kind and path for path."""
    from .verify import decision_census
    led = sorted((d["kind"], d.get("path"))
                 for d in getattr(opt, "_decisions", ())
                 if d["kind"] in _STRUCTURAL_KINDS)
    cen = sorted((c["kind"], c["path"])
                 for c in decision_census(opt, dist=dist))
    if led != cen:
        return f"ledger {led} != census {cen}"
    return None


def run_case(plan: PlanNode, cat, variants=VARIANTS,
             optimize_fn: Optional[Callable] = None,
             device=_device.DEFAULT) -> list:
    """Run one plan through the full differential matrix on ``device``;
    raises :class:`SoundnessFailure` on the first violated invariant (or
    :class:`OracleRefusal` when the oracle cannot evaluate the plan), else
    returns ``[(variant name, result Frame), ...]``.

    ``optimize_fn`` overrides ``optimizer.optimize`` — the
    broken-rule-injection tests pass a sabotaged pipeline here and
    assert the harness catches it.
    """
    from . import optimizer
    from .executor import execute, new_stats
    from .verify import (SYNC_WHITELIST, plan_exchanges, sync_budget,
                         verify)
    opt_fn = optimize_fn or optimizer.optimize
    manual = has_manual_structure(plan)
    try:
        ref = oracle(plan, cat)
    except Exception as e:
        raise OracleRefusal(repr(e)[:300]) from e
    results = []
    for v in variants:
        name = v["name"]
        flags = {k: val for k, val in v.items() if k != "name"}
        dist = bool(flags.get("distribute", False))
        with _flags(verify=True, **flags):
            try:
                opt = opt_fn(plan, distribute=dist)
            except Exception as e:
                raise SoundnessFailure("optimize", name, repr(e)[:300])
            try:
                verify(opt)
            except Exception as e:
                raise SoundnessFailure("verify-after-rewrite", name,
                                       repr(e)[:300])
            if not manual:
                bad = _check_ledger(opt, dist)
                if bad:
                    raise SoundnessFailure("ledger-census", name, bad)
            for e in sync_budget(opt, cfg=config):
                if e["count"] and e["site"] not in SYNC_WHITELIST:
                    raise SoundnessFailure(
                        "sync-whitelist", name,
                        f"unwhitelisted sync {e['site']} at {e['path']}")
            stats = new_stats()
            try:
                tbl = execute(opt, stats, device=device)
            except Exception as e:
                raise SoundnessFailure("execute", name, repr(e)[:300])
            static_ex = len(plan_exchanges(opt))
            if stats["exchanges"] != static_ex:
                raise SoundnessFailure(
                    "exchange-census", name,
                    f"static census {static_ex} != executed "
                    f"{stats['exchanges']}")
            if flags.get("aqe"):
                # runtime rewrites must leave evidence: every applied
                # flip/split bumped its stats counter AND recorded a
                # triggered ledger entry.  Structural entries must still
                # equal the census (adaptive kinds are runtime-only,
                # outside _STRUCTURAL_KINDS).
                if not manual:
                    bad = _check_ledger(opt, dist)
                    if bad:
                        raise SoundnessFailure("ledger-census-post-aqe",
                                               name, bad)
                rt = [d for d in getattr(opt, "_decisions", ())
                      if d.get("runtime")]
                flips = sum(1 for d in rt
                            if d["kind"] == "adaptive:broadcast_flip"
                            and d.get("triggered"))
                splits = sum(1 for d in rt
                             if d["kind"] == "adaptive:skew_split"
                             and d.get("triggered"))
                if flips != stats.get("aqe_flips", 0) \
                        or splits != stats.get("aqe_splits", 0):
                    raise SoundnessFailure(
                        "adaptive-ledger", name,
                        f"triggered ledger (flips={flips}, "
                        f"splits={splits}) != stats "
                        f"(flips={stats.get('aqe_flips', 0)}, "
                        f"splits={stats.get('aqe_splits', 0)})")
            results.append((name, _as_frame(tbl)))
    base_name, base = results[0]
    for name, frame in results[1:]:
        bad = _frames_match(base, frame, exact=True)
        if bad:
            raise SoundnessFailure("executor-parity", name,
                                   f"{name} != {base_name}: {bad}")
    bad = _frames_match(base, ref, exact=False)
    if bad:
        raise SoundnessFailure("oracle-parity", base_name,
                               f"engine != numpy oracle: {bad}")
    return results


# -- shrinker ----------------------------------------------------------------

def _replace(root: PlanNode, target: PlanNode,
             sub: PlanNode) -> PlanNode:
    """New tree with ``target`` (by identity) swapped for ``sub``."""
    if root is target:
        return sub
    changes = {}
    for f in ("child", "left", "right"):
        c = getattr(root, f, None)
        if isinstance(c, PlanNode):
            r = _replace(c, target, sub)
            if r is not c:
                changes[f] = r
    return rebuild(root, **changes) if changes else root


def _conjuncts(expr) -> list:
    if expr[0] == "&":
        return _conjuncts(expr[1]) + _conjuncts(expr[2])
    return [expr]


def _candidates(plan: PlanNode):
    """Structurally smaller variants of ``plan``, coarsest first."""
    for n in topo_nodes(plan):
        child = getattr(n, "child", None)
        if isinstance(child, PlanNode):
            yield _replace(plan, n, child)
        if isinstance(n, Join):
            yield _replace(plan, n, n.left)
    for n in topo_nodes(plan):
        if isinstance(n, Filter):
            parts = _conjuncts(n.predicate)
            if len(parts) > 1:
                for i in range(len(parts)):
                    kept = parts[:i] + parts[i + 1:]
                    pred = kept[0]
                    for p in kept[1:]:
                        pred = ("&", pred, p)
                    yield _replace(plan, n, Filter(n.child, pred))
        elif isinstance(n, Aggregate) and len(n.aggs) > 1:
            for i in range(len(n.aggs)):
                yield _replace(
                    plan, n,
                    Aggregate(n.child, n.keys,
                              n.aggs[:i] + n.aggs[i + 1:],
                              n.names[:i] + n.names[i + 1:]))
        elif isinstance(n, (Sort, TopK)) and len(n.keys) > 1:
            for i in range(len(n.keys)):
                yield _replace(plan, n,
                               rebuild(n, keys=n.keys[:i] + n.keys[i + 1:]))


def shrink(plan: PlanNode, fails: Callable) -> PlanNode:
    """Greedy fixpoint minimization: adopt any structurally smaller
    candidate for which ``fails(candidate)`` still returns truthy (the
    caller pins "same check code" inside ``fails``), until no candidate
    improves.  ``fails`` must treat an INVALID candidate (verify error
    on the unoptimized plan, oracle crash) as not-failing, so the
    shrinker never walks out of the valid-plan space."""
    cur = plan
    improved = True
    while improved:
        improved = False
        for cand in _candidates(cur):
            if cand is None or cand is cur:
                continue
            if len(topo_nodes(cand)) >= len(topo_nodes(cur)):
                continue
            try:
                if fails(cand):
                    cur = cand
                    improved = True
                    break
            except Exception:
                continue  # candidate invalid or check crashed: skip
    return cur


# -- corpus loop ------------------------------------------------------------

def same_check_fails(cat, check: str, variants=VARIANTS,
                     optimize_fn: Optional[Callable] = None,
                     device=_device.DEFAULT) -> Callable:
    """A ``fails`` predicate for :func:`shrink`: the candidate must be a
    valid plan AND reproduce the same failing check, under the same
    ``optimize_fn`` (a sabotaged pipeline shrinks against itself)."""
    from .verify import verify

    def _fails(cand: PlanNode) -> bool:
        try:
            verify(cand)
            oracle(cand, cat)
        except Exception:
            return False  # invalid candidate, not a repro
        try:
            run_case(cand, cat, variants, optimize_fn=optimize_fn,
                     device=device)
        except SoundnessFailure as e:
            return e.check == check
        return False

    return _fails


def run_corpus(seed: int, count: int, root, variants=VARIANTS,
               optimize_fn: Optional[Callable] = None,
               log: Optional[Callable] = None,
               shrink_failures: bool = True,
               device=_device.DEFAULT,
               on_case: Optional[Callable] = None, first: int = 0) -> dict:
    """The fuzzing loop on ``device``: one seeded warehouse, ``count``
    generated plans (cases ``first`` .. ``first + count - 1`` of the
    seed), each swept through the variant matrix.  Returns
    ``{"seed", "cases", "failures": [...], "skipped": [...]}`` where each
    failure carries the case index, the check, the message, and the SHRUNK
    minimal plan as canonical JSON, and each skipped case (the oracle
    refused its plan, :class:`OracleRefusal`) its index and the refusal.  ``on_case(i, plan, results)`` sees every clean
    case's variant results."""
    wrng = np.random.default_rng([seed, 0])
    cat = gen_warehouse(root, wrng)
    failures, skipped = [], []
    for i in range(first, first + count):
        rng = np.random.default_rng([seed, i + 1])
        plan = gen_plan(rng, cat)
        try:
            results = run_case(plan, cat, variants, optimize_fn=optimize_fn,
                               device=device)
        except OracleRefusal as e:
            skipped.append({"seed": seed, "case": i, "reason": str(e)})
            if log:
                log(f"case {i}: skipped, the oracle refused it ({e})")
        except SoundnessFailure as e:
            minimal = plan
            if shrink_failures:
                minimal = shrink(plan, same_check_fails(
                    cat, e.check, variants, optimize_fn, device))
            failures.append({
                "seed": seed, "case": i, "check": e.check,
                "variant": e.variant, "message": str(e),
                "plan_nodes": len(topo_nodes(plan)),
                "minimal_nodes": len(topo_nodes(minimal)),
                "minimal_plan": json.loads(
                    minimal.serialize().decode("utf-8")),
            })
            if log:
                log(f"case {i}: FAIL {e.check} "
                    f"({len(topo_nodes(plan))} -> "
                    f"{len(topo_nodes(minimal))} nodes)")
        else:
            if on_case:
                on_case(i, plan, results)
            if log and (i + 1 - first) % 10 == 0:
                log(f"case {i + 1 - first}/{count}: ok")
    return {"seed": seed, "cases": count, "failures": failures,
            "skipped": skipped}
