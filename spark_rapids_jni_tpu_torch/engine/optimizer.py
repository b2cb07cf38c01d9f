"""Rule-based logical plan rewrites.

The port of ``spark_rapids_jni_tpu/engine/optimizer.py``: pure plan
algebra, so the rewritten plans serialize to the same bytes in both
packages.  A structural rule first: ``Limit(Sort(x), n)`` fuses into
``TopK`` so the executor can stream ORDER BY ... LIMIT as a per-chunk
partial top-k instead of materializing the full sorted table.  Then three
rules, applied in a fixed order chosen so each enables the next:

1. **Filter split + pushdown below joins**: conjunctions split into single
   filters; a filter whose columns all come from one join input moves below
   the join (left side for inner/left/semi/anti, right side for inner;
   cross joins accept either).  This moves the q5-lite date-range filter
   from above the semi-join down onto the fact-table scan.
2. **Predicate pushdown into scans**: a range/point comparison on one
   column directly above a parquet ``Scan`` installs the reader's
   ``(column, lo, hi)`` row-group pruning hint.  The row-level ``Filter``
   stays: footer stats prune conservatively (whole groups only), the filter
   still drops in-range-group rows outside the bound.
3. **Projection pruning**: required columns flow top-down; scans read only
   what some ancestor consumes (``Scan.columns``).

With ``distribute=True`` a fourth rule places the exchanges a mesh of
shards needs (``_plan_exchanges``): broadcast or shuffle joins by the
build's row estimate, partial aggregation below a hash exchange, and none
where the input is already placed.  Hand-placed Exchange nodes whose child
is already placed as they would place it are eliminated.

All rules build new nodes (plan nodes are frozen); the input plan is never
mutated, so a cached original plan stays valid as a cache key.
"""

from __future__ import annotations

from typing import Optional

from .plan import (ORDER_SENSITIVE_AGGS, Aggregate, Exchange, Filter, Join,
                   Limit, PlanNode, Project, Scan, Sort, TopK,
                   co_partitioned, expr_columns, partitioning, rebuild,
                   topo_nodes)

#: comparisons a scan predicate hint can absorb (col vs literal)
_RANGE_OPS = {">=", "<=", ">", "<", "=="}


class _Schema:
    """Lazily resolves scan column names from file footers (cached)."""

    def __init__(self):
        self._files: dict = {}

    def scan_names(self, node: Scan) -> list:
        if node.columns is not None:
            return list(node.columns)
        key = (node.format, node.path)
        if key not in self._files:
            if node.format == "parquet":
                from ..io import ParquetFile
                self._files[key] = list(ParquetFile(node.path).names)
            else:
                from ..io import ORCFile
                self._files[key] = list(ORCFile(node.path).column_names)
        return list(self._files[key])


def output_names(node: PlanNode, schema: Optional[_Schema] = None,
                 _memo: Optional[dict] = None) -> list:
    """Column names a node produces, mirroring executor/ops semantics."""
    schema = schema or _Schema()
    memo = _memo if _memo is not None else {}
    if id(node) in memo:
        return memo[id(node)]
    if isinstance(node, Scan):
        out = schema.scan_names(node)
    elif isinstance(node, Project):
        out = list(node.columns)
    elif isinstance(node, (Filter, Sort, Limit, TopK)):
        out = output_names(node.child, schema, memo)
    elif isinstance(node, Aggregate):
        out = list(node.keys) + list(node.names)
    elif isinstance(node, Exchange):
        out = output_names(node.child, schema, memo)
    elif isinstance(node, Join):
        lnames = output_names(node.left, schema, memo)
        if node.how in ("semi", "anti"):
            out = list(lnames)
        else:
            rnames = output_names(node.right, schema, memo)
            rkeys = set(node.right_keys) if node.how != "cross" else set()
            out = list(lnames) + [
                nm + ("_r" if nm in lnames else "")
                for nm in rnames if nm not in rkeys]
    else:
        raise TypeError(f"unknown plan node {type(node).__name__}")
    memo[id(node)] = out
    return out


# -- rule 1: filter split + below-join reordering --------------------------

def _split_conjunctions(pred) -> list:
    if isinstance(pred, tuple) and pred[0] == "&":
        return _split_conjunctions(pred[1]) + _split_conjunctions(pred[2])
    return [pred]


def _push_filters(node: PlanNode, schema: _Schema, memo: dict) -> PlanNode:
    if id(node) in memo:
        return memo[id(node)]
    kids = {f: _push_filters(getattr(node, f), schema, memo)
            for f in ("child", "left", "right") if hasattr(node, f)}
    out = rebuild(node, **{k: v for k, v in kids.items()
                           if v is not getattr(node, k)})

    if isinstance(out, Filter):
        parts = _split_conjunctions(out.predicate)
        child = out.child
        rest = []
        for p in parts:
            placed = _try_push_one(p, child, schema)
            if placed is not None:
                child = placed
            else:
                rest.append(p)
        new = child
        for p in rest:
            new = Filter(new, p)
        out = new if (rest != parts or child is not out.child) else out
    memo[id(node)] = out
    return out


def _try_push_one(pred, node: PlanNode, schema: _Schema):
    """Push one conjunct below ``node`` if legal; returns new node or None."""
    if not isinstance(node, Join):
        return None
    cols = expr_columns(pred)
    lnames = set(output_names(node.left, schema))
    # sides the predicate may legally move to, by join type: a left-side
    # filter commutes with inner/left/semi/anti/cross joins (it only removes
    # left rows that would fail above anyway); a right-side filter commutes
    # with inner/cross (left/semi/anti see right rows only through matching,
    # right/full would lose null-extended rows).
    if cols and cols <= lnames and node.how in ("inner", "left", "semi",
                                                "anti", "cross"):
        pushed = _try_push_one(pred, node.left, schema)
        return rebuild(node, left=pushed if pushed is not None
                       else Filter(node.left, pred))
    if node.how in ("inner", "cross"):
        # map above-join (possibly ``_r``-suffixed) names back to the right
        # child's own names; key columns don't survive the join output
        rown = output_names(node.right, schema)
        rkeys = set(node.right_keys) if node.how != "cross" else set()
        vis = {nm + ("_r" if nm in lnames else ""): nm
               for nm in rown if nm not in rkeys}
        if cols and all(c in vis for c in cols):
            sub = _rename_expr(pred, {c: vis[c] for c in cols})
            pushed = _try_push_one(sub, node.right, schema)
            return rebuild(node, right=pushed if pushed is not None
                           else Filter(node.right, sub))
    return None


def _rename_expr(expr, mapping):
    if not isinstance(expr, tuple):
        return expr
    if expr[0] == "col":
        return ("col", mapping.get(expr[1], expr[1]))
    if expr[0] == "lit":
        return expr
    return (expr[0],) + tuple(_rename_expr(e, mapping) for e in expr[1:])


# -- rule 0: ORDER BY ... LIMIT -> TopK ------------------------------------

def _fuse_topk(node: PlanNode, memo: dict, dec: list) -> PlanNode:
    """``Limit(Sort(x), n)`` becomes ``TopK(x, keys, n)`` — semantically
    identical (sort-then-slice), but the fused node tells the executor the
    full sorted table is never observed, so a streaming partial top-k
    (capacity-n device buffer, merged once) is a legal physical plan."""
    if id(node) in memo:
        return memo[id(node)]
    kids = {f: _fuse_topk(getattr(node, f), memo, dec)
            for f in ("child", "left", "right") if hasattr(node, f)}
    out = rebuild(node, **{k: v for k, v in kids.items()
                           if v is not getattr(node, k)})
    if isinstance(out, Limit) and isinstance(out.child, Sort):
        srt = out.child
        out = TopK(srt.child, srt.keys, out.n)
        dec.append({"kind": "topk", "n": out.n,
                    "keys": [c for c, _ in out.keys]})
    memo[id(node)] = out
    return out


# -- rule 2: predicate pushdown into scan row-group pruning ----------------

def _range_of(pred):
    """``(column, lo, hi)`` for a single col-vs-literal comparison, else None.

    Strict bounds tighten by one only for integral literals; float strict
    bounds stay un-tightened (group stats pruning is conservative anyway —
    the retained row Filter enforces exact semantics).
    """
    if not (isinstance(pred, tuple) and len(pred) == 3
            and pred[0] in _RANGE_OPS):
        return None
    op, a, b = pred
    if a[0] == "lit" and b[0] == "col":  # normalize literal-first
        flip = {">=": "<=", "<=": ">=", ">": "<", "<": ">", "==": "=="}
        op, a, b = flip[op], b, a
    if a[0] != "col" or b[0] != "lit" or not isinstance(b[1], (int, float)) \
            or isinstance(b[1], bool):
        return None
    c, v = a[1], b[1]
    if op == ">=":
        return (c, v, None)
    if op == "<=":
        return (c, None, v)
    if op == ">":
        return (c, v + 1 if isinstance(v, int) else v, None)
    if op == "<":
        return (c, None, v - 1 if isinstance(v, int) else v)
    return (c, v, v)  # ==


def _push_scan_predicates(node: PlanNode, memo: dict) -> PlanNode:
    """Top-down: the *topmost* filter of a Filter-chain over a bare parquet
    Scan absorbs range bounds from the whole chain into the scan's pruning
    hint (bottom-up would install the inner filter's bound first and block
    the outer one)."""
    if id(node) in memo:
        return memo[id(node)]
    out = node
    if isinstance(node, Filter):
        chain = [node]
        cur = node.child
        while isinstance(cur, Filter):
            chain.append(cur)
            cur = cur.child
        if isinstance(cur, Scan) and cur.format == "parquet" \
                and cur.predicate is None:
            bounds: dict = {}
            for f in chain:
                for p in _split_conjunctions(f.predicate):
                    r = _range_of(p)
                    if r is None:
                        continue
                    c, lo, hi = r
                    plo, phi = bounds.get(c, (None, None))
                    if lo is not None:
                        plo = lo if plo is None else max(plo, lo)
                    if hi is not None:
                        phi = hi if phi is None else min(phi, hi)
                    bounds[c] = (plo, phi)
            # one column per scan hint: pick the most constrained (both
            # bounds beats one), first-seen on ties for determinism
            best = None
            for c, (lo, hi) in bounds.items():
                n = (lo is not None) + (hi is not None)
                if n and (best is None or n > best[1]):
                    best = (c, n, lo, hi)
            if best is not None:
                c, _, lo, hi = best
                rebuilt: PlanNode = rebuild(cur, predicate=(c, lo, hi))
                for f in reversed(chain):
                    rebuilt = Filter(rebuilt, f.predicate)
                out = rebuilt
        if out is node:  # no absorption: keep descending through the chain
            sub = _push_scan_predicates(node.child, memo)
            out = rebuild(node, child=sub) if sub is not node.child else node
    else:
        kids = {f: _push_scan_predicates(getattr(node, f), memo)
                for f in ("child", "left", "right") if hasattr(node, f)}
        out = rebuild(node, **{k: v for k, v in kids.items()
                               if v is not getattr(node, k)})
    memo[id(node)] = out
    return out


# -- rule 3: projection pruning --------------------------------------------

def _collect_required(node: PlanNode, needed, schema: _Schema, req: dict):
    """Accumulate the union of required columns per node (None = all).

    Shared nodes may be reached from several parents; the requirement only
    grows (set union, None dominating), and we re-descend whenever it grew
    so children see the widened set.  Plans are small; no fixpoint machinery
    needed.
    """
    if id(node) in req:
        prev = req[id(node)]
        merged = None if (prev is None or needed is None) \
            else prev | set(needed)
        if merged == prev:
            return  # nothing new to propagate
        req[id(node)] = merged
        needed = merged
    else:
        req[id(node)] = None if needed is None else set(needed)
        needed = req[id(node)]

    if isinstance(node, Scan):
        return
    if isinstance(node, Project):
        _collect_required(node.child, set(node.columns), schema, req)
    elif isinstance(node, Filter):
        sub = None if needed is None else needed | expr_columns(node.predicate)
        _collect_required(node.child, sub, schema, req)
    elif isinstance(node, (Sort, TopK)):
        sub = None if needed is None else needed | {c for c, _ in node.keys}
        _collect_required(node.child, sub, schema, req)
    elif isinstance(node, Limit):
        _collect_required(node.child, needed, schema, req)
    elif isinstance(node, Exchange):
        # hash placement reads the key columns even if no ancestor does
        sub = needed if (needed is None or node.kind != "hash") \
            else needed | set(node.keys)
        _collect_required(node.child, sub, schema, req)
    elif isinstance(node, Aggregate):
        sub = set(node.keys) | {c for c, _ in node.aggs if c is not None}
        _collect_required(node.child, sub, schema, req)
    elif isinstance(node, Join):
        if needed is None:
            _collect_required(node.left, None, schema, req)
            rsub = None
        else:
            lset = set(output_names(node.left, schema))
            lneed = (needed & lset) | set(node.left_keys)
            _collect_required(node.left, lneed, schema, req)
            rown = set(output_names(node.right, schema))
            rsub = set(node.right_keys)
            for c in needed - lset:
                if c in rown:
                    rsub.add(c)
                elif c.endswith("_r") and c[:-2] in rown:
                    rsub.add(c[:-2])
        if node.how in ("semi", "anti"):
            # right columns never reach the output; keys are all it needs
            rsub = set(node.right_keys)
        _collect_required(node.right, rsub, schema, req)
    else:
        raise TypeError(f"unknown plan node {type(node).__name__}")


def _apply_pruning(node: PlanNode, schema: _Schema, req: dict,
                   memo: dict) -> PlanNode:
    if id(node) in memo:
        return memo[id(node)]
    needed = req.get(id(node), None)
    kids = {f: _apply_pruning(getattr(node, f), schema, req, memo)
            for f in ("child", "left", "right") if hasattr(node, f)}
    out = rebuild(node, **{k: v for k, v in kids.items()
                           if v is not getattr(node, k)})
    if isinstance(out, Scan) and out.columns is None and needed is not None:
        order = schema.scan_names(out)
        cols = tuple(c for c in order if c in needed)
        if len(cols) < len(order):
            out = rebuild(out, columns=cols)
    memo[id(node)] = out
    return out


# -- estimates ---------------------------------------------------------------

def _scan_row_estimate(node: Scan) -> Optional[int]:
    """Row estimate for one scan from parquet footer metadata — the same
    row-group stats the pushdown machinery prunes with, reused as the
    broadcast-vs-shuffle cost input.  A pruning predicate discounts the
    groups its ``(column, lo, hi)`` hint would skip; ``None`` = unknown."""
    if node.format != "parquet":
        return None
    try:
        from ..io import ParquetFile
        f = ParquetFile(node.path)
        if node.predicate is None:
            return int(f.num_rows)
        pcol, lo, hi = node.predicate
        total = 0
        for gi in range(f.num_row_groups):
            st = f.group_stats(gi, pcol)
            if st is not None:
                gmin, gmax, _nulls = st
                if (hi is not None and gmin is not None and gmin > hi) or \
                        (lo is not None and gmax is not None and gmax < lo):
                    continue  # this group would be pruned
            total += f.row_groups[gi].num_rows
        return total
    except Exception:
        return None  # unreadable file: the executor will surface it


def _estimate_rows(node: PlanNode, memo: dict) -> Optional[int]:
    """Upper-bound row estimate per node (None = unknown).  Filters and
    aggregates only shrink their input; joins can expand, so they don't
    propagate an estimate."""
    if id(node) in memo:
        return memo[id(node)]
    if isinstance(node, Scan):
        est = _scan_row_estimate(node)
    elif isinstance(node, (Filter, Project, Sort, Exchange, Aggregate)):
        est = _estimate_rows(node.child, memo)
    elif isinstance(node, (Limit, TopK)):
        sub = _estimate_rows(node.child, memo)
        est = node.n if sub is None else min(node.n, sub)
    else:
        est = None
    memo[id(node)] = est
    return est


# -- rule 4: partitioning-aware exchange placement ----------------------------

#: join types whose RIGHT side may be replicated instead of shuffled: the
#: output is left-row-driven, so per-shard replicas of the build side never
#: duplicate result rows (right/full would emit their null-extended right
#: rows once per shard)
_BROADCAST_HOWS = ("inner", "left", "semi", "anti", "cross")


def _plan_exchanges(node: PlanNode, pmemo: dict, est: dict,
                    memo: dict, dec: list, warm=None) -> PlanNode:
    """Insert the minimal exchanges a distributed Join/Aggregate needs.

    Bottom-up, so each decision sees the children's (possibly already
    exchanged) partitioning:

    - **Join**: nothing when the build side is broadcast or the sides are
      already co-partitioned on the join keys (shuffle elimination by
      construction).  Otherwise a build whose footer row estimate is at or
      under ``config.broadcast_rows`` replicates
      (``Exchange(kind="broadcast")``); else both sides hash-exchange onto
      their join keys, skipping a side already placed correctly.
    - **Aggregate** (grouped): nothing when the input is already placed by
      a subset of the group keys.  Decomposable aggs split into a partial
      BELOW the exchange and a combine above it, so only per-shard partial
      rows cross; other aggs exchange the full input on the group keys.
      Order-sensitive aggs (first/last/collect_list) never distribute: the
      hash exchange does not keep row order, so their whole subtree stays
      the original single stream.

    ``warm`` is the AQE profile-history queue (adaptive.history_overrides):
    each placement-needing Join pops the prior run's measured build actual
    and plans from it instead of the footer estimate; joins are visited in
    the same postorder every run of a source fingerprint, so the queue
    aligns run 2's joins with run 1's recorded placements.
    """
    if id(node) in memo:
        return memo[id(node)]
    mark = len(dec)  # this subtree's ledger entries start here
    kids = {f: _plan_exchanges(getattr(node, f), pmemo, est, memo, dec,
                               warm)
            for f in ("child", "left", "right") if hasattr(node, f)}
    out = rebuild(node, **{k: v for k, v in kids.items()
                           if v is not getattr(node, k)})

    from ..utils.config import config
    if isinstance(out, Join):
        lp = partitioning(out.left, pmemo)
        rp = partitioning(out.right, pmemo)
        if rp.kind == "broadcast" or (
                out.how != "cross"
                and co_partitioned(lp, rp, out.left_keys, out.right_keys)):
            pass  # already co-located
        else:
            rows = _estimate_rows(out.right, est)
            warmed = None
            if warm is not None:
                from . import adaptive
                hint = adaptive.next_build_actual(warm)
                if hint is not None and hint.get("actual_rows") is not None:
                    # AQE rule 3 (engine/adaptive.py): the prior run of
                    # this source fingerprint measured this build side, so
                    # plan from its actual instead of the footer estimate
                    warmed = {"kind": "adaptive:history_warmed",
                              "est_before": rows,
                              "est_rows": int(hint["actual_rows"]),
                              "prior_kind": hint.get("prior_kind"),
                              "runs": warm.get("runs", 1),
                              "threshold": int(config.broadcast_rows),
                              "choice": "none"}
                    rows = int(hint["actual_rows"])
            if out.how in _BROADCAST_HOWS and rows is not None \
                    and rows <= config.broadcast_rows:
                out = rebuild(out, right=Exchange(out.right,
                                                  kind="broadcast"))
                dec.append({"kind": "broadcast", "how": out.how,
                            "est_rows": int(rows),
                            "threshold": int(config.broadcast_rows)})
                if warmed is not None:
                    warmed["choice"] = "broadcast"
            elif out.how != "cross":
                left, right = out.left, out.right
                if not (lp.kind == "hash"
                        and tuple(lp.keys) == tuple(out.left_keys)):
                    left = Exchange(left, out.left_keys, "hash")
                    dec.append({"kind": "shuffle", "side": "left",
                                "keys": list(out.left_keys),
                                "est_rows": _estimate_rows(out.left, est),
                                "build_est_rows": rows,
                                "threshold": int(config.broadcast_rows)})
                if not (rp.kind == "hash"
                        and tuple(rp.keys) == tuple(out.right_keys)):
                    right = Exchange(right, out.right_keys, "hash")
                    dec.append({"kind": "shuffle", "side": "right",
                                "keys": list(out.right_keys),
                                "est_rows": rows,
                                "threshold": int(config.broadcast_rows)})
                out = rebuild(out, left=left, right=right)
                if warmed is not None:
                    warmed["choice"] = "shuffle"
            if warmed is not None:
                dec.append(warmed)
    elif isinstance(out, Aggregate):
        from .executor import _STREAM_COMBINE
        p = partitioning(out.child, pmemo)
        if any(op in ORDER_SENSITIVE_AGGS for _, op in out.aggs):
            # revert to the pre-pass subtree, ledger entries included: no
            # planner-placed exchange may reorder rows below this aggregate
            out = node
            del dec[mark:]
            dec.append({"kind": "order_sensitive_revert",
                        "keys": list(node.keys),
                        "aggs": sorted({op for _, op in node.aggs
                                        if op in ORDER_SENSITIVE_AGGS})})
        elif not out.keys:
            pass  # ungrouped: one global group, no placement to satisfy
        elif p.kind == "broadcast" or (p.kind == "hash"
                                       and set(p.keys) <= set(out.keys)):
            pass  # every group's rows already share a shard
        elif all(op in _STREAM_COMBINE for _, op in out.aggs):
            partial = Aggregate(out.child, out.keys, out.aggs, out.names)
            combine = tuple((nm, _STREAM_COMBINE[op])
                            for nm, (_c, op) in zip(out.names, out.aggs))
            out = Aggregate(Exchange(partial, out.keys, "hash"),
                            out.keys, combine, out.names)
            dec.append({"kind": "partial_agg", "keys": list(out.keys),
                        "est_rows": _estimate_rows(node, est)})
        else:
            out = rebuild(out, child=Exchange(out.child, out.keys, "hash"))
            dec.append({"kind": "shuffle", "side": "aggregate",
                        "keys": list(out.keys),
                        "est_rows": _estimate_rows(node, est)})
    memo[id(node)] = out
    return out


# -- shuffle elimination -----------------------------------------------------

def _eliminate_exchanges(node: PlanNode, pmemo: dict, memo: dict,
                         dec: list) -> PlanNode:
    """Drop exchanges whose child is already placed the way they'd place
    it, and collapse back-to-back exchanges (only the outer placement
    survives the wire anyway) — the cleanup pass for hand-built plans that
    carry explicit Exchange nodes."""
    if id(node) in memo:
        return memo[id(node)]
    kids = {f: _eliminate_exchanges(getattr(node, f), pmemo, memo, dec)
            for f in ("child", "left", "right") if hasattr(node, f)}
    out = rebuild(node, **{k: v for k, v in kids.items()
                           if v is not getattr(node, k)})
    while isinstance(out, Exchange):
        p = partitioning(out.child, pmemo)
        if out.kind == "hash" and p.kind == "hash" \
                and tuple(p.keys) == tuple(out.keys):
            dec.append({"kind": "exchange_eliminated", "exchange": "hash",
                        "keys": list(out.keys)})
            out = out.child  # child rows already live where we'd send them
        elif out.kind == "broadcast" and p.kind == "broadcast":
            dec.append({"kind": "exchange_eliminated",
                        "exchange": "broadcast", "keys": []})
            out = out.child
        elif isinstance(out.child, Exchange):
            dec.append({"kind": "exchange_folded",
                        "inner": out.child.kind,
                        "keys": list(out.child.keys)})
            out = rebuild(out, child=out.child.child)
        else:
            break
    memo[id(node)] = out
    return out


# -- driver ----------------------------------------------------------------

def _stamp_evidence(plan: PlanNode, decisions: list, dist: bool) -> None:
    """Attach the cardinality + decision ledger to the optimized plan.

    Every node gets an ``_est_rows`` attribute (the ``_estimate_rows``
    upper bound, None = unknown) and the root gets ``_decisions`` — both
    as plain object attributes, NOT dataclass fields, so canonical
    serialization and plan fingerprints stay byte-identical.  Unknown
    estimates tick ``engine.estimate.unknown`` (one per blind node per
    optimize) so un-scorable plans are visible instead of silent.

    Structural decisions (broadcast / shuffle / partial_agg / topk /
    order_sensitive_revert) are assigned their dotted path in the FINAL
    plan by zipping, per kind and in postorder, against
    ``verify.decision_census``, the same static census EXPLAIN renders.
    Elimination/fold entries left no structure behind and carry no path.
    """
    est_memo: dict = {}
    unknown = 0
    for n in topo_nodes(plan):
        e = _estimate_rows(n, est_memo)
        if e is None:
            unknown += 1
        object.__setattr__(n, "_est_rows", e)
    if unknown:
        from ..utils import metrics
        metrics.count("engine.estimate.unknown", unknown)
    from .verify import decision_census
    by_kind: dict = {}
    for c in decision_census(plan, dist=dist):
        by_kind.setdefault(c["kind"], []).append(c)
    for d in decisions:
        q = by_kind.get(d["kind"])
        if q:
            d["path"] = q.pop(0)["path"]
    object.__setattr__(plan, "_decisions", decisions)


def _stamp_partials(plan: PlanNode) -> None:
    """Mark ``_partial`` the lower Aggregate of every partial/combine split
    this optimize made (its ``partial_agg`` decisions, at their census
    paths), where the plan still has the split's shape: the combine above a
    hash exchange on the same keys, re-aggregating each partial output
    with its ``_STREAM_COMBINE`` op.  Ranked execution
    (engine/placement.py) runs a marked partial on each rank's rows and
    leaves the combine to finish the groups; any other Aggregate over
    split rows is combined or gathered across the ranks."""
    from .executor import _STREAM_COMBINE
    from .verify import node_paths
    paths = node_paths(plan)
    at = {paths[id(n)]: n for n in topo_nodes(plan)}
    for d in getattr(plan, "_decisions", ()):
        top = at.get(d.get("path")) if d["kind"] == "partial_agg" else None
        ex = getattr(top, "child", None)
        low = getattr(ex, "child", None)
        if isinstance(top, Aggregate) and isinstance(ex, Exchange) \
                and ex.kind == "hash" and isinstance(low, Aggregate) \
                and tuple(low.keys) == tuple(top.keys) \
                and set(ex.keys) <= set(top.keys) \
                and all(op in _STREAM_COMBINE for _, op in low.aggs) \
                and tuple(map(tuple, top.aggs)) == tuple(
                    (nm, _STREAM_COMBINE[op])
                    for nm, (_c, op) in zip(low.names, low.aggs)):
            object.__setattr__(low, "_partial", True)


def optimize(plan: PlanNode, distribute: bool = False,
             ranks=None) -> PlanNode:
    """Apply all rewrite rules; returns a new plan (input untouched).

    With ``ranks`` (a group of ``parallel/ranks.py``) this is a collective
    of that group: rank 0 plans and every rank receives rank 0's physical
    plan with its stamps, so every rank executes the same plan
    (``execute(ranks=)``); when rank 0's planning raises, every rank
    raises its error.  See ``_optimize`` for the rules."""
    from ..parallel import ranks as _ranks
    return _ranks.on_root(lambda: _optimize(plan, distribute), ranks) \
        if _ranks.active(ranks) else _optimize(plan, distribute)


def _optimize(plan: PlanNode, distribute: bool = False) -> PlanNode:
    """Apply all rewrite rules; returns a new plan (input untouched).

    Unless ``config.verify`` is off, the plan verifier (engine/verify.py)
    runs on the input plan (build-time checks: unknown columns, join-key
    dtype mismatches, invalid casts) and again after every rewrite rule,
    asserting the root output schema and nullability are unchanged: a rule
    that alters them raises ``PlanVerificationError`` instead of producing
    a silently wrong result.

    ``distribute=True`` turns the partitioning-aware exchange placement on
    (``_plan_exchanges``, then ``verify.check_partitioning``).  Shuffle
    elimination (``_eliminate_exchanges``) also runs on plans that carry
    hand-placed Exchange nodes.

    The optimized plan carries per-node ``_est_rows`` and a root
    ``_decisions`` ledger (see ``_stamp_evidence``) that EXPLAIN, the
    executor and the profile store read.  With ``config.aqe`` a distributed
    plan's build estimates are warmed from the profile store's history of
    the same source plan (``adaptive.history_overrides``) and the runtime
    rules' eligibility is stamped (``adaptive.stamp_eligibility``); with
    ``config.fuse_exchange`` every partial/final sandwich carries its
    ``FusedStage`` (``_fuse_stage``).  Stamps are plain attributes, so
    fingerprints stay byte-identical.
    """
    from ..utils.config import config
    checker = None
    if config.verify:
        from .verify import RewriteChecker
        checker = RewriteChecker(plan)
    # the SOURCE (pre-rewrite) fingerprint keys profile history across
    # runs: warming exists to change the optimized shape, so the optimized
    # fingerprint cannot be the cross-run key.  Only paid when the store
    # is on.
    src_fp = plan.fingerprint() if config.profile_dir else None
    schema = _Schema()
    decisions: list = []
    plan = _fuse_topk(plan, {}, decisions)
    if checker is not None:
        checker.check("fuse_topk", plan)
    plan = _push_filters(plan, schema, {})
    if checker is not None:
        checker.check("push_filters", plan)
    plan = _push_scan_predicates(plan, {})
    if checker is not None:
        checker.check("push_scan_predicates", plan)
    if distribute:
        warm = None
        if config.aqe and src_fp:
            from . import adaptive
            warm = adaptive.history_overrides(src_fp)
        plan = _plan_exchanges(plan, {}, {}, {}, decisions, warm)
        if checker is not None:
            checker.check("plan_exchanges", plan)
    if distribute or any(isinstance(n, Exchange) for n in topo_nodes(plan)):
        plan = _eliminate_exchanges(plan, {}, {}, decisions)
        if checker is not None:
            checker.check("eliminate_exchanges", plan)
    req: dict = {}
    _collect_required(plan, None, schema, req)
    plan = _apply_pruning(plan, schema, req, {})
    if checker is not None:
        checker.check("prune_projections", plan)
    if distribute and config.verify:
        from .verify import check_partitioning
        check_partitioning(plan)
    _stamp_evidence(plan, decisions, distribute)
    if src_fp is not None:
        object.__setattr__(plan, "_source_fingerprint", src_fp)
    if distribute:
        # the runtime rules' eligibility stamps go on last: any later
        # structural pass would rebuild the nodes and drop them
        from . import adaptive
        adaptive.stamp_eligibility(plan)
        _stamp_partials(plan)
    if config.fuse_exchange:
        # whole-stage fusion hint: the executor dispatches the
        # planner-blessed FusedStage instead of re-deriving it
        from . import segment as sg
        for n in topo_nodes(plan):
            st = sg.fused_sandwich(n)
            if st is not None:
                object.__setattr__(n, "_fuse_stage", st)
    return plan
