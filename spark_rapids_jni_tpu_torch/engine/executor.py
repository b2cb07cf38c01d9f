"""Physical execution: walk an optimized plan DAG onto the ops/io layers.

The port of ``spark_rapids_jni_tpu/engine/executor.py`` for one device.
One node type maps onto one entry point (Scan -> io readers, Join ->
ops.join, Aggregate -> ops.aggregate.groupby, ...).  The interesting path
is streaming aggregation: when an ``Aggregate`` sits over exactly one
chunked parquet ``Scan`` (reachable through Filter/Project/Join nodes
only), the executor iterates ``ParquetChunkedReader`` and computes a
partial aggregate per chunk, then combines the partials with a second
groupby.  Only decomposable ops (sum/count/count_all/min/max) stream.

The streamed loop has two routes, as in the JAX package: ``iter_staged``
(host decode, one staged transfer a chunk) and ``iter_device``: each row
group's compressed pages cross the link and a ``CompiledDecodeSegment``
decodes them on the device (the K3/W1/W2 kernels on the card) and runs the
chain on them, with no host sync per chunk.  The device route is taken
whenever the target is a card (``config.device_decode`` pins a route).
Once a stream is on the device route, every path of it decodes the pages
there: a schema veto, a fused=False run and the out-of-memory step down
to the interpreted loop all decode each chunk with ``decode_table`` and
then interpret; on a card a failed transfer raises instead of re-planning
the group onto the host decoder (the JAX package re-plans it; the port
keeps that only for the CPU).  Groups whose columns the device decoder
cannot take (``plan_device_group``'s reasons) keep the host decoder.

``execute(plan, stats=..., device=...)`` fills a stats dict (row groups
pruned/read, chunk count, whether streaming engaged) and runs every reader
and op on ``device`` (default ``"cuda"``).  With ``ranks=`` (a group of
``parallel/ranks.py``) every rank of it executes the same plan over its
split of the scans, the exchanges move rows between the ranks, and the
result is gathered, so every rank returns it (``engine/placement.py``).

Scans read Parquet and ORC.  An Exchange places rows across the engine's
mesh of ``config.shards`` shards (the identity on one shard, as the JAX
package's ``ndev <= 1`` branch): a hash shuffle or a broadcast.  With
``config.fuse_exchange`` a partial/final aggregate sandwich runs as one
fused stage (``segment.FusedStage``, ``_try_fused_stage``), and with
``config.aqe`` the runtime rules of ``engine/adaptive.py`` run at the
exchanges: the broadcast flip, the hot-key skew split with its
post-exchange combine, and the counts probe that routes a hot fused stage
to the host path.  Exchanges emit spans, flows and per-shard lanes on the
event timeline (``config.timeline``).  ``execute(session=...)`` runs the
plan as a scheduled tenant (``engine/scheduler.py``): chunk boundaries are
fair-share gates, chunk bytes charge the session's memory budget, the
spilled exchange sizes its passes within that budget, and the OOM ladder
retries a rung once for a session within its budget before degrading.
Every execute runs under a flight-recorder trace scope
(``utils/blackbox.py``), and a failed one leaves a post-mortem bundle when
``config.blackbox_dir`` is set.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from ..columnar import Column, Table
from ..dtypes import TypeId, int64_values
from ..utils import metrics, timeline
from ..utils.errors import CancelToken, classify
from ..utils.memory import table_nbytes
from .placement import REP, SPLIT, Placement, hashed
from .plan import (Aggregate, Exchange, Filter, Join, Limit, PlanNode,
                   Project, Scan, Sort, TopK, node_label, topo_nodes)
from .recovery import RecoveryPolicy, query_cancel_token

#: aggregate ops with a (merge-op) decomposition usable for per-chunk
#: partials; value = op that combines partial results
_STREAM_COMBINE = {"sum": "sum", "count": "sum", "count_all": "sum",
                   "min": "min", "max": "max"}


def _join_fns():
    from ..ops import join as j
    return {"inner": j.inner_join, "left": j.left_join,
            "right": j.right_join, "full": j.full_join,
            "semi": j.left_semi_join, "anti": j.left_anti_join,
            "cross": j.cross_join}


@contextlib.contextmanager
def _scope(name: str):
    """A ``torch.profiler`` range, so a trace attributes device time to the
    plan node or segment that launched it, and a span of the same name on
    the event timeline when that is on."""
    with torch.profiler.record_function(name), timeline.span(name):
        yield


# -- filter expression evaluation ------------------------------------------

def _comparable(v, other):
    """A column's values for a comparison with ``other``: an integral column
    against a float literal compares in float64, as the JAX package's
    x64 promotion does (torch would promote to float32)."""
    if isinstance(v, torch.Tensor) and isinstance(other, float) \
            and not v.dtype.is_floating_point:
        return v.to(torch.float64)
    return v


def _eval_expr(expr, table: Table):
    """Evaluate to ``(values, valid_or_None)``; comparisons give bool data."""
    head = expr[0]
    if head == "col":
        c = table.column(expr[1])
        if c.dtype.is_string:
            return c, c.validity  # compared via ops.strings.equal below
        vals = c.data
        if c.dtype.is_unsigned and c.dtype.id not in (TypeId.UINT8,
                                                     TypeId.UINT64):
            vals = int64_values(c.dtype, vals)  # storage holds the bits
        return vals, c.validity
    if head == "lit":
        return expr[1], None
    if head == "not":
        v, valid = _eval_expr(expr[1], table)
        return torch.logical_not(v), valid
    a, avalid = _eval_expr(expr[1], table)
    b, bvalid = _eval_expr(expr[2], table)
    valid = avalid if bvalid is None else \
        (bvalid if avalid is None else avalid & bvalid)
    if isinstance(a, Column) or isinstance(b, Column):
        if head not in ("==", "!="):
            raise ValueError(
                f"string comparison {head!r} unsupported (only ==/!=; "
                f"verify() rejects ordering comparisons over strings)")
        from ..ops import strings as _strings
        scol, other = (a, b) if isinstance(a, Column) else (b, a)
        eq = _strings.equal(scol, other).data.to(torch.bool)
        return (eq if head == "==" else torch.logical_not(eq)), valid
    if head == "&":
        return torch.logical_and(a, b), valid
    if head == "|":
        return torch.logical_or(a, b), valid
    a, b = _comparable(a, b), _comparable(b, a)
    if head == ">=":
        return a >= b, valid
    if head == "<=":
        return a <= b, valid
    if head == ">":
        return a > b, valid
    if head == "<":
        return a < b, valid
    if head == "==":
        return a == b, valid
    if head == "!=":
        return a != b, valid
    raise ValueError(f"unknown expression op {head!r}")


def _mask_of(vals, valid):
    """Keep-mask of an evaluated predicate: NULL comparisons drop the row
    (SQL semantics)."""
    mask = vals.to(torch.bool)
    return mask if valid is None else mask & valid


def _filter_table(table: Table, predicate) -> Table:
    from ..ops.selection import apply_boolean_mask
    return apply_boolean_mask(table, _mask_of(*_eval_expr(predicate, table)))


# -- execution stats -------------------------------------------------------

def new_stats() -> dict:
    return {"row_groups_pruned": 0, "row_groups_read": 0,
            "chunks": 0, "streamed": False, "nodes": 0,
            "fused_segments": 0, "pipelined": False, "topk": False,
            "exchanges": 0, "aqe_flips": 0, "aqe_splits": 0}


# -- execution context -----------------------------------------------------

class _ExecCtx:
    """Per-execute knobs + segment memoization.

    ``fuse``: run Filter/Project/Aggregate chains as compiled segments
    (engine/segment.py) instead of interpreting node by node.
    ``prefetch``: chunked-scan pipeline depth (0 = serial).
    ``recovery``: the query's RecoveryPolicy, checked at every chunk
    boundary.  ``root``: the plan being executed (the device-decode and
    adaptive ledger entries land on it).  ``device``: where every reader and
    op runs.  ``stats``: the execution's stats dict (the AQE rules count
    into it).
    """

    __slots__ = ("fuse", "prefetch", "nparents", "segments", "recovery",
                 "root", "device", "stats", "ranks", "place")

    def __init__(self, root: PlanNode, fuse: bool, prefetch: int,
                 recovery: RecoveryPolicy, device: torch.device,
                 stats: Optional[dict] = None, ranks=None):
        from .segment import parent_counts
        self.root = root
        self.stats = new_stats() if stats is None else stats
        self.fuse = fuse
        self.prefetch = max(0, int(prefetch))
        self.nparents = parent_counts(root) if fuse else {}
        self.segments: dict = {}  # id(top node) -> Segment | None
        self.recovery = recovery
        self.device = device
        # the group this execution spreads over (None: one process) and
        # where each node's rows live over it (engine/placement.py)
        from ..parallel import ranks as _ranks
        self.ranks = ranks if _ranks.active(ranks) else None
        self.place = Placement(root) if self.ranks else None

    def segment_for(self, node: PlanNode):
        if not self.fuse:
            return None
        sid = id(node)
        if sid not in self.segments:
            from .segment import build_segment, worthwhile
            seg = build_segment(node, self.nparents)
            if seg is not None and not worthwhile(seg):
                seg = None
            self.segments[sid] = seg
        return self.segments[sid]


# -- streaming-aggregation eligibility -------------------------------------

def _depends_on(node: PlanNode, target: PlanNode, memo: dict) -> bool:
    if node is target:
        return True
    if id(node) in memo:
        return memo[id(node)]
    r = any(_depends_on(c, target, memo) for c in node.children())
    memo[id(node)] = r
    return r


def _single_chunked_scan(root: PlanNode) -> Optional[Scan]:
    """The single chunked parquet Scan under ``root`` reachable through
    Filter/Project/Join nodes only (scan feeding exactly one join side):
    the stream axis both partial aggregation and partial top-k need."""
    scans = [n for n in topo_nodes(root)
             if isinstance(n, Scan) and n.chunk_bytes
             and n.format == "parquet"]
    if len(scans) != 1:
        return None
    scan = scans[0]
    dep: dict = {}
    node = root
    while node is not scan:
        if isinstance(node, (Filter, Project)):
            node = node.child
        elif isinstance(node, Join):
            ld = _depends_on(node.left, scan, dep)
            rd = _depends_on(node.right, scan, dep)
            if ld and rd:
                return None  # scan on both sides: no single stream axis
            node = node.left if ld else node.right
        else:
            return None  # Sort/Limit/Aggregate between: not decomposable
    return scan


def _stream_scan_of(agg: Aggregate) -> Optional[Scan]:
    """The single chunked parquet Scan this Aggregate can stream over:
    every agg op decomposable, non-empty grouping keys, and a
    ``_single_chunked_scan`` under the child."""
    if not agg.keys:
        return None
    if any(op not in _STREAM_COMBINE for _, op in agg.aggs):
        return None
    return _single_chunked_scan(agg.child)


# -- placement over ranks --------------------------------------------------

def _gathered(table: Table, node: Optional[PlanNode],
              ctx: _ExecCtx) -> Table:
    """``node``'s output ``table`` whole on every rank (a no-op when it
    already is; ``node`` None: a table split over the ranks)."""
    from ..parallel.mesh import gather_table
    if ctx.ranks is None or (node is not None and ctx.place.of(node) == REP):
        return table
    ctx.recovery.checkpoint()  # the group's vote, before it gathers
    with _scope("engine.ranks.gather"):
        return gather_table(table, ctx.ranks)


def _chain_gathers_nothing(node: PlanNode, scan: Scan, ctx: _ExecCtx) -> bool:
    """True when no Join between ``node`` and the streamed ``scan`` must
    gather a side: then the stream over this rank's split of the scan is
    this rank's share of the chain."""
    dep: dict = {}
    while node is not scan:
        if isinstance(node, (Filter, Project)):
            node = node.child
            continue
        gl, gr, _ = ctx.place.join(node)
        if gl or gr:
            return False
        node = node.left if _depends_on(node.left, scan, dep) \
            else node.right
    return True


def _combine_ranks(table: Table, node: Aggregate, ctx: _ExecCtx) -> Table:
    """Gather every rank's partial groups of a decomposable Aggregate and
    combine them into the whole answer."""
    from ..ops.aggregate import groupby
    t = _gathered(table, None, ctx)
    return groupby(t, list(node.keys),
                   [(nm, _STREAM_COMBINE[op])
                    for nm, (_c, op) in zip(node.names, node.aggs)],
                   names=list(node.names), device=ctx.device)


# -- the walk --------------------------------------------------------------

def _scan_split(scan: Scan, ctx: _ExecCtx):
    """``(rank, world)`` when this scan's row groups split over the ranks."""
    return (ctx.ranks.rank, ctx.ranks.world) \
        if ctx.ranks is not None and id(scan) in ctx.place.split else None


def _scan_table(scan: Scan, stats: dict, ctx: _ExecCtx) -> Table:
    cols = list(scan.columns) if scan.columns else None
    split = _scan_split(scan, ctx)
    if scan.format == "orc":
        from ..io import ORCChunkedReader, read_orc
        if scan.predicate is None:
            return read_orc(scan.path, cols, device=ctx.device)
        # stripe pruning by the predicate's statistics; the row Filter
        # above keeps the exact semantics
        from ..ops.selection import concat_tables
        reader = ORCChunkedReader(scan.path, cols, tuple(scan.predicate),
                                  device=ctx.device)
        parts = list(reader)
        stats["row_groups_read"] += len(parts)
        stats["row_groups_pruned"] += reader.file.num_stripes - len(parts)
        if not parts:
            return reader.file.empty_table(cols, device=ctx.device)
        return concat_tables(parts)
    if scan.predicate is None and scan.chunk_bytes is None and split is None:
        from ..io import read_parquet
        return read_parquet(scan.path, cols, device=ctx.device)
    # pruning or chunking requested: go through the chunked reader so
    # footer-stats pruning applies, then materialize
    from ..io import ParquetChunkedReader
    from ..ops.selection import concat_tables, slice_table
    reader = ParquetChunkedReader(
        scan.path, pass_read_limit=scan.chunk_bytes or (64 << 20),
        columns=cols, predicate=scan.predicate,
        cancel=ctx.recovery.cancel, device=ctx.device, split=split)
    if _decode_on_device(ctx.device):
        # the device route, as a streamed scan takes it: each row group's
        # compressed pages cross the link and decode on the device (the
        # K3/W1/W2 kernels on a card); groups the device decoder cannot
        # take arrive host-decoded.  The JAX package materializes every
        # scan through its host decoder.
        parts = [slice_table(t, 0, nv) for t, nv in
                 (_dev_item_decoded(item, ctx)
                  for item in reader.iter_device(ctx.prefetch))]
    else:
        parts = list(reader)
    stats["row_groups_pruned"] += reader.groups_pruned
    stats["row_groups_read"] += reader.groups_read
    if not parts:
        return reader.file.empty_table(cols, device=ctx.device)
    return concat_tables(parts)


def _groupby(table: Table, agg: Aggregate, ctx: _ExecCtx) -> Table:
    from ..ops.aggregate import groupby
    return groupby(table, list(agg.keys), [(c, op) for c, op in agg.aggs],
                   names=list(agg.names), device=ctx.device)


def _interp_chain(seg, t: Table, ctx: _ExecCtx) -> Table:
    """Interpreter fallback for a segment whose input schema turned out
    runtime-ineligible (string filter columns, nested buffers): exactly the
    node-by-node semantics."""
    for nd in seg.chain:
        t = _filter_table(t, nd.predicate) if isinstance(nd, Filter) \
            else t.select(list(nd.columns))
    if seg.agg is not None:
        t = _groupby(t, seg.agg, ctx)
    return t


def _exec_segment(seg, memo: dict, stats: dict, ctx: _ExecCtx,
                  node: Optional[PlanNode] = None) -> Table:
    """Run one fused segment: materialize its input (a breaker boundary),
    then one compiled callable over the whole chain."""
    from . import segment as sg
    inp = _exec(seg.input, memo, stats, ctx)
    # interior chain nodes never pass through _exec; keep the node count
    # meaning "plan nodes executed" either way
    stats["nodes"] += len(seg.chain) - (0 if seg.agg is not None else 1)
    qm = metrics.current()
    if qm is not None and node is not None \
            and all(c is not seg.input for c in node.children()):
        # the chain collapses into one callable, so the segment root's
        # rows_in/bytes_in is the breaker-boundary input
        qm.node_add(id(node), node_label(node),
                    rows_in=inp.num_rows, bytes_in=table_nbytes(inp))
    if not sg.runtime_eligible(seg, inp):
        return _interp_chain(seg, inp, ctx)
    compiled = sg.SEGMENT_CACHE.get(seg, inp)
    stats["fused_segments"] += 1
    with _scope("engine.fused_segment"):
        if seg.agg is not None:
            return sg.run_agg_segment(compiled, inp)
        return sg.run_map_segment(compiled, inp)


def _exec_scan(node: Scan, memo: dict, stats: dict, ctx: _ExecCtx) -> Table:
    return _scan_table(node, stats, ctx)


def _exec_filter(node: Filter, memo: dict, stats: dict,
                 ctx: _ExecCtx) -> Table:
    seg = ctx.segment_for(node)
    if seg is not None:
        return _exec_segment(seg, memo, stats, ctx, node)
    return _filter_table(_exec(node.child, memo, stats, ctx),
                         node.predicate)


def _exec_project(node: Project, memo: dict, stats: dict,
                  ctx: _ExecCtx) -> Table:
    seg = ctx.segment_for(node)
    if seg is not None:
        return _exec_segment(seg, memo, stats, ctx, node)
    return _exec(node.child, memo, stats, ctx).select(list(node.columns))


def _exec_join(node: Join, memo: dict, stats: dict, ctx: _ExecCtx) -> Table:
    left = _exec(node.left, memo, stats, ctx)
    right = _exec(node.right, memo, stats, ctx)
    if ctx.ranks is not None:
        gl, gr, out = ctx.place.join(node)
        ctx.place.record(node, out)
        if gl:
            left = _gathered(left, node.left, ctx)
        if gr:
            right = _gathered(right, node.right, ctx)
    if node.how == "cross":
        return _join_fns()["cross"](left, right, device=ctx.device)
    return _join_fns()[node.how](left, right, list(node.left_keys),
                                 list(node.right_keys), device=ctx.device)


def _exec_aggregate(node: Aggregate, memo: dict, stats: dict,
                    ctx: _ExecCtx) -> Table:
    if ctx.ranks is None:
        return _aggregate_here(node, memo, stats, ctx)
    # over ranks: a non-decomposable aggregate whose input is not placed
    # by its keys gathers that input; a decomposable one runs on this
    # rank's rows (streamed when nothing on the way must gather), then
    # combines the ranks' partials unless its input placement (or its
    # exchange above) already gives each group one rank
    if not all(op in _STREAM_COMBINE for _, op in node.aggs):
        t = _exec(node.child, memo, stats, ctx)
        mode, out = ctx.place.aggregate(node)
        ctx.place.record(node, out)
        if mode == "gather":
            return _groupby(_gathered(t, node.child, ctx), node, ctx)
        return _aggregate_here(node, memo, stats, ctx)
    scan = _stream_scan_of(node)
    t = _aggregate_here(node, memo, stats, ctx, stream=scan is None or
                        _chain_gathers_nothing(node.child, scan, ctx))
    mode, out = ctx.place.aggregate(node)
    ctx.place.record(node, out)
    return _combine_ranks(t, node, ctx) if mode == "combine" else t


def _aggregate_here(node: Aggregate, memo: dict, stats: dict,
                    ctx: _ExecCtx, stream: bool = True) -> Table:
    scan = _stream_scan_of(node) if stream else None
    if scan is not None:
        # scan-independent subtrees go into the shared memo BEFORE the
        # stats snapshot: a degraded re-run finds them memoized and skips
        # them, so their counts must survive the restore below
        _precompute_independent(node.child, scan, memo, stats, ctx)
        snap = {k: (list(v) if isinstance(v, list) else v)
                for k, v in stats.items()}

        def restore():
            # drop a failed attempt's partial evidence so the re-run's
            # accounting isn't double-counted; lists re-copied so a second
            # restore starts from the clean snapshot too
            stats.clear()
            stats.update({k: (list(v) if isinstance(v, list) else v)
                          for k, v in snap.items()})

        try:
            return _exec_streamed(node, scan, memo, stats, ctx)
        except Exception as e:
            # resource exhaustion on the fused/staged stream degrades to
            # the interpreted per-chunk path, the always-correct fallback
            # with a smaller device footprint
            if not ctx.recovery.can_degrade(e):
                raise
            restore()
            if ctx.recovery.oom_retry_first("stream.fused", e):
                # a session within its own budget: the pressure was a
                # neighbour's, so one same-rung retry before degrading
                try:
                    return _exec_streamed(node, scan, memo, stats, ctx)
                except Exception as e2:
                    if not ctx.recovery.can_degrade(e2):
                        raise
                    restore()
                    e = e2
            ctx.recovery.degrade("stream-interpreted", e, stats)
            return _exec_streamed(node, scan, memo, stats, ctx,
                                  force_interp=True)
    from ..utils.config import config
    if config.fuse_exchange:
        out = _try_fused_stage(node, memo, stats, ctx)
        if out is not None:
            return out
    seg = ctx.segment_for(node)
    if seg is not None:
        return _exec_segment(seg, memo, stats, ctx, node)
    return _groupby(_exec(node.child, memo, stats, ctx), node, ctx)


def _fused_fallback(ctx: _ExecCtx, ex: Exchange, reason: str) -> None:
    """Count and ledger one give-way of the fused stage to the
    host-orchestrated exchange (a runtime re-plan, never an error)."""
    from . import adaptive
    metrics.count("engine.fused_stage.fallbacks")
    adaptive.record(ctx.root, {"kind": "fused_stage",
                               "path": adaptive._path(ctx.root, ex),
                               "dispatch": "host", "reason": reason})


def _try_fused_stage(node: Aggregate, memo: dict, stats: dict,
                     ctx: _ExecCtx) -> Optional[Table]:
    """Whole-stage fusion (``segment.FusedStage``): run the ``partial-agg
    -> hash Exchange -> final-agg`` sandwich rooted at ``node`` as one
    device pass over every shard, with no host round trip between the
    three plan nodes.  Returns the stage result, or None to fall through
    to the host-orchestrated path: not a sandwich, shared interior nodes,
    an ineligible schema, the AQE probe routing a hot stage to the host, or
    prefix/capacity overflow.  Each give-way is counted
    (``engine.fused_stage.fallbacks``) and ledgered; a failure inside the
    pass raises."""
    from ..parallel.mesh import ROW_AXIS, default_shards, make_mesh
    from ..utils.config import config
    from . import segment as sg

    # prefer the optimizer's stamped hint; hand-built plans re-derive it
    stage = getattr(node, "_fuse_stage", None) or sg.fused_sandwich(node)
    if stage is None:
        return None
    ndev = default_shards(ctx.ranks)
    if ndev <= 1:
        return None  # placement over one shard is the identity
    ex, partial = stage.exchange, stage.partial
    npar = ctx.nparents if ctx.fuse else sg.parent_counts(ctx.root)
    if npar.get(id(ex), 1) != 1 or npar.get(id(partial), 1) != 1:
        _fused_fallback(ctx, ex, "shared")
        return None  # shared interior nodes must materialize for others
    inp = _exec(partial.child, memo, stats, ctx)
    if ctx.ranks is not None and ctx.place.of(partial.child) == REP:
        inp = _rank_block(inp, ctx)  # each rank aggregates its own rows
    if not sg.fused_runtime_eligible(stage, inp):
        _fused_fallback(ctx, ex, "schema")
        return None
    mesh = make_mesh(ndev, device=ctx.device, ranks=ctx.ranks)

    prepped = None
    if config.aqe and getattr(ex, "_aqe_split", False):
        # AQE escape hatch: the skew split fires at the exchange boundary
        # this fusion erases, so a counts probe picks the path.  Input-row
        # skew at or under the split threshold dispatches the fused pass;
        # anything hotter routes to the host path, where try_skew_split
        # still fires.  Row skew bounds partial-group skew from above, so
        # the probe only errs toward the adaptive path.
        from ..parallel import shuffle as sh
        from . import adaptive
        probed, n = sg.fused_pad(inp.select(stage.sel_names()), ndev, mesh)
        counts = sh.partition_counts(probed, mesh, list(stage.combine.keys),
                                     n_valid_rows=n)
        prepped = (probed, n)  # reused by the dispatch
        metrics.host_sync(key=id(ex), label="exchange-counts-sizing")
        probe_skew = sh.device_load_stats(counts.sum(axis=0))["skew"]
        fused = probe_skew <= float(config.aqe_skew)
        adaptive.record_fused_dispatch(ctx.root, ex, probe_skew,
                                       float(config.aqe_skew),
                                       "fused" if fused else "host")
        if not fused:
            metrics.count("engine.fused_stage.fallbacks")
            metrics.count("engine.fused_stage.aqe_fallbacks")
            return None

    with _scope("engine.fused_stage"):
        res = sg.run_fused_stage(stage, inp, mesh, ROW_AXIS,
                                 prepped=prepped)
    if res is None:
        _fused_fallback(ctx, ex, "overflow")
        return None  # the static prefix or capacity overflowed
    out, info = res
    rows_mat = info["rows_matrix"]
    # the lowered Exchange still counts: the executed-exchange census sees
    # the same events whether the exchange ran in the pass or on the host
    stats["exchanges"] += 1
    stats["nodes"] += 2  # the bypassed Exchange + partial Aggregate
    from ..utils import blackbox
    blackbox.record("exchange", kind=ex.kind,
                    rows=int(rows_mat.sum()), in_program=True)
    wire = int(info["wire_bytes"])
    metrics.count("engine.exchange.shuffles")
    metrics.count("engine.exchange.wire_bytes", wire)
    qm = metrics.current()
    if qm is not None:
        qm.node_add(id(ex), node_label(ex), chunks=1, wire_bytes=wire)
    if metrics.enabled():
        from ..parallel import shuffle as sh
        # per-shard attribution from the device-side send matrix that rode
        # the one fetch: no added sync, and the wire matrix sums to the
        # engine.exchange.wire_bytes increment above (every slot crosses)
        st = sh.device_load_stats(rows_mat.sum(axis=0))
        metrics.gauge_set("engine.exchange.skew", st["skew"])
        metrics.gauge_set("engine.exchange.straggler_share",
                          st["straggler_share"])
        metrics.gauge_set("engine.exchange.max_dev_rows",
                          st["max_dev_rows"])
        for d, r in enumerate(st["dev_rows"]):
            metrics.gauge_set(f"engine.exchange.dev{d}.rows", float(r))
            metrics.observe("engine.exchange.dev_rows", r)
        if qm is not None:
            qm.node_set(id(ex), node_label(ex),
                        skew=st["skew"],
                        straggler_share=st["straggler_share"],
                        max_dev_rows=st["max_dev_rows"],
                        cap_rows=info["ndev"] * info["capacity"],
                        dev_rows=st["dev_rows"],
                        rows_matrix=rows_mat.tolist(),
                        wire_matrix=info["wire_matrix"].tolist(),
                        in_program=True)
            qm.node_set(id(node), node_label(node), in_program=True)
    return out


def _exec_sort(node: Sort, memo: dict, stats: dict, ctx: _ExecCtx) -> Table:
    from ..ops.order import SortKey
    from ..ops.selection import sort_table
    t = _gathered(_exec(node.child, memo, stats, ctx), node.child, ctx)
    return sort_table(t, [SortKey(t[c], ascending=a) for c, a in node.keys])


def _exec_limit(node: Limit, memo: dict, stats: dict,
                ctx: _ExecCtx) -> Table:
    from ..ops.selection import slice_table
    t = _gathered(_exec(node.child, memo, stats, ctx), node.child, ctx)
    return slice_table(t, 0, min(node.n, t.num_rows))


#: per-chunk row budget for the streamed hash exchange: bounds the
#: device-resident working set of one shuffle dispatch
_EXCHANGE_CHUNK_ROWS = 1 << 16


def _exec_exchange(node: Exchange, memo: dict, stats: dict,
                   ctx: _ExecCtx) -> Table:
    """Data movement as a plan node: replicate (broadcast) or re-place
    (hash shuffle) the child's rows across the engine's mesh of
    ``config.shards`` shards.  With one shard both are the identity, as in
    the JAX package with one device.  The hash kind does not keep row
    order: exchanges feed only order-insensitive consumers.

    Resource exhaustion walks a degradation ladder, each rung counted and
    logged (engine/recovery.py): full capacity -> halved chunks -> spilled
    shuffle (parallel/spill.py, host-buffered passes) -> passthrough.  The
    last rung is content-equivalent (the exchange returns the whole table
    either way); transient failures retry under the policy first.

    Over ranks a broadcast gathers the ranks' rows and a hash exchange
    moves them between the ranks (a replicated child sends only its
    rank's block); the AQE flip decides from the rows of every rank, and
    a rung of the ladder runs on every rank at once only where its cause
    does (an injected fault): a rank's own out-of-memory leaves the others
    to time out in their next collective."""
    child = _exec(node.child, memo, stats, ctx)
    # counted before any early-out so the executed count equals the static
    # verify.plan_exchanges census
    stats["exchanges"] += 1
    from ..utils import blackbox
    blackbox.record("exchange", kind=node.kind, rows=child.num_rows)
    if node.kind == "broadcast":
        return _broadcast_exchange(node, child, ctx)
    if getattr(node, "_aqe_flip", False):
        from ..utils.config import config
        if config.aqe:
            # AQE rule 1 (engine/adaptive.py): the build side is already
            # materialized, so its true row count is known before the
            # shuffle runs: flip the planned hash exchange to a broadcast
            # when it lands under the runtime threshold.  The Exchange node
            # stays the same object (census, spans and ledger paths are
            # keyed on it); only the physical op changes.
            from . import adaptive
            rows = _global_rows(child, node.child, ctx)
            if adaptive.try_broadcast_flip(node, child, ctx.root, stats,
                                           rows=rows):
                return _broadcast_exchange(node, child, ctx)
    if ctx.ranks is not None:
        ctx.place.record(node, hashed(node.keys))
        if ctx.place.of(node.child) == REP:
            child = _rank_block(child, ctx)
    rp = ctx.recovery
    try:
        return rp.retry("exchange.dispatch",
                        lambda: _hash_exchange(node, child, ctx))
    except Exception as e:
        if not rp.can_degrade(e):
            raise
        if rp.oom_retry_first("exchange.dispatch", e):
            try:
                return _hash_exchange(node, child, ctx)
            except Exception as e2:
                if not rp.can_degrade(e2):
                    raise
                e = e2
        rp.degrade("exchange-halved", e, stats)
    try:
        return _hash_exchange(node, child, ctx,
                              chunk_rows=_EXCHANGE_CHUNK_ROWS // 2)
    except Exception as e:
        if not rp.can_degrade(e):
            raise
        rp.degrade("exchange-spilled", e, stats)
    try:
        return _spilled_exchange(node, child, ctx)
    except Exception as e:
        if not rp.can_degrade(e):
            raise
        rp.degrade("exchange-passthrough", e, stats)
        if ctx.ranks is not None:
            ctx.place.record(node, SPLIT)
        return child


def _rank_block(table: Table, ctx: _ExecCtx) -> Table:
    """This rank's contiguous block of a table every rank holds whole."""
    from ..ops.selection import slice_table
    n, r, w = table.num_rows, ctx.ranks.rank, ctx.ranks.world
    return slice_table(table, r * n // w, (r + 1) * n // w - r * n // w)


def _global_rows(table: Table, node: Optional[PlanNode],
                 ctx: _ExecCtx) -> int:
    """The rows of ``node``'s output ``table`` over every rank (``node``
    None: a table split over the ranks)."""
    from ..parallel import ranks as _ranks
    if ctx.ranks is None or (node is not None and ctx.place.of(node) == REP):
        return table.num_rows
    return _ranks.host_sum(table.num_rows, ctx.ranks)


def _broadcast_exchange(node: Exchange, table: Table,
                        ctx: _ExecCtx) -> Table:
    from ..parallel.mesh import broadcast_table, default_shards, make_mesh
    ns = default_shards(ctx.ranks)
    if ctx.ranks is not None:
        was = ctx.place.of(node.child)
        ctx.place.record(node, REP)
        if was == REP:
            return table
    wire = table_nbytes(table) * max(0, ns - 1)
    metrics.count("engine.exchange.broadcasts")
    metrics.count("engine.exchange.wire_bytes", wire)
    qm = metrics.current()
    if qm is not None:
        qm.node_add(id(node), node_label(node), wire_bytes=wire)
        # a replicate is balanced by construction; its cost is the copies
        qm.node_set(id(node), node_label(node), skew=1.0,
                    straggler_share=0.0, max_dev_rows=table.num_rows,
                    dev_rows=[table.num_rows] * ns, replica_bytes=wire)
    if metrics.enabled():
        metrics.gauge_set("engine.exchange.replica_bytes", float(wire))
    if ns <= 1:
        return table
    with _scope("engine.exchange.broadcast"):
        return broadcast_table(table, make_mesh(ns, device=ctx.device,
                                                ranks=ctx.ranks))


def _hash_exchange(node: Exchange, table: Table, ctx: _ExecCtx,
                   chunk_rows: int = _EXCHANGE_CHUNK_ROWS) -> Table:
    """Streamed two-phase hash shuffle of ``table`` over the mesh.

    Chunks of ``chunk_rows`` stream through ``shuffle_chunks_pipelined``
    (dispatch-ahead keyed to the prefetch depth).  Two deliberate host
    syncs an exchange, as ``verify.sync_budget`` charges: the counts
    (global when there are several chunks or when the AQE skew rule needs
    the whole matrix, else inside the shuffle) and one fetch of the
    live-slot count, the overflow and the per-(src, dest) row matrices
    before the compaction.

    With ``config.aqe`` and the ``_aqe_split`` stamp, the counts decide the
    hot-key split (``adaptive.try_skew_split``): hot destinations' rows are
    re-dealt round-robin, the capacity comes from the post-split
    projection, the measured post-split skew is folded into the ledger
    entry, and a self-composable consumer gets the post-exchange
    partial-combine.
    """
    from ..ops.row_conversion import fixed_width_layout
    from ..ops.selection import concat_tables, gather_table, slice_table
    from ..parallel import ranks as _ranks
    from ..parallel import shuffle as sh
    from ..parallel.mesh import default_shards, make_mesh, pad_to_multiple
    ns = default_shards(ctx.ranks)
    if ns <= 1:
        return table  # placement over one shard is the identity
    plan = None
    keys = list(node.keys)
    key_specs = None
    if any(c.dtype.is_string for c in table.columns):
        # strings cross in padded-bucket form, exploded once for every
        # chunk; placement hashes the original bytes (Spark-exact)
        from ..parallel.stringplane import explode_strings
        table, plan = explode_strings(table, ranks=ctx.ranks)
        key_specs = sh.key_specs_for(table, keys, plan)
    mesh = make_mesh(ns, device=ctx.device, ranks=ctx.ranks)
    nl = ns // mesh.world  # this rank's shards
    rows = table.num_rows
    # every rank streams as many chunks as the longest block needs: the
    # chunks' collectives run in lockstep
    longest = rows if ctx.ranks is None else \
        _ranks.host_max(rows, ctx.ranks)
    nchunks = max(1, -(-longest // chunk_rows))  # 0 rows still run one pass
    layout = fixed_width_layout(table.dtypes())
    from ..utils.config import config
    aqe_split = bool(config.aqe) and getattr(node, "_aqe_split", False)
    split = split_entry = None
    combine = False
    capacity = counts = None
    if nchunks > 1 or aqe_split:
        # one counts pass sizes one grid for the whole stream (the AQE skew
        # rule needs the whole matrix up front, so it hoists this pass for
        # one chunk too: same sync, same label); a chunk's shard can
        # straddle one whole-table shard boundary, so its per-(src, dest)
        # count is bounded by two adjacent pair counts: size at twice the
        # global max
        padded, _ = pad_to_multiple(table, ns, mesh)
        counts = sh.partition_counts(padded, mesh, keys, n_valid_rows=rows,
                                     key_specs=key_specs)
        metrics.host_sync(key=id(node), label="exchange-counts-sizing")
    if aqe_split and counts is not None:
        from . import adaptive
        split, cap_need, split_entry, combine = adaptive.try_skew_split(
            node, counts, ns, ctx.root, ctx.stats)
    if counts is not None:
        if split is not None:
            # the projected post-split per-(src, dest) maximum; several
            # chunks pay the same straddle bound (two shard pieces, each
            # dealing its own hot share: at most one more row per ceil)
            need = 2 * cap_need + 2 if nchunks > 1 else cap_need
        else:
            need = 2 * int(counts.max()) if nchunks > 1 \
                else int(counts.max())
        # no (src, dest) cell of a chunk exceeds the rows of one of the
        # chunk's shards, however hot the key: a tighter bound than the
        # straddle bound wherever the table is many chunks long (the JAX
        # package sizes every chunk's grid from the straddle bound alone)
        capacity = sh.cap_bucket(min(need,
                                     -(-min(longest, chunk_rows) // nl)))

    def chunk_stream():
        for i in range(nchunks):
            ctx.recovery.checkpoint()
            lo = min(i * chunk_rows, rows)
            t, n = pad_to_multiple(
                slice_table(table, lo, min(rows - lo, chunk_rows)), ns, mesh)
            yield t, torch.arange(t.num_rows, device=ctx.device) < n
        ctx.recovery.finish()

    tl = timeline.enabled()
    fbase = timeline.new_flow_base() if tl else 0
    outs = []
    with _scope("engine.exchange.hash"):
        for ci, item in enumerate(sh.shuffle_chunks_pipelined(
                chunk_stream(), mesh, keys, capacity=capacity,
                depth=max(1, ctx.prefetch), key_specs=key_specs,
                split=split)):
            if tl:
                # flow tails at dispatch, one a (chunk, destination); the
                # heads land on the shard lanes at receipt
                for d in range(ns):
                    timeline.flow_start("engine.exchange.chunk",
                                        fbase + ci * ns + d, {"chunk": ci})
            outs.append(item)
    ok = torch.cat([o[1] for o in outs])
    ovf = torch.stack([o[2] for o in outs]).sum()
    # per-chunk (src, dest) live rows: the received layout is
    # [dest, src, slot] (this rank's dests over ranks, gathered on the
    # device); all of it rides the one compaction fetch
    mats = torch.stack([o[1].reshape(nl, ns, -1).sum(dim=2)
                        for o in outs])
    if ctx.ranks is not None:
        mats = _ranks.all_gather_rows(mats.transpose(0, 1).contiguous(),
                                      ctx.ranks, [nl] * mesh.world) \
            .transpose(0, 1)
    mats = mats.transpose(1, 2)
    t_c0 = time.perf_counter()
    meta = torch.cat([torch.stack([ovf, ok.sum()]),
                      mats.reshape(-1)]).cpu()
    metrics.host_sync(key=id(node), label="exchange-compaction")
    if int(meta[0]):
        raise RuntimeError(
            "hash exchange overflow despite counts-sized capacity")
    n_live = int(meta[1])
    chunk_mats = meta[2:].reshape(len(outs), ns, ns).numpy()
    rows_mat = chunk_mats.sum(axis=0)
    wire = sum(o[0].num_rows for o in outs) * layout.row_size
    keep = torch.argsort((~ok).to(torch.uint8), stable=True)[:n_live]
    result = gather_table(concat_tables([o[0] for o in outs]), keep)
    if tl:
        dur = time.perf_counter() - t_c0
        dev_cum = np.zeros(ns, np.int64)
        for ci, cm in enumerate(chunk_mats):
            chunk_dev = cm.sum(axis=0)
            dev_cum += chunk_dev
            for d in range(ns):
                timeline.complete("engine.exchange.recv", t_c0, dur,
                                  {"chunk": ci, "rows": int(chunk_dev[d])},
                                  dev=d)
                timeline.flow_finish("engine.exchange.chunk",
                                     fbase + ci * ns + d, dev=d)
                timeline.counter("engine.exchange.dev_rows",
                                 int(dev_cum[d]), dev=d)
    metrics.count("engine.exchange.shuffles")
    metrics.count("engine.exchange.wire_bytes", wire)
    qm = metrics.current()
    if qm is not None:
        qm.node_add(id(node), node_label(node), chunks=nchunks,
                    wire_bytes=wire)
    if metrics.enabled():
        st = sh.device_load_stats(rows_mat.sum(axis=0))
        metrics.gauge_set("engine.exchange.skew", st["skew"])
        metrics.gauge_set("engine.exchange.straggler_share",
                          st["straggler_share"])
        metrics.gauge_set("engine.exchange.max_dev_rows",
                          st["max_dev_rows"])
        for d, r in enumerate(st["dev_rows"]):
            metrics.gauge_set(f"engine.exchange.dev{d}.rows", float(r))
            metrics.observe("engine.exchange.dev_rows", r)
        if qm is not None:
            qm.node_set(id(node), node_label(node),
                        skew=st["skew"],
                        straggler_share=st["straggler_share"],
                        max_dev_rows=st["max_dev_rows"],
                        cap_rows=ok.shape[0] // ns,
                        dev_rows=st["dev_rows"],
                        rows_matrix=rows_mat.tolist())
        if split_entry is not None and split is not None:
            # the attribution matrix measured the post-split placement:
            # fold the proof the split worked into its ledger entry
            from . import adaptive
            adaptive.update(split_entry, post_skew=st["skew"],
                            post_straggler_share=st["straggler_share"])
    if plan is not None:
        from ..parallel.stringplane import reassemble_strings
        result = reassemble_strings(result, plan)
    if split is not None and combine:
        # AQE rule 2, merge half: the split scattered each hot key's rows
        # across shards, so re-combine per key over the merged output
        from . import adaptive
        result, did = adaptive.apply_precombine(node, result)
        if did:
            adaptive.update(split_entry, combined_rows=int(result.num_rows))
    if split is not None and ctx.ranks is not None:
        ctx.place.record(node, SPLIT)  # hot keys now span the ranks
    return result


def _spilled_exchange(node: Exchange, table: Table, ctx: _ExecCtx) -> Table:
    """Degraded exchange through ``shuffle_table_spilled``: bounded device
    passes, host-resident result (under ``config.spill_dir`` when set),
    moved back to the device.  Placement matches the padded path; the
    output order is pass-major, which order-insensitive consumers allow."""
    from ..parallel import shuffle as sh
    from ..parallel.mesh import default_shards, make_mesh
    from ..parallel.spill import shuffle_table_spilled
    from ..utils.config import config
    ns = default_shards(ctx.ranks)
    if ns <= 1 or _global_rows(table, None, ctx) == 0:
        return table
    plan = None
    keys = list(node.keys)
    key_specs = None
    if any(c.dtype.is_string for c in table.columns):
        from ..parallel.stringplane import explode_strings
        table, plan = explode_strings(table, ranks=ctx.ranks)
        key_specs = sh.key_specs_for(table, keys, plan)
    # half the table's footprint as the pass budget: the degraded path runs
    # because the full-capacity dispatch just ran out of memory.  A session
    # budget clamps further: one tenant's spill ladder must not size its
    # passes as if it owned the whole device
    budget = max(1 << 20, table_nbytes(table) // 2)
    srem = ctx.recovery.session_budget_remaining()
    if srem is not None:
        budget = max(1 << 20, min(budget, srem))
    metrics.count("engine.exchange.spilled_reroutes")
    result = shuffle_table_spilled(table, make_mesh(ns, device=ctx.device,
                                                    ranks=ctx.ranks),
                                   keys, hbm_budget_bytes=budget,
                                   spill_dir=config.spill_dir,
                                   key_specs=key_specs).to(ctx.device)
    if plan is not None:
        from ..parallel.stringplane import reassemble_strings
        result = reassemble_strings(result, plan)
    return result


def _exec(node: PlanNode, memo: dict, stats: dict, ctx: _ExecCtx) -> Table:
    if id(node) in memo:
        return memo[id(node)]
    handler = _EXEC_DISPATCH.get(type(node))
    if handler is None:
        raise TypeError(f"unknown plan node {type(node).__name__} "
                        f"(register it in executor._EXEC_DISPATCH)")
    stats["nodes"] += 1
    qm = metrics.current()
    t0 = time.perf_counter() if qm is not None else 0.0
    with _scope(f"engine.{node_label(node)}"):
        out = handler(node, memo, stats, ctx)
    if ctx.ranks is not None:
        ctx.place.settle(node)
    if qm is not None:
        # rows and bytes from buffer metadata: no sync
        qm.node_add(id(node), node_label(node),
                    calls=1, wall_s=time.perf_counter() - t0,
                    rows_out=out.num_rows,
                    bytes_out=table_nbytes(out),
                    rows_in=sum(memo[id(c)].num_rows
                                for c in node.children()
                                if id(c) in memo),
                    bytes_in=sum(table_nbytes(memo[id(c)])
                                 for c in node.children()
                                 if id(c) in memo))
    memo[id(node)] = out
    return out


def _precompute_independent(root: PlanNode, scan: Scan, memo: dict,
                            stats: dict, ctx: _ExecCtx) -> None:
    """Compute every scan-independent subtree once, into the shared memo,
    so per-chunk re-walks only redo scan-dependent nodes."""
    dep: dict = {}
    for n in topo_nodes(root):
        if n is not root and not _depends_on(n, scan, dep) \
                and id(n) not in memo:
            _exec(n, memo, stats, ctx)


def _get_builds(joins: tuple, build_tables: tuple, ctx: _ExecCtx) -> tuple:
    """The per-chunk BUILD_CACHE access: one ``get`` per join per chunk;
    the first chunk of a cold stream misses and pays the hash + sort,
    every later chunk hits (``hits == chunks - 1``)."""
    from ..ops.join import prepare_build
    from .cache import BUILD_CACHE
    return tuple(
        BUILD_CACHE.get(j.fingerprint(), bt,
                        lambda j=j, bt=bt: prepare_build(
                            bt, list(j.right_keys), device=ctx.device))
        for j, bt in zip(joins, build_tables))


def _exec_streamed(agg: Aggregate, scan: Scan, memo: dict,
                   stats: dict, ctx: _ExecCtx,
                   force_interp: bool = False) -> Table:
    """Per-chunk partial aggregation over the one chunked scan.

    - **Double-buffered pipeline** (``ctx.prefetch > 0``): the reader's
      producer thread decodes (or plans pages for) chunk k+1 while the
      device computes chunk k.
    - **Fused chunk segment** (``ctx.fuse``, scan feeds the segment
      directly): each staged chunk arrives padded to a power-of-two row
      bucket, so one compiled segment (filters -> masked partial groupby)
      serves every chunk with no per-chunk host sync; padded partials stay
      on the device and merge with ONE combine groupby at the end.  On the
      device-decode route the segment starts at the page planes.
    - **Fused probe joins** (``config.fuse_join``): a Join on the path
      whose build side is scan-independent joins the segment; the build is
      hashed + sorted once per execution (``BUILD_CACHE``).  Non-unique
      build hashes or ineligible schemas fall back to the interpreted
      per-chunk loop, which still pipelines (and, on the device-decode
      route, still decodes each chunk on the device).
    """
    from ..io import ParquetChunkedReader
    from ..ops.aggregate import groupby
    from ..ops.selection import concat_tables
    from ..utils.config import config
    from . import segment as sg

    _precompute_independent(agg.child, scan, memo, stats, ctx)

    cols = list(scan.columns) if scan.columns else None
    reader = ParquetChunkedReader(
        scan.path, pass_read_limit=scan.chunk_bytes,
        columns=cols, predicate=scan.predicate, prefetch=ctx.prefetch,
        cancel=ctx.recovery.cancel, device=ctx.device,
        split=_scan_split(scan, ctx))
    stats["streamed"] = True
    stats["pipelined"] = ctx.prefetch > 0
    pqm = metrics.current()
    if pqm is not None:
        pqm.progress_total(reader.footer_chunk_estimate())

    seg = None
    if ctx.fuse and not force_interp:
        cand = sg.build_stream_segment(agg, scan, ctx.nparents,
                                       fuse_join=config.fuse_join)
        if cand is not None and cand.input is scan \
                and sg.worthwhile(cand, streaming=True):
            seg = cand

    partials: list = []          # interpreted path: compacted Tables
    fused: list = []             # fused path: padded device partials
    fused_compiled = None
    device_mode = _decode_on_device(ctx.device)
    try:
        it = first = None
        first_preps: tuple = ()
        if seg is not None:
            joins = seg.joins()
            build_tables = tuple(memo[id(j.right)] for j in joins)
            it = reader.iter_device() if device_mode \
                else reader.iter_staged()
            first = next(it, None)
            if first is not None:
                if device_mode:
                    # a 1-row probe table carries the geometry's schema, so
                    # eligibility is decided WITHOUT decoding the chunk
                    from ..ops import parquet_decode as pqd
                    probe = pqd.probe_table(first[1].geom, ctx.device) \
                        if first[0] == "dev" else first[1][0]
                else:
                    probe = first[0]
                if not sg.stream_runtime_eligible(seg, probe,
                                                  build_tables):
                    seg = None  # schema veto: strings/nested in compute
                else:
                    # this access stands in for chunk 1's per-chunk get
                    first_preps = _get_builds(joins, build_tables, ctx)
                    if any(not p.unique for p in first_preps):
                        # duplicate 32-bit build hashes: the <=1-candidate
                        # probe shape doesn't hold; interpret instead
                        seg = None
        if seg is None:
            # the interpreted per-chunk loop: not fused, degraded, or
            # vetoed after the stream began
            if device_mode:
                items = reader.iter_device() if it is None \
                    else _chain_one(first, it)
                items = (_dev_item_decoded(i, ctx) for i in items)
            elif it is not None:
                items = _chain_one(first, it)
            else:
                items = ((c, c.num_rows) for c in reader)
            from ..ops.selection import slice_table
            for chunk, nvalid in items:
                ctx.recovery.checkpoint()
                if nvalid < chunk.num_rows:
                    chunk = slice_table(chunk, 0, nvalid)
                partials.extend(_stream_partial(agg, scan, chunk, memo,
                                                stats, ctx))
            ctx.recovery.finish()
        else:
            stats["nodes"] += len(seg.chain)  # agg counted by _exec
            qm = metrics.current()
            preps = first_preps
            dd = dd_entry = None
            if device_mode:
                from ..utils.errors import (ResourceExhaustedError,
                                            TransientError)
                dd = {"device_chunks": 0, "host_chunks": 0, "rows": 0,
                      "link_bytes": 0, "uncompressed_bytes": 0,
                      "reasons": {}}
                from . import adaptive
                dd_entry = adaptive.record(
                    ctx.root, {"kind": "scan:device_decode",
                               "node": node_label(scan)})
            for item in _chain_one(first, it) if first is not None else ():
                ctx.recovery.checkpoint()
                stats["chunks"] += 1
                tc0 = time.perf_counter() if qm is not None else 0.0
                if fused:  # chunks after the first hit the cache
                    preps = _get_builds(joins, build_tables, ctx)
                if device_mode:
                    kind, payload, reason = item
                    planes = None
                    if kind == "dev":
                        try:
                            planes = _ship(payload, ctx)
                        except (TransientError,
                                ResourceExhaustedError, OSError):
                            if ctx.device.type != "cpu":
                                raise  # work on a card stays on it
                            # persistent link failure: this one group
                            # re-plans onto the host decoder (results
                            # identical); cancellation unwinds as usual
                            metrics.count("io.device_decode.fallbacks")
                            kind, reason = "host", "transfer_error"
                            payload = _dev_item_host(item, reader)
                    if kind == "dev":
                        ctx.recovery.charge(payload.comp_bytes)
                        fused_compiled = sg.SEGMENT_CACHE.get_decode(
                            seg, payload.geom, build_tables)
                        with _scope("engine.fused_segment"):
                            fused.append(fused_compiled(
                                planes, payload.nrows, preps))
                        nvalid, padded = payload.nrows, 0
                        cb = payload.comp_bytes
                        dd["device_chunks"] += 1
                        dd["link_bytes"] += int(payload.comp_bytes)
                        dd["uncompressed_bytes"] += int(payload.unc_bytes)
                    else:
                        chunk, nvalid = payload
                        if reason is not None:
                            dd["reasons"][reason] = \
                                dd["reasons"].get(reason, 0) + 1
                        dd["host_chunks"] += 1
                        cb = table_nbytes(chunk)
                        padded = chunk.num_rows - nvalid
                        ctx.recovery.charge(cb)
                        fused_compiled = sg.SEGMENT_CACHE.get(
                            seg, chunk, build_tables)
                        with _scope("engine.fused_segment"):
                            fused.append(fused_compiled(
                                chunk, nvalid, preps))
                else:
                    chunk, nvalid = item
                    cb = table_nbytes(chunk)
                    padded = chunk.num_rows - nvalid
                    ctx.recovery.charge(cb)
                    fused_compiled = sg.SEGMENT_CACHE.get(seg, chunk,
                                                          build_tables)
                    with _scope("engine.fused_segment"):
                        fused.append(fused_compiled(chunk, nvalid, preps))
                if qm is not None:
                    # per-chunk latency is dispatch time: the fused loop
                    # never syncs per chunk, by design
                    dt = time.perf_counter() - tc0
                    qm.node_add(id(agg), node_label(agg), chunks=1,
                                rows_in=int(nvalid), bytes_in=cb,
                                padded_rows=int(padded))
                    qm.progress_step(chunks=1, rows=int(nvalid), nbytes=cb)
                    metrics.observe("engine.stream.chunk_latency_s", dt)
                    metrics.observe("engine.stream.chunk_rows", int(nvalid))
                    metrics.mem_checkpoint(ctx.device)
                if dd is not None:
                    dd["rows"] += int(nvalid)
            ctx.recovery.finish()
            if fused:
                stats["fused_segments"] += 1
            if dd is not None:
                _finish_device_decode(dd, dd_entry, scan, qm)
    finally:
        reader.close()
    stats["row_groups_pruned"] += reader.groups_pruned
    stats["row_groups_read"] += reader.groups_read

    if fused:
        return sg.combine_partials(fused, fused_compiled)
    if not partials:
        # everything pruned/filtered: run the plan once on an empty chunk
        # so the output schema still comes out right
        sub = _ChunkMemo(memo)
        sub[id(scan)] = reader.file.empty_table(cols, device=ctx.device)
        return _groupby(_exec(agg.child, sub, stats, ctx), agg, ctx)

    merged = concat_tables(partials)
    combine = [(nm, _STREAM_COMBINE[op])
               for nm, (_, op) in zip(agg.names, agg.aggs)]
    return groupby(merged, list(agg.keys), combine, names=list(agg.names),
                   device=ctx.device)


def _chain_one(first, rest):
    yield first
    yield from rest


def _decode_on_device(dev: torch.device) -> bool:
    """Whether a streamed scan takes the device-decode route:
    ``config.device_decode`` when it pins one, else whenever ``dev`` is a
    card."""
    from ..utils.config import config
    if config.device_decode is None:
        return dev.type == "cuda"
    return bool(config.device_decode)


def _ship(payload, ctx: _ExecCtx) -> dict:
    """One device page chunk's planes on ``ctx.device``; transient link
    failures retry (``parquet.device_decode``)."""
    from ..utils.errors import retry_call
    return retry_call(lambda: payload.to_device(ctx.device),
                      "parquet.device_decode", cancel=ctx.recovery.cancel)


def _dev_item_decoded(item, ctx: _ExecCtx):
    """Normalize a device-stream item to ``(padded Table, nvalid)`` for the
    interpreted loop: a device page chunk decodes on ``ctx.device`` with
    ``decode_table`` (the K3/W1/W2 kernels on a card); a group the device
    decoder could not take arrives host-decoded."""
    kind, payload, _ = item
    if kind == "host":
        return payload
    from ..ops.parquet_decode import decode_table
    return decode_table(_ship(payload, ctx), payload.geom), payload.nrows


def _dev_item_host(item, reader):
    """A device page chunk whose transfer failed on the CPU, re-planned
    onto the host decoder: the same staged shape class as any other
    fallback group (a device group always fits one pass budget)."""
    return reader._stage_one(
        reader.file._decode_group(item[1].gi, reader.columns))


def _finish_device_decode(dd: dict, dd_entry: dict, scan: Scan,
                          qm) -> None:
    """Stamp the stream's decode routing into the ledger entry and the
    query metrics (``decode=`` is what EXPLAIN ANALYZE renders on the scan
    node, with the link and uncompressed byte totals)."""
    dev, host = dd["device_chunks"], dd["host_chunks"]
    choice = "device" if host == 0 and dev > 0 else \
        ("host" if dev == 0 else "mixed")
    dd_entry.update(choice=choice, device_chunks=dev, host_chunks=host,
                    link_bytes=dd["link_bytes"],
                    uncompressed_bytes=dd["uncompressed_bytes"],
                    reasons=dict(dd["reasons"]))
    if qm is not None:
        qm.node_set(id(scan), node_label(scan), decode=choice,
                    rows_in=dd["rows"], rows_out=dd["rows"],
                    link_bytes=dd["link_bytes"],
                    unc_bytes=dd["uncompressed_bytes"])


class _ChunkMemo(dict):
    """Per-chunk memo overlay: scan-dependent results land here (a small
    dict rebuilt each chunk), scan-independent ones resolve from the
    shared base memo."""

    __slots__ = ("base",)

    def __init__(self, base: dict):
        super().__init__()
        self.base = base

    def __contains__(self, k):
        return dict.__contains__(self, k) or k in self.base

    def __getitem__(self, k):
        try:
            return dict.__getitem__(self, k)
        except KeyError:
            return self.base[k]


def _stream_partial(agg: Aggregate, scan: Scan, chunk: Table, memo: dict,
                    stats: dict, ctx: _ExecCtx) -> list:
    """Interpreted per-chunk partial: re-walk the scan-dependent subtree
    with the chunk standing in for the scan, then a compacting groupby."""
    stats["chunks"] += 1
    ctx.recovery.charge(table_nbytes(chunk))
    qm = metrics.current()
    tc0 = time.perf_counter() if qm is not None else 0.0
    sub = _ChunkMemo(memo)
    sub[id(scan)] = chunk
    t = _exec(agg.child, sub, stats, ctx)
    out = [_groupby(t, agg, ctx)] if t.num_rows else []
    if qm is not None:
        cb = table_nbytes(chunk)
        qm.node_add(id(agg), node_label(agg), chunks=1,
                    rows_in=chunk.num_rows, bytes_in=cb)
        qm.progress_step(chunks=1, rows=chunk.num_rows, nbytes=cb)
        metrics.observe("engine.stream.chunk_latency_s",
                        time.perf_counter() - tc0)
        metrics.observe("engine.stream.chunk_rows", chunk.num_rows)
        metrics.mem_checkpoint(ctx.device)
    return out


def _exec_topk(node: TopK, memo: dict, stats: dict, ctx: _ExecCtx) -> Table:
    """ORDER BY ... LIMIT k without materializing the full table.

    When the child streams over one chunked scan (``config.topk``), each
    chunk's survivors are ranked by their order-preserving key words
    (ops/order.py) plus a global arrival-index word (ties break by
    post-filter row order, which is chunk-geometry-invariant) and merged
    into a capacity-k buffer: concat buffer-first, one lexsort, one gather.
    Otherwise: full sort + slice.
    """
    from ..ops.order import SortKey, encode_keys, lexsort
    from ..ops.selection import (concat_tables, gather_table, slice_table,
                                 sort_table)
    from ..utils.config import config

    scan = _single_chunked_scan(node.child) if config.topk else None
    if ctx.ranks is not None and ctx.place.of(node.child) != REP:
        scan = None  # the child's rows are split: gather, then rank them
    if scan is None or node.n == 0:
        t = _gathered(_exec(node.child, memo, stats, ctx), node.child, ctx)
        t = sort_table(t, [SortKey(t[c], ascending=a)
                           for c, a in node.keys])
        return slice_table(t, 0, min(node.n, t.num_rows))

    from ..io import ParquetChunkedReader

    _precompute_independent(node.child, scan, memo, stats, ctx)

    cols = list(scan.columns) if scan.columns else None
    reader = ParquetChunkedReader(
        scan.path, pass_read_limit=scan.chunk_bytes,
        columns=cols, predicate=scan.predicate, prefetch=ctx.prefetch,
        cancel=ctx.recovery.cancel, device=ctx.device,
        split=_scan_split(scan, ctx))
    stats["streamed"] = True
    stats["topk"] = True
    stats["pipelined"] = ctx.prefetch > 0

    buf: Optional[Table] = None   # current top rows (<= k), sorted
    buf_words: list = []          # their sort words (incl. tiebreak)
    rows_seen = 0
    qm = metrics.current()
    if qm is not None:
        qm.progress_total(reader.footer_chunk_estimate())
    try:
        for chunk in reader:
            ctx.recovery.checkpoint()
            stats["chunks"] += 1
            ctx.recovery.charge(table_nbytes(chunk))
            tc0 = time.perf_counter() if qm is not None else 0.0
            if qm is not None:
                cb = table_nbytes(chunk)
                qm.node_add(id(node), node_label(node), chunks=1,
                            rows_in=chunk.num_rows, bytes_in=cb)
                qm.progress_step(chunks=1, rows=chunk.num_rows, nbytes=cb)
            sub = _ChunkMemo(memo)
            sub[id(scan)] = chunk
            t = _exec(node.child, sub, stats, ctx)
            n = t.num_rows
            if n == 0:
                if qm is not None:
                    metrics.observe("engine.stream.chunk_latency_s",
                                    time.perf_counter() - tc0)
                continue
            words = encode_keys([SortKey(t[c], ascending=a)
                                 for c, a in node.keys])
            words.append(torch.arange(rows_seen, rows_seen + n,
                                      device=ctx.device))
            rows_seen += n
            if buf is None:
                cand_t, cand_w = t, words
            else:
                cand_t = concat_tables([buf, t])
                cand_w = [torch.cat([bw, w])
                          for bw, w in zip(buf_words, words)]
            order = lexsort(cand_w)
            keep = order[:min(node.n, order.shape[0])]
            buf = gather_table(cand_t, keep)
            buf_words = [w[keep] for w in cand_w]
            if qm is not None:
                metrics.observe("engine.stream.chunk_latency_s",
                                time.perf_counter() - tc0)
                metrics.observe("engine.stream.chunk_rows", chunk.num_rows)
                metrics.mem_checkpoint(ctx.device)
        ctx.recovery.finish()
    finally:
        reader.close()
    stats["row_groups_pruned"] += reader.groups_pruned
    stats["row_groups_read"] += reader.groups_read

    if buf is None:
        # nothing survived: one empty-chunk walk for the output schema
        sub = _ChunkMemo(memo)
        sub[id(scan)] = reader.file.empty_table(cols, device=ctx.device)
        return _exec(node.child, sub, stats, ctx)
    return buf


#: plan-node class -> handler
_EXEC_DISPATCH = {
    Scan: _exec_scan,
    Filter: _exec_filter,
    Project: _exec_project,
    Join: _exec_join,
    Aggregate: _exec_aggregate,
    Sort: _exec_sort,
    Limit: _exec_limit,
    TopK: _exec_topk,
    Exchange: _exec_exchange,
}


def _stamp_plan_feedback(plan: PlanNode, qm) -> None:
    """Post-run estimate-vs-actual join: copy the optimizer's evidence
    (``_est_rows`` per node, the root's ``_decisions`` ledger) onto the
    query's spans, so summaries and EXPLAIN ANALYZE carry ``est_rows`` /
    ``q_error`` per node and the decision ledger per query."""
    from .verify import node_paths
    paths = node_paths(plan)
    for n in topo_nodes(plan):
        rec = qm.node_spans.get(id(n))
        if rec is None:
            continue
        fields = {"path": paths[id(n)]}
        est = getattr(n, "_est_rows", None)
        if est is not None:
            fields["est_rows"] = int(est)
            fields["q_error"] = metrics.q_error(est, rec.get("rows_out"))
        qm.node_set(id(n), node_label(n), **fields)
    dec = getattr(plan, "_decisions", None)
    if dec:
        qm.set_decisions(dec)


def execute(plan: PlanNode, stats: Optional[dict] = None,
            fused: Optional[bool] = None,
            prefetch: Optional[int] = None,
            cancel: Optional[CancelToken] = None,
            device=_device.DEFAULT, session=None, ranks=None) -> Table:
    """Run ``plan`` on ``device``; returns the result Table there.

    ``ranks`` (a group of ``parallel/ranks.py``; default None, one
    process) makes this a collective of that group: every rank runs
    ``plan`` (rank 0's, from ``optimize(ranks=)``) over its split of the
    scans and returns the whole answer (``engine/placement.py``).

    ``stats`` (optional dict) is updated in place with execution evidence:
    ``row_groups_pruned``/``row_groups_read`` (scan pruning), ``chunks``,
    ``streamed`` and ``pipelined`` (partial-aggregation path), ``nodes``
    executed, ``fused_segments`` compiled-segment runs, ``degradations``
    (ladder steps taken, engine/recovery.py).

    ``fused``/``prefetch`` override ``config.fuse``/``config.prefetch`` for
    this execution.  ``cancel`` (utils.errors.CancelToken) makes the
    execution cooperatively cancellable at chunk boundaries; with no token,
    ``config.query_timeout_s > 0`` installs a deadline-only token.  Over
    ranks the ranks vote on their tokens at every chunk boundary and
    gather, and all raise together (engine/recovery.py).

    ``session`` (engine.scheduler.QuerySession, optional) makes the
    execution a scheduled tenant: chunk boundaries become fair-share
    scheduling points, chunk bytes charge the session's memory budget, and
    the OOM ladder consults that budget before degrading
    (engine/recovery.py ``oom_retry_first``).

    Failures are classified (utils.errors) on the way out: the query
    summary carries an ``outcome`` record, ``engine.errors.<kind>`` ticks,
    and a post-mortem bundle is written (``config.blackbox_dir``), its path
    and the trace id stamped on the exception.
    """
    from ..utils.config import config
    dev = _device.resolve(device)
    if stats is None:
        stats = new_stats()
    else:
        for k, v in new_stats().items():
            stats.setdefault(k, v)
    if cancel is None:
        cancel = query_cancel_token()
    ctx = _ExecCtx(plan,
                   fuse=config.fuse if fused is None else bool(fused),
                   prefetch=config.prefetch if prefetch is None
                   else int(prefetch),
                   recovery=RecoveryPolicy(cancel=cancel, session=session,
                                           ranks=ranks),
                   device=dev, stats=stats, ranks=ranks)
    if config.aqe or config.fuse_exchange:
        # a cached optimized plan is re-executed object-identical: strip
        # the previous run's runtime ledger entries before this run
        # appends its own
        from . import adaptive
        adaptive.reset(plan)
    # one QueryMetrics per top-level execute (nested executes attribute
    # into the enclosing query); config.metrics off skips it entirely.  The
    # flight recorder's trace scope wraps it, re-entrant the same way: it
    # binds (or mints) the end-to-end trace id, and stays on with the
    # metrics layer off
    from ..utils import blackbox
    with blackbox.query_scope(label=f"execute:{node_label(plan)}") as scope, \
            metrics.maybe_query(f"execute:{node_label(plan)}") as qm:
        tq = qm if qm is not None else metrics.current()
        if tq is not None and not tq.trace_id:
            tq.trace_id = scope.trace_id
        if config.profile_dir:
            # the profile store keys cross-run diffs by plan fingerprint;
            # stamp whichever query covers this execute (the one just
            # opened, or a caller's); the first plan wins.  The source
            # fingerprint rides along so profile.history can match runs of
            # the same source plan when AQE warming changed the optimized
            # shape.
            cq = qm if qm is not None else metrics.current()
            if cq is not None and not cq.fingerprint:
                cq.fingerprint = plan.fingerprint()
                sfp = getattr(plan, "_source_fingerprint", "")
                if sfp and not cq.source_fingerprint:
                    cq.source_fingerprint = sfp
        try:
            out = _exec(plan, {}, stats, ctx)
            # over ranks the answer is collected from every rank, onto
            # every rank
            out = _gathered(out, plan, ctx)
        except BaseException as e:
            kind, _ = classify(e)
            metrics.count(f"engine.errors.{kind}")
            oq = qm if qm is not None else metrics.current()
            if oq is not None:
                oq.set_outcome("error", kind=kind, error=str(e))
            # the outcome is stamped, so the bundle's query summary says
            # how it died; the exception carries trace_id and bundle_path
            # out to the bridge
            blackbox.post_mortem(f"engine.execute:{kind}", exc=e, qm=oq)
            raise
        oq = qm if qm is not None else metrics.current()
        if oq is not None:
            oq.set_outcome("ok")
            _stamp_plan_feedback(plan, oq)
        if qm is not None:
            qm.note_stats(stats)
            metrics.mem_checkpoint(dev)
    return out
