"""Segment fusion: plan chains run as one compiled callable over tensors.

The port of ``spark_rapids_jni_tpu/engine/segment.py`` up to its fused
stage.  The design is the JAX package's:

- A **segment** is a maximal Filter/Project chain, optionally rooted by a
  decomposable Aggregate, between pipeline breakers (Scan, Join, Sort,
  Limit, Exchange).  Breakers materialize; segments do not.
- Inside a segment, Filters never compact: they AND into a live-row mask,
  Projects are metadata-only selects, and an Aggregate root takes the mask
  as ``groupby_padded(row_mask=...)``.  So no intermediate is compacted and
  the segment makes no host sync until its boundary.
- On the streamed path a Join whose build side is scan-independent is not
  a breaker (``build_stream_segment``): the prepared build (hash + stable
  sort, cached in ``engine.cache.BUILD_CACHE``) enters the callable as an
  input and each probe chunk masks and gathers at probe-row shape.
  ``CompiledDecodeSegment`` starts at the compressed page planes and runs
  ``decode_table`` (the K3/W1/W2 kernels on the card) first, so a chunk
  goes from the link to its partial aggregate with no host boundary.
- Compiled segments live in a process-wide LRU keyed by ``(segment
  fingerprint, input shape-class)`` with ``engine.segment_cache.*``
  counters.

A compiled segment here is an eager Python callable over torch ops (no
tracing compiler, no CUDA graph).  ``CompiledSegment.traces`` and the
``engine.segment.compile`` / ``engine.segment.replay`` counters tick where
the JAX package's do: the first call of a cache entry is its "compile", the
later calls replay it.

The whole-stage ``FusedStage`` (``config.fuse_exchange``) lowers the
optimizer's ``partial-agg -> hash Exchange -> final-agg`` sandwich into one
device pass over every shard of the mesh: partial groupby, Spark placement,
plane pack, the (src, dst) grid transpose and the combine groupby, with no
host round trip between them and one deliberate sync at the boundary.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..columnar import Column, Table
from ..dtypes import INT32
from ..parallel.mesh import ROW_AXIS
from ..utils import metrics, timeline
from ..utils.config import config
from .plan import (Aggregate, Filter, Join, PlanNode, Project, expr_columns,
                   topo_nodes)

#: chain members fusable into a segment body (everything else is a breaker)
_FUSABLE = (Filter, Project)

#: join types the streamed probe-join segment supports (output stays at
#: probe-row shape: semi masks, inner gathers one build row per probe row)
_FUSABLE_JOINS = ("inner", "semi")

#: aggregate ops a segment may root on: the JAX package's groupby fast
#: path (``ops.aggregate._FAST_OPS``), so both engines fuse the same plans
_FUSABLE_AGG_OPS = frozenset({"sum", "min", "max", "mean", "count",
                              "count_all", "var", "std", "sumsq", "fsum"})


# -- segment extraction ----------------------------------------------------

def parent_counts(root: PlanNode) -> dict:
    """id(node) -> number of parents in the DAG (shared nodes must
    materialize once, so they terminate segment growth)."""
    counts: dict = {}
    for n in topo_nodes(root):
        for c in n.children():
            counts[id(c)] = counts.get(id(c), 0) + 1
    return counts


def _agg_fusable(agg: Aggregate) -> bool:
    return bool(agg.keys) and all(op in _FUSABLE_AGG_OPS
                                  for _, op in agg.aggs)


class Segment:
    """One fusable chain: ``input -> chain (bottom-up) [-> agg]``.

    On the streamed path the chain may contain ``Join`` nodes whose build
    side is scan-independent (``build_stream_segment``); their prepared
    builds enter the compiled callable as extra inputs."""

    __slots__ = ("chain", "agg", "input", "_fp")

    def __init__(self, chain: tuple, agg: Optional[Aggregate],
                 input_node: PlanNode):
        self.chain = chain          # Filter/Project/Join nodes, exec order
        self.agg = agg              # optional Aggregate root
        self.input = input_node     # breaker output the segment consumes
        self._fp: Optional[str] = None

    def nodes(self) -> tuple:
        return self.chain + ((self.agg,) if self.agg is not None else ())

    def joins(self) -> tuple:
        """Join nodes in the chain, execution order."""
        return tuple(nd for nd in self.chain if isinstance(nd, Join))

    def fingerprint(self) -> str:
        """Structure-only identity (input excluded): equal chains over
        different inputs share compiled segments."""
        if self._fp is None:
            sig = []
            for nd in self.chain:
                if isinstance(nd, Filter):
                    sig.append(("filter", nd.predicate))
                elif isinstance(nd, Join):
                    sig.append(("join", tuple(nd.left_keys),
                                tuple(nd.right_keys), nd.how))
                else:
                    sig.append(("project", tuple(nd.columns)))
            if self.agg is not None:
                sig.append(("aggregate", tuple(self.agg.keys),
                            tuple(self.agg.aggs), tuple(self.agg.names)))
            self._fp = hashlib.sha256(repr(tuple(sig)).encode()).hexdigest()
        return self._fp

    def columns_used(self) -> set:
        cols = set()
        for nd in self.chain:
            if isinstance(nd, Filter):
                cols |= expr_columns(nd.predicate)
        if self.agg is not None:
            cols |= set(self.agg.keys)
            cols |= {c for c, _ in self.agg.aggs if c is not None}
        return cols


def build_segment(top: PlanNode, nparents: dict) -> Optional[Segment]:
    """The segment rooted at ``top``, or None when ``top`` can't root one.

    ``top`` itself is always included; deeper nodes are absorbed only while
    they are Filter/Project with exactly one parent (a shared subtree must
    materialize once for its other consumers).
    """
    if isinstance(top, Aggregate):
        if not _agg_fusable(top):
            return None
        agg, cur, absorb_first = top, top.child, False
    elif isinstance(top, _FUSABLE):
        agg, cur, absorb_first = None, top, True
    else:
        return None
    chain = []
    while isinstance(cur, _FUSABLE) and \
            (absorb_first or nparents.get(id(cur), 1) == 1):
        absorb_first = False
        chain.append(cur)
        cur = cur.child
    return Segment(tuple(reversed(chain)), agg, cur)


def build_stream_segment(agg: Aggregate, scan: PlanNode,
                         nparents: dict,
                         fuse_join: bool = True) -> Optional[Segment]:
    """The streamed-path segment under ``agg``: like ``build_segment``, but
    an inner/semi Join whose build (right) side is scan-independent is
    absorbed instead of breaking; the chain continues down the probe side
    toward the scan, and the prepared build becomes an input."""
    if not _agg_fusable(agg):
        return None
    from .executor import _depends_on
    dep: dict = {}
    chain = []
    cur = agg.child
    while True:
        if isinstance(cur, _FUSABLE) and nparents.get(id(cur), 1) == 1:
            chain.append(cur)
            cur = cur.child
        elif (fuse_join and isinstance(cur, Join)
              and nparents.get(id(cur), 1) == 1
              and cur.how in _FUSABLE_JOINS
              and _depends_on(cur.left, scan, dep)
              and not _depends_on(cur.right, scan, dep)):
            chain.append(cur)
            cur = cur.left
        else:
            break
    return Segment(tuple(reversed(chain)), agg, cur)


def worthwhile(seg: Segment, streaming: bool = False) -> bool:
    """Fusion must beat the interpreter: a lone Project is a metadata select
    and a bare Aggregate already runs as one groupby, except on the
    streaming path, where a fused agg segment is what keeps per-chunk
    partials padded on the device (no per-chunk host sync)."""
    if seg.agg is not None:
        return streaming or len(seg.chain) >= 1
    return len(seg.chain) >= 2 and \
        any(isinstance(nd, Filter) for nd in seg.chain)


def _computable(c: Column) -> bool:
    """A column a segment may compute on: 1-D fixed width."""
    return not (c.dtype.is_string or c.data is None or c.data.ndim != 1)


def runtime_eligible(seg: Segment, table: Table) -> bool:
    """Static fusability said yes; the input schema gets the veto:
    computed-on columns must be 1-D fixed-width (strings may pass THROUGH
    a segment untouched, but can't be filtered on or aggregated)."""
    if seg.agg is not None and table.num_rows == 0:
        return False  # empty-input agg: the interpreter handles it
    try:
        return all(_computable(table.column(name))
                   for name in seg.columns_used())
    except (KeyError, ValueError):
        return False


def _needed_after(seg: Segment, pos: int) -> frozenset:
    """Column names referenced by chain nodes at index >= ``pos`` plus the
    agg root: the set an inner join in the chain must take from the build
    side."""
    need = set()
    for nd in seg.chain[pos:]:
        if isinstance(nd, Filter):
            need |= expr_columns(nd.predicate)
        elif isinstance(nd, Join):
            need |= set(nd.left_keys)
        else:
            need |= set(nd.columns)
    if seg.agg is not None:
        need |= set(seg.agg.keys)
        need |= {c for c, _ in seg.agg.aggs if c is not None}
    return frozenset(need)


def _join_out_name(name: str, left_names) -> str:
    """Inner-join output name for a right payload column (the ``_r``
    collision rule)."""
    return name + "_r" if name in left_names else name


def stream_runtime_eligible(seg: Segment, table: Table,
                            builds: tuple) -> bool:
    """``runtime_eligible`` for join-bearing stream segments: walks the
    chain tracking the available name -> Column mapping (chunk columns,
    then gathered build payloads), vetoing strings and non-1-D buffers in
    any computed-on or gathered position."""
    if not seg.joins():
        return runtime_eligible(seg, table)
    if seg.agg is not None and table.num_rows == 0:
        return False
    try:
        avail = {nm: table.column(nm) for nm in (table.names or [])}
        ji = 0
        for i, nd in enumerate(seg.chain):
            if isinstance(nd, Filter):
                for name in expr_columns(nd.predicate):
                    if not _computable(avail[name]):
                        return False
            elif isinstance(nd, Project):
                avail = {nm: avail[nm] for nm in nd.columns}
            else:  # Join
                b = builds[ji]
                ji += 1
                for k in nd.left_keys:
                    if not _computable(avail[k]):
                        return False
                bcols = {nm: b.column(nm) for nm in (b.names or [])}
                for k in nd.right_keys:
                    if not _computable(bcols[k]):
                        return False
                if nd.how == "inner":
                    lnames = set(avail)
                    needed = _needed_after(seg, i + 1)
                    for nm in (b.names or []):
                        if nm in nd.right_keys:
                            continue
                        out_nm = _join_out_name(nm, lnames)
                        if out_nm in needed:
                            if not _computable(bcols[nm]):
                                return False
                            avail[out_nm] = bcols[nm]
        if seg.agg is not None:
            for name in set(seg.agg.keys) | \
                    {c for c, _ in seg.agg.aggs if c is not None}:
                if not _computable(avail[name]):
                    return False
        return True
    except (KeyError, ValueError):
        return False


# -- compiled form ----------------------------------------------------------

def shape_class(table: Table) -> tuple:
    """The cache key of a Table input: row count (padded chunk bucket),
    names, and per-column (dtype, buffer shape and dtype, nullability)."""
    return (
        table.num_rows,
        tuple(table.names) if table.names else None,
        tuple((c.dtype,
               None if c.data is None else (tuple(c.data.shape),
                                            str(c.data.dtype)),
               c.validity is not None)
              for c in table.columns),
    )


def _probe_join_node(nd: Join, pb, table: Table, live, needed):
    """One fused probe-join step at probe-row shape: mask ``live`` by the
    verified match, and (inner only) gather the needed build payload
    columns at the matched build rows.  No expansion and no host sync: the
    prepared build guarantees at most one candidate per probe row."""
    from ..ops.join import probe_join_prepared
    from ..ops.selection import gather_column
    lk = Table([table.column(k) for k in nd.left_keys])
    ri, matched = probe_join_prepared(lk, pb, left_live=live)
    live = live & matched
    if nd.how == "semi":
        return table, live
    lnames = list(table.names or [])
    cols, names = list(table.columns), list(lnames)
    n = table.num_rows
    for nm, c in zip(pb.payload.names or [], pb.payload.columns):
        if nm in nd.right_keys:
            continue
        out_nm = _join_out_name(nm, lnames)
        if out_nm not in needed:
            continue
        if pb.nr == 0:  # dead rows only (live is all-False); typed zeros
            cols.append(Column(c.dtype, data=torch.zeros(
                n, dtype=c.data.dtype, device=live.device)))
        else:
            cols.append(gather_column(c, ri))
        names.append(out_nm)
    return Table(cols, names), live


def _build_fn(seg: Segment):
    """The callable a segment compiles to.

    ``fn(table, nvalid, prepared)``: rows >= nvalid are padding (chunk
    buckets); ``prepared`` carries one ``PreparedBuild`` per Join in the
    chain (execution order).  Map segments return (table, live); agg
    segments return padded partial aggregates, the group-live mask and the
    group count as a tensor: all on the device, no host sync.
    """
    chain, agg = seg.chain, seg.agg
    needed = {i: _needed_after(seg, i + 1)
              for i, nd in enumerate(chain) if isinstance(nd, Join)}

    def fn(table: Table, nvalid: int, prepared=()):
        from ..ops.aggregate import groupby_padded
        from .executor import _eval_expr, _mask_of
        dev = table.columns[0].device
        live = torch.arange(table.num_rows, device=dev) < nvalid
        ji = 0
        for i, nd in enumerate(chain):
            if isinstance(nd, Filter):
                live = live & _mask_of(*_eval_expr(nd.predicate, table))
            elif isinstance(nd, Join):
                table, live = _probe_join_node(nd, prepared[ji], table,
                                               live, needed[i])
                ji += 1
            else:
                table = table.select(list(nd.columns))
        if agg is None:
            return table, live
        out_keys, out_aggs, ngroups = groupby_padded(
            table, list(agg.keys), [(c, op) for c, op in agg.aggs],
            row_mask=live, device=dev)
        npad = out_aggs[0].data.shape[0] if out_aggs else live.shape[0]
        glive = torch.arange(npad, device=dev) < ngroups
        kdat = tuple(spec[2] for spec in out_keys)
        kval = tuple(spec[3] for spec in out_keys)
        return kdat, kval, tuple(out_aggs), glive, ngroups

    return fn


class CompiledSegment:
    """One (segment, shape-class) entry: the callable plus the counter
    that proves chunks reuse one entry (``traces``: 1 after the first
    call, as the JAX package's trace count)."""

    __slots__ = ("key", "segment", "key_dtypes", "fn", "traces", "calls")

    def __init__(self, key: tuple, segment: Segment, key_dtypes: tuple,
                 fn=None):
        self.key = key
        self.segment = segment
        self.key_dtypes = key_dtypes
        self.traces = 0
        self.calls = 0
        self.fn = fn if fn is not None else _build_fn(segment)

    def __call__(self, table, nvalid=None, prepared=()):
        self.calls += 1
        nv = int(table.num_rows if nvalid is None else nvalid)
        kind = "replay" if self.traces else "compile"
        self.traces = 1
        if not metrics.enabled():
            return self.fn(table, nv, tuple(prepared))
        # host-side dispatch time: the call enqueues device work and
        # returns (no sync added here)
        t0 = time.perf_counter()
        out = self.fn(table, nv, tuple(prepared))
        dt = time.perf_counter() - t0
        metrics.count(f"engine.segment.{kind}")
        metrics.observe("engine.segment.trace_s" if kind == "compile"
                        else "engine.segment.replay_dispatch_s", dt)
        return out


class CompiledDecodeSegment(CompiledSegment):
    """A CompiledSegment whose callable starts at the page planes
    (``DevicePageChunk.to_device()``): ``decode_table`` then the chain.
    The executor passes ``nvalid`` explicitly (the planes have no row
    count) and the planes ride in the table slot."""

    __slots__ = ("geom",)

    def __init__(self, key: tuple, segment: Segment, key_dtypes: tuple,
                 geom):
        from ..ops.parquet_decode import decode_table
        inner = _build_fn(segment)

        def fn(planes, nvalid, prepared=()):
            return inner(decode_table(planes, geom), nvalid, prepared)

        super().__init__(key, segment, key_dtypes, fn)
        self.geom = geom


def _resolve_dtype(name: str, table: Table, builds: tuple):
    """Dtype of an agg key that may come off a join's build side (raw name
    or with the ``_r`` collision suffix stripped)."""
    try:
        return table.column(name).dtype
    except (KeyError, ValueError):
        pass
    base = name[:-2] if name.endswith("_r") else name
    for b in builds:
        for cand in (name, base):
            try:
                return b.column(cand).dtype
            except (KeyError, ValueError):
                continue
    raise KeyError(name)


class SegmentCache:
    """LRU: (segment fingerprint, shape-class) -> CompiledSegment, with
    ``engine.segment_cache.{hit,miss,eviction}`` counters; capacity
    ``config.segment_cache`` unless given."""

    def __init__(self, maxsize: Optional[int] = None):
        self._maxsize = None if maxsize is None else int(maxsize)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, CompiledSegment]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def maxsize(self) -> int:
        return self._maxsize if self._maxsize is not None \
            else config.segment_cache

    def _lookup(self, key: tuple, make) -> CompiledSegment:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.segment_cache.hit")
                return hit
        compiled = make()
        with self._lock:
            racer = self._entries.get(key)
            if racer is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.segment_cache.hit")
                return racer
            self.misses += 1
            metrics.count("engine.segment_cache.miss")
            self._entries[key] = compiled
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                metrics.count("engine.segment_cache.eviction")
            return compiled

    def get(self, segment: Segment, table: Table,
            builds: tuple = ()) -> CompiledSegment:
        key = (segment.fingerprint(), shape_class(table),
               tuple(shape_class(b) for b in builds))

        def make():
            key_dtypes = () if segment.agg is None else tuple(
                _resolve_dtype(k, table, builds) for k in segment.agg.keys)
            return CompiledSegment(key, segment, key_dtypes)
        return self._lookup(key, make)

    def get_decode(self, segment: Segment, geom,
                   builds: tuple = ()) -> CompiledDecodeSegment:
        """The page-planes variant of :meth:`get`: keyed by (fingerprint,
        page geometry, build shapes), one entry per geometry bucket."""
        key = (segment.fingerprint(), ("device_decode", geom),
               tuple(shape_class(b) for b in builds))

        def make():
            from ..ops.parquet_decode import probe_table
            probe = probe_table(geom, device="cpu")  # dtypes only
            key_dtypes = () if segment.agg is None else tuple(
                _resolve_dtype(k, probe, builds) for k in segment.agg.keys)
            return CompiledDecodeSegment(key, segment, key_dtypes, geom)
        return self._lookup(key, make)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


#: process-wide compiled-segment cache
SEGMENT_CACHE = SegmentCache()


# -- boundary materialization ----------------------------------------------

def run_map_segment(compiled: CompiledSegment, table: Table,
                    nvalid=None) -> Table:
    """Fused chain then ONE compaction at the breaker boundary (the only
    host sync the whole chain pays, against one per interpreted Filter)."""
    from ..ops.selection import apply_boolean_mask
    out, live = compiled(table, nvalid)
    metrics.host_sync(label="segment-boundary-compaction")
    return apply_boolean_mask(out, live)


def _compact_padded(key_dtypes, kdat, kval, out_aggs, ngroups,
                    names) -> Table:
    """The padded -> compact tail for fused outputs (fixed-width keys,
    which runtime eligibility guarantees).  One host sync fetches the
    group count and, per key, whether any live group key is null (a key
    column with none carries no validity, as in the JAX package)."""
    metrics.host_sync(label="groupby-compaction")
    dev = ngroups.device
    glive = torch.arange(kval[0].shape[0] if kval else 0,
                         device=dev) < ngroups
    head = torch.stack([ngroups.to(torch.int64)] +
                       [(glive & ~v).any().to(torch.int64) for v in kval])
    ng, *key_nulls = head.tolist()  # the one host sync
    cols = []
    for dtype, data, valid, has_null in zip(key_dtypes, kdat, kval,
                                            key_nulls):
        cols.append(Column(dtype, data=data[:ng],
                           validity=valid[:ng] if has_null else None))
    for c in out_aggs:
        cols.append(Column(c.dtype, data=c.data[:ng],
                           validity=None if c.validity is None
                           else c.validity[:ng]))
    return Table(cols, names)


def run_agg_segment(compiled: CompiledSegment, table: Table,
                    nvalid=None) -> Table:
    """Fused chain + aggregate, compacted to the final group rows."""
    agg = compiled.segment.agg
    kdat, kval, out_aggs, _glive, ngroups = compiled(table, nvalid)
    return _compact_padded(compiled.key_dtypes, kdat, kval, out_aggs,
                           ngroups, list(agg.keys) + list(agg.names))


def combine_partials(partials: list, compiled: CompiledSegment) -> Table:
    """Merge per-chunk padded partial aggregates into the final Table.

    ``partials``: [(kdat, kval, out_aggs, glive, ngroups), ...] straight
    off the fused agg callable, never synced per chunk.  Two host syncs in
    all, however many chunks streamed: one ``max(ngroups)`` fetch to size
    the combine, one in the compaction tail.  Live groups sit at the front
    of each padded partial, so slicing every partial to one power-of-two
    capacity >= max(ngroups) keeps every live group and shrinks the
    combine by bucket/cap.
    """
    from ..ops.aggregate import groupby_padded
    from .executor import _STREAM_COMBINE
    agg = compiled.segment.agg
    nk = len(agg.keys)
    metrics.host_sync(label="combine-sizing")
    maxng = int(torch.stack([p[4] for p in partials]).max())
    cap = 64
    while cap < maxng:
        cap *= 2

    def cut(a):
        return a[:cap] if a.shape[0] > cap else a

    key_cols = [
        Column(compiled.key_dtypes[i],
               data=torch.cat([cut(p[0][i]) for p in partials]),
               validity=torch.cat([cut(p[1][i]) for p in partials]))
        for i in range(nk)]
    agg_cols = []
    for j in range(len(agg.aggs)):
        datas = [cut(p[2][j].data) for p in partials]
        valids = [None if p[2][j].validity is None
                  else cut(p[2][j].validity) for p in partials]
        validity = None if all(v is None for v in valids) else \
            torch.cat([torch.ones(d.shape[0], dtype=torch.bool,
                                  device=d.device) if v is None else v
                       for d, v in zip(datas, valids)])
        agg_cols.append(Column(partials[0][2][j].dtype,
                               data=torch.cat(datas), validity=validity))
    live = torch.cat([cut(p[3]) for p in partials])
    knames = [f"k{i}" for i in range(nk)]
    anames = [f"a{j}" for j in range(len(agg.aggs))]
    merged = Table(key_cols + agg_cols, knames + anames)
    combine = [(anames[j], _STREAM_COMBINE[op])
               for j, (_, op) in enumerate(agg.aggs)]
    out_keys, out_aggs, ngroups = groupby_padded(
        merged, knames, combine, row_mask=live, device=live.device)
    kdat = tuple(spec[2] for spec in out_keys)
    kval = tuple(spec[3] for spec in out_keys)
    return _compact_padded(compiled.key_dtypes, kdat, kval, out_aggs,
                           ngroups, list(agg.keys) + list(agg.names))


# -- whole-stage fusion: the exchange inside the pass -----------------------
#
# The segments above stop at pipeline breakers, and Exchange is the breaker
# that costs the most: the host orchestrates a two-phase shuffle (counts
# sync + compaction sync) between the partial and final aggregates of a
# distributed group-by.  ``FusedStage`` runs the optimizer's ``partial-agg
# -> hash Exchange -> final-agg`` sandwich as one device pass over every
# shard: partial groupby, murmur3 placement, bucket pack, the grid
# transpose, and the combine groupby, with no host round trip between the
# three plan nodes.  Every size is static (a per-shard group prefix and a
# capacity of twice the uniform share), overflow is counted on the device,
# and the whole stage pays one deliberate host sync: the boundary fetch.
# The host-orchestrated path stays the fallback (ineligible schema, shared
# interior nodes, the AQE probe's routing, overflow), as in the JAX package.

#: partial-side ops a fused stage supports: each has a merge op
#: (executor._STREAM_COMBINE keys)
_FUSED_PARTIAL_OPS = frozenset({"sum", "count", "count_all", "min", "max"})
#: merge-side ops (the _STREAM_COMBINE value set)
_FUSED_COMBINE_OPS = frozenset({"sum", "min", "max"})


class FusedStage:
    """One distributed stage, ``Aggregate(final) -> Exchange(hash) ->
    Aggregate(partial)``, run as a single device pass."""

    __slots__ = ("combine", "exchange", "partial", "_fp")

    def __init__(self, combine: Aggregate, exchange, partial: Aggregate):
        self.combine = combine
        self.exchange = exchange
        self.partial = partial
        self._fp: Optional[str] = None

    def sel_names(self) -> list:
        """Input columns the stage consumes: group keys then agg inputs."""
        out = list(self.combine.keys)
        for c, _ in self.partial.aggs:
            if c is not None and c not in out:
                out.append(c)
        return out

    def fingerprint(self) -> str:
        if self._fp is None:
            sig = ("fused-stage", tuple(self.combine.keys),
                   tuple(self.partial.aggs), tuple(self.partial.names),
                   tuple(self.combine.aggs), tuple(self.combine.names),
                   tuple(self.exchange.keys))
            self._fp = hashlib.sha256(repr(sig).encode()).hexdigest()
        return self._fp


def fused_sandwich(node) -> Optional[FusedStage]:
    """Detect the partial/final sandwich rooted at ``node`` (the same
    structural test as ``verify.decision_census``) plus op eligibility.
    Returns None when ``node`` cannot head a fused stage."""
    from .plan import Exchange
    if not isinstance(node, Aggregate):
        return None
    ex = node.child
    if not (isinstance(ex, Exchange) and ex.kind == "hash"):
        return None
    p = ex.child
    if not (isinstance(p, Aggregate) and p.keys
            and tuple(p.keys) == tuple(node.keys)
            and tuple(p.names) == tuple(node.names)):
        return None
    if not set(ex.keys) <= set(node.keys):
        return None  # the exchange must co-locate whole groups
    if len(node.aggs) != len(p.aggs):
        return None
    if any(op not in _FUSED_PARTIAL_OPS for _, op in p.aggs):
        return None
    if any(op not in _FUSED_COMBINE_OPS for _, op in node.aggs):
        return None
    return FusedStage(node, ex, p)


def _fused_col_ok(dt) -> bool:
    """Dtype gate shared by the static (verify) and runtime checks: stage
    columns cross the exchange as word planes, one value per row, so they
    must be 1-D fixed-width (no strings, nested or decimal columns)."""
    return (dt.is_fixed_width and not dt.is_string and not dt.is_nested
            and not dt.is_decimal)


def fused_static_eligible(stage: FusedStage, schema=None) -> bool:
    """Schema-level eligibility from a name -> DType mapping (the
    verifier's resolved view).  Unknown columns assume eligible: the
    runtime check over the actual table has the final veto."""
    if schema is None:
        return True
    for nm in stage.sel_names():
        dt = schema.get(nm)
        if dt is not None and not _fused_col_ok(dt):
            return False
    return True


def fused_runtime_eligible(stage: FusedStage, table: Table) -> bool:
    """The actual input schema's veto (mirrors ``runtime_eligible``)."""
    try:
        for nm in stage.sel_names():
            c = table.column(nm)
            if not _fused_col_ok(c.dtype) or c.data is None \
                    or c.data.ndim != 1:
                return False
    except (KeyError, ValueError):
        return False
    return True


def fused_prefix(n_local: int) -> int:
    """Static per-shard live-group budget of the fused stage.

    The partial groupby packs each shard's live groups to the front of
    that shard's slots, so everything downstream (placement, plane pack,
    the grid, the combine) only needs a static prefix sized for the groups
    a shard can plausibly hold: ``config.fuse_groups``, bucketed and
    clamped by the shard's rows.  A shard that aggregates more groups than
    the budget counts into the same device-side overflow as a full
    exchange bucket, and the executor re-plans on the host path."""
    from ..parallel.shuffle import cap_bucket
    if n_local <= 0:
        return 1
    return min(n_local, cap_bucket(max(1, int(config.fuse_groups))))


def fused_capacity(prefix: int, ndev: int) -> int:
    """Static per-(src, dest) slot capacity of the in-pass exchange: twice
    the uniform share of a shard's prefix (murmur3 spreads groups near
    uniformly), bucketed; the overflow count read at the one boundary sync
    catches the adversarial remainder."""
    from ..parallel.shuffle import cap_bucket
    return min(cap_bucket(2 * (-(-prefix // ndev))), cap_bucket(prefix))


def _build_fused_fn(stage: FusedStage, compiled: "CompiledFusedStage"):
    """The stage's device pass over every shard at once: partial groupby
    (the shard index leads the keys) -> per-shard group rank into a static
    prefix -> murmur3 placement -> plane pack and grid transpose -> the
    combine groupby.  All on the device, no host sync."""
    from ..ops.aggregate import groupby_padded
    from ..ops.row_conversion import (_build_planes, _from_planes,
                                      fixed_width_layout)
    from ..parallel.shuffle import exchange_planes, partition_ids_specs

    from ..parallel import ranks as _ranks

    partial, combine = stage.partial, stage.combine
    keys = list(combine.keys)
    nk = len(keys)
    sel = stage.sel_names()
    ns, prefix, capacity = compiled.ndev, compiled.prefix, compiled.capacity
    nl = compiled.nlocal  # the shards this process holds (all but ranks)

    def fn(datas, masks, n_valid: int, ranks=None):
        dev = datas[0].device
        n = datas[0].shape[0]
        n_local = n // nl
        table = Table([Column(dt, data=d, validity=m)
                       for dt, d, m in zip(compiled.in_dtypes, datas,
                                           masks)], list(sel))
        row = torch.arange(n, device=dev)
        live = row < n_valid
        src = row // n_local

        # 1) every shard's partial aggregate in one batched groupby: the
        # shard index leads the keys, so the live groups come out in
        # (shard, key) order, each shard's groups one contiguous run
        pkeys, paggs, ng1 = groupby_padded(
            table, None, [(c, op) for c, op in partial.aggs],
            keys_cols=[Column(INT32, data=src.to(torch.int32))] +
            [table.column(k) for k in keys], row_mask=live, device=dev)
        # per-shard group rank: group g of shard s sits at start[s] + rank,
        # so slot (s, r) of the static prefix reads group start[s] + r.
        # A shard holding more groups than the prefix counts them as
        # overflow (the executor re-plans on the host path)
        gshard = pkeys[0][2].to(torch.int64)
        gshard = torch.where(row < ng1, gshard, nl)
        ngs = torch.zeros(nl + 1, dtype=torch.int64, device=dev) \
            .index_add_(0, gshard, torch.ones_like(gshard))[:nl]
        start = torch.cumsum(ngs, 0) - ngs
        pre_overflow = _ranks.all_reduce((ngs - prefix).clamp(min=0).sum(),
                                         ranks)
        r = torch.arange(prefix, device=dev)
        gidx = (start[:, None] + r[None, :]).reshape(-1).clamp(max=n - 1)
        glive = (r[None, :] < ngs[:, None]).reshape(-1)
        kcols = [Column(s[1], data=s[2][gidx], validity=s[3][gidx])
                 for s in pkeys[1:]]
        acols = [Column(c.dtype, data=c.data[gidx],
                        validity=None if c.validity is None
                        else c.validity[gidx]) for c in paggs]

        # 2) Spark-exact placement of each live group, the same
        # partition_ids_specs the host exchange uses
        specs = tuple(("fixed", i, kcols[i].dtype) for i in range(nk))
        dest = partition_ids_specs(kcols, specs, ns)

        # 3) partial rows -> word planes -> one dense (dst, src) block
        layout = fixed_width_layout([c.dtype for c in kcols + acols])
        compiled.layout = layout
        m = nl * prefix
        planes = _build_planes(layout, [c.data for c in kcols + acols],
                               [c.validity for c in kcols + acols], m, dev)
        slot_src = torch.arange(m, device=dev) // prefix
        planes_in, rok, overflow = exchange_planes(
            planes, slot_src, dest, glive, ns, capacity, ranks)

        # 4) received planes -> columns -> every shard's combine, batched
        # the same way (the receiving shard leads the keys)
        datas_in, masks_in = _from_planes(layout, planes_in)
        recv = Table([Column(dt, data=d, validity=v)
                      for dt, d, v in zip(layout.schema, datas_in,
                                          masks_in)],
                     keys + list(partial.names))
        rshard = torch.arange(rok.shape[0], device=dev) // (ns * capacity)
        out_keys, out_aggs, ng2 = groupby_padded(
            recv, None, [(c, op) for c, op in combine.aggs],
            keys_cols=[Column(INT32, data=rshard.to(torch.int32))] +
            [recv.column(k) for k in keys], row_mask=rok, device=dev)

        # 5) outputs: padded combine results (live groups first, in
        # (shard, key) order), the per-(src, dest) send matrix (every
        # rank's rows, gathered on the device) and the overflow count, all
        # still on the device
        flat = torch.where(glive, slot_src * (ns + 1) + dest,
                           slot_src * (ns + 1) + ns)
        sent = torch.zeros(nl * (ns + 1), dtype=torch.int64, device=dev) \
            .index_add_(0, flat, torch.ones_like(flat)) \
            .reshape(nl, ns + 1)[:, :ns]
        sent = _ranks.all_gather_rows(sent, ranks,
                                      [nl] * (ns // nl))
        kdat = tuple(s[2] for s in out_keys[1:])
        kval = tuple(s[3] for s in out_keys[1:])
        return (kdat, kval, tuple(out_aggs), ng2, sent,
                overflow + pre_overflow)

    return fn


class CompiledFusedStage:
    """One (stage, input shape-class, shard count) entry: the stage's
    device pass as one callable, plus the counter that proves
    re-dispatches replay one entry (``traces``: 1 after its first call,
    the "compile"; every later call is a replay)."""

    __slots__ = ("key", "stage", "ndev", "nlocal", "prefix", "capacity",
                 "in_dtypes", "key_dtypes", "layout", "traces", "calls", "fn")

    def __init__(self, key: tuple, stage: FusedStage, ndev: int,
                 in_dtypes: tuple, key_dtypes: tuple, n_local: int,
                 nlocal: Optional[int] = None):
        self.key = key
        self.stage = stage
        self.ndev = ndev
        self.nlocal = ndev if nlocal is None else nlocal
        self.prefix = fused_prefix(n_local)
        self.capacity = fused_capacity(self.prefix, ndev)
        self.in_dtypes = in_dtypes
        self.key_dtypes = key_dtypes
        self.layout = None  # set by the first call (host wire attribution)
        self.traces = 0
        self.calls = 0
        self.fn = _build_fused_fn(stage, self)

    def __call__(self, datas, masks, n_valid: int, ranks=None):
        self.calls += 1
        kind = "replay" if self.traces else "compile"
        self.traces = 1
        if not metrics.enabled() and not timeline.enabled():
            return self.fn(datas, masks, n_valid, ranks)
        # host-side dispatch time: the call enqueues device work and
        # returns (no sync added here)
        t0 = time.perf_counter()
        out = self.fn(datas, masks, n_valid, ranks)
        dt = time.perf_counter() - t0
        timeline.complete(f"engine.fused_stage.{kind}", t0, dt)
        if metrics.enabled():
            metrics.count(f"engine.fused_stage.{kind}")
            if kind == "compile":
                metrics.observe("engine.fused_stage.trace_s", dt)
        return out


class FusedStageCache:
    """LRU: (stage fingerprint, input shape-class, shards, prefix) ->
    CompiledFusedStage, with ``engine.fused_stage_cache.{hit,miss,
    eviction}`` counters; sized by ``config.segment_cache`` unless given."""

    def __init__(self, maxsize: Optional[int] = None):
        self._maxsize = None if maxsize is None else int(maxsize)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, CompiledFusedStage]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def maxsize(self) -> int:
        return self._maxsize if self._maxsize is not None \
            else config.segment_cache

    def get(self, stage: FusedStage, padded: Table, ndev: int,
            nlocal: Optional[int] = None) -> CompiledFusedStage:
        nlocal = ndev if nlocal is None else nlocal
        n_local = padded.num_rows // nlocal
        # the prefix is in the key: a fuse_groups change must build a fresh
        # entry, not replay one sized for the old budget
        key = (stage.fingerprint(), shape_class(padded), ndev, nlocal,
               fused_prefix(n_local))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.fused_stage_cache.hit")
                return hit
        compiled = CompiledFusedStage(
            key, stage, ndev, tuple(c.dtype for c in padded.columns),
            tuple(padded.column(k).dtype for k in stage.combine.keys),
            n_local, nlocal)
        with self._lock:
            racer = self._entries.get(key)
            if racer is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count("engine.fused_stage_cache.hit")
                return racer
            self.misses += 1
            metrics.count("engine.fused_stage_cache.miss")
            self._entries[key] = compiled
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
                metrics.count("engine.fused_stage_cache.eviction")
            return compiled

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


#: process-wide fused-stage cache
FUSED_STAGE_CACHE = FusedStageCache()


def fused_pad(t: Table, ndev: int, mesh=None):
    """``pad_to_multiple`` with the empty-input synthesis: an empty table
    still runs the same one-sync pass over one dead row a shard (n_valid 0
    masks every one), which keeps ``verify.sync_budget`` exact for empty
    inputs.  Over ranks (``mesh``) this rank's block pads to every rank's
    length.  Returns (padded Table, n_valid)."""
    from ..parallel.mesh import local_shards, pad_to_multiple
    if t.num_rows == 0:
        nl = ndev if mesh is None else local_shards(mesh)
        t = Table([Column(c.dtype,
                          data=c.data.new_zeros((nl,)),
                          validity=torch.zeros(nl, dtype=torch.bool,
                                               device=c.data.device))
                   for c in t.columns], list(t.names))
        if mesh is None or mesh.world == 1:
            return t, 0
        return pad_to_multiple(t, ndev, mesh)[0], 0
    return pad_to_multiple(t, ndev, mesh)


def run_fused_stage(stage: FusedStage, table: Table, mesh,
                    axis: str = ROW_AXIS, prepped=None):
    """Execute the whole distributed stage over ``table`` (the partial
    aggregate's input) on ``mesh``.  Returns ``(result Table, info)``, or
    None when the static prefix or capacity overflowed (the caller re-plans
    on the host-orchestrated path).

    ``prepped`` is an optional ``(padded, n_valid)`` pair from a caller
    that already padded and placed the stage input (the AQE counts probe
    does).

    Exactly one deliberate host sync for the whole stage: one fetch of the
    overflow count, the live group count, the null flags of every output
    column and the per-(src, dest) send matrix.  The output comes back in
    ascending key order, the order one global groupby (the host path)
    gives: hash placement makes the shards' key sets disjoint, so a stable
    sort of the (shard, key)-ordered groups by key restores it."""
    from ..ops.order import SortKey, encode_keys, lexsort
    from ..parallel.mesh import axis_size, local_shards, shard_table

    ndev = axis_size(mesh, axis)
    if prepped is None:
        padded, nrows = fused_pad(table.select(stage.sel_names()), ndev,
                                  mesh)
        padded = shard_table(padded, mesh, axis)
    else:
        padded, nrows = prepped
    compiled = FUSED_STAGE_CACHE.get(stage, padded, ndev,
                                     local_shards(mesh, axis))
    datas = tuple(c.data for c in padded.columns)
    masks = tuple(c.validity for c in padded.columns)
    with timeline.span("engine.fused_stage.dispatch",
                       {"capacity": int(compiled.capacity),
                        "rows": int(table.num_rows)}):
        kdat, kval, aggs, ngroups, sent, overflow = compiled(
            datas, masks, int(nrows), mesh.ranks)

    # the one deliberate host sync of the whole stage
    metrics.host_sync(label="groupby-compaction")
    dev = ngroups.device
    glive = torch.arange(kval[0].shape[0], device=dev) < ngroups
    nulls = [(glive & ~v).any() for v in kval] + \
        [torch.zeros((), dtype=torch.bool, device=dev) if c.validity is None
         else (glive & ~c.validity).any() for c in aggs]
    head = torch.cat([torch.stack([overflow.to(torch.int64),
                                   ngroups.to(torch.int64)] +
                                  [f.to(torch.int64) for f in nulls]),
                      sent.reshape(-1)]).cpu()
    if int(head[0]):
        metrics.count("engine.fused_stage.overflow_fallbacks")
        return None
    ng = int(head[1])
    has_null = [bool(f) for f in head[2:2 + len(nulls)]]
    counts = head[2 + len(nulls):].reshape(ndev, ndev).numpy()

    key_cols = [Column(dt, data=d[:ng], validity=v[:ng])
                for dt, d, v in zip(compiled.key_dtypes, kdat, kval)]
    order = lexsort(encode_keys([SortKey(c) for c in key_cols]))
    cols = [Column(c.dtype, data=c.data[order],
                   validity=c.validity[order] if hn else None)
            for c, hn in zip(key_cols, has_null)]
    for c, hn in zip(aggs, has_null[len(kval):]):
        cols.append(Column(c.dtype, data=c.data[:ng][order],
                           validity=c.validity[:ng][order] if hn else None))
    out = Table(cols, list(stage.combine.keys) + list(stage.combine.names))
    metrics.count("engine.fused_stage.dispatches")
    cap, row_size = compiled.capacity, compiled.layout.row_size
    info = {"capacity": cap, "ndev": ndev, "row_size": row_size,
            "wire_bytes": ndev * ndev * cap * row_size,
            "rows_matrix": counts,  # [src, dest], device-derived
            "wire_matrix": np.full((ndev, ndev), cap * row_size, np.int64),
            "in_rows": int(table.num_rows)}
    return out, info
