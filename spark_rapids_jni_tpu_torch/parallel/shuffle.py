"""Hash-partition shuffle of row-word planes between the shards of a mesh.

The port of ``spark_rapids_jni_tpu/parallel/shuffle.py``.  Per shard:

    dest = pmod(murmur3(keys), nshards)             (Spark HashPartitioning)
    word planes (ops/row_conversion._build_planes)
    bucket pack into a (dest, capacity) send grid

then the exchange: JAX's ``lax.all_to_all`` over the (src, dst, capacity)
grid is the (dst, src, capacity) transpose of the batched grid, so shard d
receives ``nshards * capacity`` slots, source-major.  Over ranks
(``parallel/ranks.py``) each rank packs its own shards' rows and the grid
crosses in one ``all_to_all_single`` of destination-rank blocks; the
counts matrix is an all-gather of the ranks' rows, and overflows and
string widths are summed or maxed over the ranks.  Every shard's work
runs batched: one stable sort of (src, dest, row) over the whole table, one
``searchsorted`` for every (src, dest) start and count, one gather fill of
the grid.  The slot placement is the JAX package's bit for bit.

Static shapes, as in JAX: each source shard sends at most ``capacity`` rows
to each destination.  Capacity comes from a two-phase exchange: a counts
pass (hash + one scatter-add) whose matrix reaches the host (the one
deliberate sync, ``exchange-counts-sizing``), then the payload pass at the
counts' power-of-two bucket.  Overflow is still counted.

``split=(hot_dests, salt)`` is adaptive execution's hot-key split
(``engine/adaptive.py``): rows placed on a hot destination are re-dealt
round-robin over every shard, ``(salt + shard + hot_idx) % nshards``, where
``hot_idx`` counts each source shard's own live hot rows.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..columnar import Column, Table
from ..ops.hash import murmur3_hash, murmur3_hash_specs
from ..ops.row_conversion import _build_planes, _from_planes, \
    fixed_width_layout
from ..utils import faults, metrics, timeline
from ..utils.tracing import traced
from . import ranks as _ranks
from .mesh import ROW_AXIS, Mesh, axis_size, local_shards, shard_offset
from .stringplane import (LEN_SUFFIX, WORD_SUFFIX, explode_strings,
                          reassemble_strings)


def _pmod(h: torch.Tensor, n: int) -> torch.Tensor:
    """pmod of a u32-in-int64 hash read as Spark's signed int."""
    signed = torch.where(h >= 1 << 31, h - (1 << 32), h)
    return torch.remainder(signed, n)


def partition_ids(key_table: Table, num_partitions: int) -> torch.Tensor:
    """Spark HashPartitioning: pmod(murmur3_hash(keys, 42), n) as INT32."""
    h = murmur3_hash(key_table, device=key_table.columns[0].device).data
    return _pmod(h.to(torch.int64) & 0xFFFFFFFF,
                 num_partitions).to(torch.int32)


def partition_ids_specs(cols, key_specs, num_partitions: int) -> torch.Tensor:
    """Spark HashPartitioning over possibly-exploded key columns (int64).

    ``key_specs`` (per original key): ("fixed", idx, dtype) or
    ("string", len_idx, (word_idx, ...)) into ``cols``.  String keys hash
    their UTF-8 bytes rebuilt from the exploded words (Spark UTF8String
    murmur3), so placement is width-independent and Spark-exact.
    """
    hs = tuple(("fixed", s[1]) if s[0] == "fixed" else s for s in key_specs)
    return _pmod(murmur3_hash_specs(cols, hs), num_partitions)


def key_specs_for(table: Table, keys, plan) -> tuple:
    """Key specs for ``partition_ids_specs`` over a possibly-exploded table:
    ``keys`` are the ORIGINAL key names (or indices when nothing was
    exploded), ``plan`` the StringPlan (or None)."""
    spec_of = dict(zip(plan.names, plan.specs)) if plan is not None else {}
    names = list(table.names or [f"c{i}" for i in range(table.num_columns)])
    out = []
    for k in keys:
        s = spec_of.get(k, ("fixed",)) if isinstance(k, str) else ("fixed",)
        if s[0] == "string":
            li = names.index(f"{k}{LEN_SUFFIX}")
            out.append(("string", li,
                        tuple(names.index(f"{k}{WORD_SUFFIX}{i}")
                              for i in range(s[1]))))
        else:
            i = names.index(k) if isinstance(k, str) else int(k)
            out.append(("fixed", i, table.columns[i].dtype))
    return tuple(out)


def _bucket_pack_planes(planes: torch.Tensor, src: torch.Tensor,
                        dest: torch.Tensor, row_mask, nsrc: int, ndst: int,
                        capacity: int):
    """Scatter-free bucket pack of every shard at once.

    ``planes``: int32[nw, n] row words; ``src``/``dest``: int64[n] source
    shard and destination of each row; ``row_mask``: bool[n] or None (dead
    rows are never sent).  One stable sort of (src, dest) carries the row
    indices (row order within a bucket is the input order, as in JAX's
    per-shard stable 2-operand sort); the grid slot (s, d, r) reads sorted
    position start[s, d] + r.  Returns (send int32[nw, nsrc, ndst, cap],
    ok bool[nsrc, ndst, cap], overflow: live rows that did not fit, a 0-d
    tensor)."""
    nw, n = planes.shape
    dev = planes.device
    if n == 0:
        return (torch.zeros((nw, nsrc, ndst, capacity), dtype=planes.dtype,
                            device=dev),
                torch.zeros((nsrc, ndst, capacity), dtype=torch.bool,
                            device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    if row_mask is not None:
        dest = torch.where(row_mask, dest, ndst)
    key = src * (ndst + 1) + dest
    skey, si = torch.sort(key, stable=True)
    q = (torch.arange(nsrc, device=dev)[:, None] * (ndst + 1)
         + torch.arange(ndst, device=dev)[None, :]).reshape(-1)
    start = torch.searchsorted(skey, q)
    cnt = torch.searchsorted(skey, q, right=True) - start
    r = torch.arange(capacity, device=dev)
    ok = r[None, :] < cnt.clamp(max=capacity)[:, None]
    rows = si[(start[:, None] + r[None, :]).clamp(0, n - 1)].reshape(-1)
    send = torch.where(ok.reshape(1, -1), planes[:, rows],
                       torch.zeros((), dtype=planes.dtype, device=dev))
    overflow = (cnt - capacity).clamp(min=0).sum()
    return (send.reshape(nw, nsrc, ndst, capacity),
            ok.reshape(nsrc, ndst, capacity), overflow)


def exchange_planes(planes: torch.Tensor, src: torch.Tensor,
                    dest: torch.Tensor, row_mask, nshards: int,
                    capacity: int, ranks=None):
    """Bucket-pack word planes and move them between the shards as one
    dense block: the (src, dst) grid transposed to (dst, src).  Returns
    (planes_in int32[nw, nlocal * nshards * capacity], live mask, overflow
    summed over every shard); local shard d owns received rows
    ``[d * nshards * capacity, (d + 1) * ...)``, source-major, as JAX's
    all_to_all lays them out.  ``src`` is each row's shard among this
    rank's ``nlocal = nshards / world`` (all of them without ``ranks``).

    Over ranks the (src_local, dst, cap) grid regroups by destination rank
    and crosses in one all-to-all, the live mask riding as one more plane;
    a rank receives its shards' slice of the one-process grid."""
    world = ranks.world if _ranks.active(ranks) else 1
    nlocal = nshards // world
    send, ok, overflow = _bucket_pack_planes(planes, src, dest, row_mask,
                                             nlocal, nshards, capacity)
    nw = planes.shape[0]
    if world == 1:
        recv = send.transpose(1, 2).reshape(nw, -1)
        rok = ok.transpose(0, 1).reshape(-1)
        return recv, rok, overflow
    grid = torch.cat([send, ok.to(send.dtype)[None]])  # (nw+1, Ls, N, cap)
    grid = grid.reshape(nw + 1, nlocal, world, nlocal, capacity)
    got = _ranks.all_to_all(grid.permute(2, 0, 1, 3, 4), ranks)
    # got: (src rank, nw+1, src local, dst local, cap) -> dst-major
    got = got.permute(1, 3, 0, 2, 4).reshape(nw + 1, -1)
    return got[:nw], got[nw] != 0, _ranks.all_reduce(overflow, ranks)


def shard_ids(n: int, nshards: int, device, offset: int = 0) -> torch.Tensor:
    """Shard of each row of a row-sharded block of ``n`` rows split into
    ``nshards`` shards, counted from ``offset`` (a rank's first shard)."""
    return torch.arange(n, device=device) // max(n // nshards, 1) + offset


def device_load_stats(dest_rows) -> dict:
    """Skew/straggler attribution from per-destination row counts.

    Skew is max/mean destination load (1.0 balanced, nshards everything on
    one); the straggler share (max - mean)/max is the fraction of the
    fullest shard's work the others sit idle for.
    """
    rows = np.asarray(dest_rows, dtype=np.int64).reshape(-1)
    ndev = max(1, rows.size)
    total = int(rows.sum()) if rows.size else 0
    mean = total / ndev
    mx = int(rows.max()) if rows.size else 0
    skew = (mx / mean) if mean > 0 else 1.0
    straggler = ((mx - mean) / mx) if mx > 0 else 0.0
    return {"dev_rows": [int(r) for r in rows],
            "total_rows": total,
            "max_dev_rows": mx,
            "mean_dev_rows": round(mean, 3),
            "skew": round(float(skew), 6),
            "straggler_share": round(float(straggler), 6)}


def cap_bucket(count: int) -> int:
    """Round a counts-derived capacity up to a power-of-two bucket (>=32)."""
    cap = 32
    while cap < count:
        cap *= 2
    return cap


def cap_bucket_fine(count: int) -> int:
    """Round up to a quarter-power-of-two bucket (1, 1.25, 1.5, 1.75 x 2^k):
    at most 25% padding for large data-dependent capacities."""
    cap = cap_bucket(count)
    if cap >= 128:
        for frac in (4, 5, 6, 7):
            if cap // 8 * frac >= count:
                return cap // 8 * frac
    return cap


def _live_rows(n: int, n_valid, device):
    if n_valid is None:
        return None
    return torch.arange(n, device=device) < int(n_valid)


def partition_counts(table: Table, mesh: Mesh, keys: list,
                     axis=ROW_AXIS, n_valid_rows=None,
                     key_specs: tuple | None = None) -> np.ndarray:
    """Phase 1 of the two-phase exchange: int64[nshards, nshards] host
    matrix, row s = the rows shard s sends to each destination.  Rows of
    this rank's block at index >= ``n_valid_rows`` are padding and count
    nowhere.  Over ranks every rank computes its shards' rows and the
    all-gather gives every rank the same whole matrix.

    The matrix reaching the host is a deliberate sync; the engine's
    Exchange paths label it ``exchange-counts-sizing`` at their call
    sites."""
    if key_specs is None:
        key_specs = key_specs_for(table, keys, None)
    ns = axis_size(mesh, axis)
    nl = local_shards(mesh, axis)
    n = table.num_rows
    dev = mesh.device
    dest = partition_ids_specs(table.columns, key_specs, ns) if n else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    live = _live_rows(n, n_valid_rows, dev)
    if live is not None:
        dest = torch.where(live, dest, ns)
    flat = shard_ids(n, nl, dev) * (ns + 1) + dest
    # a scatter-add, not bincount: bincount sizes its output on the host
    counts = torch.zeros(nl * (ns + 1), dtype=torch.int64, device=dev) \
        .index_add_(0, flat, torch.ones_like(flat))
    counts = counts.reshape(nl, ns + 1)[:, :ns]
    return _ranks.all_gather_rows(counts, mesh.ranks,
                                  [nl] * mesh.world).cpu().numpy()


def split_dest(dest: torch.Tensor, split: tuple, live, nshards: int,
               nlocal: int | None = None, offset: int = 0):
    """Destinations after the AQE hot-key split ``(hot_dests, salt)``.

    Rows placed on a hot destination are re-dealt round-robin across every
    shard by a per-source-shard running index of its live hot rows,
    staggered by the source shard (``(salt + shard + hot_idx) % nshards``),
    which bounds each destination's share of a shard's hot rows at
    ceil(hot / nshards).  Dead rows do not advance the deal: the capacity
    projection counted live rows only.  In the batched layout the running
    index is a cumsum along each shard's row block of the (shards, n_local)
    view, as JAX's per-shard ``cumsum`` is.  ``dest`` holds this rank's
    ``nlocal`` shards (every one by default), the first at global index
    ``offset``."""
    hot, salt = split
    nlocal = nshards if nlocal is None else nlocal
    is_hot = dest == int(hot[0])
    for h in hot[1:]:
        is_hot = is_hot | (dest == int(h))
    if live is not None:
        is_hot = is_hot & live
    n = dest.shape[0]
    src = shard_ids(n, nlocal, dest.device, offset)
    hot_idx = torch.cumsum(is_hot.to(torch.int64).reshape(
        nlocal, n // nlocal), dim=1).reshape(-1) - 1
    return torch.where(is_hot, (int(salt) + src + hot_idx) % nshards, dest)


@traced("shuffle_table_padded")
def shuffle_table_padded(table: Table, mesh: Mesh, keys: list,
                         capacity: int | None = None, axis=ROW_AXIS,
                         live=None, key_specs: tuple | None = None,
                         split: tuple | None = None):
    """Shuffle a row-sharded table by key hash.

    Returns (padded Table of nshards^2 * capacity rows, bool row mask,
    overflow 0-d tensor).  Over ranks ``table`` is this rank's block, the
    result its shards' ``nlocal * nshards * capacity`` slots and the
    overflow the sum over every rank.  Rows land on the shard owning
    pmod(murmur3(keys), nshards); padding slots have mask False.  ``live``:
    optional bool row mask, dead rows are never sent.

    STRING columns cross in padded-bucket form (``stringplane``), string
    keys partitioning by Spark's UTF8String murmur3 over their original
    bytes.  ``key_specs``: precomputed ``key_specs_for`` of an already
    exploded table (the engine explodes once so every chunk shares one
    layout).

    ``split``: the AQE skew-split ``(hot_dests, salt)`` (``split_dest``).
    The internal counts pass sizes capacity for the unsplit placement, so
    a split needs the projected capacity passed explicitly.
    """
    if split is not None and capacity is None:
        raise ValueError("split requires an explicitly projected capacity")
    plan = None
    if any(c.dtype.is_string for c in table.columns):
        names0 = table.names or [f"c{i}" for i in range(table.num_columns)]
        keys = [k if isinstance(k, str) else names0[int(k)] for k in keys]
        table, plan = explode_strings(table, ranks=mesh.ranks)
    table = table.to(mesh.device)
    layout = fixed_width_layout(table.dtypes())
    ns = axis_size(mesh, axis)
    nl = local_shards(mesh, axis)
    n = table.num_rows
    if n % nl:
        raise ValueError(f"{n} rows do not split into {nl} equal shards")
    if key_specs is None:
        key_specs = key_specs_for(table, keys, plan)
    if capacity is None:
        counts_mat = partition_counts(table, mesh, list(keys), axis,
                                      key_specs=key_specs)
        capacity = cap_bucket(int(counts_mat.max()))
        metrics.host_sync(label="exchange-counts-sizing")
        if metrics.enabled():
            st = device_load_stats(counts_mat.sum(axis=0))
            metrics.gauge_set("parallel.shuffle.skew", st["skew"])
            metrics.gauge_set("parallel.shuffle.max_dev_rows",
                              st["max_dev_rows"])
            for r in st["dev_rows"]:
                metrics.observe("parallel.shuffle.dev_rows", r)
    wire = ns * ns * capacity * layout.row_size
    metrics.count("parallel.shuffle.exchanges")
    metrics.count("parallel.shuffle.exchange_bytes", wire)
    metrics.observe("parallel.shuffle.capacity_rows", capacity)
    with torch.profiler.record_function("parallel.shuffle.exchange"), \
            timeline.span("parallel.shuffle.exchange",
                          {"capacity": int(capacity), "wire_bytes": wire}):
        dev = mesh.device
        dest = partition_ids_specs(table.columns, key_specs, ns) if n else \
            torch.zeros(0, dtype=torch.int64, device=dev)
        planes = _build_planes(layout, [c.data for c in table.columns],
                               [c.validity for c in table.columns], n, dev)
        if live is not None:
            live = live.to(dev)
        if split is not None:
            dest = split_dest(dest, split, live, ns, nl,
                              shard_offset(mesh, axis))
        planes_in, ok, overflow = exchange_planes(
            planes, shard_ids(n, nl, dev), dest, live, ns, capacity,
            mesh.ranks)
        datas, masks = _from_planes(layout, planes_in)
    out = Table([Column(dt, data=d, validity=m)
                 for dt, d, m in zip(layout.schema, datas, masks)],
                table.names)
    if plan is not None:
        out = reassemble_strings(out, plan)
    return out, ok, overflow


def shuffle_chunks_pipelined(chunks, mesh: Mesh, keys: list,
                             capacity: int | None = None, depth: int = 1,
                             axis=ROW_AXIS, key_specs: tuple | None = None,
                             split: tuple | None = None):
    """Exchange a stream of row-sharded chunks (or ``(Table, live)`` pairs)
    with dispatch-ahead overlap: up to ``depth`` exchanges are queued on
    the device in front of the consumer (``depth=0`` is the serial loop).
    Pass ``capacity`` sized from global counts so one grid shape serves the
    stream; ``split`` passes the AQE skew split through (it needs
    ``capacity``).  Yields ``(padded Table, ok mask, overflow)`` per chunk,
    in order."""
    inflight: deque = deque()
    for item in chunks:
        tbl, live = item if isinstance(item, tuple) else (item, None)
        faults.check("exchange.dispatch")
        inflight.append(shuffle_table_padded(
            tbl, mesh, list(keys), capacity=capacity, axis=axis, live=live,
            key_specs=key_specs, split=split))
        metrics.gauge_max("parallel.shuffle.dispatch_ahead", len(inflight))
        if len(inflight) > max(0, int(depth)):
            yield inflight.popleft()
    while inflight:
        yield inflight.popleft()

