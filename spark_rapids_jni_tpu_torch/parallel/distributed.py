"""Distributed query plans over a mesh of shards: shuffle-then-aggregate,
shuffle-then-join, the broadcast cross join and the co-partitioned window.

The port of ``spark_rapids_jni_tpu/parallel/distributed.py``.  The JAX
package compiles each plan into one ``shard_map`` program whose per-shard
body runs once a device.  Here every shard's work runs in one batched pass
over the whole row-sharded table: the shard index leads the keys of the
per-shard groupby, join or window, so groups, matches and window
partitions never cross shards, exactly as on a mesh.

- GROUP BY: local partial groupby -> exchange of the partial rows by key
  hash -> final groupby of what each shard received.
- equi-join (BASELINE configs[3], shuffle + SortMergeJoin): both sides
  hash-partition on the join keys, then each shard joins its partitions.
- cross join: left row-sharded, right replicated (no exchange).
- window: co-partition on the partition keys, then the window per shard.

STRING columns cross in padded-bucket form (``stringplane``); string keys
place by Spark's UTF8String murmur3.  Results compact to the live rows.

Over a mesh of ranks (``parallel/ranks.py``) every argument is this rank's
block of the row-sharded table (the cross join's right side too) and the
result is this rank's shards' rows: put together in rank order, the
one-process result.  Capacities come from the gathered counts, overflows
are summed over the ranks before any check, so every rank raises or none
does.
"""

from __future__ import annotations

import torch

from ..columnar import Column, Table
from ..dtypes import FLOAT64, INT32
from ..ops.aggregate import _float64_vals, groupby_padded
from ..ops.join import cross_join, sort_merge_join
from ..ops.row_conversion import (_build_planes, _from_planes,
                                  fixed_width_layout)
from ..ops.selection import gather_table
from ..utils.tracing import traced
from . import ranks as _ranks
from .mesh import ROW_AXIS, Mesh, axis_size, broadcast_table, \
    local_shards, pad_to_multiple
from .shuffle import (_live_rows, cap_bucket, exchange_planes, key_specs_for,
                      partition_counts, partition_ids_specs, shard_ids,
                      shuffle_table_padded)
from .stringplane import StringPlan, explode_strings, reassemble_strings

#: the batched pass's leading key: the shard a row sits on
SHARD = "__shard"

# (partial op emitted by the local pass, final re-aggregation op)
_REAGG = {"sum": "sum", "count": "sum", "count_all": "sum",
          "min": "min", "max": "max", "sumsq": "sum", "fsum": "sum"}


def _expand_aggs(aggs):
    """mean decomposes into (sum, count) partials + a final divide;
    var/std into (fsum, sumsq, count) partials + a final moment combine."""
    partial_specs = []   # (col_ref, op) for the local pass
    final_plan = []      # ("direct", i, op) | ("mean", si, ci)
    for ref, op in aggs:  # | ("var"/"std", si, qi, ci)
        if op == "mean":
            si = len(partial_specs)
            partial_specs += [(ref, "sum"), (ref, "count")]
            final_plan.append(("mean", si, si + 1))
        elif op in ("var", "std"):
            si = len(partial_specs)
            partial_specs += [(ref, "fsum"), (ref, "sumsq"), (ref, "count")]
            final_plan.append((op, si, si + 1, si + 2))
        else:
            if op not in _REAGG:
                raise ValueError(
                    f"aggregation {op!r} is not supported in the "
                    "distributed groupby (no partial/re-aggregation "
                    f"decomposition); supported: "
                    f"{sorted(_REAGG) + ['mean', 'var', 'std']}")
            partial_specs.append((ref, op))
            final_plan.append(("direct", len(partial_specs) - 1,
                               _REAGG[op]))
    return partial_specs, final_plan


def _shard_col(ids: torch.Tensor) -> Column:
    return Column(INT32, data=ids.to(torch.int32))


def _exchange_table(table: Table, src, dest, live, ns: int, capacity: int,
                    ranks=None):
    """Exchange every row of ``table`` (row i from this rank's shard
    src[i] to dest[i]); returns (received Table, live mask, overflow)."""
    layout = fixed_width_layout(table.dtypes())
    dev = src.device
    planes = _build_planes(layout, [c.data for c in table.columns],
                           [c.validity for c in table.columns],
                           table.num_rows, dev)
    planes_in, live_in, overflow = exchange_planes(planes, src, dest, live,
                                                   ns, capacity, ranks)
    datas, masks = _from_planes(layout, planes_in)
    return (Table([Column(dt, data=d, validity=m) for dt, d, m in
                   zip(layout.schema, datas, masks)], table.names),
            live_in, overflow)


def _compact(table: Table, live: torch.Tensor) -> Table:
    """The live rows, each column's validity dropped when all valid."""
    out = gather_table(table, torch.nonzero(live, as_tuple=True)[0])
    return Table([c if c.validity is None or not c.dtype.is_fixed_width
                  or not bool(c.validity.all())
                  else Column(c.dtype, data=c.data, validity=None)
                  for c in out.columns], out.names)


@traced("distributed_groupby")
def distributed_groupby(table: Table, mesh: Mesh, key_names: list,
                        aggs: list, capacity: int | None = None,
                        axis=ROW_AXIS,
                        n_valid_rows: int | None = None) -> Table:
    """GROUP BY over a row-sharded table, compacted.

    Tables whose rows do not split into equal shards are padded here with
    masked null rows; callers who pre-padded with ``pad_to_multiple`` pass
    the original row count as ``n_valid_rows`` so padding rows don't
    aggregate.  STRING keys and counted STRING values ride in padded-bucket
    form.  Output: the keys, then ``{op}_{col}`` per aggregation.
    """
    ns = axis_size(mesh, axis)
    nl = local_shards(mesh, axis)
    ranked = _ranks.active(mesh.ranks)
    dev = mesh.device
    table = table.to(dev)
    orig_keys, orig_aggs = list(key_names), list(aggs)
    plan = None
    if any(c.dtype.is_string for c in table.columns):
        table, plan = explode_strings(table, ranks=mesh.ranks)
        spec_of = dict(zip(plan.names, plan.specs))
        key_names = plan.exploded_keys(orig_keys)
        aggs = []
        for ref, op in orig_aggs:
            if spec_of.get(ref, ("fixed",))[0] == "string":
                if op not in ("count", "count_all"):
                    raise TypeError(
                        "string value aggregation not supported; "
                        "dictionary-encode first (ops.dictionary)")
                aggs.append((f"{ref}#len", op))  # same validity
            else:
                aggs.append((ref, op))
    if table.num_rows % nl:
        if n_valid_rows is not None:
            raise ValueError("table rows not mesh-divisible; pad first or "
                             "let distributed_groupby pad (omit "
                             "n_valid_rows)")
    if n_valid_rows is None and (ranked or table.num_rows % nl):
        table, n_valid_rows = pad_to_multiple(table, ns, mesh)
    n = table.num_rows
    kcols = Table([table.column(k) for k in key_names], list(key_names))
    part_specs = key_specs_for(kcols, orig_keys, plan)
    live = _live_rows(n, n_valid_rows, dev)
    partial_specs, final_plan = _expand_aggs(aggs)
    specs = list(partial_specs)
    # var/std moments over globally mean-shifted values (variance is
    # shift-invariant; unshifted (sum x^2, sum x) cancel when |mean| >> std)
    shifted: dict = {}
    for plan_i in final_plan:
        if plan_i[0] not in ("var", "std"):
            continue
        for i in plan_i[1:3]:
            ref = partial_specs[i][0]
            if ref not in shifted:
                c = table.column(ref)
                vf = _float64_vals(c)
                ok = c.valid_mask() if live is None else \
                    c.valid_mask() & live
                tot = _ranks.all_reduce(torch.stack(
                    [torch.where(ok, vf, 0.0).sum(),
                     ok.sum().to(torch.float64)]), mesh.ranks)
                gm = tot[0] / tot[1].clamp(min=1)
                shifted[ref] = Column(FLOAT64, data=vf - gm,
                                      validity=c.validity)
            specs[i] = (shifted[ref], partial_specs[i][1])

    # 1. local partial aggregation, every shard at once
    src = shard_ids(n, nl, dev)
    pkeys, paggs, png = groupby_padded(
        table, None, specs,
        keys_cols=[_shard_col(src)] + [kcols.column(k) for k in key_names],
        row_mask=live, device=dev)
    partial = Table([Column(spec[1], data=spec[2], validity=spec[3])
                     for spec in pkeys[1:]] + list(paggs),
                    list(key_names) + [f"agg{i}" for i in range(len(paggs))])
    plive = torch.arange(n, device=dev) < png

    # 2. exchange the partial groups by key hash.  The JAX package sizes
    # the grid from raw-row counts before the partial pass (its program's
    # shapes are static); here the partial groups' own (src, dest) counts
    # size it exactly, in the same one fetch
    dest = partition_ids_specs(partial.columns, part_specs, ns)
    psrc = pkeys[0][2].to(torch.int64)
    if capacity is None:
        flat = torch.where(plive, psrc * ns + dest, nl * ns)
        counts = torch.zeros(nl * ns + 1, dtype=torch.int64, device=dev) \
            .index_add_(0, flat, torch.ones_like(flat))
        capacity = cap_bucket(int(_ranks.all_reduce(
            counts[:-1].max(), mesh.ranks, "max")))
    recv, rlive, overflow = _exchange_table(partial, psrc, dest, plive, ns,
                                            capacity, mesh.ranks)
    if int(overflow) > 0:
        raise RuntimeError(
            f"shuffle capacity overflow ({int(overflow)} rows); rerun with "
            f"larger capacity (got {capacity})")

    # 3. final aggregation of what each shard received
    final_specs = []
    for p in final_plan:
        if p[0] == "direct":
            final_specs.append((f"agg{p[1]}", p[2]))
        else:
            final_specs += [(f"agg{i}", "sum") for i in p[1:]]
    dst = torch.arange(recv.num_rows, device=dev) // (ns * capacity)
    fkeys, faggs, ng = groupby_padded(
        recv, None, final_specs,
        keys_cols=[_shard_col(dst)] + [recv.column(k) for k in key_names],
        row_mask=rlive, device=dev)

    # 4. resolve means and moments
    out_cols, fi = [], 0
    for p in final_plan:
        if p[0] == "mean":
            s, c = faggs[fi], faggs[fi + 1]
            fi += 2
            m = s.data.to(torch.float64) / \
                c.data.clamp(min=1).to(torch.float64)
            valid = (c.data > 0) if s.validity is None else \
                (s.validity & (c.data > 0))
            out_cols.append(Column(FLOAT64, data=m, validity=valid))
        elif p[0] in ("var", "std"):
            s, q, c = faggs[fi], faggs[fi + 1], faggs[fi + 2]
            fi += 3
            nf = c.data.clamp(min=1).to(torch.float64)
            var = ((q.data - s.data * s.data / nf)
                   / (nf - 1.0).clamp(min=1.0)).clamp(min=0.0)
            out_cols.append(Column(FLOAT64, data=var.sqrt()
                                   if p[0] == "std" else var,
                                   validity=c.data > 1))
        else:
            out_cols.append(faggs[fi])
            fi += 1
    agg_names = [f"{op}_{ref}" for ref, op in orig_aggs]
    result = Table([Column(spec[1], data=spec[2], validity=spec[3])
                    for spec in fkeys[1:]] + out_cols,
                   list(key_names) + agg_names)
    result = _compact(result, torch.arange(result.num_rows, device=dev) < ng)
    if plan is not None:
        out_specs = tuple([spec_of[k] for k in orig_keys]
                          + [("fixed",)] * len(orig_aggs))
        result = reassemble_strings(
            result, StringPlan(tuple(orig_keys + agg_names), out_specs))
    return result


@traced("distributed_join")
def distributed_join(left: Table, right: Table, mesh: Mesh, on_left,
                     on_right=None, how: str = "inner",
                     capacity: int | None = None,
                     suffixes=("", "_r"), axis=ROW_AXIS) -> Table:
    """Distributed equi-join (inner/left/right/full/semi/anti), compacted.

    Both sides hash-partition on the join keys, then every shard joins its
    partitions (``sort_merge_join``) in one batched pass keyed by the shard.
    Outer rows are shard-local correct: co-partitioning puts every
    occurrence of a key on one shard.  String join keys explode at one
    common width on both sides; placement hashes their bytes, so the sides
    co-partition whatever their widths.  ``capacity`` bounds the rows a side
    sends from one shard to another; overflow raises with the count.
    """
    from ..ops.strings_common import string_width_bucket
    on_right = list(on_right or on_left)
    on_left = list(on_left)
    ns = axis_size(mesh, axis)
    nl = local_shards(mesh, axis)
    dev = mesh.device
    left, right = left.to(dev), right.to(dev)

    lov, rov = {}, {}
    for lk, rk in zip(on_left, on_right):
        lc, rc = left.column(lk), right.column(rk)
        wl = string_width_bucket(lc) if lc.dtype.is_string else None
        wr = string_width_bucket(rc) if rc.dtype.is_string else None
        if wl is not None or wr is not None:
            lov[lk] = rov[rk] = max(wl or 0, wr or 0)

    def prep(t, keys, overrides):
        plan = None
        if any(c.dtype.is_string for c in t.columns):
            t, plan = explode_strings(t, width_overrides=overrides,
                                      ranks=mesh.ranks)
        t, n_orig = pad_to_multiple(t, ns, mesh)
        return t, plan, n_orig, key_specs_for(t, keys, plan)

    lt, lplan, ln, lspecs = prep(left, on_left, lov)
    rt, rplan, rn, rspecs = prep(right, on_right, rov)
    llive, rlive = _live_rows(lt.num_rows, ln, dev), \
        _live_rows(rt.num_rows, rn, dev)
    if len(lspecs) != len(rspecs) or any(
            (a[0] == "string") != (b[0] == "string")
            for a, b in zip(lspecs, rspecs)):
        raise TypeError("join keys disagree: string keys must pair with "
                        "string keys")
    if capacity is None:
        lcap = cap_bucket(int(partition_counts(
            lt, mesh, on_left, axis, n_valid_rows=ln,
            key_specs=lspecs).max()))
        rcap = cap_bucket(int(partition_counts(
            rt, mesh, on_right, axis, n_valid_rows=rn,
            key_specs=rspecs).max()))
    else:
        lcap = rcap = capacity

    def exchange(t, live, specs, cap, plan):
        n = t.num_rows
        dest = partition_ids_specs(t.columns, specs, ns)
        recv, rl, ovf = _exchange_table(t, shard_ids(n, nl, dev), dest, live,
                                        ns, cap, mesh.ranks)
        if int(ovf) > 0:
            raise RuntimeError(
                f"distributed_join exchange overflow ({int(ovf)} rows); "
                f"rerun with larger capacity (got {cap})")
        dst = torch.arange(recv.num_rows, device=dev) // (ns * cap)
        recv = Table(list(recv.columns) + [_shard_col(dst)],
                     list(recv.names) + [SHARD])
        recv = gather_table(recv, torch.nonzero(rl, as_tuple=True)[0])
        if plan is None:
            return recv
        body = reassemble_strings(Table(recv.columns[:-1],
                                        recv.names[:-1]), plan)
        return Table(list(body.columns) + [recv.columns[-1]],
                     list(body.names) + [SHARD])

    lx = exchange(lt, llive, lspecs, lcap, lplan)
    rx = exchange(rt, rlive, rspecs, rcap, rplan)
    out = sort_merge_join(lx, rx, [SHARD] + on_left, [SHARD] + on_right,
                          how=how, suffixes=suffixes, device=dev)
    keep = [i for i, nm in enumerate(out.names) if nm != SHARD]
    return Table([out.columns[i] for i in keep],
                 [out.names[i] for i in keep])


@traced("distributed_cross_join")
def distributed_cross_join(left: Table, right: Table, mesh: Mesh,
                           suffixes=("", "_r"), axis=ROW_AXIS) -> Table:
    """Distributed Cartesian product: left row-sharded, right replicated to
    every shard (no exchange).  Each shard pairs its left rows with the
    whole right side, and the shards' outputs in shard order are the left
    rows in order: one batched pairing of the whole table."""
    axis_size(mesh, axis)
    return cross_join(left.to(mesh.device), broadcast_table(right, mesh),
                      suffixes=suffixes, device=mesh.device)


@traced("distributed_window")
def distributed_window(table: Table, mesh: Mesh, partition_by: list,
                       order_by: list, specs: list, names: list | None = None,
                       axis=ROW_AXIS) -> Table:
    """Window functions over a mesh: co-partition on the partition keys,
    then ``ops.window`` per shard (exact: a window never crosses
    partitions, and a partition never crosses shards).  ``order_by``
    entries are names or ``(name, ascending)``.  Row order of the result
    is unspecified, as in Spark."""
    from ..ops.order import SortKey
    from ..ops.window import default_window_names, window
    ns = axis_size(mesh, axis)
    nl = local_shards(mesh, axis)
    dev = mesh.device
    t = table.to(dev)
    live = None
    if not any(c.dtype.is_string for c in t.columns) and (
            t.num_rows % nl or _ranks.active(mesh.ranks)):
        t, n_orig = pad_to_multiple(t, ns, mesh)
        live = _live_rows(t.num_rows, n_orig, dev)
    elif t.num_rows % nl:
        raise ValueError("distributed_window: STRING tables must split "
                         "into equal shards")
    shuffled, ok, overflow = shuffle_table_padded(t, mesh, list(partition_by),
                                                  axis=axis, live=live)
    if int(overflow):
        raise RuntimeError(f"window shuffle overflow: {int(overflow)} rows")
    dst = torch.arange(shuffled.num_rows, device=dev) // \
        max(shuffled.num_rows // nl, 1)
    base = Table(list(shuffled.columns) + [_shard_col(dst)],
                 list(shuffled.names) + [SHARD])

    def order_key(k):
        if isinstance(k, tuple):
            return SortKey(base.column(k[0]), ascending=k[1])
        return k

    nspecs = [tuple(s) for s in specs]
    out = window(base, [SHARD] + list(partition_by),
                 [order_key(k) for k in order_by], nspecs, live=ok)
    new = list(out.columns[base.num_columns:])
    wnames = list(names) if names is not None \
        else default_window_names(nspecs)
    res = Table(list(shuffled.columns) + new, list(shuffled.names) + wnames)
    return gather_table(res, torch.nonzero(ok, as_tuple=True)[0])
