"""Spill-capable shuffle: exchanges larger than device memory, in bounded
passes.

The port of ``spark_rapids_jni_tpu/parallel/spill.py``.  When the counts say
the received payload would exceed a device budget, the exchange runs as
several passes over within-destination rank windows: each pass is the
ordinary shuffle (parallel/shuffle.py) at a small capacity with a row mask
selecting its window (dead rows are never sent), and each pass's received
rows leave the device at once, into host arrays or numpy memmaps under
``spill_dir``.  Row order is deterministic: pass-major, then destination
order.  Fixed-width columns only; explode STRING columns first
(parallel/stringplane).
"""

from __future__ import annotations

import itertools
import logging
import os
import weakref

import numpy as np
import torch

from ..columnar import Column, Table
from ..dtypes import NUMPY_OF_TORCH
from ..ops.row_conversion import (_build_planes, _from_planes,
                                  fixed_width_layout)
from ..utils import faults, metrics
from ..utils.errors import retry_call
from ..utils.tracing import traced
from .mesh import ROW_AXIS, Mesh, axis_size, pad_to_multiple
from .shuffle import (_live_rows, cap_bucket, exchange_planes, key_specs_for,
                      partition_counts, partition_ids_specs, shard_ids)

_SPILL_SEQ = itertools.count(1)


def dest_ranks(table: Table, key_specs: tuple, ns: int, live):
    """(dest, rank of each row within its (source shard, destination)
    bucket): one stable sort, computed once so every pass reuses it.
    Dead rows (``live`` False) rank in a bucket of their own."""
    n = table.num_rows
    dev = table.columns[0].device
    dest = partition_ids_specs(table.columns, key_specs, ns)
    if live is not None:
        dest = torch.where(live, dest, ns)
    key = shard_ids(n, ns, dev) * (ns + 1) + dest
    skey, si = torch.sort(key, stable=True)
    idx = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = skey[1:] != skey[:-1]
    run_start = torch.cummax(torch.where(first, idx, -1), 0).values
    rank = torch.empty_like(idx)
    rank[si] = idx - run_start
    return dest, rank


def _unlink_quiet(path):
    try:
        os.unlink(path)
    except OSError:
        pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def sweep_orphans(spill_dir: str) -> int:
    """Unlink spill files left by dead processes; returns the count.

    A result's memmaps unlink themselves when collected, but a crashed
    query never runs its finalizers.  Names carry the owning pid, so
    liveness is one ``kill(pid, 0)``; files of this process and of live
    ones are never touched.
    """
    try:
        names = os.listdir(spill_dir)
    except OSError:
        return 0
    me = os.getpid()
    reaped = 0
    for name in names:
        if not (name.startswith("spill-") and name.endswith(".npy")):
            continue
        try:
            pid = int(name.split("-")[1])
        except (IndexError, ValueError):
            continue
        if pid == me or _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(spill_dir, name))
            reaped += 1
        except OSError:
            continue
    if reaped:
        metrics.count("parallel.spill.orphans_reaped", reaped)
        logging.getLogger(__name__).warning(
            "reaped %d orphaned spill file(s) in %s", reaped, spill_dir)
    return reaped


def _spill_buffers(dtypes, shapes, total_rows: int, spill_dir):
    """Per-column host buffers: numpy arrays, or memmaps under spill_dir
    (unlinked when the buffer is collected)."""
    datas, valids = [], []
    for i, (npdt, tail) in enumerate(zip(dtypes, shapes)):
        shape = (total_rows,) + tuple(tail)
        if spill_dir is None:
            datas.append(np.empty(shape, npdt))
        else:
            mm = np.lib.format.open_memmap(
                os.path.join(spill_dir,
                             f"spill-{os.getpid()}-{next(_SPILL_SEQ)}"
                             f"-col{i}.npy"),
                mode="w+", dtype=npdt, shape=shape)
            weakref.finalize(mm, _unlink_quiet, mm.filename)
            datas.append(mm)
        valids.append(np.ones(total_rows, np.bool_))
    return datas, valids


@traced("shuffle_table_spilled")
def shuffle_table_spilled(table: Table, mesh: Mesh, keys: list,
                          hbm_budget_bytes: int,
                          spill_dir: str | None = None, axis=ROW_AXIS,
                          key_specs: tuple | None = None) -> Table:
    """Shuffle by key hash with the device working set bounded by
    ``hbm_budget_bytes``; returns a host-resident compacted Table (its
    buffers numpy arrays, or memmaps under ``spill_dir``).

    Row placement is ``shuffle_table_padded``'s (Spark HashPartitioning);
    rows come out pass-major, destination order within a pass.
    """
    if any(not c.dtype.is_fixed_width for c in table.columns):
        raise TypeError(
            "spilled shuffle is fixed-width only; dictionary-encode "
            "(ops/dictionary) or explode (parallel/stringplane) first")
    if spill_dir is not None:
        sweep_orphans(spill_dir)
    ns = axis_size(mesh, axis)
    dev = mesh.device
    table, n_valid = pad_to_multiple(table.to(dev), ns)
    layout = fixed_width_layout(table.dtypes())
    if key_specs is None:
        key_specs = key_specs_for(table, keys, None)
    counts = partition_counts(table, mesh, list(keys), axis,
                              n_valid_rows=n_valid, key_specs=key_specs)
    max_cap = int(counts.max())
    row_bytes = layout.row_size
    # a pass holds its received block and the send block of the same size
    budget_rows = max(32, int(hbm_budget_bytes // (2 * ns * ns * row_bytes)))
    # round DOWN to a power of two: rounding up could bust the budget
    cap_slice = 1 << (budget_rows.bit_length() - 1)
    cap_slice = min(cap_slice, cap_bucket(max(max_cap, 1)))
    npasses = max(1, -(-max_cap // cap_slice))

    n = table.num_rows
    live = _live_rows(n, n_valid, dev)
    dest, rank = dest_ranks(table, key_specs, ns, live)
    src = shard_ids(n, ns, dev)
    planes = _build_planes(layout, [c.data for c in table.columns],
                           [c.validity for c in table.columns], n, dev)
    total = int(counts.sum())
    probe = _from_planes(layout, planes[:, :0])[0]
    out_datas, out_valids = _spill_buffers(
        [NUMPY_OF_TORCH[d.dtype] for d in probe],
        [d.shape[1:] for d in probe], total, spill_dir)
    metrics.count("parallel.spill.spills")
    metrics.count("parallel.spill.passes", npasses)
    metrics.gauge_max("parallel.spill.buffer_bytes",
                      sum(d.nbytes for d in out_datas)
                      + sum(v.nbytes for v in out_valids))
    metrics.observe("parallel.spill.pass_capacity_rows", cap_slice)
    written = 0

    def run_pass(p, window):
        # writes land at offsets fixed by the pre-pass ``written``, so a
        # transient failure replays the whole pass idempotently
        faults.check("spill.write")
        planes_in, ok, ovf = exchange_planes(planes, src, dest, window, ns,
                                             cap_slice)
        if int(ovf):
            raise RuntimeError(f"spill pass {p} overflow ({int(ovf)} rows)"
                               " — counts pass disagrees with payload")
        keep = torch.nonzero(ok, as_tuple=True)[0]
        datas, masks = _from_planes(layout, planes_in[:, keep])
        nlive = keep.shape[0]
        for ci, (d, m) in enumerate(zip(datas, masks)):
            out_datas[ci][written:written + nlive] = d.cpu().numpy()
            out_valids[ci][written:written + nlive] = m.cpu().numpy()
        return nlive

    for p in range(npasses):
        window = (rank >= p * cap_slice) & (rank < (p + 1) * cap_slice)
        if live is not None:
            window = window & live
        with torch.profiler.record_function("parallel.spill.pass"):
            nlive = retry_call(lambda: run_pass(p, window), "spill.write")
        written += nlive
        metrics.count("parallel.spill.bytes_spilled",
                      nlive * (row_bytes + len(out_valids)))
    assert written == total, (written, total)

    cols = [Column(dtp, data=torch.from_numpy(d),  # host-resident
                   validity=None if v.all() else torch.from_numpy(v))
            for dtp, d, v in zip(table.dtypes(), out_datas, out_valids)]
    return Table(cols, table.names)
