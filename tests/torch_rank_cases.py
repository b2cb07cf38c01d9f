"""The rank side of tests/test_torch_ranks.py and test_torch_ranks_engine.py.

``parallel.ranks.spawn`` starts fresh interpreters that import this module
to find their function, so it imports the port and numpy only: never jax
nor the JAX package (each case asserts it).  The inputs are made here from
seeds, so the test process can make the same ones for the JAX package.
Every rank holds 4 of the mesh's 8 shards and returns host values:
``HostColumn``s, numpy arrays and Python lists.
"""

import sys
import time

import numpy as np
import torch

NDEV = 8


def no_jax():
    bad = [m for m in ("jax", "spark_rapids_jni_tpu") if m in sys.modules]
    assert not bad, f"a rank imported {bad}"


# -- inputs (the test process builds the JAX tables from the same arrays) --

def fixed_arrays(n, seed=0, nkeys=16):
    """An INT32 key with nulls, an INT32 with nulls, a FLOAT64, an INT8."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, nkeys, n).astype(np.int32)
    kv = rng.random(n) > 0.1
    v = rng.integers(-100, 100, n).astype(np.int32)
    vv = rng.random(n) > 0.2
    f = rng.standard_normal(n)
    b = (rng.random(n) > 0.5).astype(np.int8)
    return {"k": (k, kv), "v": (v, vv), "f": (f, None), "b": (b, None)}


def string_arrays(n, seed=1):
    rng = np.random.default_rng(seed)
    words = ["", "a", "abc", "abcd", "abcde", "héllo wörld", "δδδ",
             "exactly8", "a-longer-string-past-one-word", "\U0001F600!"]
    vals = [None if i % 11 == 3 else words[int(j)]
            for i, j in enumerate(rng.integers(0, len(words), n))]
    return {"s": vals, "v": (np.arange(n, dtype=np.int64), None)}


def kv_arrays(n, nkeys, seed, key_nulls=0.1):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, nkeys, n).astype(np.int64)
    kv = rng.random(n) > key_nulls
    v = rng.integers(-100, 100, n).astype(np.int64)
    vv = rng.random(n) > 0.2
    f = rng.standard_normal(n) * 10 + 1e6
    return {"k": (k, kv), "v": (v, vv), "f": (f, None)}


def join_arrays(seed, nl=301, nr=257):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 40, nl).astype(np.int64)
    lkv = rng.random(nl) > 0.1
    rk = rng.integers(0, 40, nr).astype(np.int64)
    rkv = rng.random(nr) > 0.1
    return ({"k": (lk, lkv), "lv": (np.arange(nl, dtype=np.int64), None)},
            {"k": (rk, rkv), "rv": (np.arange(nr, dtype=np.int64) * 7,
                                    None)})


AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
        ("f", "mean"), ("f", "var"), ("f", "std"), ("v", "count_all")]
WINDOW = [(None, "row_number"), ("v", "sum"), ("v", "max")]


def nrows(arrays) -> int:
    first = next(iter(arrays.values()))
    return len(first) if isinstance(first, list) else len(first[0])


def block(n, rank, world, pad_to=None):
    """Rank ``rank``'s rows of a global table of ``n`` rows whose padded
    length (``pad_to``, default n) splits evenly over the ranks."""
    per = (pad_to or n) // world
    return rank * per, min(n, (rank + 1) * per)


def port_table(arrays, lo=0, hi=None, device="cpu"):
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    cols = []
    for name, val in arrays.items():
        if isinstance(val, list):
            cols.append(Column.from_pylist(val[lo:hi], device=device))
        else:
            data, valid = val
            cols.append(Column.from_numpy(
                data[lo:hi], validity=None if valid is None
                else valid[lo:hi], device=device))
    return Table(cols, list(arrays))


def host(table):
    from spark_rapids_jni_tpu_torch.columnar.interop import HostColumn
    return [(nm, HostColumn.of(c)) for nm, c in zip(table.names,
                                                    table.columns)]


def pylists(table):
    return list(table.names), [c.to_pylist() for c in table.columns]


# -- the exchange layer ------------------------------------------------------

SHUFFLES = {
    # name: (arrays, keys, capacity)
    "int32-key": (lambda: fixed_arrays(1024), ["k"], None),
    "two-keys": (lambda: fixed_arrays(512, 2, 5), ["k", "v"], None),
    "hot-key-capacity-4": (lambda: {"k": (np.zeros(512, np.int64), None)},
                           ["k"], 4),
    "string-key": (lambda: string_arrays(512), ["s"], None),
    "string-payload": (lambda: string_arrays(512), ["v"], None),
}


def run_parallel(ranks, spill_dir):
    """Every exchange-layer case on this rank; returns {case: result}."""
    from spark_rapids_jni_tpu_torch.parallel import distributed as pdist
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
    from spark_rapids_jni_tpu_torch.parallel import shuffle as psh
    from spark_rapids_jni_tpu_torch.parallel.spill import \
        shuffle_table_spilled
    torch.set_num_threads(1)
    no_jax()
    r, w, dev = ranks.rank, ranks.world, ranks.device
    mesh = pmesh.make_mesh(NDEV, device=dev, ranks=ranks)
    assert (mesh.rank, mesh.world, pmesh.local_shards(mesh)) == \
        (r, w, NDEV // w)
    out = {}
    for name, (make, keys, cap) in SHUFFLES.items():
        arrays = make()
        t = port_table(arrays, *block(nrows(arrays), r, w), device=dev)
        if not any(c.dtype.is_string for c in t.columns):
            t = pmesh.shard_table(t, mesh)
        got, ok, ovf = psh.shuffle_table_padded(t, mesh, keys, capacity=cap)
        out[f"shuffle/{name}"] = (host(got), ok.cpu().numpy(), int(ovf))

    # rows that do not split into equal shards: rank blocks of the padded
    # layout, each padded to the longest block
    arrays = fixed_arrays(1001, 4)
    lo, hi = block(1001, r, w, pad_to=1008)
    padded, n_local = pmesh.pad_to_multiple(
        port_table(arrays, lo, hi, dev), NDEV, mesh)
    live = torch.arange(padded.num_rows, device=dev) < n_local
    got, ok, ovf = psh.shuffle_table_padded(padded, mesh, ["k"], live=live)
    out["shuffle/padded-live"] = (host(got), ok.cpu().numpy(), int(ovf))

    arrays = fixed_arrays(2048, 7, 50)
    out["counts"] = psh.partition_counts(
        port_table(arrays, *block(2048, r, w), device=dev), mesh, ["k"])

    arrays = kv_arrays(2043, 30, 3)
    out["groupby/2043"] = pylists(pdist.distributed_groupby(
        port_table(arrays, *block(2043, r, w, 2048), dev), mesh, ["k"],
        AGGS))
    words = ["alpha", "b", "charlie-delta-echo", "", "δδ"]
    svals = {"s": [None if i % 13 == 0 else words[i % 5]
                   for i in range(776)],
             "v": (np.arange(776, dtype=np.int64), None)}
    out["groupby/string-keys"] = pylists(pdist.distributed_groupby(
        port_table(svals, *block(776, r, w), device=dev), mesh, ["s"],
        [("v", "sum"), ("s", "count"), ("v", "max")]))

    la, ra = join_arrays(11)
    lt = port_table(la, *block(301, r, w, 304), device=dev)
    rt = port_table(ra, *block(257, r, w, 264), device=dev)
    for how in ("inner", "left", "full", "semi", "anti"):
        out[f"join/{how}"] = pylists(pdist.distributed_join(
            lt, rt, mesh, ["k"], how=how))
    la, ra = join_arrays(12, 37, 11)
    out["cross_join"] = pylists(pdist.distributed_cross_join(
        port_table(la, *block(37, r, w, 40), device=dev).select(["lv"]),
        port_table(ra, *block(11, r, w, 16), device=dev), mesh))
    arrays = kv_arrays(500, 12, 13)
    out["window"] = pylists(pdist.distributed_window(
        port_table(arrays, *block(500, r, w, 504), device=dev), mesh,
        ["k"], [("v", False)], WINDOW))

    # the spilled shuffle: a budget of a few rows a pass forces several
    arrays = kv_arrays(4096, 40, 21)
    t = port_table(arrays, *block(4096, r, w), device=dev)
    out["spilled"] = pylists(shuffle_table_spilled(
        t, mesh, ["k"], hbm_budget_bytes=1 << 12, spill_dir=spill_dir))
    out["spill_files_left"] = sorted(__import__("os").listdir(spill_dir))
    return out


def one_process_parallel():
    """The one-process port's answers to the cases ``run_parallel``'s
    one-rank run is held against (no group)."""
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
    from spark_rapids_jni_tpu_torch.parallel import shuffle as psh
    mesh = pmesh.make_mesh(NDEV, device="cpu")
    arrays = fixed_arrays(1024)
    got, ok, ovf = psh.shuffle_table_padded(
        pmesh.shard_table(port_table(arrays), mesh), mesh, ["k"])
    return {"shuffle/int32-key": (host(got), ok.numpy(), int(ovf))}


def run_one_rank(ranks):
    """A group of one rank gives what no group gives."""
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
    from spark_rapids_jni_tpu_torch.parallel import shuffle as psh
    torch.set_num_threads(1)
    no_jax()
    mesh = pmesh.make_mesh(NDEV, device=ranks.device, ranks=ranks)
    assert mesh.ranks is ranks and mesh.world == 1
    got, ok, ovf = psh.shuffle_table_padded(
        pmesh.shard_table(port_table(fixed_arrays(1024)), mesh), mesh,
        ["k"])
    return {"shuffle/int32-key": (host(got), ok.cpu().numpy(), int(ovf))}


def run_raising(ranks):
    """Rank 1 raises before the gather its peer waits in."""
    from spark_rapids_jni_tpu_torch.parallel import ranks as _ranks
    if ranks.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    _ranks.all_gather_rows(torch.zeros(4), ranks)


def run_dying(ranks):
    """Rank 1's process ends without a word."""
    import os
    from spark_rapids_jni_tpu_torch.parallel import ranks as _ranks
    if ranks.rank == 1:
        os._exit(7)
    _ranks.all_gather_rows(torch.zeros(4), ranks)


# -- the engine ---------------------------------------------------------------

def run_engine(ranks, plans: dict, settings: dict):
    """Each plan (serialized bytes) optimized on rank 0 with
    ``distribute=True``, broadcast, executed on every rank over its split of
    the scans; returns per plan the result, the plan bytes this rank ran,
    its stats and the adaptive ledger's runtime decisions, or, where
    planning raised, the error's type, its notes and the seconds to it."""
    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.engine import adaptive
    from spark_rapids_jni_tpu_torch.utils import tracing
    from spark_rapids_jni_tpu_torch.utils.config import config
    torch.set_num_threads(1)
    no_jax()
    out = {}
    for name, blob in plans.items():
        saved = {k: getattr(config, k) for k in settings[name]}
        try:
            for k, v in settings[name].items():
                setattr(config, k, v)
            before = {k: tracing.counter_value(k) for k in COUNTERS}
            t0 = time.monotonic()
            try:
                opt = pe.optimize(pe.deserialize(blob), distribute=True,
                                  ranks=ranks)
            except Exception as e:
                out[name] = {"error": type(e).__name__,
                             "notes": getattr(e, "__notes__", []),
                             "s": time.monotonic() - t0}
                continue
            stats = pe.new_stats()
            res = pe.execute(opt, stats, device=ranks.device, ranks=ranks)
            out[name] = {
                "result": pylists(res),
                "plan": opt.serialize(),
                "stats": {k: stats[k] for k in ("exchanges", "aqe_flips",
                                                "aqe_splits",
                                                "row_groups_read")},
                # the adaptive decisions (a scan's own chunk counts differ
                # by rank)
                "runtime": [e for e in adaptive.runtime_entries(opt)
                            if e["kind"].startswith("adaptive:")],
                "counters": {k: tracing.counter_value(k) - before[k]
                             for k in COUNTERS}}
        finally:
            for k, v in saved.items():
                setattr(config, k, v)
    return out


COUNTERS = ("engine.fused_stage.dispatches", "engine.exchange.shuffles",
            "engine.exchange.broadcasts")
