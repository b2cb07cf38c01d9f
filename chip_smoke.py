#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (spark_rapids_jni_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, and drives one Spark stage end to end on the card.

    python3 chip_smoke.py [--seed 0] [--rows 16777216] [--string-rows 4194304]

Phases (any failed check raises, and the script exits non-zero):

1. build    compile kernels/csrc/row_wire.cu with nvcc for sm_90a.
2. kernels  K1 interleave_planes and K2 deinterleave_wire against their
            plain versions, bit-exact, at the stage's shape (2^24 rows of
            12 words), at 2 and 64 words, and at a row count that is not a
            multiple of 256; kernel, plain and library (``t().contiguous()``)
            times beside the bound (bytes moved / 3.35 TB/s).
3. stage    one 2^24-row batch of the bench schema (bench.py
            build_host_table; INT32 key with 100,000 distinct values)
            through GpuColumnarToRow -> GpuRowToColumnar (bit-exact round
            trip) -> partial HashAggregate (held against numpy) ->
            HashPartitioning (murmur3 seed 42, pmod 200; held against the
            port's CPU run on 1M rows) -> ColumnarToRow of the aggregate ->
            ColumnarToRow in 256 MiB batches (4 batches, 32-row aligned).
            It runs twice: the first run loads every kernel it uses (cold
            times); the K1/K2 launch counters are zeroed before the second
            (checked, warm times) and read after it.
4. strings  INT64 + STRING (4..20 lowercase letters) round trip at 2^22
            rows, bit-exact, and the bytes of a 64k-row slice against a
            numpy packer of the variable-width contract.

Output: one JSON line per phase, the card's name and power limit as
nvidia-smi reports them, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.  Without a CUDA card, or without the port's
package beside it, the script fails before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
MAIN_WORDS = 12            # the stage's 48-byte rows
STAGE_AGGS = [("i64", "sum"), ("i64", "count"), ("f64", "min"),
              ("f64", "max"), ("f32", "mean"), ("i16", "count")]
PARTITIONS = 200           # spark.sql.shuffle.partitions default
BATCH_CAP = 256 << 20
U = 2.0 ** -53             # float64 unit roundoff
DEV = "cuda"


def check(cond, what: str):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def wall(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bits_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

def phase_kernels(torch, row_wire, seed: int, n_main: int) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(seed)
    n_side = min(n_main, 1 << 20)
    shapes = [(MAIN_WORDS, n_main), (2, n_main), (64, n_side),
              (MAIN_WORDS, n_side + 96)]  # last: not a multiple of 256
    out = {"interleave_planes": {"max_abs_err": 0},
           "deinterleave_wire": {"max_abs_err": 0}}
    for nw, n in shapes:
        mat = torch.randint(-2**31, 2**31 - 1, (nw, n), dtype=torch.int32,
                            device=DEV, generator=gen)
        wire = row_wire.interleave_planes(mat)
        plain = row_wire.interleave_planes_plain(mat)
        back = row_wire.deinterleave_wire(wire, nw)
        back_plain = row_wire.deinterleave_wire_plain(plain, nw)
        torch.cuda.synchronize()
        for name, got, want in [("interleave_planes", wire, plain),
                                ("deinterleave_wire", back, back_plain)]:
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                      .max())
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            check(err == 0, f"{name} bit-exact at ({nw}, {n})")
        check(torch.equal(back, mat), f"K2(K1(x)) == x at ({nw}, {n})")
        del mat, wire, plain, back, back_plain

    nw, n = MAIN_WORDS, n_main
    mat = torch.randint(-2**31, 2**31 - 1, (nw, n), dtype=torch.int32,
                        device=DEV, generator=gen)
    wire = row_wire.interleave_planes_plain(mat)
    bound_ms = 2 * 4 * n * nw / HBM_BYTES_PER_S * 1e3
    timings = {
        "interleave_planes": (
            lambda: row_wire.interleave_planes(mat),
            lambda: row_wire.interleave_planes_plain(mat),
            lambda: mat.t().contiguous()),
        "deinterleave_wire": (
            lambda: row_wire.deinterleave_wire(wire, nw),
            lambda: row_wire.deinterleave_wire_plain(wire, nw),
            lambda: wire.view(n, nw).t().contiguous()),
    }
    for name, (kern, plain, lib) in timings.items():
        # in turns: kernel, plain, library, library, plain, kernel
        k1, p1, l1 = cuda_ms(torch, kern), cuda_ms(torch, plain), \
            cuda_ms(torch, lib)
        l2, p2, k2 = cuda_ms(torch, lib), cuda_ms(torch, plain), \
            cuda_ms(torch, kern)
        out[name].update(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=min(l1, l2), bound_ms=bound_ms,
                         shape=[nw, n])
    del mat, wire
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 3. the stage
# ---------------------------------------------------------------------------

def stage_columns(n: int, seed: int):
    """bench.py build_host_table at n rows, INT32 key drawn from 100,000
    values (bench.py bench_hash_aggregate's key count)."""
    rng = np.random.default_rng(seed)
    return [
        ("i64", 4, 0, rng.integers(-2**62, 2**62, n).astype(np.int64), None),
        ("f64", 10, 0, rng.standard_normal(n), rng.random(n) > 0.1),
        ("i32", 3, 0, rng.integers(0, 100_000, n).astype(np.int32), None),
        ("f32", 9, 0, rng.standard_normal(n).astype(np.float32), None),
        ("i16", 2, 0, rng.integers(-2**15, 2**15 - 1, n).astype(np.int16),
         rng.random(n) > 0.5),
        ("i8", 1, 0, rng.integers(-128, 128, n).astype(np.int8), None),
        ("bool", 11, 0, (rng.random(n) > 0.5).astype(np.uint8), None),
        ("dec64", 26, -4, rng.integers(-10**15, 10**15, n).astype(np.int64),
         None),
    ]


def numpy_groupby(cols):
    """Independent reference of STAGE_AGGS with numpy: group keys, exact
    integer sums (wrapping like int64), counts, float min/max over valid
    rows, and the float32 mean with its rounding bound."""
    c = {name: (data, valid) for name, _, _, data, valid in cols}
    keys, inv = np.unique(c["i32"][0], return_inverse=True)
    g = len(keys)
    i64 = c["i64"][0]
    s = np.zeros(g, np.int64)
    np.add.at(s, inv, i64)
    count = np.bincount(inv, minlength=g).astype(np.int64)
    f64, fv = c["f64"]
    mn = np.full(g, np.inf)
    mx = np.full(g, -np.inf)
    np.minimum.at(mn, inv[fv], f64[fv])
    np.maximum.at(mx, inv[fv], f64[fv])
    f_has = np.bincount(inv[fv], minlength=g) > 0
    f32 = c["f32"][0].astype(np.float64)
    mean = np.bincount(inv, weights=f32, minlength=g) / count
    sum_abs = np.bincount(inv, weights=np.abs(f32), minlength=g)
    # two summation orders of m terms differ by at most 2(m-1)u sum|x|;
    # over the count that is < 2u sum|x|, plus the divisions' rounding
    mean_tol = 4 * U * (sum_abs + np.abs(mean))
    i16_count = np.bincount(inv[c["i16"][1]], minlength=g).astype(np.int64)
    return keys, s, count, mn, mx, f_has, mean, mean_tol, i16_count


def phase_stage(torch, port, cols, seed: int) -> dict:
    (Table, HostColumn, table_from_numpy, convert_to_rows, convert_from_rows,
     fixed_width_layout, groupby, murmur3_hash, row_wire, tracing) = port
    n = len(cols[0][3])
    table = table_from_numpy([HostColumn(t, s, d, v)
                              for _, t, s, d, v in cols],
                             [c[0] for c in cols])  # default device: cuda
    layout = fixed_width_layout(table.dtypes())
    check(layout.row_size == 48, "stage rows pack to 48 bytes")
    blob_bytes = n * layout.row_size
    # 256 MiB batches: 4 of them at 2^24 rows (smaller runs: about 4 too)
    cap = min(BATCH_CAP, blob_bytes // 3)
    rows_per_batch = cap // layout.row_size // 32 * 32
    want_batches = -(-n // rows_per_batch)

    def drive():
        """The stage once: (outputs, wall seconds per step)."""
        steps = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ColumnarToRow, then RowToColumnar: the spark-rapids transitions
        blobs, steps["to_rows"] = wall(torch, lambda: convert_to_rows(table))
        back, steps["from_rows"] = wall(
            torch, lambda: convert_from_rows(blobs[0], table.dtypes()))
        back = Table(back.columns, table.names)
        # partial HashAggregate
        agg, steps["groupby"] = wall(
            torch, lambda: groupby(back, ["i32"], STAGE_AGGS))
        # HashPartitioning of the aggregate's keys
        key_hash, steps["hash"] = wall(
            torch, lambda: murmur3_hash(agg.select(["i32"])))
        pids = torch.remainder(key_hash.data.to(torch.int64), PARTITIONS)
        # ColumnarToRow (and back) of the aggregate; the input in batches
        agg_blobs, steps["agg_to_rows"] = wall(
            torch, lambda: convert_to_rows(agg))
        agg_back = convert_from_rows(agg_blobs[0], agg.dtypes())
        batches, steps["batched_to_rows"] = wall(
            torch, lambda: convert_to_rows(table, max_batch_bytes=cap))
        steps["stage"] = time.perf_counter() - t0
        return (blobs, back, agg, key_hash, pids, agg_back, batches), steps

    cold = drive()[1]  # the first run also loads every kernel it uses
    tracing.reset_counters("kernel.")
    (blobs, back, agg, key_hash, pids, agg_back, batches), warm = drive()
    launches = {name: row_wire.launches(name)
                for name in ("interleave_planes", "deinterleave_wire")}
    for name, count in launches.items():
        check(count > 0, f"the stage launched {name}")

    # -- checks outside the timed stage --------------------------------------
    check(len(blobs) == 1, "2^24 rows of 48 B stay one batch")
    for a, b in zip(table.columns, back.columns):
        check(bits_equal(torch, a.data, b.data)
              and torch.equal(a.valid_mask(), b.valid_mask()),
              f"round trip of {a.dtype!r} is bit-exact")
    for a, b in zip(agg.columns, agg_back.columns):
        check(bits_equal(torch, a.data, b.data)
              and torch.equal(a.valid_mask(), b.valid_mask()),
              "aggregate round trip is bit-exact")
    check(len(batches) == want_batches,
          f"{want_batches} batches of <= {cap} B, got {len(batches)}")
    check(all(b.size % 32 == 0 for b in batches), "batches 32-row aligned")
    check(all(int(b.offsets[-1]) <= cap for b in batches),
          "batches within the cap")
    check(torch.equal(torch.cat([b.children[0].data for b in batches]),
                      blobs[0].children[0].data),
          "batched blobs concatenate to the one-batch blob")

    keys, s, count, mn, mx, f_has, mean, mean_tol, i16_count = \
        numpy_groupby(cols)
    host = {name: agg.column(name) for name in agg.names}
    check(agg.num_rows == len(keys), "group count matches numpy")
    check(np.array_equal(host["i32"].to_numpy(), keys), "group keys")
    check(np.array_equal(host["sum_i64"].to_numpy(), s), "sum(i64) exact")
    check(np.array_equal(host["count_i64"].to_numpy(), count), "count(i64)")
    check(np.array_equal(host["count_i16"].to_numpy(), i16_count),
          "count(i16) skips nulls")
    for name, want in (("min_f64", mn), ("max_f64", mx)):
        col = host[name]
        check(np.array_equal(col.validity_numpy(), f_has), f"{name} validity")
        check(np.array_equal(col.to_numpy()[f_has].view(np.int64),
                             want[f_has].view(np.int64)), f"{name} exact")
    got_mean = host["mean_f32"].to_numpy()
    mean_err = np.abs(got_mean - mean)
    check(bool((mean_err <= mean_tol).all()), "mean(f32) within its bound")

    # murmur3 on the card against the port's own CPU run
    keys_1m = table.select(["i32"]).gather(torch.arange(min(n, 1 << 20),
                                                        device=DEV))
    check(torch.equal(murmur3_hash(keys_1m).data.cpu(),
                      murmur3_hash(keys_1m.to("cpu"), device="cpu").data),
          "murmur3 on the card == CPU run (1M rows)")
    agg_keys_cpu = agg.select(["i32"]).to("cpu")
    check(torch.equal(key_hash.data.cpu(),
                      murmur3_hash(agg_keys_cpu, device="cpu").data),
          "murmur3 of the group keys == CPU run")
    check(bool(((pids >= 0) & (pids < PARTITIONS)).all()), "pmod range")

    t1, t2 = warm["to_rows"], warm["from_rows"]
    return {
        "phase": "stage", "rows": n, "row_bytes": layout.row_size,
        "groups": int(agg.num_rows), "warm_s": warm, "cold_s": cold,
        "round_trip_rows_per_s": n / (t1 + t2),
        "to_rows_GBps": blob_bytes / t1 / 1e9,
        "from_rows_GBps": blob_bytes / t2 / 1e9,
        "round_trip_GBps": 2 * blob_bytes / (t1 + t2) / 1e9,
        "stage_rows_per_s": n / warm["stage"],
        "batch_cap": cap, "batches": [int(b.size) for b in batches],
        "partition_ids_distinct": int(torch.unique(pids).numel()),
        "mean_f32_max_err": float(mean_err.max()),
        "launches": launches,
    }


# ---------------------------------------------------------------------------
# 4. strings
# ---------------------------------------------------------------------------

def numpy_pack_var(i64, chars, lens, base):
    """Numpy packer of the variable-width contract for (INT64, STRING)
    rows, both valid (bench.py numpy_pack_var)."""
    pad = (lens.astype(np.int64) + 7) // 8 * 8
    row_sizes = base.row_size + pad
    row_ends = np.cumsum(row_sizes)
    row_starts = row_ends - row_sizes
    out = np.zeros(int(row_ends[-1]), np.uint8)
    n = i64.shape[0]
    out[row_starts[:, None] + np.arange(8)] = i64.view(np.uint8).reshape(n, 8)
    slot = np.empty((n, 8), np.uint8)
    slot[:, :4] = np.full((n,), base.row_size, np.uint32)[:, None].view(
        np.uint8).reshape(n, 4)
    slot[:, 4:] = lens.astype(np.uint32)[:, None].view(np.uint8).reshape(n, 4)
    out[row_starts[:, None] + np.arange(8, 16)] = slot
    out[row_starts + base.validity_offset] = 0x3
    coff = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=coff[1:])
    within = np.arange(coff[-1]) - np.repeat(coff[:-1], lens)
    out[np.repeat(row_starts + base.row_size, lens) + within] = chars
    return out


def phase_strings(torch, port, n: int, seed: int) -> dict:
    (Table, HostColumn, table_from_numpy, convert_to_rows, convert_from_rows,
     *_rest) = port
    from spark_rapids_jni_tpu_torch.ops.row_conversion import \
        variable_width_layout
    rng = np.random.default_rng(seed + 5)
    i64 = rng.integers(-2**62, 2**62, n).astype(np.int64)
    lens = rng.integers(4, 21, n).astype(np.int32)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = rng.integers(97, 123, int(offs[-1])).astype(np.uint8)

    def make(rows):
        return table_from_numpy([
            HostColumn(4, 0, i64[:rows]),
            HostColumn(23, 0, None, None, offs[:rows + 1].astype(np.int32),
                       chars[:offs[rows]])], ["l", "s"])

    table = make(n)
    convert_from_rows(convert_to_rows(table)[0], table.dtypes())  # warm-up
    blobs, t_to = wall(torch, lambda: convert_to_rows(table))
    check(len(blobs) == 1, "string rows stay one batch")
    back, t_from = wall(torch, lambda: convert_from_rows(blobs[0],
                                                         table.dtypes()))
    a, b = table.columns[1], back.columns[1]
    check(torch.equal(table.columns[0].data, back.columns[0].data)
          and torch.equal(a.offsets, b.offsets)
          and torch.equal(a.data, b.data)
          and bool(b.valid_mask().all()), "string round trip is bit-exact")

    m = 1 << 16
    [small] = convert_to_rows(make(m))
    base = variable_width_layout(table.dtypes()).base
    want = numpy_pack_var(i64[:m], chars[:offs[m]], lens[:m], base)
    check(np.array_equal(small.children[0].bytes_numpy()[:len(want)], want)
          and int(small.offsets[-1]) == len(want),
          "64k-row string blob == numpy packer")
    blob_bytes = int(blobs[0].offsets[-1])
    return {"phase": "strings", "rows": n, "blob_bytes": blob_bytes,
            "to_rows_s": t_to, "from_rows_s": t_from,
            "round_trip_rows_per_s": n / (t_to + t_from),
            "round_trip_GBps": 2 * blob_bytes / (t_to + t_from) / 1e9}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--string-rows", type=int, default=1 << 22)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar.interop import (
        HostColumn, table_from_numpy)
    from spark_rapids_jni_tpu_torch.kernels import row_wire
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.hash import murmur3_hash
    from spark_rapids_jni_tpu_torch.ops.row_conversion import (
        convert_from_rows, convert_to_rows, fixed_width_layout)
    from spark_rapids_jni_tpu_torch.utils import tracing
    port = (Table, HostColumn, table_from_numpy, convert_to_rows,
            convert_from_rows, fixed_width_layout, groupby, murmur3_hash,
            row_wire, tracing)

    t0 = time.perf_counter()
    built = row_wire.build(verbose=True)
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": built["seconds"], "ptxas": ptxas})

    kernels = phase_kernels(torch, row_wire, args.seed, args.rows)
    emit({"phase": "kernels", **kernels})

    cols = stage_columns(args.rows, args.seed)
    stage = phase_stage(torch, port, cols, args.seed)
    del cols
    torch.cuda.empty_cache()
    emit(stage)

    emit(phase_strings(torch, port, args.string_rows, args.seed))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    src = "spark_rapids_jni_tpu_torch/kernels/csrc/row_wire.cu"
    replaces = {"interleave_planes":
                "spark_rapids_jni_tpu/ops/pallas_kernels.py:28",
                "deinterleave_wire":
                "spark_rapids_jni_tpu/ops/pallas_kernels.py:34"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": stage["launches"][name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": "bytes",
         "library_ms": k["library_ms"], "shape": k["shape"]}
        for name, k in kernels.items()]})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
