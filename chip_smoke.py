#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (spark_rapids_jni_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, drives a Spark stage end to end on the card, and scans
NDS-shaped Parquet files on the card for q5-lite, hand-wired and as an
engine plan, then the op surface, NDS-lite queries, ORC with q95-lite, the
exchange layer on a mesh of 8 shards of the card, adaptive execution
with the fused partial -> exchange -> combine stage on the same mesh, and
the device server the JVM talks to (bridge/), reached over its socket,
nested columns through the rest of I/O (Parquet, ORC, CSV), and the mesh
spread over processes (ranks of torch.distributed).

    python3 chip_smoke.py [--seed 0] [--rows 16777216]
        [--string-rows 4194304] [--fact-rows 16777216]
        [--ops-rows ...] [--nds-rows ...] [--orc-rows 4194304]
        [--exchange-rows 16777216] [--exchange-string-rows 4194304]
        [--adaptive-rows 16777216] [--bridge-rows 16777216]
        [--nested-rows 4194304] [--ranks-rows 16777216]
        [--ranks-string-rows 4194304]

Phases (any failed check raises, and the script exits non-zero):

1. build    compile kernels/csrc/row_wire.cu and parquet_decode.cu with
            nvcc for sm_90a, both at once.
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
5. files    the script's own numpy Parquet writer (the card's host has no
            pyarrow) writes NDS store_sales (2^24 rows in 2^20-row groups,
            snappy; dictionary date and store keys, PLAIN quantity, price
            and profit, 2% and 3% nulls), date_dim (73,049 rows) and store
            (402 rows with STRING names).
6. decode   every row group of store_sales by the device route
            (plan_device_group -> to_device -> decode_table, under
            torch.cuda.set_sync_debug_mode("error")) and the host route,
            bit-exact against each other and the written values; then a
            2^20-row matrix (uncompressed / snappy literal-only / snappy
            with copies x plain / dict x int32, int64, float32, float64,
            bool x no / sparse nulls).  Plan, decode and host-route times,
            link bytes, and a profile of one group's decode.
7. decode_kernels  K3 plain_gather on its own (blk, 512) -> (blk, 128)
            contract (beside its library call, one torch.gather of the
            bytes at int64 offsets) and on the page planes decode_table
            gives it (4 and 8 bytes, with nulls); W1 snappy_walk and W2
            hybrid_decode on every call decode_table makes on the fact
            file's first group and on a copy-bearing file (literal-only,
            copy-bearing, def-level and dictionary pages), then on their
            torn sets (hybrid_torn_set, snappy_torn_set: damaged and
            wrapping streams, which the CPU tests hold against the JAX
            package).
            Bit-exact against the plain versions, timed; W1/W2 report the
            tokens or runs walked, ns a step and the chain floor.
8. q5       q5-lite over the three files for the year 2000 (footer pruning
            engages), by the device route and by the host route, twice
            each (cold, warm), against a numpy oracle (counts exact, sums
            within rel 1e-9); the K3/W1/W2 launch counters are zeroed
            before the warm device run and must be above zero after it.
9. engine   the same query as a plan (tests/test_engine_e2e.py::q5_plan,
            the fact Scan with chunk_bytes = 64 MiB) through the port's
            engine: optimize (the date filter must reach the fact scan's
            pruning predicate), then execute by the device route (the
            default on a card: each chunk's pages decode inside the fused
            segment) and the host route (config.device_decode = False),
            cold and warm, against the oracle; row groups pruned, no
            device-decode fallback on the fact file, K3/W1/W2 launched by
            the engine's warm device route (counters zeroed just before
            it); the interpreted loop (fused=False) decoding every chunk on
            the card too; PlanCache identity for a plan
            rebuilt from its bytes; the synchronising CUDA calls of one warm
            device-route execute (set_sync_debug_mode("warn")) at 4 and 7
            row groups read, which must not grow with the chunks; a profile
            per route; and the explain_analyze text, its ceiling this card's
            copy rate (the kernels phase's library time).
10. ops     every op of the spark-rapids-jni surface at full width:
            numeric and temporal columns of 2^24 rows, NDS-shaped strings
            of 2^22 rows (numeric_strings, text_strings).  CastStrings in
            every direction, cast across int/float/decimal64/decimal128,
            the string functions, regex_matches (a rewritable pattern and
            the host escape), utc_to_local/local_to_utc (Los Angeles,
            Kolkata; 1900-2100), interleave_bits (2 and 3 columns), bloom
            build/merge/probe at Spark's sizing for 2^24 items (fpp 0.03),
            window (row_number, running sum/min/max, 1,000 partitions),
            dictionary, distinct, nunique, collect_list.  Each result is
            held bit-exact against the port on the CPU (row-wise ops on
            the first 2^20 rows of the output; the others run on a
            2^20-row input on both), and independent oracles run on a
            65,536-row sample (Python int()/float()/decimal.Decimal/str,
            datetime, zoneinfo, Spark's murmur3 bloom positions, a Python
            bit interleaver, numpy window).  Per op: warm wall time, rows/s,
            launches and busy share (one profiled call), synchronising calls
            (set_sync_debug_mode("warn")).
11. nds     q64, q67, q97 and predicate-cast lites (tests/test_query_nds.py
            wiring) at one SF100 task's split: 2^24-row q64 store_sales
            and q67 fact, 2^23-row catalog_sales, store_returns a tenth of
            the split's (item, ticket) pairs, customer (2,000,000 rows,
            STRING country), item (204,000, STRING colour), date_dim,
            store; predicate-cast over a 2^22-row table built on the card.
            The facts are read by the device route (K3/W1/W2 counted on
            each warm run); every query runs cold and warm against a numpy
            oracle (counts exact, sums within rel 1e-9), with a profile
            and a sync count.
12. orc     q95-lite (tests/test_query_nds.py wiring) at one split:
            web_sales of 2^22 rows (about 5 lines an order, warehouses
            1-5) in 2^20-row zlib stripes and web_returns (a tenth of the
            orders), written by the port's ORC writer (the card's host has
            no pyarrow), read back onto the card bit for bit, run cold and
            warm against a numpy oracle and the port on the CPU (count
            exact, sums within rel 1e-9); write, read and query times,
            launches and syncs.
13. exchange  a mesh of 8 shards on the card: the stage's 2^24-row table
            shuffled by its INT32 key and a 2^22-row table by a STRING key:
            capacity from the counts, wire bytes, skew, warm times, syncs
            (set_sync_debug_mode("warn"): the counts fetch only), every
            row once and on the shard pmod(murmur3(key), 8) names, slots
            bit for bit against the port on the CPU over 2^20 rows,
            placement against Python's Spark murmur3 on 65,536 rows;
            distributed groupby and join against one device; engine q5
            planned with distribute=True against the one-shard plan.
14. adaptive  8 shards, over a 2^24-row hot-key fact (half the rows on
            one key; tests/test_adaptive.py::warehouse at full width) and a
            400-row dimension written by the script's snappy writer, every
            fact scan decoding on the card (K3/W1/W2): the hash-planned
            join-aggregate with aqe off and on (the broadcast flip, the
            hot-key split with post_skew < measured_skew, the combine to 7
            rows); profile-warmed planning (run 2 plans the broadcast from
            run 1's profile); the fused stage by a 100,000-value key, fused
            at fuse_groups=16384 and re-planned at 4096, beside the
            unfused run and one device, its pass alone paying one
            synchronising call; aqe with fuse_exchange (the hot stage
            routed to the host path and split, the balanced one fused, the
            event timeline dumped); engine q5 fused against unfused.  Every
            result against the one-shard answer and a numpy oracle;
            deliberate host syncs against verify.sync_budget.
15. bridge  the port's device server on the card, in a thread of this
            process, and once as ``python3 -m
            spark_rapids_jni_tpu_torch.bridge.server --device cuda``, with
            the C ABI harness (g++ from src/main/cpp) at "0 leaks" against
            it.  RowConversion over the wire at 2^24 rows of the stage's
            schema (IMPORT_TABLE, TO_ROWS on K1, EXPORT_COLUMN, FROM_ROWS
            on K2, EXPORT_TABLE bit-exact), murmur3 and the groupby
            against the port in process; engine q5 as one PLAN_EXECUTE,
            cold and warm, equal to in-process execute, K3/W1/W2 launched
            in the server; four concurrent q5 point queries beside a bulk
            scan of the adaptive fact with the scheduler on and off (p50,
            p95), max_sessions=2 queueing, a burn-rate shed, OP_CANCEL of a
            running scan, a device-decode fault retried to the same answer
            and a post-mortem bundle naming its trace id.  Round-trip ms,
            shm GB/s, the plan's warm time beside in-process, launches.
16. nested  a Spark-shaped fact of 2^22 rows in 2^20-row groups with
            nested columns (INT64 key and FLOAT64 measure with nulls, a
            STRING, an optional STRUCT<id, name, price> with nulls at both
            levels, LIST<INT32> of 0-16 items with null lists and items,
            LIST<LIST<INT64>>), written by the port's Parquet writer
            (snappy: pyarrow's codec where it imports, the port's own
            encoder on a host without it), read whole and through the
            chunked reader onto the card and held against the written
            arrays (offsets, validity, child data), row group 0 bit for
            bit against the port's CPU read; an engine plan projecting
            the key and measure under a key filter (the device route:
            K3/W1/W2 counted), and one projecting the STRUCT and the LIST
            too (every group to the host route, reason "nested", the rows
            gathered on the card), both against numpy; an ORC round trip
            (zlib, 2^20 rows with the STRUCT and the LIST) and a CSV round
            trip (2^20 rows x 6 columns, nulls and quoted fields) onto the
            card.  Times of each step.
17. ranks   the mesh over processes (parallel/ranks.py), 4 shards a rank:
            two gloo ranks sharing the card (host-staged), each shuffling
            its block of the stage's 2^24-row table by its INT32 key and
            of the 2^22-row STRING table, every received slot and live
            mask bit for bit its slice of the one-process 8-shard shuffle;
            the distributed groupby and join gathered against one device;
            engine q5 planned on rank 0 with distribute=True, broadcast,
            run on both ranks over their row groups against the
            one-process plan (counts exact, sums within rel 1e-9), with
            K3/W1/W2 launched on each rank.  Then one NCCL rank on the
            card (the same shuffle, and NCCL's collectives over one rank),
            NCCL refusing two ranks on one card, and, with two cards or
            more, NCCL with one rank a card (on one card a line says it was
            not run).  Shuffle ms a backend beside the grid's bytes.

Output: one JSON line per phase (the engine's after its explain text), the
card's name and power limit as nvidia-smi reports them, a
{"kernels": [...]} line, and last
{"ok": true, "device": {...}}.  Without a CUDA card, or without the port's
package beside it, the script fails before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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


def device_ms(torch, fn, iters=5, spin_cycles=10_000_000) -> float:
    """Device time of one call of ``fn`` without its host time: a spin
    kernel (~5 ms) holds the stream while ``iters`` calls are enqueued
    behind it, so the events around them time the card's work alone."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
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


def _segments_to_strings(rng, segments, n: int, null_rate: float):
    """(chars, int32 offsets, validity) of rows made by concatenating
    ``segments``: [(lengths[n], chars[n, max_len] uint8)], per row."""
    width = sum(c.shape[1] for _, c in segments)
    mat = np.zeros((n, width), np.uint8)
    pos = np.zeros(n, np.int64)
    rows = np.arange(n)
    for lens, chars in segments:
        for j in range(chars.shape[1]):
            m = j < lens
            mat[rows[m], pos[m] + j] = chars[m, j]
        pos += lens
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(pos, out=offsets[1:])
    chars = mat[np.arange(width)[None, :] < pos[:, None]]
    return chars, offsets.astype(np.int32), rng.random(n) >= null_rate


def _digit_chars(rng, n: int, width: int) -> np.ndarray:
    return rng.integers(ord("0"), ord("9") + 1, (n, width)).astype(np.uint8)


def numeric_strings(rng, n: int, null_rate: float = 0.02):
    """Cast inputs, 4-20 characters: valid, invalid, signed, fractional,
    exponent and whitespace-padded numbers.  Returns (chars, int32 offsets,
    validity), numpy."""
    def seg(lens, chars):
        return (np.asarray(lens, np.int64), np.asarray(chars, np.uint8))

    def fixed(ch, p):
        return seg(rng.random(n) < p, np.full((n, 1), ord(ch)))
    lead = seg(rng.random(n) < 0.1, np.full((n, 1), ord(" ")))
    sign = seg(rng.random(n) < 0.3, np.where(
        rng.random((n, 1)) < 0.7, ord("-"), ord("+")))
    has_frac = rng.random(n) < 0.4
    frac_len = np.where(has_frac, rng.integers(2, 7, n), 0)  # "." + digits
    frac_chars = _digit_chars(rng, n, 6)
    frac_chars[:, 0] = ord(".")
    has_exp = rng.random(n) < 0.15
    exp_chars = np.stack([np.full(n, ord("e")), np.where(
        rng.random(n) < 0.5, ord("-"), ord("+")),
        *_digit_chars(rng, n, 2).T], axis=1)
    exp_len = np.where(has_exp, rng.integers(2, 5, n), 0)
    trail = seg(rng.random(n) < 0.1, np.full((n, 1), ord(" ")))
    rest = lead[0] + sign[0] + frac_len + exp_len + trail[0]
    int_len = np.clip(rng.integers(1, 12, n), 4 - rest, 20 - rest)
    ints = _digit_chars(rng, n, 11)
    segs = [lead, sign, seg(int_len, ints), seg(frac_len, frac_chars),
            seg(exp_len, exp_chars), trail]
    chars, offsets, valid = _segments_to_strings(rng, segs, n, null_rate)
    # 8% invalid: one character becomes a letter
    bad = np.flatnonzero(rng.random(n) < 0.08)
    at = offsets[bad] + rng.integers(0, 1 << 30, len(bad)) % (
        offsets[bad + 1] - offsets[bad])
    chars[at] = rng.integers(ord("a"), ord("z") + 1, len(bad))
    return chars, offsets, valid


WORDS = np.array([b"able", b"anti", b"bar", b"cally", b"ese", b"eing",
                  b"ought", b"pri", b"ation", b"n st", b"misty", b"plum",
                  b"red", b"blue", b"cat-1A", b"cat-22B", b"dog-3C"], object)


def text_strings(rng, n: int, null_rate: float = 0.02):
    """NDS-shaped text, 4-20 characters: one to three words joined by '-'
    or ' ', some with leading or trailing spaces.  (chars, int32 offsets,
    validity), numpy."""
    wl = np.array([len(w) for w in WORDS])
    wm = np.zeros((len(WORDS), 7), np.uint8)
    for i, w in enumerate(WORDS):
        wm[i, :len(w)] = np.frombuffer(w, np.uint8)
    segs = []
    total = np.zeros(n, np.int64)
    for k in range(3):
        pick = rng.integers(0, len(WORDS), n)
        use = np.ones(n, bool) if k == 0 else \
            (rng.random(n) < 0.6) & (total + 1 + wl[pick] <= 19)
        if k:
            sep = np.where(rng.random((n, 1)) < 0.5, ord("-"), ord(" "))
            segs.append((use.astype(np.int64), sep.astype(np.uint8)))
            total += use
        segs.append((np.where(use, wl[pick], 0), wm[pick]))
        total += np.where(use, wl[pick], 0)
    pad = ((total < 4) | (rng.random(n) < 0.1)) & (total < 20)
    segs.append((pad.astype(np.int64), np.full((n, 1), ord(" "), np.uint8)))
    return _segments_to_strings(rng, segs, n, null_rate)


# the port's record_function ranges on q5's paths, hand-wired and engine
TRACED = ("decode_table", "left_semi_join", "groupby", "inner_join",
          "xxhash64", "groupby_padded", "engine.fused_segment",
          "engine.aggregate", "engine.join")


def profile_top(torch, fn, top: int = 10) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the summed
    device time of its kernels and copies, their ratio (the device busy
    share; the profiler's own cost is in the wall), the number of kernels
    and copies launched, the kernels with the most device time, and the
    device time under each traced range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e, total=False):
        name = "device_time_total" if total else "self_device_time_total"
        return getattr(e, name, getattr(e, name.replace("device", "cuda"),
                                        0))
    ev = prof.key_averages()
    # device-side events are kernels and copies, plus a GPU mirror of each
    # record_function range, which bears the range's (CPU-side) name
    ranges = {e.key for e in ev if e.device_type == DeviceType.CPU}
    kern = sorted((e for e in ev if e.device_type == DeviceType.CUDA
                   and e.key not in ranges), key=dev_us, reverse=True)
    device_ms = sum(dev_us(e) for e in kern) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "launches": sum(e.count for e in kern),
            "top_kernels": [[e.key[:60], dev_us(e) / 1e3, e.count]
                            for e in kern[:top]],
            "ranges": {e.key: [dev_us(e, True) / 1e3, e.count]
                       for e in ev if e.key in TRACED}}


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
# 5. files: a small Parquet writer in numpy (the card's host has no pyarrow)
# ---------------------------------------------------------------------------

# parquet.thrift ids
_PHYS = {"bool": 0, "int32": 1, "int64": 2, "float32": 4, "float64": 5,
         "string": 6}
_ENC_PLAIN, _ENC_RLE, _ENC_RLE_DICT = 0, 3, 8
_CODEC = {"none": 0, "snappy": 1}
PAGE_BYTES = 1 << 20  # largest uncompressed data page


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def rle_hybrid_encode(values: np.ndarray, bw: int) -> bytes:
    """Parquet's RLE/bit-packed hybrid of ``values`` (ints < 2^bw): runs of
    whole 8-value groups that repeat one value become RLE runs, every other
    stretch of groups one bit-packed run (the last group zero-padded)."""
    n = len(values)
    ng = -(-n // 8)
    v = np.zeros(ng * 8, np.int64)
    v[:n] = values
    grp = v.reshape(ng, 8)
    const = (grp == grp[:, :1]).all(axis=1)
    if n % 8:
        const[-1] = False
    gval = grp[:, 0]
    new = np.ones(ng, np.bool_)
    new[1:] = (const[1:] != const[:-1]) | (const[1:] & (gval[1:] != gval[:-1]))
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], ng)
    bits = ((v[:, None] >> np.arange(bw)) & 1).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    bwb = (bw + 7) // 8
    out = []
    for g0, g1 in zip(starts.tolist(), ends.tolist()):
        k = g1 - g0
        if const[g0]:
            out.append(_uvarint((8 * k) << 1))
            out.append(int(gval[g0]).to_bytes(bwb, "little"))
        else:
            out.append(_uvarint((k << 1) | 1))
            out.append(packed[g0 * bw:g1 * bw])
    return b"".join(out)


# W1's and W2's torn sets: inputs the kernels must walk bit for bit like
# their plain versions, real streams and damaged ones alike (the CPU tests
# hold the same inputs against the JAX package)
TORN_UB, TORN_VB = 1 << 17, 8192


def _hybrid_blocks(rng, n: int, bw: int, lo: int, hi: int) -> np.ndarray:
    """``n`` values < 2^bw in blocks of lo..hi values, each block one
    repeated value (an RLE run) or random ones (a bit-packed run)."""
    out = np.empty(n, np.int64)
    at = 0
    while at < n:
        k = min(int(rng.integers(lo, hi + 1)), n - at)
        out[at:at + k] = rng.integers(0, 1 << bw) if rng.random() < 0.5 \
            else rng.integers(0, 1 << bw, k)
        at += k
    return out


def hybrid_torn_set(seed: int):
    """W2's torn set: (labels, data uint8[R, TORN_UB], start, end, bw,
    n int32[R], vb, jax_ok bool[R]).  Real streams longer than one window
    of the kernel, with runs at every phase of its window boundaries;
    chains of runs that each jump past a window, more in a row than the
    kernel stages for one batch, between runs that do not;
    random bytes at bit widths 0, 1, 7, 32 and 40; zero-count headers;
    runs past n and past vb; a 5-byte header whose groups*8 wraps the value
    count (the walk then laps the stream, writing slot 0 with negative
    counts and the same slots again); a header that steps 0 bytes; empty
    walks.  ``jax_ok`` is False on the row where the port's ``it < n`` bound
    ends a walk that the JAX loop would carry on for ~2^30 steps."""
    rng = np.random.default_rng(seed + 23)
    ub, vb = TORN_UB, TORN_VB
    rows = []

    def add(label, body, start, bw, n, end=None, jax_ok=True, lead=0):
        row = np.zeros(ub, np.uint8)
        row[0] = lead
        body = np.frombuffer(bytes(body), np.uint8)[:ub - start]
        row[start:start + len(body)] = body
        rows.append((label, row, start,
                     start + len(body) if end is None else end, bw, n,
                     jax_ok))

    enc = rle_hybrid_encode
    add("def levels, 5% nulls, 65,536 values (past vb)",
        enc((rng.random(1 << 16) >= 0.05).astype(np.int64), 1), 0, 1,
        1 << 16)
    add("indices bw 11, RLE and packed blocks",
        enc(_hybrid_blocks(rng, vb, 11, 8, 64), 11), 5, 11, vb)
    add("bw 5, short blocks", enc(_hybrid_blocks(rng, vb, 5, 8, 24), 5), 1,
        5, vb)
    add("bw 11, long packed runs (hops past a window)",
        enc(_hybrid_blocks(rng, vb, 11, 256, 1024), 11), 2, 11, vb)
    add("bw 32, RLE and packed blocks",
        enc(_hybrid_blocks(rng, 2048, 32, 8, 64), 32), 3, 32, 2048)
    ones = b"".join(bytes([2, int(x)]) for x in rng.integers(0, 256, vb))
    for start in range(4):  # 2-byte runs: every phase of every boundary
        add(f"bw 8 one-value runs from byte {start}", ones, start, 8, vb)
    add("runs past n", enc(_hybrid_blocks(rng, vb, 3, 8, 40), 3), 0, 3,
        vb // 3)
    # bit-packed runs of 64 groups at bw 32 step 2,050 bytes, past a
    # window; RLE runs of 8 values step 5
    far = [_uvarint((64 << 1) | 1)
           + rng.integers(0, 256, 64 * 32, dtype=np.uint8).tobytes()
           for _ in range(50)]
    near = [_uvarint(8 << 1) + int(x).to_bytes(4, "little")
            for x in rng.integers(0, 1 << 32, 50, dtype=np.uint64)]
    add("far runs: chains of 5, 5 and 40 between RLE runs",
        b"".join(far[:5] + near[:20] + far[5:10] + near[20:40] + far[10:]
                 + near[40:]), 4, 32, 1 << 16)
    for bw in (0, 1, 7, 32, 40):
        add(f"random bytes, bw {bw}",
            rng.integers(0, 256, ub - 8, dtype=np.uint8).tobytes(),
            int(rng.integers(0, 8)), bw, vb, end=ub)
    add("zero-count headers", b"", 0, 3, vb, end=40)
    # nine RLE runs of 40 values (27 bytes), then a packed header with
    # groups = 2^28 - 2: count 2^31 - 16 wraps v, and 16 * groups steps
    # back to the stream's start (5 + 27 - 32)
    lap = b"".join(bytes([80]) + int(x).to_bytes(2, "little")
                   for x in rng.integers(0, 1 << 16, 9))
    add("wrapping value count (laps the stream)",
        lap + _uvarint(((2**28 - 2) << 1) | 1)
        + rng.integers(0, 256, 64, dtype=np.uint8).tobytes(), 6, 16, vb)
    # a packed header with groups = -5 and bw 1 steps 5 - 5 = 0 bytes
    add("a header that steps 0 bytes",
        enc(rng.integers(0, 2, 64), 1) + _uvarint(2**32 - 9), 0, 1, vb)
    # two RLE runs of 100, then groups = 2^28 - 1: v wraps and s jumps to
    # -2^31 + 4, where every clipped read sees row[0] = 2 (one-value runs)
    add("it < n bound (value count and position wrap)",
        bytes([0xC8, 0x01, 7, 0xC8, 0x01, 9]) + _uvarint(2**29 - 1), 1, 8,
        vb, jax_ok=False, lead=2)
    add("start past end", enc(rng.integers(0, 8, 64), 3), 10, 3, vb, end=5)
    add("n = 0", enc(rng.integers(0, 8, 64), 3), 0, 3, 0)
    labels = [r[0] for r in rows]
    data = np.stack([r[1] for r in rows])
    cols = [np.asarray([r[k] for r in rows], np.int32) for k in (2, 3, 4, 5)]
    return labels, data, *cols, vb, np.asarray([r[6] for r in rows])


def snappy_torn_set(path, device: str):
    """W1's torn set: the page planes of ``path`` (a copy-bearing snappy
    file: literal and copy tokens, pages longer than one window) plus torn
    rows: random bytes, a truncated compressed length, a page cut short,
    a literal that leaves the window at once, and a chain of 40 literals
    that each leave it (more in a row than the kernel stages for one
    batch) between short literals and copies.  Returns numpy ``(comp, clen,
    ulen)`` and the column's geometry."""
    from spark_rapids_jni_tpu_torch.io import parquet as ppq
    chunk, _ = ppq.plan_device_group(ppq.ParquetFile(path), 0, None, 1 << 30,
                                     device)
    g = chunk.geom.columns[0]
    p = chunk.planes[g.name]
    cb = p["comp"].shape[1]
    rng = np.random.default_rng(17)
    torn = rng.integers(0, 256, (3, cb), dtype=np.uint8)
    # a 2-byte preamble, then a 3,000-byte literal: tag (61 << 2) and two
    # length bytes
    torn[2, :3] = [0x80, 0x20, 61 << 2]
    torn[2, 3:5] = np.frombuffer((3000 - 1).to_bytes(2, "little"), np.uint8)

    def literal(n):
        body = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        return (bytes([(n - 1) << 2]) if n <= 60 else
                bytes([61 << 2]) + (n - 1).to_bytes(2, "little")) + body
    copy = bytes([(7 << 2) | 2, 5, 0])  # 8 bytes from 5 back
    chain = np.frombuffer(b"".join(
        [bytes([0x80, 0x80, 0x08])] + [literal(10)] * 3
        + [literal(2100) for _ in range(40)] + [copy] * 5
        + [literal(2100) for _ in range(3)] + [literal(10)] * 2), np.uint8)
    width = max(cb, len(chain))
    comp = np.zeros((p["comp"].shape[0] + 4, width), np.uint8)
    comp[:-4, :cb] = p["comp"]
    comp[-4:-1, :cb] = torn
    comp[-1, :len(chain)] = chain
    clen = np.concatenate([p["clen"], [cb, 9, cb, len(chain)]])
    ulen = np.concatenate([p["ulen"], [g.ub, g.ub, g.ub, 1 << 17]])
    clen[1] = clen[1] // 2  # a page cut short
    return comp, clen.astype(np.int32), ulen.astype(np.int32), g


def _plain_bytes(kind: str, vals) -> bytes:
    if kind == "bool":
        return np.packbits(np.asarray(vals, np.uint8),
                           bitorder="little").tobytes()
    if kind == "string":
        return b"".join(len(b).to_bytes(4, "little") + b for b in vals)
    return np.ascontiguousarray(vals).tobytes()


def _page(ptype: int, body: bytes, codec: str, copies: bool, sub: tuple):
    """(header + compressed body) of one page."""
    from spark_rapids_jni_tpu_torch.io import snappy, thrift as T
    comp = snappy.compress(body, copies) if codec == "snappy" else body
    hdr = T.encode_struct([(1, T.T_I32, ptype), (2, T.T_I32, len(body)),
                           (3, T.T_I32, len(comp)), sub])
    return hdr + comp


def write_parquet(path, columns, group_rows: int, codec: str = "snappy",
                  copies: bool = False, page_bytes: int = PAGE_BYTES) -> None:
    """Write a flat Parquet file with V1 data pages.

    ``columns``: [(name, kind, values, valid, dictionary)] with kind one of
    int32/int64/float32/float64/bool (numpy arrays) or string (a list of
    bytes); ``valid`` is a bool array or None (a REQUIRED column).  Nulls
    are RLE def levels; ``dictionary`` columns write a PLAIN dictionary page
    and RLE_DICTIONARY data pages.  Data pages hold at most ``page_bytes``
    uncompressed; every fixed-width chunk carries min/max statistics.
    """
    from spark_rapids_jni_tpu_torch.io import thrift as T
    n = len(columns[0][2])
    buf = [b"PAR1"]
    at = 4
    groups = []
    for g0 in range(0, max(n, 1), group_rows):
        g1 = min(n, g0 + group_rows)
        chunks, gbytes = [], 0
        for name, kind, values, valid, dictionary in columns:
            vals = values[g0:g1]
            ok = None if valid is None else np.asarray(valid[g0:g1], np.bool_)
            nn = vals if ok is None else (
                [b for b, o in zip(vals, ok) if o] if kind == "string"
                else vals[ok])
            start, parts, unc = at, [], 0
            dict_off = None
            if dictionary:
                dvals, idx = np.unique(nn, return_inverse=True)
                bw = max(1, int(len(dvals) - 1).bit_length())
                body = _plain_bytes(kind, dvals)
                parts.append(_page(2, body, codec, copies,
                                   (7, T.T_STRUCT, [(1, T.T_I32, len(dvals)),
                                                    (2, T.T_I32, _ENC_PLAIN)])))
                unc += len(body)
                dict_off = at
                per_value = bw + 2  # worst case: alternating short runs
            else:
                idx = None
                per_value = 1 if kind == "bool" else (
                    8 * (4 + max(map(len, nn), default=0))
                    if kind == "string" else 8 * np.dtype(kind).itemsize)
            per_row = per_value + (2 if ok is not None else 0)
            rows_pp = max(8, (page_bytes - min(4096, page_bytes // 8)) * 8
                          // per_row)
            data_off = at + sum(len(p) for p in parts)
            k = 0  # non-null values written so far
            for p0 in range(0, g1 - g0, rows_pp):
                p1 = min(g1 - g0, p0 + rows_pp)
                body = b""
                m = p1 - p0
                if ok is not None:
                    lv = rle_hybrid_encode(ok[p0:p1].astype(np.int64), 1)
                    body = len(lv).to_bytes(4, "little") + lv
                    m = int(ok[p0:p1].sum())
                if dictionary:
                    body += bytes([bw]) + rle_hybrid_encode(idx[k:k + m], bw)
                else:
                    body += _plain_bytes(kind, nn[k:k + m])
                k += m
                if len(body) > page_bytes:
                    raise AssertionError("data page over its byte budget")
                parts.append(_page(0, body, codec, copies, (5, T.T_STRUCT, [
                    (1, T.T_I32, p1 - p0),
                    (2, T.T_I32, _ENC_RLE_DICT if dictionary else _ENC_PLAIN),
                    (3, T.T_I32, _ENC_RLE), (4, T.T_I32, _ENC_RLE)])))
                unc += len(body)
            blob = b"".join(parts)
            buf.append(blob)
            at += len(blob)
            stats = None
            if kind not in ("bool", "string") and len(nn):
                stats = [(3, T.T_I64, 0 if ok is None else int((~ok).sum())),
                         (5, T.T_BINARY, np.asarray(nn).max().tobytes()),
                         (6, T.T_BINARY, np.asarray(nn).min().tobytes())]
            encs = [_ENC_PLAIN, _ENC_RLE] + ([_ENC_RLE_DICT] if dictionary
                                             else [])
            meta = [(1, T.T_I32, _PHYS[kind]), (2, T.T_LIST, (T.T_I32, encs)),
                    (3, T.T_LIST, (T.T_BINARY, [name])),
                    (4, T.T_I32, _CODEC[codec]), (5, T.T_I64, g1 - g0),
                    (6, T.T_I64, unc), (7, T.T_I64, len(blob)),
                    (9, T.T_I64, data_off), (11, T.T_I64, dict_off),
                    (12, T.T_STRUCT, stats)]
            chunks.append([(2, T.T_I64, start), (3, T.T_STRUCT, meta)])
            gbytes += unc
        groups.append([(1, T.T_LIST, (T.T_STRUCT, chunks)),
                       (2, T.T_I64, gbytes), (3, T.T_I64, g1 - g0)])
        if n == 0:
            break
    schema = [[(4, T.T_BINARY, "schema"), (5, T.T_I32, len(columns))]]
    for name, kind, _, valid, _ in columns:
        schema.append([(1, T.T_I32, _PHYS[kind]),
                       (3, T.T_I32, 0 if valid is None else 1),
                       (4, T.T_BINARY, name),
                       (6, T.T_I32, 0 if kind == "string" else None)])
    footer = T.encode_struct([(1, T.T_I32, 1),
                              (2, T.T_LIST, (T.T_STRUCT, schema)),
                              (3, T.T_I64, n),
                              (4, T.T_LIST, (T.T_STRUCT, groups))])
    buf += [footer, len(footer).to_bytes(4, "little"), b"PAR1"]
    with open(path, "wb") as f:
        f.write(b"".join(buf))


# NDS store_sales at SF100 shape (the q5 tables), cut to one Spark task's
# input split: 2^24 fact rows in 2^20-row groups
DATE_SK0, N_DAYS = 2450816, 1827      # ss_sold_date_sk spans 1998-2002
DATE_DIM_SK0, DATE_DIM_ROWS = 2415022, 73049
N_STORES = 402                       # NDS SF100 store count
Q5_DATES = (2451545, 2451910)         # the year 2000: footer pruning engages
Q5_COLUMNS = ["ss_sold_date_sk", "ss_store_sk", "ss_ext_sales_price",
              "ss_net_profit"]
STORE_SYLLABLES = ["ought", "able", "pri", "ese", "anti", "cally", "ation",
                   "eing", "bar", "n st"]  # NDS name syllables
MATRIX_KINDS = ["int32", "int64", "float32", "float64", "bool"]


def fact_columns(n: int, seed: int):
    """store_sales at NDS shape: (name, kind, values, valid, dictionary)."""
    rng = np.random.default_rng(seed + 11)
    date = np.sort(rng.integers(DATE_SK0, DATE_SK0 + N_DAYS, n))
    store = rng.integers(1, N_STORES + 1, n)
    cents = rng.integers(0, 2_000_000, n)           # 0 .. 20,000.00
    profit = rng.integers(-500_000, 1_000_000, n)   # -5,000 .. 10,000.00
    return [
        ("ss_sold_date_sk", "int64", date, None, True),
        ("ss_store_sk", "int64", store, rng.random(n) >= 0.02, True),
        ("ss_quantity", "int32", rng.integers(1, 101, n).astype(np.int32),
         None, False),
        ("ss_ext_sales_price", "float64", cents / 100.0,
         rng.random(n) >= 0.03, False),
        ("ss_net_profit", "float64", profit / 100.0, None, False),
    ]


def dim_columns():
    """date_dim (d_date_sk, d_year) and store (s_store_sk, s_store_name)."""
    dsk = np.arange(DATE_DIM_SK0, DATE_DIM_SK0 + DATE_DIM_ROWS, dtype=np.int64)
    dates = [("d_date_sk", "int64", dsk, None, False),
             ("d_year", "int32", (1900 + (dsk - DATE_DIM_SK0) // 365.25)
              .astype(np.int32), None, False)]
    syl = STORE_SYLLABLES
    names = [(syl[(i // 10) % 10] + syl[i % 10]).encode()
             for i in range(N_STORES)]  # every tenth store shares a name
    stores = [("s_store_sk", "int64", np.arange(1, N_STORES + 1), None, False),
              ("s_store_name", "string", names, None, False)]
    return dates, stores


def matrix_columns(n: int, seed: int, encoding: str, nulls: str,
                   copies: bool):
    """One column per type; ``copies`` repeats each value 64 times so 64-byte
    blocks repeat, ``dict`` draws from 1,000 values."""
    rng = np.random.default_rng(seed + 17)
    cols = []
    for kind in MATRIX_KINDS:
        m = -(-n // 64) if copies else n
        if kind == "bool":
            v = rng.random(m) < 0.5
        elif kind.startswith("float"):
            v = (rng.integers(-4000, 4000, m) / 4.0).astype(kind)
        else:
            v = rng.integers(-2**30, 2**30, m).astype(kind)
        if encoding == "dict" and kind != "bool":
            v = rng.choice(v[:1000], m)
        if copies:
            v = np.repeat(v, 64)[:n]
        valid = None if nulls == "none" else rng.random(n) >= 0.05
        cols.append((kind, kind, v, valid,
                     encoding == "dict" and kind != "bool"))
    return cols


def head(table, n: int):
    """The first ``n`` rows of a Table, as views (the decode output is
    padded to its row bucket)."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    if table.num_rows == n:  # host chunks of strings come unpadded
        return table
    return Table([Column(c.dtype, data=c.data[:n],
                         validity=None if c.validity is None
                         else c.validity[:n]) for c in table.columns],
                 table.names)


def scan(path, route: str, device, info: dict, columns=None,
         predicate=None, limit: int = 64 << 20, prefetch: int = 0):
    """The chunks of one file by ``route``: "host" iterates the chunked
    reader (host decode, per-column transfer); "device" takes
    ``iter_device`` and decodes each planned group with ``decode_table``
    (fallback groups arrive host-decoded, their reason kept in ``info``)."""
    from spark_rapids_jni_tpu_torch.io import ParquetChunkedReader
    from spark_rapids_jni_tpu_torch.ops.parquet_decode import decode_table
    with ParquetChunkedReader(path, pass_read_limit=limit, columns=columns,
                              predicate=predicate, prefetch=prefetch,
                              device=device) as reader:
        if route == "host":
            for table in reader:
                info["rows"] = info.get("rows", 0) + table.num_rows
                yield table
        else:
            for kind, item, reason in reader.iter_device():
                if kind == "dev":
                    table, n = decode_table(item.to_device(device),
                                            item.geom), item.nrows
                else:
                    (table, n) = item
                    info.setdefault("fallbacks", []).append(
                        (str(path).rsplit("/", 1)[-1], reason))
                info["rows"] = info.get("rows", 0) + n
                yield head(table, n)
        info["groups_read"] = info.get("groups_read", 0) + reader.groups_read
        info["groups_pruned"] = info.get("groups_pruned", 0) \
            + reader.groups_pruned


def q5_lite(root, route: str, device, date_lo: int, date_hi: int,
            limit: int = 64 << 20, columns=None, prefetch: int = 0):
    """NDS q5-lite through the port: sales, profit and count by store name
    over a date range.  Scan date_dim and filter; chunked scan of
    store_sales with footer pruning, per-chunk semi-join on the dates and
    partial aggregation; combine; join the stores; aggregate by name.
    The composition of tests/test_query_e2e.py's run_engine.
    Returns ({name: (sales, profit, n)}, scan info)."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.io import read_parquet
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.join import (inner_join,
                                                     left_semi_join)
    from spark_rapids_jni_tpu_torch.ops.selection import (apply_boolean_mask,
                                                          concat_tables)
    root = Path(root)
    info: dict = {}

    def dim(name):
        if route == "host":
            return read_parquet(root / name, device=device)
        return concat_tables(list(scan(root / name, "device", device,
                                       info)))

    dates = dim("date_dim.parquet")
    dk = dates["d_date_sk"].data
    dkeep = apply_boolean_mask(dates, (dk >= date_lo) & (dk <= date_hi))
    stores = dim("store.parquet")
    fact_info: dict = {}
    partials = []
    for chunk in scan(root / "store_sales.parquet", route, device, fact_info,
                      columns, ("ss_sold_date_sk", date_lo, date_hi), limit,
                      prefetch):
        kept = left_semi_join(chunk, dkeep, ["ss_sold_date_sk"],
                              ["d_date_sk"], device=device)
        if kept.num_rows == 0:
            continue
        partials.append(groupby(
            kept, ["ss_store_sk"],
            [("ss_ext_sales_price", "sum"), ("ss_net_profit", "sum"),
             ("ss_ext_sales_price", "count")],
            names=["sales", "profit", "n"], device=device))
    merged = Table.from_pydict({
        name: sum((p[name].to_pylist() for p in partials), [])
        for name in partials[0].names}, device=device)
    totals = groupby(merged, ["ss_store_sk"],
                     [("sales", "sum"), ("profit", "sum"), ("n", "sum")],
                     names=["sales", "profit", "n"], device=device)
    joined = inner_join(totals, stores, ["ss_store_sk"], ["s_store_sk"],
                        device=device)
    result = groupby(joined, ["s_store_name"],
                     [("sales", "sum"), ("profit", "sum"), ("n", "sum")],
                     names=["sales", "profit", "n"], device=device)
    info.update(fact_info)
    out = {nm: (s, p, int(n)) for nm, s, p, n in zip(
        result["s_store_name"].to_pylist(), result["sales"].to_pylist(),
        result["profit"].to_pylist(), result["n"].to_pylist())}
    return out, info


def q5_oracle(fact, dates, stores, date_lo: int, date_hi: int) -> dict:
    """q5-lite in numpy: np.isin on the kept dates, bincount by store, the
    store table's names, a sum by name."""
    c = {name: (v, ok) for name, _, v, ok, _ in fact}
    d = dates[0][2]
    keep = np.isin(c["ss_sold_date_sk"][0], d[(d >= date_lo) & (d <= date_hi)])
    store, sok = c["ss_store_sk"]
    keep &= sok
    price, pok = c["ss_ext_sales_price"]
    profit = c["ss_net_profit"][0]
    m = N_STORES + 1
    sk = store[keep]
    pv = pok[keep]
    sales = np.bincount(sk, np.where(pv, price[keep], 0.0), m)
    prof = np.bincount(sk, profit[keep], m)
    cnt = np.bincount(sk[pv], minlength=m)
    has = np.bincount(sk, minlength=m) > 0
    out: dict = {}
    for s_sk, name in zip(stores[0][2].tolist(), stores[1][2]):
        if not has[s_sk]:
            continue
        a, b, k = out.get(name.decode(), (0.0, 0.0, 0))
        out[name.decode()] = (a + sales[s_sk], b + prof[s_sk],
                              k + int(cnt[s_sk]))
    return out


def q5_matches(got: dict, want: dict, rel: float = 1e-9) -> bool:
    """Same names and counts; sums within ``rel`` (atomic summation order)."""
    if set(got) != set(want):
        return False
    for name, (ws, wp, wn) in want.items():
        gs, gp, gn = got[name]
        if gn != wn or abs(gs - ws) > rel * abs(ws) or \
                abs(gp - wp) > rel * abs(wp):
            return False
    return True


# ---------------------------------------------------------------------------
# NDS-lite queries (the nds phase; tests/test_torch_nds.py runs the same
# functions on the CPU): q64, q67, q97 and predicate-cast, wired as
# tests/test_query_nds.py wires them through the JAX package's ops
# ---------------------------------------------------------------------------

Q64_COLORS = ("plum", "misty")
Q64_COLUMNS = ["ss_sold_date_sk", "ss_store_sk", "ss_customer_sk",
               "ss_item_sk", "ss_ticket_number", "ss_sales_price"]
PREDICATE = r"^cat-\d+[A-Z]$"      # outside the rewrite set: host escape


def _dim(root, name, route, device, info):
    """A whole (small) table: the host reader, or the device route's
    decode of every group (STRING groups take the host decoder)."""
    from spark_rapids_jni_tpu_torch.io import read_parquet
    from spark_rapids_jni_tpu_torch.ops.selection import concat_tables
    if route == "host":
        return read_parquet(Path(root) / name, device=device)
    return concat_tables(list(scan(Path(root) / name, "device", device,
                                   info)))


def q64_lite(root, route: str, device):
    """q64-lite: store_sales joined with date_dim, store, customer and the
    items whose colour is plum or misty (``ops.strings.equal`` on the
    card), left-joined with store_returns on (item, ticket); net = price -
    returned amount; sum and count of net by (store name, year).  Each fact
    chunk aggregates partially, then the partials combine.  Returns
    ({(name, year): (net, n)}, scan info)."""
    import torch
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import BOOL8, FLOAT64
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.join import inner_join, left_join
    from spark_rapids_jni_tpu_torch.ops.selection import (apply_boolean_mask,
                                                          concat_tables)
    from spark_rapids_jni_tpu_torch.ops.strings import equal
    info: dict = {}
    t0 = time.perf_counter()
    dd = _dim(root, "date_dim.parquet", route, device, info)
    stores = _dim(root, "store.parquet", route, device, info)
    cust = _dim(root, "customer.parquet", route, device, info)
    items = _dim(root, "item.parquet", route, device, info)
    sr = _dim(root, "store_returns.parquet", route, device, info)
    info["dims_s"] = time.perf_counter() - t0
    color = items["i_color"]
    hit = (equal(color, Q64_COLORS[0]).data != 0) | \
        (equal(color, Q64_COLORS[1]).data != 0)
    fitems = apply_boolean_mask(items, Column(BOOL8, data=hit.to(torch.uint8),
                                              validity=color.validity))
    partials = []
    fact_info: dict = {}
    for chunk in scan(Path(root) / "store_sales.parquet", route, device,
                      fact_info, Q64_COLUMNS):
        j = inner_join(chunk, dd, ["ss_sold_date_sk"], ["d_date_sk"],
                       device=device)
        j = inner_join(j, stores, ["ss_store_sk"], ["s_store_sk"],
                       device=device)
        j = inner_join(j, cust, ["ss_customer_sk"], ["c_customer_sk"],
                       device=device)
        j = inner_join(j, fitems, ["ss_item_sk"], ["i_item_sk"],
                       device=device)
        j = left_join(j, sr, ["ss_item_sk", "ss_ticket_number"],
                      ["sr_item_sk", "sr_ticket_number"], device=device)
        ret = j["sr_return_amt"]
        net = j["ss_sales_price"].data - torch.where(
            ret.valid_mask(), ret.data, torch.zeros_like(ret.data))
        jt = Table(list(j.columns) + [Column(FLOAT64, data=net)],
                   list(j.names) + ["net"])
        partials.append(groupby(jt, ["s_store_name", "d_year"],
                                [("net", "sum"), ("net", "count")],
                                names=["net", "n"], device=device))
    g = groupby(concat_tables(partials), ["s_store_name", "d_year"],
                [("net", "sum"), ("n", "sum")], names=["net", "n"],
                device=device)
    info.update(fact_info)
    return {(nm, int(y)): (s, int(n)) for nm, y, s, n in zip(
        g["s_store_name"].to_pylist(), g["d_year"].to_pylist(),
        g["net"].to_pylist(), g["n"].to_pylist())}, info


def q67_lite(root, route: str, device, top: int = 3):
    """q67-lite: sales by (store, category, item), ranked within (store,
    category) by ``window`` row_number on descending sales, top 3 kept.
    Returns (sorted [(store, cat, round(sales, 6))], scan info)."""
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.order import SortKey
    from spark_rapids_jni_tpu_torch.ops.selection import (apply_boolean_mask,
                                                          concat_tables)
    from spark_rapids_jni_tpu_torch.ops.window import window
    info: dict = {}
    keys = ["store", "cat", "item"]
    partials = [groupby(chunk, keys, [("price", "sum")], names=["sales"],
                        device=device)
                for chunk in scan(Path(root) / "q67_sales.parquet", route,
                                  device, info)]
    per_item = groupby(concat_tables(partials), keys, [("sales", "sum")],
                       names=["sales"], device=device)
    ranked = window(per_item, ["store", "cat"],
                    [SortKey(per_item["sales"], ascending=False)],
                    [(None, "row_number")], names=["rn"])
    kept = apply_boolean_mask(ranked, ranked["rn"].data <= top)
    return sorted(zip(kept["store"].to_pylist(), kept["cat"].to_pylist(),
                      [round(s, 6) for s in kept["sales"].to_pylist()])), info


def q97_lite(root, route: str, device, date_lo: int, date_hi: int):
    """q97-lite: distinct (customer, item) pairs of store_sales and of
    catalog_sales in a date range, full outer join; the channel-overlap
    counts follow from the join's cardinality.  Returns ((store_only,
    catalog_only, both), scan info)."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.ops.join import full_join
    from spark_rapids_jni_tpu_torch.ops.selection import (apply_boolean_mask,
                                                          concat_tables,
                                                          distinct)
    info: dict = {}

    def keys_in_range(name, date_col, keys):
        parts = []
        for t in scan(Path(root) / name, route, device, info,
                      [date_col] + keys, (date_col, date_lo, date_hi)):
            d = t[date_col].data
            t = apply_boolean_mask(t, (d >= date_lo) & (d <= date_hi))
            parts.append(Table([t[k] for k in keys], keys))
        return distinct(concat_tables(parts))

    ssk = keys_in_range("store_sales.parquet", "ss_sold_date_sk",
                        ["ss_customer_sk", "ss_item_sk"])
    csk = keys_in_range("catalog_sales.parquet", "cs_sold_date_sk",
                        ["cs_bill_customer_sk", "cs_item_sk"])
    out = full_join(ssk, csk, ["ss_customer_sk", "ss_item_sk"],
                    ["cs_bill_customer_sk", "cs_item_sk"], device=device)
    both = ssk.num_rows + csk.num_rows - out.num_rows
    return (ssk.num_rows - both, csk.num_rows - both, both), info


Q95_COLUMNS = ["ws_order_number", "ws_warehouse_sk", "ws_ship_date_sk",
               "ws_ext_ship_cost", "ws_net_profit"]


def q95_lite(ws, wr, date_lo: int, date_hi: int) -> tuple:
    """q95-lite (tests/test_query_nds.py wiring) over port tables on one
    device: web orders shipped from more than one warehouse (a self
    ``inner_join`` on the order number, a differing-warehouse mask, a
    groupby), shipped in [date_lo, date_hi] and returned (two
    ``left_semi_join``s); count-distinct as groupby-then-count.  Returns
    (orders, ship cost sum, net profit sum)."""
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.join import (inner_join,
                                                     left_semi_join)
    from spark_rapids_jni_tpu_torch.ops.selection import apply_boolean_mask
    dev = ws.columns[0].device
    sub = ws.select(["ws_order_number", "ws_warehouse_sk"])
    pairs = inner_join(sub, sub, ["ws_order_number"], device=dev)
    diff = apply_boolean_mask(pairs, pairs["ws_warehouse_sk"].data
                              != pairs["ws_warehouse_sk_r"].data)
    multi = groupby(diff, ["ws_order_number"],
                    [("ws_order_number", "count_all")], names=["n"],
                    device=dev)
    d = ws["ws_ship_date_sk"].data
    in_window = apply_boolean_mask(ws, (d >= date_lo) & (d <= date_hi))
    kept = left_semi_join(in_window, multi, ["ws_order_number"], device=dev)
    kept = left_semi_join(kept, wr, ["ws_order_number"], ["wr_order_number"],
                          device=dev)
    distinct = groupby(kept, ["ws_order_number"],
                       [("ws_ext_ship_cost", "sum"),
                        ("ws_net_profit", "sum")],
                       names=["ship", "profit"], device=dev)
    return (distinct.num_rows, float(distinct["ship"].data.sum()),
            float(distinct["profit"].data.sum()))


def q95_columns(n: int, seed: int) -> tuple:
    """One web_sales split of ``n`` rows (about 5 lines an order, warehouses
    1-5, ship dates over 300 days, costs and profits in cents) and its
    web_returns: a tenth of the orders.  Host numpy columns."""
    rng = np.random.default_rng(seed + 95)
    n_orders = max(n // 5, 1)
    ws = {"ws_order_number": rng.integers(0, n_orders, n),
          "ws_warehouse_sk": rng.integers(1, 6, n),
          "ws_ship_date_sk": rng.integers(2_450_800, 2_451_100, n),
          "ws_ext_ship_cost": np.round(rng.uniform(1, 50, n), 2),
          "ws_net_profit": np.round(rng.uniform(-20, 80, n), 2)}
    wr = {"wr_order_number": rng.choice(n_orders, max(n_orders // 10, 1),
                                        replace=False)}
    return ws, wr


def q95_oracle_np(ws: dict, wr: dict, date_lo: int, date_hi: int) -> tuple:
    """q95-lite in numpy: (orders, ship cost sum, net profit sum)."""
    order, wh = ws["ws_order_number"], ws["ws_warehouse_sk"]
    pairs = np.unique(np.stack([order, wh], axis=1), axis=0)
    uo, cnt = np.unique(pairs[:, 0], return_counts=True)
    multi = uo[cnt > 1]
    d = ws["ws_ship_date_sk"]
    keep = (d >= date_lo) & (d <= date_hi) & np.isin(order, multi) & \
        np.isin(order, wr["wr_order_number"])
    return (int(np.unique(order[keep]).shape[0]),
            float(ws["ws_ext_ship_cost"][keep].sum()),
            float(ws["ws_net_profit"][keep].sum()))


def predicate_cast_lite(table):
    """predicate-cast-lite over a port Table (cat STRING, amt DECIMAL64
    scale -2, d DATE): RLIKE outside the rewrite set (the host escape),
    the date cast to STRING, the decimal summed by that string.  Returns
    {date string: unscaled sum}."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.dtypes import STRING
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.cast import cast
    from spark_rapids_jni_tpu_torch.ops.regex_rewrite import regex_matches
    from spark_rapids_jni_tpu_torch.ops.selection import apply_boolean_mask
    dev = table.columns[0].device
    kept = apply_boolean_mask(table, regex_matches(table["cat"], PREDICATE))
    dstr = cast(kept["d"], STRING)
    g = groupby(Table([dstr, kept["amt"]], ["ds", "amt"]), ["ds"],
                [("amt", "sum")], device=dev)
    return dict(zip(g["ds"].to_pylist(), g["sum_amt"].data.cpu().tolist()))


# ---------------------------------------------------------------------------
# 6. decode: device route against host route and the written values
# ---------------------------------------------------------------------------

def _want_bytes(kind: str, values, valid) -> np.ndarray:
    """What a decoded column must hold: the written values, zero on null
    rows, as raw bytes."""
    v = np.asarray(values)
    if kind == "bool":
        v = v.astype(np.uint8)
    if valid is not None:
        v = np.where(valid, v, np.zeros((), v.dtype))
    return v.view(np.uint8)


def check_group(torch, dev_table, host_table, nrows: int, cols, g0: int,
                what: str) -> None:
    """Device route == host route == the writer's values, bit for bit."""
    for c_dev, c_host, (name, kind, values, valid, _) in zip(
            dev_table.columns, host_table.columns, cols):
        a = c_dev.data[:nrows].contiguous().view(torch.uint8)
        b = c_host.data[:nrows].contiguous().view(torch.uint8)
        check(torch.equal(a, b), f"{what} {name}: device == host route")
        ok = None if valid is None else valid[g0:g0 + nrows]
        want = _want_bytes(kind, values[g0:g0 + nrows], ok)
        check(np.array_equal(a.cpu().numpy(), want),
              f"{what} {name}: decoded == written values")
        check((c_dev.validity is None) == (valid is None),
              f"{what} {name}: validity present iff nullable")
        if valid is not None:
            check(np.array_equal(c_dev.validity[:nrows].cpu().numpy(), ok)
                  and np.array_equal(c_host.validity[:nrows].cpu().numpy(),
                                     ok)
                  and not bool(c_dev.validity[nrows:].any()),
                  f"{what} {name}: validity")


def decode_file(torch, path, cols, what: str, timed_groups=()) -> dict:
    """Every row group of ``path`` by both routes, checked; the plan time
    of every group, other times for the groups in ``timed_groups``."""
    from spark_rapids_jni_tpu_torch.io.parquet import (ParquetFile,
                                                       plan_device_group)
    from spark_rapids_jni_tpu_torch.ops.parquet_decode import decode_table
    pf = ParquetFile(path)
    out = {"groups": pf.num_row_groups, "link_bytes": 0,
           "uncompressed_bytes": 0, "plan_ms": [], "timed": []}
    g0 = 0
    for gi in range(pf.num_row_groups):
        t0 = time.perf_counter()
        chunk, reason = plan_device_group(pf, gi, None, None, DEV)
        plan_s = time.perf_counter() - t0
        out["plan_ms"].append(plan_s * 1e3)
        check(chunk is not None, f"{what} group {gi} planned ({reason})")
        planes = chunk.to_device(DEV)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # decode_table never syncs
        try:
            table = decode_table(planes, chunk.geom)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host = pf.read_row_group(gi, device=DEV)
        check_group(torch, table, host, chunk.nrows, cols, g0,
                    f"{what} group {gi}")
        out["link_bytes"] += chunk.comp_bytes
        out["uncompressed_bytes"] += chunk.unc_bytes
        if gi in timed_groups:
            dec_ms = cuda_ms(torch, lambda: decode_table(planes, chunk.geom),
                             iters=5, warmup=1)
            if gi == timed_groups[0] and what == "store_sales":
                out["profile"] = profile_top(
                    torch, lambda: decode_table(planes, chunk.geom))
            _, host_s = wall(torch, lambda: pf.read_row_group(gi, device=DEV))
            out_bytes = sum(c.data[:chunk.nrows].numel()
                            * c.data.element_size()
                            + (chunk.nrows if c.validity is not None else 0)
                            for c in table.columns)
            out["timed"].append({
                "group": gi, "rows": chunk.nrows, "plan_ms": plan_s * 1e3,
                "link_bytes": chunk.comp_bytes,
                "uncompressed_bytes": chunk.unc_bytes,
                "decode_ms": dec_ms, "decode_GBps": out_bytes / dec_ms / 1e6,
                "host_route_ms": host_s * 1e3,
                "has_copies": [g.has_copies for g in chunk.geom.columns]})
        g0 += chunk.nrows
        del planes, table, host
    return out


def phase_decode(torch, root, fact, seed: int, matrix_rows: int) -> dict:
    """The fact file's row groups and a codec x encoding x nulls matrix."""
    t0 = time.perf_counter()
    fact_out = decode_file(torch, root / "store_sales.parquet", fact,
                           "store_sales", timed_groups=(0, 1))
    fact_s = time.perf_counter() - t0
    matrix = []
    t0 = time.perf_counter()
    for codec, copies in (("none", False), ("snappy", False),
                          ("snappy", True)):
        for encoding in ("plain", "dict"):
            for nulls in ("none", "sparse"):
                cols = matrix_columns(matrix_rows, seed, encoding, nulls,
                                      copies)
                path = root / f"m_{codec}{copies:d}_{encoding}_{nulls}.parquet"
                write_parquet(path, cols, matrix_rows, codec, copies)
                res = decode_file(torch, path, cols, path.stem,
                                  timed_groups=(0,))
                t = res["timed"][0]
                matrix.append({"file": path.stem, **{
                    k: t[k] for k in ("decode_ms", "decode_GBps",
                                      "host_route_ms", "link_bytes",
                                      "uncompressed_bytes", "has_copies")}})
                path.unlink()
    return {"phase": "decode", "fact": fact_out, "fact_s": fact_s,
            "matrix_rows": matrix_rows, "matrix": matrix,
            "matrix_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# 7. the decode kernels K3, W1, W2 against their plain versions
# ---------------------------------------------------------------------------

def capture_decode_calls(pqk, pqd, planes, geom) -> dict:
    """The arguments ``decode_table`` gives each kernel wrapper, captured by
    wrapping the wrappers for one decode (the main path's real inputs)."""
    calls = {"plain_gather": [], "snappy_walk": [], "hybrid_decode": []}
    saved = {name: getattr(pqk, name) for name in calls}

    def wrap(name):
        def f(*args):
            calls[name].append(args)
            return saved[name](*args)
        return f
    for name in calls:
        setattr(pqk, name, wrap(name))
    try:
        pqd.decode_table(planes, geom)
    finally:
        for name, fn in saved.items():
            setattr(pqk, name, fn)
    return calls


def _plain_ms(torch, fn, reps: int = 1) -> float:
    _, s = wall(torch, fn)
    for _ in range(reps - 1):
        s = min(s, wall(torch, fn)[1])
    return s * 1e3


# next-pointers the chain probe follows: ~20 ms of hops, so its launch is
# lost in the timing
PROBE_HOPS = 1 << 20


def hop_ns(torch, pqk) -> float:
    """One dependent shared-memory hop of a walk's chain, in ns: the chain
    probe (``hop_probe``) timed on the card."""
    return device_ms(torch, lambda: pqk.hop_probe(PROBE_HOPS, DEV)) * 1e6 \
        / PROBE_HOPS


def walk_case(torch, pqk, name: str, tag: str, a, hop: float) -> dict:
    """W1 (``snappy_walk``) or W2 (``hybrid_decode``) against its plain
    version on one call's arguments ``a``: max_abs_err (0 or the check
    fails, naming the rows that differ), ms (CUDA events around back-to-back
    wrapper calls, so the wrapper's host time shows where it is the
    longer), kernel ms (the kernels' own device time, ``device_ms``), plain
    ms (wall clock: Python walks), bound ms (bytes), the tokens or runs
    walked (all rows and the longest row), kernel ns a token or run on the
    longest row, and beside it ``hop`` (ns of one shared-memory hop, from
    ``hop_ns``) and the longest row's walk at one such hop a step."""
    fn, plain = getattr(pqk, name), getattr(pqk, name + "_plain")
    got = fn(*a)
    want, plain_s = wall(torch, lambda: plain(*a))
    if name == "snappy_walk":
        comp, clen, ulen, ub, tb = a
        r = comp.shape[0]
        steps = (want[0] < ub).sum(dim=1)
        nbytes = int(clen.clamp(0, comp.shape[1]).sum()) + 8 * r \
            + 12 * r * tb
    else:
        data, start, end, bw, n, vb = a
        r, ub = data.shape
        got, want = (got,), (want,)
        # a run per written slot: exact on real streams (rising counts)
        steps = (pqk.hybrid_walk_plain(*a)[0] >= 0).sum(dim=1)
        streams = (end.clamp(0, ub) - start.clamp(0, ub)).clamp(min=0)
        nbytes = int(streams.sum()) + 16 * r + 8 * r * vb
    diff = [(x.to(torch.int64) - y.to(torch.int64)).abs()
            for x, y in zip(got, want)]
    e = max((int(d.max()) for d in diff if d.numel()), default=0)
    rows = [i for i in range(r) if any(bool(d[i].any()) for d in diff)]
    check(e == 0 and not rows, f"{name} bit-exact on {tag} (rows {rows})")
    ms = cuda_ms(torch, lambda: fn(*a), iters=5, warmup=1)
    kernel_ms = device_ms(torch, lambda: fn(*a))
    longest = int(steps.max()) if r else 0
    return {"case": tag, "rows": r, "max_abs_err": e,
            "walked": int(steps.sum()), "longest_walk": longest,
            "ms": ms, "kernel_ms": kernel_ms,
            "ns_per_step": kernel_ms * 1e6 / longest if longest else None,
            "plain_ms": plain_s * 1e3,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "hop_ns": hop, "one_hop_chain_ms": longest * hop / 1e6}


def phase_torn_walks(torch, pqk, root, seed: int, hop: float) -> dict:
    """W1 and W2 on their torn sets (hybrid_torn_set, snappy_torn_set), the
    inputs on which the CPU tests hold the plain versions to the JAX
    package."""
    labels, data, start, end, bw, n, vb, _ = hybrid_torn_set(seed)
    a = [torch.from_numpy(x).to(DEV) for x in (data, start, end, bw, n)]
    w2 = walk_case(torch, pqk, "hybrid_decode",
                   f"torn set ({len(labels)} rows)", (*a, vb), hop)
    path = root / "torn_copies.parquet"
    cols = matrix_columns(3000, 2, "plain", "sparse", True)
    write_parquet(path, [c for c in cols if c[0] == "int64"], 3000, "snappy",
                  True, page_bytes=8192)
    comp, clen, ulen, g = snappy_torn_set(path, DEV)
    path.unlink()
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
         for x in (comp, clen, ulen)]
    w1 = walk_case(torch, pqk, "snappy_walk",
                   f"torn set ({comp.shape[0]} rows)", (*a, g.ub, g.tb),
                   hop)
    return {"snappy_walk": w1, "hybrid_decode": w2}


def phase_decode_kernels(torch, root, fact_path, seed: int,
                         matrix_rows: int) -> dict:
    """K3 on its own contract and on real page planes (4 and 8 bytes, with
    nulls); W1 on literal-only and copy-bearing pages; W2 on def levels and
    dictionary indices; then W1 and W2 on their torn sets.  Bit-exact,
    timed (CUDA events; plain versions by wall clock, the W1/W2 ones being
    Python loops)."""
    from spark_rapids_jni_tpu_torch.io.parquet import (ParquetFile,
                                                       plan_device_group)
    from spark_rapids_jni_tpu_torch.kernels import parquet_decode as pqk
    from spark_rapids_jni_tpu_torch.ops import parquet_decode as pqd

    def err(a, b):
        a, b = [x.cpu() for x in a], [x.cpu() for x in b]
        return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                   if x.numel() else 0 for x, y in zip(a, b))

    out = {"plain_gather": {"cases": []}, "snappy_walk": {"cases": []},
           "hybrid_decode": {"cases": []}}
    hop = out["hop_ns"] = hop_ns(torch, pqk)
    # K3's own contract: u8 (blk, 512) -> u32 (blk, 128), voff 0, nn arange
    blk = 1 << 16
    gen = torch.Generator(device=DEV).manual_seed(seed)
    unc = torch.randint(0, 256, (blk, 512), dtype=torch.uint8, device=DEV,
                        generator=gen)
    voff = torch.zeros(blk, dtype=torch.int32, device=DEV)
    nn = torch.arange(128, dtype=torch.int32, device=DEV).expand(blk, 128) \
        .contiguous()
    cases = [("contract (blk=2^16, 512 B)", (unc, voff, nn, 4))]

    # real planes: the fact file's group 0 and a copy-bearing, nullable
    # plain file; each wrapper's largest captured call per column
    mcols = matrix_columns(matrix_rows, seed, "plain", "sparse", True)
    mpath = root / "k_copies.parquet"
    write_parquet(mpath, mcols, matrix_rows, "snappy", True)
    walks = []
    for path, label in ((fact_path, "store_sales"), (mpath, "copies")):
        pf = ParquetFile(path)
        chunk, reason = plan_device_group(pf, 0, None, None, DEV)
        check(chunk is not None, f"{label}: planned ({reason})")
        planes = chunk.to_device(DEV)
        for g in chunk.geom.columns:
            calls = capture_decode_calls(pqk, pqd, {g.name: planes[g.name]},
                                         pqd.ChunkGeom((g,), chunk.geom.rb))
            tag = f"{label}.{g.name}"
            for a in calls["plain_gather"]:
                if a[3] == 8 or (a[3] == 4 and g.max_def > 0) or \
                        g.name == "ss_quantity":
                    cases.append((f"{tag} size {a[3]}", a))
            for a in calls["snappy_walk"]:
                walks.append(("snappy_walk", tag, a))
            for k, a in enumerate(calls["hybrid_decode"]):
                what = "def levels" if g.max_def > 0 and k == 0 else "indices"
                walks.append(("hybrid_decode", f"{tag} {what}", a))
    mpath.unlink()

    for label, (u, vo, n_, size) in cases:
        got = pqk.plain_gather(u, vo, n_, size)
        want = pqk.plain_gather_plain(u, vo, n_, size)
        torch.cuda.synchronize()
        e = err([got], [want])
        check(e == 0, f"K3 plain_gather bit-exact on {label}")
        r, v = n_.shape
        out["plain_gather"]["cases"].append({
            "case": label, "shape": [r, v], "size": size,
            "max_abs_err": e,
            "ms": cuda_ms(torch, lambda: pqk.plain_gather(u, vo, n_, size)),
            "plain_ms": cuda_ms(torch, lambda: pqk.plain_gather_plain(
                u, vo, n_, size), iters=5, warmup=1),
            "bound_ms": r * v * (4 + 2 * size) / HBM_BYTES_PER_S * 1e3})
    # the library call for K3's contract: one torch.gather of the bytes at
    # int64 offsets (built outside the timed call), viewed as words
    c0 = out["plain_gather"]["cases"][0]
    flat = (voff.to(torch.int64)[:, None, None]
            + nn.to(torch.int64)[:, :, None] * 4
            + torch.arange(4, device=DEV)).reshape(blk, 512)

    def library():
        return torch.gather(unc, 1, flat).view(torch.int32)
    lib = library()
    check(err([lib], [pqk.plain_gather(unc, voff, nn, 4)]) == 0,
          "K3's library call == K3 on its contract")
    c0["library_ms"] = cuda_ms(torch, library)
    del flat, lib

    for name, tag, a in walks:
        out[name]["cases"].append(walk_case(torch, pqk, name, tag, a, hop))
    for name, case in phase_torn_walks(torch, pqk, root, seed, hop).items():
        out[name]["torn"] = case
    for name in ("plain_gather", "snappy_walk", "hybrid_decode"):
        k = out[name]
        check(k["cases"], f"{name} was checked")
        k["max_abs_err"] = max(c["max_abs_err"] for c in
                               k["cases"] + ([k["torn"]] if "torn" in k
                                             else []))
    return out


# ---------------------------------------------------------------------------
# 8. q5-lite over the three files, by both routes
# ---------------------------------------------------------------------------

def phase_q5(torch, root, fact, dates, stores, pqk, tracing) -> dict:
    want = q5_oracle(fact, dates, stores, *Q5_DATES)
    n_fact = len(fact[0][2])
    out = {"phase": "q5", "dates": list(Q5_DATES), "fact_rows": n_fact,
           "names": len(want)}
    for route in ("device", "host"):
        times = []
        for rep in range(2):
            if route == "device" and rep == 1:
                tracing.reset_counters("kernel.")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, info = q5_lite(root, route, DEV, *Q5_DATES,
                                columns=Q5_COLUMNS, prefetch=1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if route == "device" and rep == 1:
                out["launches"] = {name: pqk.launches(name) for name in
                                   ("plain_gather", "snappy_walk",
                                    "hybrid_decode")}
            check(q5_matches(got, want),
                  f"q5-lite by the {route} route == numpy oracle")
        out[route] = {"cold_s": times[0], "warm_s": times[1],
                      "groups_read": info["groups_read"],
                      "groups_pruned": info["groups_pruned"],
                      "fallbacks": info.get("fallbacks", []),
                      "file_rows_per_s": n_fact / times[1],
                      "rows_read": info["rows"],
                      "rows_read_per_s": info["rows"] / times[1]}
    for route in ("device", "host"):
        out[route]["profile"] = profile_top(torch, lambda: q5_lite(
            root, route, DEV, *Q5_DATES, columns=Q5_COLUMNS, prefetch=1))
    check(out["device"]["fallbacks"] == [("store.parquet", "physical_type")],
          "device route: only the STRING store file falls back")
    check(out["device"]["groups_pruned"] > 0, "footer pruning engaged")
    for name, count in out["launches"].items():
        check(count > 0, f"q5's device route launched {name}")
    return out


# ---------------------------------------------------------------------------
# 9. q5-lite as an engine plan: optimize, then execute by both routes
# ---------------------------------------------------------------------------

Q5_TWO_YEARS = (2451545, 2452275)  # 2000-2001: 7 of 16 groups read
DECODE_KERNELS = ("plain_gather", "snappy_walk", "hybrid_decode")


def q5_engine_plan(root, date_lo: int, date_hi: int):
    """tests/test_engine_e2e.py::q5_plan over the script's files: the date
    filter sits ABOVE the semi join, so the optimizer has to split it,
    sink it onto the fact side and feed the scan predicate."""
    from spark_rapids_jni_tpu_torch.engine import (Aggregate, Filter, Join,
                                                   Scan, col, lit)
    root = Path(root)
    between = ("&", (">=", col("ss_sold_date_sk"), lit(date_lo)),
               ("<=", col("ss_sold_date_sk"), lit(date_hi)))
    dates_f = Filter(Scan(root / "date_dim.parquet"),
                     ("&", (">=", col("d_date_sk"), lit(date_lo)),
                      ("<=", col("d_date_sk"), lit(date_hi))))
    sales = Scan(root / "store_sales.parquet", chunk_bytes=64 << 20)
    kept = Filter(Join(sales, dates_f, ["ss_sold_date_sk"], ["d_date_sk"],
                       how="semi"), between)
    totals = Aggregate(kept, ["ss_store_sk"],
                       [("ss_ext_sales_price", "sum"),
                        ("ss_net_profit", "sum"),
                        ("ss_ext_sales_price", "count")],
                       names=["sales", "profit", "n"])
    joined = Join(totals, Scan(root / "store.parquet"),
                  ["ss_store_sk"], ["s_store_sk"], how="inner")
    return Aggregate(joined, ["s_store_name"],
                     [("sales", "sum"), ("profit", "sum"), ("n", "sum")],
                     names=["sales", "profit", "n"])


def engine_result(table) -> dict:
    return {nm: (s, p, int(n)) for nm, s, p, n in zip(
        table["s_store_name"].to_pylist(), table["sales"].to_pylist(),
        table["profit"].to_pylist(), table["n"].to_pylist())}


def count_syncs(torch, fn):
    """The synchronising CUDA calls ``fn`` makes, from every thread, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: their count
    and the Python lines that made them (file:line -> count)."""
    import collections
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # "called a synchronizing CUDA operation" marks each sync; the mode's
    # own once-a-process notice ("... prototype feature and does not yet
    # detect all synchronizing operations") is not one
    sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in seen
        if "called a synchronizing" in str(w.message))
    return sum(sites.values()), dict(sites)


def phase_engine(torch, root, fact, dates, stores, pqk, tracing, q5,
                 copy_gbps: float) -> dict:
    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.engine.plan import topo_nodes
    from spark_rapids_jni_tpu_torch.utils.config import config
    n_fact = len(fact[0][2])
    want = q5_oracle(fact, dates, stores, *Q5_DATES)
    out = {"phase": "engine", "dates": list(Q5_DATES), "fact_rows": n_fact}

    plan = q5_engine_plan(root, *Q5_DATES)
    t0 = time.perf_counter()
    opt = pe.optimize(plan)
    out["optimize_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pe.optimize(q5_engine_plan(root, *Q5_DATES))
    out["optimize_warm_ms"] = (time.perf_counter() - t0) * 1e3
    fact_scan = [n for n in topo_nodes(opt) if isinstance(n, pe.Scan)
                 and n.path.endswith("store_sales.parquet")][0]
    out["scan_predicate"] = list(fact_scan.predicate)
    out["scan_columns"] = list(fact_scan.columns)
    check(fact_scan.predicate == ("ss_sold_date_sk", *Q5_DATES),
          "the date filter reached the fact scan's pruning predicate")

    def run(route, p=opt, stats=None, fused=None):
        # the device route is the default on a card; the host route is
        # pinned for the comparison
        config.device_decode = None if route == "device" else False
        try:
            return pe.execute(p, stats=stats, fused=fused, device=DEV)
        finally:
            config.device_decode = None

    for route in ("device", "host"):
        rec = {}
        for rep in ("cold", "warm"):
            stats = pe.new_stats()
            tracing.reset_counters("engine.segment.")
            f0 = tracing.counter_value("io.device_decode.fallbacks")
            if rep == "warm" and route == "device":
                tracing.reset_counters("kernel.")
            result, secs = wall(torch, lambda: run(route, stats=stats))
            if rep == "warm" and route == "device":
                out["launches"] = {k: pqk.launches(k)
                                   for k in DECODE_KERNELS}
            check(q5_matches(engine_result(result), want),
                  f"engine q5 by the {route} route ({rep}) == numpy oracle")
            rec[rep] = {
                "s": secs,
                "stats": {k: stats[k] for k in (
                    "row_groups_pruned", "row_groups_read", "chunks",
                    "streamed", "fused_segments")},
                "segment_compile": tracing.counter_value(
                    "engine.segment.compile"),
                "segment_replay": tracing.counter_value(
                    "engine.segment.replay"),
                "fallbacks": tracing.counter_value(
                    "io.device_decode.fallbacks") - f0}
            check(stats["row_groups_pruned"] > 0, "row groups were pruned")
            check(stats["streamed"] and stats["fused_segments"] == 1,
                  f"the {route} route streamed through one fused segment")
            check(rec[rep]["fallbacks"] == 0,
                  f"{route} route: no device-decode fallback on the fact "
                  "file")
        rec["file_rows_per_s"] = n_fact / rec["warm"]["s"]
        out[route] = rec
    dd = [d for d in opt._decisions if d["kind"] == "scan:device_decode"]
    out["device_decode_ledger"] = dd[-1]
    check(all(d["choice"] == "device" and d["host_chunks"] == 0
              and not d["reasons"] for d in dd),
          "every fact chunk decoded on the device (ledger)")
    for name, count in out["launches"].items():
        check(count > 0, f"the engine's device route launched {name}")

    # the interpreted per-chunk loop (fused=False; also what a schema veto
    # or the out-of-memory step down runs) decodes on the card too
    tracing.reset_counters("kernel.")
    stats = pe.new_stats()
    result, out["interp_s"] = wall(
        torch, lambda: run("device", stats=stats, fused=False))
    check(q5_matches(engine_result(result), want),
          "engine q5 by the interpreted device route == numpy oracle")
    out["interp_launches"] = {k: pqk.launches(k) for k in DECODE_KERNELS}
    check(all(out["interp_launches"][k] >= stats["chunks"] > 0
              for k in DECODE_KERNELS),
          "the interpreted device route decodes every chunk on the card")

    # the plan cache: a plan rebuilt from its bytes is the same object
    cache = pe.PlanCache()
    first = cache.get(q5_engine_plan(root, *Q5_DATES))
    r1 = engine_result(first.execute(device=DEV))
    second = cache.get(pe.deserialize(
        q5_engine_plan(root, *Q5_DATES).serialize()))
    r2 = engine_result(second.execute(device=DEV))
    check(second is first, "PlanCache returns the same CompiledPlan")
    # the same answer: names and counts exact, sums within rel 1e-9 (the
    # card's atomics add in no fixed order)
    check(q5_matches(r1, want) and q5_matches(r2, r1),
          "the cached plan gives the same answer")
    out["plan_cache"] = cache.stats()

    # host syncs of one warm device-route execute at 4 and 7 groups read
    syncs = {}
    for lo, hi in (Q5_DATES, Q5_TWO_YEARS):
        p = pe.optimize(q5_engine_plan(root, lo, hi))
        run("device", p)  # warm the segment and build caches
        stats = pe.new_stats()
        box = {}
        n, sites = count_syncs(torch, lambda: box.update(
            r=run("device", p, stats)))
        check(q5_matches(engine_result(box["r"]),
                         q5_oracle(fact, dates, stores, lo, hi)),
              f"engine q5 over {lo}..{hi} == numpy oracle")
        syncs[f"{lo}..{hi}"] = {"groups_read": stats["row_groups_read"],
                                "chunks": stats["chunks"], "syncs": n,
                                "sites": sites}
    (a, b) = syncs.values()
    out["syncs"] = syncs
    emit({"phase": "engine_syncs", **syncs})
    out["syncs_per_chunk"] = (b["syncs"] - a["syncs"]) / \
        (b["chunks"] - a["chunks"])
    check(b["chunks"] > a["chunks"] and b["syncs"] <= a["syncs"],
          "the device route makes no host sync per streamed chunk")

    for route in ("device", "host"):
        out[route]["profile"] = profile_top(torch, lambda: run(route))
    out["q5_hand_wired_warm_s"] = {r: q5[r]["warm_s"]
                                   for r in ("device", "host")}

    config.roofline_gbps = copy_gbps
    try:
        rep = pe.explain_analyze(q5_engine_plan(root, *Q5_DATES),
                                 device=DEV)
    finally:
        config.roofline_gbps = 0.0
    check(q5_matches(engine_result(rep.result), want),
          "explain_analyze's result == numpy oracle")
    out["roofline_gbps"] = copy_gbps
    print(rep.text, flush=True)
    return out


# ---------------------------------------------------------------------------
# 10. ops: every op of the spark-rapids-jni surface at full width
# ---------------------------------------------------------------------------

CPU_SLICE = 1 << 20      # rows of the CPU runs the card is held against
ORACLE_ROWS = 1 << 16    # rows each independent oracle checks
OPS_PARTITIONS = 1000
TZ_ZONES = ("America/Los_Angeles", "Asia/Kolkata")
BLOOM_FPP = 0.03


def col_head(col, m: int):
    """The first ``m`` rows of a column (STRING and LIST offsets rebased
    from 0 already: every column here starts at offset 0)."""
    from spark_rapids_jni_tpu_torch.columnar import Column
    m = min(m, col.size)
    valid = None if col.validity is None else col.validity[:m]
    if col.offsets is not None:
        offs = col.offsets[:m + 1]
        if col.children:
            child = col_head(col.children[0], int(offs[-1]))
            return Column(col.dtype, validity=valid, offsets=offs,
                          children=(child,))
        return Column(col.dtype, data=col.data[:int(offs[-1])],
                      validity=valid, offsets=offs)
    return Column(col.dtype, data=col.data[:m], validity=valid)


def same_column(a, b) -> bool:
    """Bit-exact equality of two port columns on any devices: type,
    validity (None-ness too), data bits, offsets and children."""
    import torch

    def host(t):
        return None if t is None else t.detach().cpu().contiguous()

    def bits(t):
        t = host(t)
        return None if t is None else t.view(torch.uint8).reshape(-1) \
            if t.dtype != torch.bool else t

    if a.dtype != b.dtype or (a.validity is None) != (b.validity is None):
        return False
    for x, y in ((a.validity, b.validity), (a.offsets, b.offsets),
                 (a.data, b.data)):
        x, y = bits(x), bits(y)
        if (x is None) != (y is None) or (x is not None and (
                x.shape != y.shape or not torch.equal(x, y))):
            return False
    return len(a.children) == len(b.children) and all(
        same_column(x, y) for x, y in zip(a.children, b.children))


def column_bytes(col) -> int:
    """Bytes of a column's buffers (data, validity, offsets, children)."""
    return sum(t.numel() * t.element_size()
               for t in (col.data, col.validity, col.offsets)
               if t is not None) + sum(column_bytes(c) for c in col.children)


def first_differences(torch, a, b, x, k: int = 6) -> dict:
    """Where two fixed-width columns differ: up to ``k`` rows with both
    values and validity, and the numeric-string input of those rows."""
    if a.offsets is not None or b.offsets is not None:
        return {"offsets_equal": bool(torch.equal(a.offsets.cpu(),
                                                  b.offsets.cpu()))}
    da = a.data.cpu().contiguous().view(torch.uint8).reshape(a.size, -1)
    db = b.data.cpu().contiguous().view(torch.uint8).reshape(b.size, -1)
    bad = (da != db).any(1) | (a.valid_mask().cpu() != b.valid_mask().cpu())
    rows = torch.nonzero(bad)[:k, 0].tolist()
    chars, offs, _ = x["num"]
    return {"count": int(bad.sum()), "rows": [
        {"row": r, "card": da[r].numpy().tobytes()[::-1].hex(),
         "cpu": db[r].numpy().tobytes()[::-1].hex(), "card_valid": bool(a.valid_mask()[r]),
         "cpu_valid": bool(b.valid_mask()[r]),
         "num_input": bytes(chars[offs[r]:offs[r + 1]]).decode()}
        for r in rows]}


PROFILED_CALLS = 3


def time_op(torch, fn) -> dict:
    """Cold call, warm wall time, and ``PROFILED_CALLS`` calls under the
    profiler and ``set_sync_debug_mode("warn")``: launches, device time and
    sync count a call, busy share."""
    out = fn()
    torch.cuda.synchronize()
    _, warm = wall(torch, fn)
    prof = {"launches": 0}
    for _ in range(3):  # a short session can come back with no device events
        syncs, sites = count_syncs(torch, lambda: prof.update(profile_top(
            torch, lambda: [fn() for _ in range(PROFILED_CALLS)], top=3)))
        if prof["launches"]:
            break
    return out, {"warm_s": warm,
                 "launches": prof["launches"] / PROFILED_CALLS,
                 "device_ms": prof["device_ms"] / PROFILED_CALLS,
                 "busy_share": prof["busy_share"],
                 "syncs": syncs / PROFILED_CALLS,
                 "sync_sites": dict(sorted(sites.items(),
                                           key=lambda kv: -kv[1])[:4])}


def _py_int(s: str):
    """Spark CAST(string AS BIGINT), by Python int(): None when invalid."""
    import re
    t = s.strip("".join(chr(c) for c in range(33)))
    m = re.fullmatch(r"([+-]?)(\d*)(?:\.(\d*))?", t)
    if not m or not (m.group(2) or m.group(3)):
        return None
    v = int(m.group(2) or "0")
    v = -v if m.group(1) == "-" else v
    return v if -2**63 <= v < 2**63 else None


def _py_float(s: str):
    """Spark CAST(string AS DOUBLE) on Java parseDouble's syntax (trailing
    d/D/f/F allowed), by Python float(): None when invalid."""
    import re
    t = s.strip("".join(chr(c) for c in range(33)))
    if len(t) > 1 and t[-1] in "dDfF":
        t = t[:-1]
    m = re.fullmatch(r"[+-]?(\d*)\.?(\d*)(?:[eE]([+-]?\d+))?", t)
    if not m or not (m.group(1) or m.group(2)):
        return None
    # a zero mantissa reads 0.0 whatever the exponent ("0e999"), as in
    # Java and the port (the JAX package reads 0 x inf = NaN)
    return float(t)


def _py_decimal(s: str, scale: int):
    """Spark CAST(string AS DECIMAL) at ``scale`` (cudf convention), by
    decimal.Decimal with HALF_UP: the unscaled value, None when invalid."""
    import decimal
    import re
    t = s.strip("".join(chr(c) for c in range(33)))
    if not re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", t):
        return None
    with decimal.localcontext() as ctx:
        ctx.prec = 400
        try:
            q = decimal.Decimal(t).scaleb(-scale).quantize(
                decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP)
        except decimal.DecimalException:  # past 400 digits or Emax: overflow
            return None
    return int(q) if -2**63 <= q < 2**63 else None


def _murmur_long_py(v: int, seed: int) -> int:
    """Spark Murmur3_x86_32.hashLong in Python (u32 result)."""
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    def mix(h, k):
        k = rotl((k * 0xCC9E2D51) & M, 15) * 0x1B873593 & M
        return (rotl(h ^ k, 13) * 5 + 0xE6546B64) & M
    h = mix(mix(seed & M, v & M), (v >> 32) & M)
    h ^= 8
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    return h ^ (h >> 16)


def _murmur_py(words, tail: bytes, length: int, seed: int) -> int:
    """Spark Murmur3_x86_32 over 32-bit ``words``, then each ``tail`` byte
    mixed on its own as a sign-extended int (hashUnsafeBytes), finalized
    with ``length`` (u32 result)."""
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    def mix(h, k):
        k = rotl((k * 0xCC9E2D51) & M, 15) * 0x1B873593 & M
        return (rotl(h ^ k, 13) * 5 + 0xE6546B64) & M
    h = seed & M
    for w in words:
        h = mix(h, w & M)
    for b in tail:
        h = mix(h, (b - 256 if b > 127 else b) & M)
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    return h ^ (h >> 16)


def spark_partition_py(value, n: int, seed: int = 42) -> int:
    """Spark HashPartitioning of one INT32 or STRING key (None: the seed
    passes through): pmod(murmur3(value), n), in Python."""
    if value is None:
        h = seed
    elif isinstance(value, (bytes, str)):
        b = value.encode() if isinstance(value, str) else value
        nb = len(b) // 4 * 4
        h = _murmur_py([int.from_bytes(b[i:i + 4], "little")
                        for i in range(0, nb, 4)], b[nb:], len(b), seed)
    else:
        h = _murmur_py([int(value)], b"", 4, seed)
    return (h - (1 << 32) if h >= 1 << 31 else h) % n


def _bloom_positions_py(item: int, k: int, num_bits: int):
    """Spark BloomFilterImpl's bit positions of one long item."""
    def s32(u):
        return u - (1 << 32) if u >= 1 << 31 else u
    h1 = s32(_murmur_long_py(item & (2**64 - 1), 0))
    h2 = s32(_murmur_long_py(item & (2**64 - 1), h1 & 0xFFFFFFFF))
    out = []
    for i in range(1, k + 1):
        c = s32((h1 + i * h2) & 0xFFFFFFFF)
        out.append((~c if c < 0 else c) % num_bits)
    return out


def _interleave_py(vals, w: int) -> bytes:
    bits = [(vals[t % len(vals)] >> (w - 1 - t // len(vals))) & 1
            for t in range(len(vals) * w)]
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def ops_inputs(n: int, n_str: int, seed: int) -> dict:
    """numpy inputs of the ops phase."""
    rng = np.random.default_rng(seed + 23)
    lo = -2208988800            # 1900-01-01
    hi = 4102444800             # 2100-01-01
    return {
        "i64": rng.integers(-2**62, 2**62, n) // 10 ** rng.integers(0, 18, n),
        "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "f64": rng.standard_normal(n) * 10.0 ** rng.integers(-8, 12, n),
        "d64": rng.integers(-10**12, 10**12, n),
        "d128_hi": rng.integers(-2**40, 2**40, n),
        "ts_us": rng.integers(lo, hi, n) * 10**6 + rng.integers(0, 10**6, n),
        "days": rng.integers(-25567, 47482, n).astype(np.int32),
        "part": rng.integers(0, OPS_PARTITIONS, n),
        "valid": rng.random(n) >= 0.02,
        "num": numeric_strings(rng, n_str),
        "text": text_strings(rng, n_str),
    }


def phase_ops(torch, tracing, n: int, n_str: int, seed: int) -> dict:
    import datetime as _dt
    import decimal
    import math
    from zoneinfo import ZoneInfo
    from spark_rapids_jni_tpu_torch import dtypes as D
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops import (binary, bloom_filter,
                                                cast_strings, datetime,
                                                dictionary, regex_rewrite,
                                                strings, timezone, window,
                                                zorder)
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.cast import cast
    from spark_rapids_jni_tpu_torch.ops.order import SortKey
    from spark_rapids_jni_tpu_torch.ops.selection import distinct
    x = ops_inputs(n, n_str, seed)
    valid = x["valid"]
    ts_dtype = D.TIMESTAMP_MICROSECONDS
    d128 = np.stack([x["d64"] * 7919, x["d128_hi"]], axis=1)

    def columns(dev, rows, srows):
        def fx(dtype, a, v=True):
            return Column.fixed(dtype, a[:rows], valid[:rows] if v else None,
                                device=dev)

        def st(key):
            chars, offs, ok = x[key]
            return Column.string(chars[:offs[srows]], offs[:srows + 1],
                                 ok[:srows], device=dev)
        return {"i64": fx(D.INT64, x["i64"]), "i32": fx(D.INT32, x["i32"]),
                "f64": fx(D.FLOAT64, x["f64"]),
                "d64": fx(D.decimal64(-2), x["d64"]),
                "d128": fx(D.decimal128(-4), d128),
                "ts": fx(ts_dtype, x["ts_us"]),
                "date": fx(D.TIMESTAMP_DAYS, x["days"]),
                "part": fx(D.INT64, x["part"], False),
                "o": fx(D.INT32, x["i32"] % 4096, False),
                "num": st("num"), "text": st("text")}

    dev = columns(DEV, n, n_str)
    cpu = columns("cpu", CPU_SLICE, CPU_SLICE)
    nb = bloom_filter.optimal_num_bits(n, BLOOM_FPP)
    nh = bloom_filter.optimal_num_hashes(n, nb)
    win_specs = [(None, "row_number"), ("i64", "sum"), ("f64", "min"),
                 ("f64", "max")]

    def win(c):
        t = Table([c["part"], c["o"], c["i64"], c["f64"]],
                  ["p", "o", "i64", "f64"])
        return list(window.window(t, ["p"], ["o"], win_specs).columns[-4:])

    # (name, rows, fn(columns) -> column or list of columns, row-wise)
    cases = [
        ("cast_to_integer", n_str,
         lambda c: cast_strings.cast_to_integer(c["num"], D.INT64), True),
        ("cast_to_float", n_str,
         lambda c: cast_strings.cast_to_float(c["num"], D.FLOAT64), True),
        ("cast_to_decimal", n_str, lambda c: cast_strings.cast_to_decimal(
            c["num"], D.decimal64(-2)), True),
        ("cast_to_bool", n_str,
         lambda c: cast_strings.cast_to_bool(c["num"]), True),
        ("cast_from_integer", n,
         lambda c: cast_strings.cast_from_integer(c["i64"]), True),
        ("cast_from_decimal", n,
         lambda c: cast_strings.cast_from_decimal(c["d64"]), True),
        ("cast_from_decimal128", n,
         lambda c: cast_strings.cast_from_decimal(c["d128"]), True),
        ("cast_from_float", n,
         lambda c: cast_strings.cast_from_float(c["f64"]), True),
        ("cast_from_datetime", n,
         lambda c: cast_strings.cast_from_datetime(c["ts"]), True),
        ("cast_from_date", n,
         lambda c: cast_strings.cast_from_datetime(c["date"]), True),
        ("cast_i64_i32", n, lambda c: cast(c["i64"], D.INT32), True),
        ("cast_f64_i64", n, lambda c: cast(c["f64"], D.INT64), True),
        ("cast_i32_f64", n, lambda c: cast(c["i32"], D.FLOAT64), True),
        ("cast_f64_decimal64", n,
         lambda c: cast(c["f64"], D.decimal64(-2)), True),
        ("cast_decimal64_decimal128", n,
         lambda c: cast(c["d64"], D.decimal128(-6)), True),
        ("cast_decimal128_decimal64", n,
         lambda c: cast(c["d128"], D.decimal64(-2)), True),
        ("cast_f64_decimal128", n,
         lambda c: cast(c["f64"], D.decimal128(-2)), True),
        ("year", n, lambda c: datetime.year(c["ts"]), True),
        ("add_i64", n, lambda c: binary.add(c["i64"], c["i32"]), True),
        ("divide_f64", n,
         lambda c: binary.true_divide(c["f64"], c["i32"]), True),
        ("lt_f64", n, lambda c: binary.lt(c["f64"], c["i64"]), True),
        ("char_length", n_str, lambda c: strings.char_length(c["text"]),
         True),
        ("upper", n_str, lambda c: strings.upper(c["text"]), True),
        ("substring", n_str, lambda c: strings.substring(c["text"], 2, 5),
         True),
        ("contains", n_str, lambda c: strings.contains(c["text"], "an"),
         True),
        ("find", n_str, lambda c: strings.find(c["text"], "-"), True),
        ("replace", n_str,
         lambda c: strings.replace(c["text"], "-", "__"), True),
        ("split_part", n_str,
         lambda c: strings.split_part(c["text"], "-", 2), True),
        ("split", n_str, lambda c: strings.split(c["text"], "-"), True),
        ("trim", n_str, lambda c: strings.trim(c["text"]), True),
        ("lpad", n_str, lambda c: strings.lpad(c["text"], 16, "*"), True),
        ("concat", n_str,
         lambda c: strings.concat(c["text"], c["num"]), True),
        ("like", n_str, lambda c: strings.like(c["text"], "%a_e%"), True),
        ("regex_rewritable", n_str,
         lambda c: regex_rewrite.regex_matches(c["text"], "^cat"), True),
        ("regex_host_escape", n_str,
         lambda c: regex_rewrite.regex_matches(c["text"], PREDICATE), True),
        *[(f"utc_to_local:{z}", n,
           lambda c, z=z: timezone.utc_to_local(c["ts"], z), True)
          for z in TZ_ZONES],
        *[(f"local_to_utc:{z}", n,
           lambda c, z=z: timezone.local_to_utc(c["ts"], z), True)
          for z in TZ_ZONES],
        ("interleave_bits_2x64", n, lambda c: zorder.interleave_bits(
            Table([c["i64"], c["d64"]])), True),
        ("interleave_bits_3x32", n, lambda c: zorder.interleave_bits(
            Table([c["i32"], c["date"], cast(c["i64"], D.INT32)])), True),
        ("bloom_build", n, lambda c: Column(D.BOOL8, data=bloom_filter
                                            .bloom_build(c["i64"], nb, nh)
                                            .to(torch.uint8)), False),
        ("bloom_probe", n, lambda c: bloom_filter.bloom_might_contain(
            bloom_filter.bloom_build(c["i64"], nb, nh), c["d64"], nh), False),
        ("window", n, win, False),
        ("dictionary_encode", n_str,
         lambda c: list(dictionary.dictionary_encode(c["text"])), False),
        ("distinct", n, lambda c: list(distinct(Table(
            [c["part"], cast(c["i32"], D.INT8)], ["p", "b"])).columns),
         False),
        ("nunique", n, lambda c: list(groupby(Table(
            [c["part"], cast(c["i32"], D.INT8)], ["p", "b"]), ["p"],
            [("b", "nunique")], device=c["part"].device).columns), False),
        ("collect_list", n, lambda c: list(groupby(Table(
            [c["part"], cast(c["i32"], D.INT8)], ["p", "b"]), ["p"],
            [("b", "collect_list")], device=c["part"].device).columns), False),
    ]
    # the columns each op reads, for its memory-bound time
    reads = {"add_i64": ("i64", "i32"), "divide_f64": ("f64", "i32"),
             "lt_f64": ("f64", "i64"), "concat": ("text", "num"),
             "interleave_bits_2x64": ("i64", "d64"),
             "interleave_bits_3x32": ("i32", "date", "i64"),
             "bloom_probe": ("i64", "d64"),
             "window": ("part", "o", "i64", "f64"),
             "distinct": ("part", "i32"), "nunique": ("part", "i32"),
             "collect_list": ("part", "i32")}
    for name, _, _, _ in cases:
        if name not in reads:
            key = {"cast_to": "num", "cast_from_integer": "i64",
                   "cast_from_decimal128": "d128", "cast_from_decimal": "d64",
                   "cast_from_float": "f64", "cast_from_datetime": "ts",
                   "cast_from_date": "date", "cast_i64": "i64",
                   "cast_f64": "f64", "cast_i32": "i32",
                   "cast_decimal64": "d64", "cast_decimal128": "d128",
                   "year": "ts", "utc_to": "ts", "local_to": "ts",
                   "bloom_build": "i64"}
            reads[name] = tuple(v for k, v in key.items()
                                if name.startswith(k))[:1] or ("text",)
    out = {"phase": "ops", "rows": n, "string_rows": n_str,
           "cpu_slice": CPU_SLICE, "oracle_rows": ORACLE_ROWS,
           "bloom": {"num_bits": nb, "num_hashes": nh}, "ops": {}}
    results = {}
    for name, rows, fn, rowwise in cases:
        tracing.reset_counters("ops.regex.")
        res, rec = time_op(torch, lambda: fn(dev))
        rec["rows"] = rows
        rec["rows_per_s"] = rows / rec["warm_s"]
        if name == "regex_host_escape":
            rec["host_fallbacks"] = tracing.counter_value(
                "ops.regex.host_fallback")
            check(rec["host_fallbacks"] > 0, "the host escape was taken")
        got = res if isinstance(res, list) else [res]
        # bound: each input read once, each output written once
        rec["bytes"] = sum(column_bytes(dev[k]) for k in reads[name]) + \
            sum(column_bytes(g) for g in got)
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        rec["x_bound"] = rec["warm_s"] * 1e3 / rec["bound_ms"]
        if rowwise:
            want = fn(cpu)
            want = want if isinstance(want, list) else [want]
            got_cmp = [col_head(g, CPU_SLICE) for g in got]
        else:  # the same op on the first 2^20 rows, card and CPU
            small = columns(DEV, CPU_SLICE, CPU_SLICE)
            got_cmp = fn(small)
            got_cmp = got_cmp if isinstance(got_cmp, list) else [got_cmp]
            want = fn(cpu)
            want = want if isinstance(want, list) else [want]
        same = len(got_cmp) == len(want) and all(
            same_column(g, w) for g, w in zip(got_cmp, want))
        if not same:
            emit({"phase": "ops_mismatch", "op": name,
                  **first_differences(torch, got_cmp[0], want[0], x)})
        check(same, f"{name} on the card == the port on the CPU, bit for bit")
        results[name] = got
        out["ops"][name] = rec
        emit({"phase": "ops_case", "op": name, **rec})

    # independent oracles on a 65,536-row sample
    m = ORACLE_ROWS
    nchars, noffs, nok = x["num"]
    strs = [bytes(nchars[noffs[i]:noffs[i + 1]]).decode() for i in range(m)]
    ints = col_head(results["cast_to_integer"][0], m).to_pylist()
    check(ints == [(_py_int(s) if ok else None) for s, ok in
                   zip(strs, nok[:m])], "cast_to_integer == Python int()")
    decs = col_head(results["cast_to_decimal"][0], m)
    dv = decs.to_numpy()
    dok = decs.validity_numpy()
    want_d = [(_py_decimal(s, -2) if ok else None) for s, ok in
              zip(strs, nok[:m])]
    check(all((w is None and not k) or (k and int(v) == w)
              for v, k, w in zip(dv.tolist(), dok.tolist(), want_d)),
          "cast_to_decimal == decimal.Decimal HALF_UP")
    fl = col_head(results["cast_to_float"][0], m)
    fv, fok = fl.to_numpy(), fl.validity_numpy()
    want_f = [(_py_float(s) if ok else None) for s, ok in zip(strs, nok[:m])]
    check(fok.tolist() == [w is not None for w in want_f],
          "cast_to_float validity == Python float() on Java's syntax")
    # the port parses with two roundings (the digits, then the power of
    # ten): within 2 ulp of Python's correctly rounded float()
    check(all(w is None or v == w or abs(v - w) <= 4.5e-16 * abs(w)
              or (math.isnan(v) and math.isnan(w))
              for v, w in zip(fv.tolist(), want_f)),
          "cast_to_float values within 2 ulp of Python float()")
    out["cast_to_float_zero_mantissa_rows"] = sum(
        w is not None and w == 0.0 and any(c in "eE" for c in s)
        for s, w in zip(strs, want_f))
    i64 = x["i64"][:m]
    check(col_head(results["cast_from_integer"][0], m).to_pylist() ==
          [str(int(v)) if ok else None for v, ok in zip(i64, valid[:m])],
          "cast_from_integer == str(int)")
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        check(col_head(results["cast_from_decimal"][0], m).to_pylist() ==
              [f"{decimal.Decimal(int(v)).scaleb(-2):.2f}" if ok else None
               for v, ok in zip(x["d64"][:m], valid[:m])],
              "cast_from_decimal == decimal.Decimal")
        want128 = [f"{decimal.Decimal((int(h) << 64) + (int(lo) & (2**64 - 1))).scaleb(-4):.4f}"  # noqa: E501
                   if ok else None for lo, h, ok in
                   zip(d128[:m, 0], d128[:m, 1], valid[:m])]
        check(col_head(results["cast_from_decimal128"][0], m).to_pylist()
              == want128, "cast_from_decimal on DECIMAL128 == Decimal")
    fs = col_head(results["cast_from_float"][0], m).to_pylist()
    check(all(s is None or float(s.replace("E", "e")) == v
              for s, v in zip(fs, x["f64"][:m].tolist())),
          "cast_from_float round-trips every value (Java's shortest digits)")
    epoch = _dt.datetime(1970, 1, 1)
    want_ts = []
    for us, ok in zip(x["ts_us"][:m].tolist(), valid[:m]):
        t = epoch + _dt.timedelta(microseconds=us)
        frac = f"{t.microsecond:06d}".rstrip("0")
        want_ts.append(t.strftime("%Y-%m-%d %H:%M:%S")
                       + (f".{frac}" if frac else "") if ok else None)
    check(col_head(results["cast_from_datetime"][0], m).to_pylist()
          == want_ts, "cast_from_datetime == datetime")
    for z in TZ_ZONES:
        zi = ZoneInfo(z)
        got = col_head(results[f"utc_to_local:{z}"][0], m).to_numpy()
        for us, g in zip(x["ts_us"][:m:16].tolist(), got[::16].tolist()):
            u = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc) + \
                _dt.timedelta(microseconds=us)
            if u.year < 1901:
                continue  # before the zone's LMT rules: not the oracle
            check(g - us == int(zi.utcoffset(u.astimezone(zi))
                                .total_seconds()) * 10**6,
                  f"utc_to_local {z} == zoneinfo at {u}")
    bits = bloom_filter.bloom_build(dev["i64"], nb, nh).cpu().numpy()
    for item, ok in zip(x["i64"][:4096].tolist(), valid[:4096]):
        if ok:
            check(all(bits[p] for p in _bloom_positions_py(item, nh, nb)),
                  "bloom bits hold Spark's murmur3 positions")
    probe = results["bloom_probe"][0]
    self_probe = bloom_filter.bloom_might_contain(
        bloom_filter.bloom_build(dev["i64"], nb, nh), dev["i64"], nh)
    check(bool((self_probe.data != 0)[dev["i64"].validity].all()),
          "no false negative on the build items")
    fpp = float((probe.data != 0)[probe.valid_mask()].float().mean())
    out["bloom"]["probe_positive_share"] = fpp
    half = n // 2
    tail = Column(D.INT64, data=dev["i64"].data[half:],
                  validity=dev["i64"].validity[half:])
    merged = bloom_filter.bloom_merge([
        bloom_filter.bloom_build(col_head(dev["i64"], half), nb, nh),
        bloom_filter.bloom_build(tail, nb, nh)])
    check(torch.equal(merged, bloom_filter.bloom_build(dev["i64"], nb, nh)),
          "bloom_merge of two halves == one build")
    raw = results["interleave_bits_2x64"][0].children[0].data[:4096 * 16] \
        .cpu().numpy().view(np.uint8).reshape(-1, 16)
    for i in range(0, 4096, 64):
        check(raw[i].tobytes() == _interleave_py(
            [int(x["i64"][i]) & (2**64 - 1), int(x["d64"][i]) & (2**64 - 1)],
            64), "interleave_bits == the Python interleaver")
    codes, dic = results["dictionary_encode"]
    tchars, toffs, tok = x["text"]
    words = [bytes(tchars[toffs[i]:toffs[i + 1]]) for i in range(m)]
    uniq = sorted({w for w, ok in zip(words, tok[:m]) if ok})
    dl = [w.encode() for w in dic.to_pylist()]
    check(set(uniq) <= set(dl) and dl == sorted(dl),
          "the dictionary holds the distinct values in order")
    cl = col_head(codes, m).to_pylist()
    check(all((c is None) == (not ok) and (c is None or dl[c] == w)
              for c, w, ok in zip(cl, words, tok[:m])),
          "dictionary codes index their values")
    # window: numpy oracle on the card's window of a 65,536-row sample
    sm = columns(DEV, m, m)
    rn, s, lo_, hi_ = win(sm)
    p, o, v = x["part"][:m], x["i32"][:m] % 4096, x["i64"][:m]
    f = x["f64"][:m]
    order = np.lexsort((np.arange(m), o, p))
    ok = valid[:m][order]
    ps, os_ = p[order], o[order]
    start = np.r_[True, ps[1:] != ps[:-1]]
    seg = np.cumsum(start) - 1
    seg_start = np.flatnonzero(start)[seg]
    want_rn = np.arange(m) - seg_start + 1
    peer_end = np.r_[(ps[1:] != ps[:-1]) | (os_[1:] != os_[:-1]), True]
    end_of = np.minimum.accumulate(np.where(peer_end, np.arange(m), m)
                                   [::-1])[::-1]
    c = np.cumsum(np.where(ok, v[order], 0))
    want_sum = (c - (c - np.where(ok, v[order], 0))[seg_start])[end_of]
    check(np.array_equal(rn.data.cpu().numpy()[order], want_rn),
          "window row_number == numpy")
    check(np.array_equal(s.data.cpu().numpy()[order], want_sum),
          "window running sum == numpy (RANGE peers)")
    fo = np.where(ok, f[order], np.inf)
    run_min = np.empty(m)
    for a, b in zip(np.flatnonzero(start), np.r_[np.flatnonzero(start)[1:],
                                                 m]):
        run_min[a:b] = np.minimum.accumulate(fo[a:b])
    got_min = lo_.data.cpu().numpy()[order]
    has = np.cumsum(ok) - (np.cumsum(ok) - ok)[seg_start]
    has = has[end_of] > 0
    check(np.array_equal(got_min[has], run_min[end_of][has]),
          "window running min == numpy")
    # strings: Python on the sample
    tl = [w.decode() if ok else None for w, ok in zip(words, tok[:m])]
    for name, py in (("upper", str.upper),
                     ("substring", lambda t: t[1:6]),
                     ("replace", lambda t: t.replace("-", "__")),
                     ("trim", lambda t: t.strip(" ")),
                     ("split_part", lambda t: (t.split("-") + [""])[1]),
                     ("lpad", lambda t: t[:16].rjust(16, "*"))):
        check(col_head(results[name][0], m).to_pylist() ==
              [None if t is None else py(t) for t in tl],
              f"{name} == Python str")
    out["sync_total"] = sum(r["syncs"] for r in out["ops"].values())
    return out


# ---------------------------------------------------------------------------
# 11. nds: q64, q67, q97 and predicate-cast at one SF100 task's split
# ---------------------------------------------------------------------------

N_CUSTOMERS = 2_000_000          # NDS SF100 customer rows
N_ITEMS = 204_000                # NDS SF100 item rows
N_CATEGORIES = 10
COUNTRIES = ["UNITED STATES", "GERMANY", "JAPAN", "BRAZIL", "INDIA",
             "CHINA", "FRANCE", "KENYA", "PERU", "CANADA", "NORWAY",
             "EGYPT", "MEXICO", "SPAIN", "CHILE", "GHANA", "ITALY",
             "NEPAL", "POLAND", "TONGA"]
COLORS = [a + b for a in ("", "light ", "dark ") for b in (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro")][:88] + ["plum", "misty"]
PC_CATEGORIES = ["cat-1A", "cat-22B", "dog-3C", "cat-9", "fish-44D"]
PC_DAY0 = 18000


def _strings_of(choices, idx):
    """STRING column buffers whose row i is ``choices[idx[i]]``."""
    enc = [c.encode() for c in choices]
    mat = np.zeros((len(enc), max(map(len, enc))), np.uint8)
    for i, e in enumerate(enc):
        mat[i, :len(e)] = np.frombuffer(e, np.uint8)
    lens = np.array([len(e) for e in enc])[idx]
    keep = np.arange(mat.shape[1])[None, :] < lens[:, None]
    chars = mat[idx][keep]
    offsets = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return chars, offsets.astype(np.int32)


def nds_columns(n: int, seed: int) -> dict:
    """The nds phase's tables as writer columns (name, kind, values, valid,
    dictionary), at one SF100 split: 2^24-row q64 store_sales and q67
    fact, 2^23-row catalog_sales, returns a tenth of the split's
    (item, ticket) pairs; customer, item, date_dim and store at SF100."""
    rng = np.random.default_rng(seed + 64)
    date = np.sort(rng.integers(DATE_SK0, DATE_SK0 + N_DAYS, n))
    cust = rng.integers(1, N_CUSTOMERS + 1, n)
    item = rng.integers(1, N_ITEMS + 1, n)
    ss = [("ss_sold_date_sk", "int64", date, None, True),
          ("ss_store_sk", "int64", rng.integers(1, N_STORES + 1, n), None,
           True),
          ("ss_customer_sk", "int64", cust, None, False),
          ("ss_item_sk", "int64", item, None, False),
          ("ss_ticket_number", "int64", np.arange(n), None, False),
          ("ss_sales_price", "float64",
           rng.integers(100, 20_000, n) / 100.0, None, False)]
    ret = rng.choice(n, n // 10, replace=False)
    sr = [("sr_item_sk", "int64", item[ret], None, False),
          ("sr_ticket_number", "int64", ret, None, False),
          ("sr_return_amt", "float64",
           rng.integers(100, 6_000, len(ret)) / 100.0, None, False)]
    customers = [("c_customer_sk", "int64", np.arange(1, N_CUSTOMERS + 1),
                  None, False),
                 ("c_birth_country", "string",
                  [COUNTRIES[i].encode() for i in rng.integers(
                      0, len(COUNTRIES), N_CUSTOMERS)], None, False)]
    items = [("i_item_sk", "int64", np.arange(1, N_ITEMS + 1), None, False),
             ("i_color", "string", [COLORS[i].encode() for i in rng.integers(
                 0, len(COLORS), N_ITEMS)], None, False)]
    q67 = [("store", "int64", rng.integers(1, N_STORES + 1, n), None, True),
           ("cat", "int64", rng.integers(0, N_CATEGORIES, n), None, True),
           ("item", "int64", rng.integers(1, N_ITEMS + 1, n), None, False),
           ("price", "float64", rng.integers(100, 20_000, n) / 100.0, None,
            False)]
    m = n // 2
    cs_cust = rng.integers(1, N_CUSTOMERS + 1, m)
    cs_item = rng.integers(1, N_ITEMS + 1, m)
    share = rng.random(m) < 0.3     # pairs bought in both channels
    src = rng.integers(0, n, m)
    cs_cust[share], cs_item[share] = cust[src[share]], item[src[share]]
    cs = [("cs_sold_date_sk", "int64",
           np.sort(rng.integers(DATE_SK0, DATE_SK0 + N_DAYS, m)), None, True),
          ("cs_bill_customer_sk", "int64", cs_cust, None, False),
          ("cs_item_sk", "int64", cs_item, None, False)]
    dates, stores = dim_columns()
    return {"store_sales": ss, "store_returns": sr, "customer": customers,
            "item": items, "q67_sales": q67, "catalog_sales": cs,
            "date_dim": dates, "store": stores}


def _values(cols, name):
    return next(c[2] for c in cols if c[0] == name)


def q64_oracle_np(t: dict) -> dict:
    ss = {c[0]: c[2] for c in t["store_sales"]}
    sr = {c[0]: c[2] for c in t["store_returns"]}
    colors = np.array([c.decode() for c in _values(t["item"], "i_color")])
    item_ok = np.r_[False, np.isin(colors, Q64_COLORS)]
    keep = item_ok[ss["ss_item_sk"]]
    ret = np.zeros(len(keep))
    ret[sr["sr_ticket_number"]] = sr["sr_return_amt"]
    net = (ss["ss_sales_price"] - ret)[keep]
    year = _values(t["date_dim"], "d_year")[
        ss["ss_sold_date_sk"][keep] - DATE_DIM_SK0].astype(np.int64)
    names = [nm.decode() for nm in _values(t["store"], "s_store_name")]
    uniq_names = sorted(set(names))
    name_id = np.r_[0, [uniq_names.index(nm) for nm in names]]
    key = name_id[ss["ss_store_sk"][keep]] * 10_000 + year
    u, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, net)
    cnts = np.bincount(inv)
    return {(uniq_names[k // 10_000], int(k % 10_000)): (float(a), int(b))
            for k, a, b in zip(u.tolist(), sums, cnts)}


def q67_oracle_np(t: dict, top: int = 3) -> list:
    c = {x[0]: x[2] for x in t["q67_sales"]}
    key = (c["store"] * N_CATEGORIES + c["cat"]) * (N_ITEMS + 1) + c["item"]
    u, inv = np.unique(key, return_inverse=True)
    sales = np.bincount(inv, c["price"])
    grp = u // (N_ITEMS + 1)
    order = np.lexsort((-sales, grp))
    g = grp[order]
    first = np.r_[True, g[1:] != g[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(g)), 0))
    kept = order[np.arange(len(g)) - start < top]
    return sorted(zip((grp[kept] // N_CATEGORIES).tolist(),
                      (grp[kept] % N_CATEGORIES).tolist(),
                      [round(s, 6) for s in sales[kept].tolist()]))


def q97_oracle_np(t: dict, lo: int, hi: int) -> tuple:
    def pairs(cols, d, a, b):
        c = {x[0]: x[2] for x in cols}
        k = (c[d] >= lo) & (c[d] <= hi)
        return np.unique(c[a][k] * (N_ITEMS + 1) + c[b][k])
    s = pairs(t["store_sales"], "ss_sold_date_sk", "ss_customer_sk",
              "ss_item_sk")
    c = pairs(t["catalog_sales"], "cs_sold_date_sk", "cs_bill_customer_sk",
              "cs_item_sk")
    both = len(np.intersect1d(s, c, assume_unique=True))
    return (len(s) - both, len(c) - both, both)


def predicate_cast_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed + 336)
    return (rng.integers(0, len(PC_CATEGORIES), n),
            rng.integers(-10**6, 10**6, n),
            rng.integers(PC_DAY0, PC_DAY0 + 10, n).astype(np.int32))


def predicate_cast_oracle_np(cat, amt, day) -> dict:
    import datetime as _dt
    import re
    hit = np.array([re.search(PREDICATE, c) is not None
                    for c in PC_CATEGORIES])[cat]
    sums = np.zeros(10, np.int64)
    np.add.at(sums, day[hit] - PC_DAY0, amt[hit])
    seen = np.bincount(day[hit] - PC_DAY0, minlength=10) > 0
    return {(_dt.date(1970, 1, 1) + _dt.timedelta(days=PC_DAY0 + i))
            .isoformat(): int(sums[i]) for i in range(10) if seen[i]}


def phase_nds(torch, root, pqk, tracing, n: int, seed: int) -> dict:
    import collections
    from spark_rapids_jni_tpu_torch import dtypes as D
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    nroot = Path(root) / "nds"
    nroot.mkdir()
    t0 = time.perf_counter()
    tables = nds_columns(n, seed)
    for name, cols in tables.items():
        write_parquet(nroot / f"{name}.parquet", cols,
                      max(n // 16, 1) if len(cols[0][2]) >= n // 2
                      else 1 << 20, "snappy")
    out = {"phase": "nds", "fact_rows": n,
           "files_s": time.perf_counter() - t0,
           "bytes": {p.name: p.stat().st_size
                     for p in sorted(nroot.iterdir())}}
    n_pc = n // 4
    cat, amt, day = predicate_cast_inputs(n_pc, seed)
    chars, offs = _strings_of(PC_CATEGORIES, cat)
    pc_table = Table([Column.string(chars, offs, device=DEV),
                      Column.fixed(D.decimal64(-2), amt, device=DEV),
                      Column.fixed(D.TIMESTAMP_DAYS, day, device=DEV)],
                     ["cat", "amt", "d"])

    def q5_like(got, want):
        return q5_matches({k: (v[0], 0.0, v[1]) for k, v in got.items()},
                          {k: (v[0], 0.0, v[1]) for k, v in want.items()})
    queries = [
        ("q64", n, lambda: q64_lite(nroot, "device", DEV),
         q64_oracle_np(tables), q5_like),
        ("q67", n, lambda: q67_lite(nroot, "device", DEV),
         q67_oracle_np(tables), lambda a, b: a == b),
        ("q97", n + n // 2, lambda: q97_lite(nroot, "device", DEV,
                                              *Q5_DATES),
         q97_oracle_np(tables, *Q5_DATES), lambda a, b: a == b),
        ("predicate_cast", n_pc, lambda: (predicate_cast_lite(pc_table), {}),
         predicate_cast_oracle_np(cat, amt, day), lambda a, b: a == b),
    ]
    out["launches"] = {k: 0 for k in DECODE_KERNELS}
    for name, rows, fn, want, same in queries:
        rec = {"rows": rows}
        (got, _), rec["cold_s"] = wall(torch, fn)
        check(same(got, want), f"{name} (cold) == numpy oracle")
        tracing.reset_counters("kernel.")
        (got, info), rec["warm_s"] = wall(torch, fn)
        check(same(got, want), f"{name} (warm) == numpy oracle")
        rec["scan"] = {k: info[k] for k in ("groups_read", "groups_pruned",
                                            "dims_s") if k in info}
        rec["scan"]["host_decoded_groups"] = dict(collections.Counter(
            f for f, _ in info.get("fallbacks", ())))
        rec["kernel_launches"] = {k: pqk.launches(k) for k in DECODE_KERNELS}
        if name != "predicate_cast":   # the three that scan Parquet
            for k, v in rec["kernel_launches"].items():
                check(v > 0, f"{name}'s warm device-route scan launched {k}")
                out["launches"][k] += v
        rec["file_rows_per_s"] = rows / rec["warm_s"]
        prof = {}
        rec["syncs"], sites = count_syncs(torch, lambda: prof.update(
            profile_top(torch, fn, top=5)))
        rec["sync_sites"] = dict(sorted(sites.items(),
                                        key=lambda kv: -kv[1])[:5])
        rec["profile"] = prof
        rec["result_size"] = len(got) if hasattr(got, "__len__") else 1
        out[name] = rec
        emit({"phase": "nds_query", "query": name, **rec})
        torch.cuda.empty_cache()
    out["q97_counts"] = list(queries[2][3])
    return out


# ---------------------------------------------------------------------------

ORC_STRIPE_ROWS = 1 << 20
Q95_DATES = (2_450_900, 2_451_000)
ALL_KERNELS = ("interleave_planes", "deinterleave_wire") + DECODE_KERNELS
SHARDS = 8                 # the JAX package's 8-device mesh, on one card


def kernel_launches(tracing) -> dict:
    """Every kernel wrapper's launch count since the last reset."""
    return {k: tracing.counter_value("kernel." + k) for k in ALL_KERNELS}


def q95_close(a: tuple, b: tuple, rel: float = 1e-9) -> bool:
    return a[0] == b[0] and all(abs(x - y) <= rel * max(abs(y), 1.0)
                                for x, y in zip(a[1:], b[1:]))


def phase_orc(torch, root, tracing, n: int, seed: int) -> dict:
    """q95-lite over ORC files the port's writer makes (zlib, 2^20-row
    stripes), read on the card, against a numpy oracle and the port on the
    CPU.  The read is host work: RLE runs decode in Python and numpy."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.io import ORCFile, read_orc, write_orc
    out = {"phase": "orc", "rows": n, "stripe_rows": ORC_STRIPE_ROWS,
           "dates": list(Q95_DATES)}
    ws, wr = q95_columns(n, seed)
    paths = (root / "web_sales.orc", root / "web_returns.orc")
    t0 = time.perf_counter()
    write_orc(Table.from_pydict(ws, device="cpu"), paths[0],
              compression="zlib", stripe_rows=ORC_STRIPE_ROWS)
    write_orc(Table.from_pydict(wr, device="cpu"), paths[1],
              compression="zlib")
    out["write_s"] = time.perf_counter() - t0
    out["bytes"] = {p.name: p.stat().st_size for p in paths}
    out["stripes"] = ORCFile(paths[0]).num_stripes
    check(out["stripes"] == -(-n // ORC_STRIPE_ROWS),
          "web_sales has one stripe per 2^20 rows")
    tracing.reset_counters("kernel.")
    (wst, wrt), out["read_s"] = wall(torch, lambda: (
        read_orc(paths[0], device=DEV), read_orc(paths[1], device=DEV)))
    out["read_rows_per_s"] = (n + len(wr["wr_order_number"])) / \
        out["read_s"]
    for name, vals in list(ws.items()) + list(wr.items()):
        t = wst if name in ws else wrt
        got = t[name].data.cpu().numpy()
        check(t[name].validity is None and
              np.array_equal(got.view(np.uint8), vals.view(np.uint8)),
              f"ORC {name} reads back bit for bit on the card")
    want = q95_oracle_np(ws, wr, *Q95_DATES)
    got, out["cold_s"] = wall(torch, lambda: q95_lite(wst, wrt, *Q95_DATES))
    check(q95_close(got, want), "q95-lite on the card (cold) == numpy")
    got, out["warm_s"] = wall(torch, lambda: q95_lite(wst, wrt, *Q95_DATES))
    check(q95_close(got, want), "q95-lite on the card (warm) == numpy")
    out["launches"] = kernel_launches(tracing)
    out["syncs"], out["sync_sites"] = count_syncs(
        torch, lambda: q95_lite(wst, wrt, *Q95_DATES))
    cpu, out["cpu_s"] = wall(torch, lambda: q95_lite(
        wst.to("cpu"), wrt.to("cpu"), *Q95_DATES))
    check(q95_close(got, cpu), "q95-lite on the card == the port on the CPU")
    out["result"] = {"orders": got[0], "ship_cost": got[1],
                     "net_profit": got[2]}
    out["file_rows_per_s"] = n / out["warm_s"]
    return out


def _sorted_by(torch, table, name):
    """The table's rows in ascending order of one unique column."""
    from spark_rapids_jni_tpu_torch.ops.selection import gather_table
    return gather_table(table, torch.argsort(table[name].data, stable=True))


def _same_values(torch, a, b) -> bool:
    """Same type, validity and values at the valid rows (bits for
    fixed-width columns, bytes for strings); a missing validity is all
    valid, and what a null row holds is not compared."""
    from spark_rapids_jni_tpu_torch.ops.strings_common import \
        to_padded_bytes
    if a.dtype != b.dtype or a.size != b.size:
        return False
    va, vb = a.valid_mask(), b.valid_mask().to(a.valid_mask().device)
    if not torch.equal(va, vb):
        return False
    if a.dtype.is_string:
        w = max(string_width(a), string_width(b))
        (ma, la), (mb, lb) = to_padded_bytes(a, w), to_padded_bytes(b, w)
        mb, lb = mb.to(ma.device), lb.to(la.device)
        return bool(((la == lb) | ~va).all()) and \
            bool(((ma == mb).all(dim=1) | ~va).all())
    da = a.data.contiguous().view(torch.uint8).reshape(a.size, -1)
    db = b.data.to(a.data.device).contiguous().view(torch.uint8) \
        .reshape(b.size, -1)
    return bool(((da == db).all(dim=1) | ~va).all())


def string_width(col) -> int:
    from spark_rapids_jni_tpu_torch.ops.strings_common import \
        string_width_bucket
    return string_width_bucket(col)


def _tables_equal(torch, a, b, exact: bool = False) -> bool:
    """Same names and columns: bit for bit (``exact``: validity None-ness
    and null rows too) or by ``_same_values``."""
    return list(a.names) == list(b.names) and all(
        same_column(x, y) if exact else _same_values(torch, x, y)
        for x, y in zip(a.columns, b.columns))


def _live_table(torch, table, ok):
    from spark_rapids_jni_tpu_torch.ops.selection import gather_table
    return gather_table(table, torch.nonzero(ok, as_tuple=True)[0])


def phase_exchange(torch, root, tracing, n: int, n_str: int,
                   seed: int) -> dict:
    """The exchange layer on a mesh of 8 shards of the card: the stage's
    2^24-row table shuffled by its INT32 key and a 2^22-row table by a
    STRING key (slots bit for bit against the port on the CPU over 2^20
    rows, placement against Python's Spark murmur3 on 65,536 rows, no row
    lost or added), distributed groupby and join against one device, and
    engine q5 planned with distribute=True against the one-shard plan."""
    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.interop import (
        HostColumn, table_from_numpy)
    from spark_rapids_jni_tpu_torch.dtypes import INT32, INT64
    from spark_rapids_jni_tpu_torch.engine.verify import plan_exchanges
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.join import inner_join
    from spark_rapids_jni_tpu_torch.ops.row_conversion import \
        fixed_width_layout
    from spark_rapids_jni_tpu_torch.parallel import distributed as dist
    from spark_rapids_jni_tpu_torch.parallel import make_mesh
    from spark_rapids_jni_tpu_torch.parallel import shuffle as sh
    out = {"phase": "exchange", "shards": SHARDS, "rows": n,
           "string_rows": n_str}
    mesh, cpu_mesh = make_mesh(SHARDS, device=DEV), \
        make_mesh(SHARDS, device="cpu")
    cols = stage_columns(n, seed)
    table = table_from_numpy([HostColumn(t, s, d, v)
                              for _, t, s, d, v in cols],
                             [c[0] for c in cols], device=DEV)

    def case(tbl, key, rows):
        rec = {}
        counts = sh.partition_counts(tbl, mesh, [key])
        st = sh.device_load_stats(counts.sum(axis=0))
        rec["capacity"] = sh.cap_bucket(int(counts.max()))
        flat = tbl
        if any(c.dtype.is_string for c in tbl.columns):
            from spark_rapids_jni_tpu_torch.parallel.stringplane import \
                explode_strings
            flat = explode_strings(tbl)[0]
        row_size = fixed_width_layout(flat.dtypes()).row_size
        rec["row_bytes"] = row_size
        rec["wire_bytes"] = SHARDS * SHARDS * rec["capacity"] * row_size
        rec["skew"], rec["straggler_share"] = st["skew"], \
            st["straggler_share"]
        rec["dest_rows"] = st["dev_rows"]
        _, rec["cold_s"] = wall(torch, lambda: sh.shuffle_table_padded(
            tbl, mesh, [key]))
        tracing.reset_counters("kernel.")
        (got, ok, ovf), rec["warm_s"] = wall(
            torch, lambda: sh.shuffle_table_padded(tbl, mesh, [key]))
        rec["launches"] = kernel_launches(tracing)
        rec["syncs"], rec["sync_sites"] = count_syncs(
            torch, lambda: sh.shuffle_table_padded(tbl, mesh, [key]))
        rec["rows_per_s"] = rows / rec["warm_s"]
        check(int(ovf) == 0 and int(ok.sum()) == rows,
              f"{key} shuffle: every row arrived once, no overflow")
        check(got.num_rows == SHARDS * SHARDS * rec["capacity"],
              f"{key} shuffle: the counts sized the grid")
        # placement: every live row sits on the shard its key hashes to
        pid = sh.partition_ids(Table([got[key]], [key]), SHARDS)
        shard = torch.arange(got.num_rows, device=ok.device) // \
            (SHARDS * rec["capacity"])
        check(bool((pid.to(torch.int64) == shard)[ok].all()),
              f"{key} shuffle: rows placed by pmod(murmur3(key), 8)")
        # lossless: the live rows are the input rows
        check(_tables_equal(torch, _sorted_by(torch, tbl, "row"),
                            _sorted_by(torch, _live_table(torch, got, ok),
                                       "row")),
              f"{key} shuffle: the live rows are the input's")
        # bit for bit against the port on the CPU over a slice
        m = min(CPU_SLICE, rows) // SHARDS * SHARDS
        part = Table([col_head(c, m) for c in tbl.columns], tbl.names)
        dg, dok, _ = sh.shuffle_table_padded(part, mesh, [key])
        cg, cok, _ = sh.shuffle_table_padded(part.to("cpu"), cpu_mesh,
                                             [key])
        check(torch.equal(dok.cpu(), cok)
              and _tables_equal(torch, dg, cg, exact=True),
              f"{key} shuffle of {m} rows: slots bit for bit == the CPU")
        # placement against Python's Spark murmur3
        k = ORACLE_ROWS
        head = col_head(tbl[key], k)
        ids = sh.partition_ids(Table([head], [key]), SHARDS).cpu().tolist()
        vals = head.to_pylist()
        check(ids == [spark_partition_py(
            v.encode() if isinstance(v, str) else v, SHARDS) for v in vals],
              f"{key} placement == Python Spark murmur3 on {k} rows")
        return rec

    table = Table(list(table.columns) + [Column(INT64, data=torch.arange(
        n, device=table.columns[0].device))], list(table.names) + ["row"])
    out["int32_key"] = case(table, "i32", n)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 6)
    chars, offsets, valid = text_strings(rng, n_str)
    stbl = Table([Column.string(chars, offsets, valid, device=DEV),
                  Column.fixed(INT64, np.arange(n_str), device=DEV)],
                 ["s", "row"])
    out["string_key"] = case(stbl, "s", n_str)
    del stbl
    torch.cuda.empty_cache()

    # distributed groupby and join against one device
    aggs = [("i64", "sum"), ("i64", "count"), ("f64", "min"),
            ("f64", "max"), ("f32", "mean")]
    gb = {}
    got, gb["cold_s"] = wall(torch, lambda: dist.distributed_groupby(
        table, mesh, ["i32"], aggs))
    tracing.reset_counters("kernel.")
    got, gb["warm_s"] = wall(torch, lambda: dist.distributed_groupby(
        table, mesh, ["i32"], aggs))
    gb["launches"] = kernel_launches(tracing)
    one, gb["one_device_s"] = wall(torch, lambda: groupby(
        table, ["i32"], aggs, device=DEV))
    got = _sorted_by(torch, got, "i32")
    check(got.num_rows == one.num_rows and all(
        _same_values(torch, a, b)
        for a, b in zip(got.columns[:5], one.columns[:5])),
          "distributed groupby keys, sums, counts, min, max == one device")
    gm, om = got.columns[5].data, one.columns[5].data
    check(bool(((gm - om).abs() <= 1e-9 * om.abs().clamp(min=1.0)).all()),
          "distributed groupby means within rel 1e-9 of one device")
    gb["groups"] = got.num_rows
    out["groupby"] = gb

    m = min(n, 1 << 22)
    fact = Table([col_head(table["i32"], m), col_head(table["row"], m)],
                 ["k", "row"])
    dk = torch.arange(100_000, device=fact.columns[0].device)
    dim = Table([Column(INT32, data=dk.to(torch.int32)),
                 Column(INT64, data=dk * 3)], ["k", "v"])
    jn = {"fact_rows": m, "dim_rows": 100_000}
    _, jn["cold_s"] = wall(torch, lambda: dist.distributed_join(
        fact, dim, mesh, ["k"]))
    tracing.reset_counters("kernel.")
    got, jn["warm_s"] = wall(torch, lambda: dist.distributed_join(
        fact, dim, mesh, ["k"]))
    jn["launches"] = kernel_launches(tracing)
    one, jn["one_device_s"] = wall(torch, lambda: inner_join(
        fact, dim, ["k"], device=DEV))
    check(_tables_equal(torch, _sorted_by(torch, got, "row"),
                        _sorted_by(torch, one, "row")),
          "distributed join == one device")
    jn["rows_out"] = got.num_rows
    out["join"] = jn

    # engine q5 planned for the mesh against the one-shard plan
    plan = q5_engine_plan(root, *Q5_DATES)
    base = pe.execute(pe.optimize(plan), device=DEV)
    with settings(shards=SHARDS):
        opt = pe.optimize(plan, distribute=True)
        eng = {"exchanges_planned": [e["kind"]
                                     for e in plan_exchanges(opt)]}
        _, eng["cold_s"] = wall(torch, lambda: pe.execute(opt, device=DEV))
        stats = pe.new_stats()
        tracing.reset_counters("kernel.")
        res, eng["warm_s"] = wall(torch, lambda: pe.execute(
            opt, stats=stats, device=DEV))
        eng["launches"] = kernel_launches(tracing)
    eng["exchanges"] = stats["exchanges"]
    check(stats["exchanges"] == len(eng["exchanges_planned"]) > 0,
          "engine q5 ran every planned exchange")
    check(q5_matches(engine_result(res), engine_result(base)),
          "engine q5 with distribute=True == the one-shard plan")
    out["engine_q5"] = eng
    out["launches"] = {k: sum(r["launches"][k] for r in (
        out["int32_key"], out["string_key"], gb, jn, eng))
        for k in ALL_KERNELS}
    return out


# ---------------------------------------------------------------------------
# 14. adaptive execution and the fused stage on 8 shards of the card
# ---------------------------------------------------------------------------

AQE_DIM_ROWS = 400          # tests/test_adaptive.py::warehouse's dimension
AQE_HOT_KEY = 3             # half the fact sits on this key
AQE_U_VALUES = 100_000      # the fused stage's group key
AQE_AGGS = (("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"))
AQE_NAMES = ("s", "n", "lo", "hi")


def adaptive_columns(n: int, seed: int):
    """tests/test_adaptive.py::warehouse at full width: a fact whose INT64
    key ``k`` holds half its rows on one key (the rest uniform over the
    400 dimension keys; dictionary-encoded), an INT32 ``u`` uniform over
    100,000 values and clustered (the file is written in ``u`` order, as a
    fact sorted on a key is, so a shard holds about 12,500 of them), and
    INT64 ``v = arange``; the dimension ``dk``, ``grp = dk % 7``."""
    rng = np.random.default_rng(seed + 23)
    k = rng.integers(0, AQE_DIM_ROWS, n)
    k[: n // 2] = AQE_HOT_KEY
    u = np.sort(rng.integers(0, AQE_U_VALUES, n)).astype(np.int32)
    fact = [("k", "int64", k, None, True), ("u", "int32", u, None, False),
            ("v", "int64", np.arange(n, dtype=np.int64), None, False)]
    dk = np.arange(AQE_DIM_ROWS, dtype=np.int64)
    dim = [("dk", "int64", dk, None, False),
           ("grp", "int64", dk % 7, None, False)]
    return fact, dim


def group_oracle(keys: np.ndarray, v: np.ndarray) -> dict:
    """key -> (sum, count, min, max) of ``v`` by numpy, exact in int64."""
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], v[order]
    idx = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return dict(zip(ks[idx].tolist(), zip(
        np.add.reduceat(vs, idx).tolist(),
        np.diff(np.r_[idx, len(ks)]).tolist(),
        np.minimum.reduceat(vs, idx).tolist(),
        np.maximum.reduceat(vs, idx).tolist())))


def table_groups(table, key: str) -> dict:
    """key -> the tuple of the other columns, from a result table."""
    cols = [table[nm].to_pylist() for nm in table.names if nm != key]
    return dict(zip(table[key].to_pylist(), zip(*cols)))


class settings:
    """Set fields of the port's ``config`` for a block; restore after."""

    def __init__(self, **kw):
        from spark_rapids_jni_tpu_torch.utils.config import config
        self.config, self.kw = config, kw

    def __enter__(self):
        self.saved = {k: getattr(self.config, k) for k in self.kw}
        for k, v in self.kw.items():
            setattr(self.config, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.config, k, v)


def phase_adaptive(torch, root, tracing, n: int, seed: int) -> dict:
    """Adaptive execution and the fused partial -> exchange -> combine
    stage on 8 shards of the card, every fact scan decoding on the device
    route (K3/W1/W2).  Each run is cold and warm, held against the
    one-shard answer and a numpy oracle (INT64 sums exact):

    1. ``Aggregate(Join(fact, dim, k=dk), grp, sum(v))`` planned with
       every join hash (broadcast_rows=0), aqe off and on: on, the dim's
       exchange flips to a broadcast and the partial aggregate's exchange
       splits its hot destinations (post_skew < measured_skew) and
       re-combines to 7 rows.
    2. Profile-warmed planning: the plan with the dim filtered to dk < 50,
       twice into one profile store with broadcast_rows=100: run 1 plans a
       shuffle from the 400-row footer, run 2 the broadcast from run 1's
       measured 50 rows (``adaptive:history_warmed``).
    3. The fused stage ``Aggregate(fact, u, sum/count/min/max(v))``: fused
       with fuse_groups=16384, re-planned on the host path at 4096 (prefix
       overflow), beside the unfused distributed run and one device; the
       fused pass alone pays one synchronising call.
    4. aqe and fuse_exchange together: the probe routes the hot k stage to
       the host path, where the split fires, and the u stage runs fused.
    5. Engine q5-lite with fuse_exchange: its INT64-key stage runs fused,
       equal to the unfused distributed run (sums within rel 1e-9).

    Deliberate host syncs (``engine.host_sync``) equal
    ``verify.sync_budget`` on every run of 3 and 4; run 4 records the
    event timeline, dumped to a temporary directory."""
    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.engine import adaptive
    from spark_rapids_jni_tpu_torch.engine import segment as sg
    from spark_rapids_jni_tpu_torch.engine.verify import sync_budget
    from spark_rapids_jni_tpu_torch.parallel import make_mesh
    from spark_rapids_jni_tpu_torch.utils import timeline
    out = {"phase": "adaptive", "shards": SHARDS, "fact_rows": n}
    t0 = time.perf_counter()
    fact, dim = adaptive_columns(n, seed)
    fpath, dpath = root / "aqe_fact.parquet", root / "aqe_dim.parquet"
    write_parquet(fpath, fact, max(n // 16, 1), "snappy")
    write_parquet(dpath, dim, 1 << 20, "snappy")
    out["write_s"] = time.perf_counter() - t0
    k, u, v = (c[2] for c in fact)
    launches = {name: 0 for name in ALL_KERNELS}

    def counter(name):
        return tracing.counter_value(name)

    def execute(opt, rec):
        """One cold and one warm execute of ``opt``: times, kernel
        launches, deliberate host syncs and wire bytes of the warm one."""
        _, rec["cold_s"] = wall(torch, lambda: pe.execute(opt, device=DEV))
        stats = pe.new_stats()
        tracing.reset_counters("kernel.")
        h0 = counter("engine.host_sync")
        w0 = counter("engine.exchange.wire_bytes")
        res, rec["warm_s"] = wall(torch, lambda: pe.execute(
            opt, stats=stats, device=DEV))
        rec["launches"] = kernel_launches(tracing)
        for name, c in rec["launches"].items():
            launches[name] += c
        rec["host_syncs"] = counter("engine.host_sync") - h0
        rec["wire_bytes"] = counter("engine.exchange.wire_bytes") - w0
        rec["exchanges"] = stats["exchanges"]
        rec["aqe_flips"], rec["aqe_splits"] = stats["aqe_flips"], \
            stats["aqe_splits"]
        return res

    def join_plan(dk_below=None):
        dims = pe.Scan(dpath)
        if dk_below is not None:
            dims = pe.Filter(dims, ("<", pe.col("dk"), pe.lit(dk_below)))
        j = pe.Join(pe.Scan(fpath, chunk_bytes=64 << 20), dims, ("k",),
                    ("dk",), "inner")
        return pe.Aggregate(j, ("grp",), (("v", "sum"),), ("total",))

    # 1. the broadcast flip and the hot-key split
    want = {g: int(v[k % 7 == g].sum()) for g in range(7)}
    one = table_groups(pe.execute(pe.optimize(join_plan()), device=DEV),
                       "grp")
    check({g: t[0] for g, t in one.items()} == want,
          "join-aggregate on one shard == numpy")
    join = {}
    for label, kw in (("aqe_off", {"aqe": False}),
                      ("aqe_on", {"aqe": True, "aqe_skew": 1.5,
                                  "aqe_broadcast_rows": 1_000_000})):
        rec = join[label] = {}
        with settings(shards=SHARDS, broadcast_rows=0, **kw):
            opt = pe.optimize(join_plan(), distribute=True)
            res = execute(opt, rec)
        check(table_groups(res, "grp") == one,
              f"join-aggregate, {label}: == one shard and numpy (exact)")
        rt = adaptive.runtime_entries(opt)
        rec["ledger"] = [{k2: d[k2] for k2 in (
            "kind", "triggered", "measured_rows", "measured_skew",
            "post_skew", "hot_devices", "combined_rows") if k2 in d}
            for d in rt]
    on = join["aqe_on"]
    check(join["aqe_off"]["aqe_flips"] == join["aqe_off"]["aqe_splits"]
          == 0 and not join["aqe_off"]["ledger"],
          "aqe off: no flip, no split, no runtime ledger entry")
    (split,) = [d for d in on["ledger"]
                if d["kind"] == "adaptive:skew_split" and d["triggered"]]
    check(on["aqe_flips"] >= 1 and on["aqe_splits"] >= 1
          and split["post_skew"] < split["measured_skew"]
          and split["combined_rows"] == 7,
          "aqe on: a flip and a split, post_skew < measured_skew, the "
          "combine back to 7 rows")
    out["join"] = join

    # 2. profile-warmed planning
    want50 = {g: int(v[(k % 7 == g) & (k < 50)].sum()) for g in range(7)}
    warm = {}
    with tempfile.TemporaryDirectory(prefix="aqe_profiles_") as pdir, \
            settings(shards=SHARDS, aqe=True, metrics=True, profile_dir=pdir,
                     broadcast_rows=100):
        for label in ("run1", "run2"):
            rec = warm[label] = {}
            opt = pe.optimize(join_plan(50), distribute=True)
            res, rec["wall_s"] = wall(torch, lambda: pe.execute(
                opt, device=DEV))
            rec["exchanges_planned"] = sorted(
                e.kind for e in pe.plan.topo_nodes(opt)
                if isinstance(e, pe.Exchange))
            rec["result"] = {g: t[0] for g, t in
                             table_groups(res, "grp").items()}
            rec["warmed"] = [d for d in opt._decisions
                             if d.get("kind") == "adaptive:history_warmed"]
        warm["profiles"] = len(os.listdir(pdir))
    (hw,) = warm["run2"]["warmed"]
    check("broadcast" not in warm["run1"]["exchanges_planned"]
          and not warm["run1"]["warmed"]
          and "broadcast" in warm["run2"]["exchanges_planned"]
          and (hw["est_before"], hw["est_rows"], hw["choice"],
               hw["prior_kind"]) == (AQE_DIM_ROWS, 50, "broadcast",
                                     "shuffle"),
          "run 1 planned a shuffle from the footer, run 2 the broadcast "
          "from run 1's measured 50 rows")
    check(warm["run1"]["result"] == warm["run2"]["result"] == want50,
          "both warmed runs == numpy (exact)")
    for label in ("run1", "run2"):
        del warm[label]["result"]
    out["warmed"] = warm

    # 3. the fused stage by u
    u_want = group_oracle(u.astype(np.int64), v)
    stage_plan = pe.Aggregate(pe.Scan(fpath, chunk_bytes=64 << 20), ("u",),
                              AQE_AGGS, AQE_NAMES)
    st = {"groups": len(u_want)}
    ref, st["one_device_s"] = wall(torch, lambda: pe.execute(
        pe.optimize(stage_plan), device=DEV))
    check(table_groups(ref, "u") == u_want,
          "u stage on one shard == numpy (exact)")
    for label, kw in (("unfused", {"fuse_exchange": False}),
                      ("fused", {"fuse_exchange": True,
                                 "fuse_groups": 16384}),
                      ("fused_4096", {"fuse_exchange": True,
                                      "fuse_groups": 4096})):
        rec = st[label] = {}
        with settings(shards=SHARDS, **kw):
            opt = pe.optimize(stage_plan, distribute=True)
            rec["budget"] = [e["site"] for e in sync_budget(opt)]
            d0 = counter("engine.fused_stage.dispatches")
            o0 = counter("engine.fused_stage.overflow_fallbacks")
            res = execute(opt, rec)
            rec["fused_dispatches"] = \
                counter("engine.fused_stage.dispatches") - d0
            rec["overflow_fallbacks"] = \
                counter("engine.fused_stage.overflow_fallbacks") - o0
        check(table_groups(res, "u") == u_want,
              f"u stage, {label}: == one shard and numpy (exact)")
    check(st["fused"]["fused_dispatches"] == 2
          and st["fused"]["overflow_fallbacks"] == 0,
          "fuse_groups=16384: the stage ran fused, cold and warm")
    check(st["fused_4096"]["fused_dispatches"] == 0
          and st["fused_4096"]["overflow_fallbacks"] == 2,
          "fuse_groups=4096: the prefix overflowed and the host path "
          "re-planned, cold and warm")
    for label in ("unfused", "fused"):
        check(st[label]["host_syncs"] == len(st[label]["budget"]),
              f"u stage, {label}: deliberate syncs == verify.sync_budget")
    check(st["fused"]["budget"].count("groupby-compaction") == 1
          and "exchange-compaction" not in st["fused"]["budget"]
          and st["unfused"]["budget"].count("exchange-counts-sizing") == 1
          and st["unfused"]["budget"].count("exchange-compaction") == 1,
          "the fused exchange pays one sync, the host exchange two")
    # the fused pass alone, over its materialized input
    with settings(shards=SHARDS, fuse_exchange=True, fuse_groups=16384):
        opt = pe.optimize(stage_plan, distribute=True)
        stage = opt._fuse_stage
        inp = pe.execute(stage.partial.child, device=DEV)
        mesh = make_mesh(SHARDS, device=DEV)
        st["pass_syncs"], st["pass_sync_sites"] = count_syncs(
            torch, lambda: sg.run_fused_stage(stage, inp, mesh))
        (res, info), st["pass_s"] = wall(
            torch, lambda: sg.run_fused_stage(stage, inp, mesh))
        for key in ("capacity", "row_size", "wire_bytes"):
            st["pass_" + key] = info[key]
        rows_mat = info["rows_matrix"]
        st["pass_send_matrix_rows"] = int(rows_mat.sum())
        st["pass_prefix"] = sg.fused_prefix(inp.num_rows // SHARDS)
        del inp
    check(st["pass_syncs"] == 1,
          "the fused pass pays one synchronising call (the boundary "
          f"fetch); it made {st['pass_syncs']}: {st['pass_sync_sites']}")
    check(table_groups(res, "u") == u_want, "the fused pass == numpy")
    out["stage"] = st
    torch.cuda.empty_cache()

    # 4. aqe + fuse_exchange: the probe routes the hot stage to the host
    k_want = group_oracle(k, v)
    mix = {}
    with tempfile.TemporaryDirectory(prefix="aqe_trace_") as tdir, \
            settings(shards=SHARDS, aqe=True, aqe_skew=1.1,
                     fuse_exchange=True, fuse_groups=16384, timeline=True,
                     timeline_cap=1 << 16):
        timeline.reset()
        for key, want_g in (("k", k_want), ("u", u_want)):
            rec = mix[key] = {}
            plan = pe.Aggregate(pe.Scan(fpath, chunk_bytes=64 << 20),
                                (key,), AQE_AGGS, AQE_NAMES)
            opt = pe.optimize(plan, distribute=True)
            rec["budget"] = [e["site"] for e in sync_budget(opt)]
            a0 = counter("engine.fused_stage.aqe_fallbacks")
            res = execute(opt, rec)
            rec["aqe_fallbacks"] = \
                counter("engine.fused_stage.aqe_fallbacks") - a0
            rt = adaptive.runtime_entries(opt)
            rec["dispatch"] = [d["dispatch"] for d in rt
                               if d["kind"] == "fused_stage"]
            rec["probe_skew"] = [d["measured_skew"] for d in rt
                                 if d["kind"] == "fused_stage"]
            rec["split"] = [{f: d.get(f) for f in (
                "measured_skew", "post_skew", "hot_devices")}
                for d in rt if d["kind"] == "adaptive:skew_split"
                and d["triggered"]]
            check(table_groups(res, key) == want_g,
                  f"aqe + fuse, {key} stage: == numpy (exact)")
        path = timeline.dump(str(Path(tdir) / "adaptive_trace.json"))
        evs = timeline.events_snapshot()
        heads = {e["id"] for e in evs if e["ph"] == "f"}
        mix["timeline"] = {
            "events": len(evs), "bytes": os.path.getsize(path),
            "flows": sum(1 for e in evs if e["ph"] == "s"
                         and e["id"] in heads),
            "dropped": timeline.dropped_events(),
            "by_phase": {ph: sum(1 for e in evs if e["ph"] == ph)
                         for ph in sorted({e["ph"] for e in evs})},
            "fused_dispatch_spans": sum(
                1 for e in evs if e["name"] == "engine.fused_stage.dispatch"),
            "hash_exchange_spans": sum(
                1 for e in evs if e["name"] == "engine.exchange.hash")}
        timeline.reset()
    check(mix["k"]["dispatch"] == ["host"] and mix["k"]["aqe_fallbacks"] == 2
          and mix["k"]["split"],
          "aqe + fuse: the hot k stage went to the host path and split")
    check(mix["u"]["dispatch"] == ["fused"] and not mix["u"]["split"],
          "aqe + fuse: the balanced u stage ran fused")
    check(mix["u"]["host_syncs"] == len(mix["u"]["budget"]) == 2,
          "aqe + fuse, u stage: syncs == verify.sync_budget (probe + fetch)")
    check(mix["timeline"]["flows"] > 0 and mix["timeline"]["dropped"] == 0
          and mix["timeline"]["fused_dispatch_spans"] > 0,
          "the timeline recorded flows and the fused dispatch")
    out["aqe_fused"] = mix

    # 5. engine q5-lite with the fused stage against the unfused run
    plan = q5_engine_plan(root, *Q5_DATES)
    q5 = {}
    with settings(shards=SHARDS):
        base = engine_result(pe.execute(pe.optimize(plan, distribute=True),
                                        device=DEV))
    with settings(shards=SHARDS, fuse_exchange=True):
        opt = pe.optimize(plan, distribute=True)
        d0 = counter("engine.fused_stage.dispatches")
        f0 = counter("engine.fused_stage.fallbacks")
        res = execute(opt, q5)
        q5["fused_dispatches"] = counter("engine.fused_stage.dispatches") - d0
        q5["fallbacks"] = counter("engine.fused_stage.fallbacks") - f0
        q5["fallback_reasons"] = [d.get("reason") for d in
                                  adaptive.runtime_entries(opt)
                                  if d["kind"] == "fused_stage"]
    check(q5["fused_dispatches"] == 2,
          "engine q5: its INT64-key stage ran fused, cold and warm")
    check(q5_matches(engine_result(res), base),
          "engine q5 fused == unfused (counts exact, sums rel 1e-9)")
    out["q5"] = q5
    out["launches"] = launches
    check(all(launches[name] > 0 for name in DECODE_KERNELS),
          "K3/W1/W2 launched in the phase's fact scans")
    dpath.unlink()  # the fact stays: the bridge phase scans it
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# 15. the device server the JVM talks to (bridge/): RowConversion, engine
#     plans, the scheduler, cancel, faults and the flight recorder over the
#     wire
# ---------------------------------------------------------------------------

POINT_CLIENTS = 4          # concurrent point lookups beside one scan
POINT_OBJECTIVE_MS = 50    # the lookups' SLO objective (scheduler weight 8)
POINT_ALONE_REPS = 20      # lookups timed with the server otherwise idle
THINK_S = 0.1              # a lookup client's pause between its queries
BASELINE_S = 2.0           # the lookups' run with no scan beside them
OVERHEAD_REPS = 7          # warm q5 runs, alternating in process and wire
CACHE_HIT_REPS = 20        # PLAN_EXECUTE round trips served from the cache
SERVING_ROUNDS = 5          # scans a mode, lookups beside each


def _named(table, names):
    from spark_rapids_jni_tpu_torch.columnar import Table
    return Table(list(table.columns), names)


def build_c_abi(out_dir: Path) -> Path:
    """g++ the C ABI (src/main/cpp/src/tpubridge.cpp) and its round-trip
    harness (src/main/cpp/tests/bridge_roundtrip_test.cpp), with the
    flags of src/main/cpp/CMakeLists.txt; returns the harness."""
    cpp = Path(__file__).resolve().parent / "src" / "main" / "cpp"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = ["-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror",
             "-I", str(cpp / "include")]
    lib = out_dir / "libtpubridge.so"
    harness = out_dir / "bridge_roundtrip_test"
    subprocess.run(["g++", *flags, "-shared", "-fPIC",
                    str(cpp / "src" / "tpubridge.cpp"), "-o", str(lib),
                    "-lrt"], check=True, capture_output=True, timeout=300)
    subprocess.run(["g++", *flags, str(cpp / "tests" /
                                       "bridge_roundtrip_test.cpp"),
                    "-L", str(out_dir), "-ltpubridge",
                    f"-Wl,-rpath,{out_dir}", "-o", str(harness)],
                   check=True, capture_output=True, timeout=300)
    return harness


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def phase_bridge(torch, root, tracing, n: int, seed: int) -> dict:
    """The port's device server on the card, driven as Spark drives it:

    1. Servers: ``bridge.server.BridgeServer`` on the card in a thread of
       this process (so the launch counters and CUDA events see its work),
       and ``python3 -m spark_rapids_jni_tpu_torch.bridge.server --device
       cuda`` spawned once, against which the C ABI round-trip harness
       (built here with g++) must print "0 leaks".
    2. RowConversion over the wire on the stage's table (bench.py's
       build_host_table schema, 2^24 rows, 0.8 GB: one Spark batch of the
       1 GiB default target): IMPORT_TABLE, TO_ROWS (K1), EXPORT_COLUMN,
       FROM_ROWS (K2), EXPORT_TABLE bit-exact against the input, then
       murmur3 seed 42 and the stage's groupby bit-exact against the
       port's in-process result.
    3. Engine q5 over the store_sales split as one PLAN_EXECUTE, cold and
       warm, equal to the in-process ``execute`` (sums rel 1e-9, counts
       exact); K3/W1/W2 launch in the server.  The bridge's overhead is
       the median of seven paired differences (a warm in-process run, then
       a warm PLAN_EXECUTE), with their spread, beside the round trip of a
       PLAN_EXECUTE served from the result cache.
    4. Serving: four clients sending point lookups (one store by key, an
       SLO objective of 50 ms, so weight 8), each 100 ms after its last
       answer, with no scan beside them, then while one bulk scan of the
       adaptive fact (weight 1) runs, with the scheduler on, off, and with
       max_sessions=1 (the lookups queue behind the scan); the lookup
       alone first, as the objective's yardstick; max_sessions=2 queues;
       a burning fingerprint is shed at once on a saturated server;
       OP_CANCEL of a running scan; a parquet.device_decode fault
       recovers to the same answer; a failing query leaves a post-mortem
       bundle under blackbox_dir that names its trace id.

    Every error reply the phase did not ask for fails it."""
    import shutil
    import threading
    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.bridge import BridgeClient, spawn_server
    from spark_rapids_jni_tpu_torch.bridge import shm as shmlib
    from spark_rapids_jni_tpu_torch.bridge.server import serve
    from spark_rapids_jni_tpu_torch.columnar.interop import (
        HostColumn, table_from_numpy)
    from spark_rapids_jni_tpu_torch.engine.scheduler import SCHEDULER
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.hash import murmur3_hash
    from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows
    from spark_rapids_jni_tpu_torch.utils import blackbox, faults
    from spark_rapids_jni_tpu_torch.utils.errors import (
        AdmissionRejectedError, QueryCancelledError, TransientError)
    from spark_rapids_jni_tpu_torch.bridge import protocol as P
    out = {"phase": "bridge", "rows": n}
    t_phase = time.perf_counter()
    # sockets in a short directory beside the shm segments: a Unix socket
    # path holds at most 107 bytes, and a temporary root may be longer
    sock_dir = Path(tempfile.mkdtemp(prefix="srjt-", dir=shmlib.SHM_DIR))
    sock = str(sock_dir / "card.sock")
    ready = threading.Event()
    st = threading.Thread(target=serve, args=(sock, DEV, ready),
                          daemon=True)
    st.start()
    check(ready.wait(30), "the in-process server listens")
    c = BridgeClient(sock, device="cpu")
    spawned = None
    try:
        # -- 1. the module entry point and the C ABI ---------------------
        t0 = time.perf_counter()
        sock2 = str(sock_dir / "spawned.sock")
        spawned = spawn_server(sock2, device=DEV)
        out["spawn_s"] = time.perf_counter() - t0
        harness = build_c_abi(Path(__file__).resolve().parent /
                              "spark_rapids_jni_tpu_torch" / "kernels" /
                              "_build" / "c_abi")
        res = subprocess.run([str(harness), sock2], capture_output=True,
                             text=True, timeout=300)
        out["c_abi"] = res.stdout.strip().splitlines()[-1:]
        check(res.returncode == 0 and "0 leaks" in res.stdout,
              f"C ABI harness against the spawned server: {res.stdout}"
              f"{res.stderr}")
        c2 = BridgeClient(sock2, device="cpu")
        m2 = c2.metrics()
        check(m2["device"] == DEV and m2["errors"] == 2,
              "the spawned server ran on the card (its two errors: the "
              "harness's deliberate bad handle and double release)")
        c2.shutdown_server()
        spawned.wait(timeout=60)
        check(spawned.returncode == 0, "the spawned server shut down")
        spawned = None

        pings = []
        for _ in range(200):
            t0 = time.perf_counter()
            c.ping()
            pings.append(time.perf_counter() - t0)
        out["ping_ms"] = {"p50": _percentile(pings, 50) * 1e3,
                          "p95": _percentile(pings, 95) * 1e3}

        # -- 2. RowConversion over the wire ------------------------------
        cols = stage_columns(n, seed)
        names = [x[0] for x in cols]
        host = table_from_numpy([HostColumn(t, s, d, v)
                                 for _, t, s, d, v in cols], names,
                                device="cpu")
        nbytes = sum(x[3].nbytes + (0 if x[4] is None else n)
                     for x in cols)
        dev_table = table_from_numpy([HostColumn(t, s, d, v)
                                      for _, t, s, d, v in cols], names,
                                     device=DEV)
        wire = {"table_bytes": nbytes}
        steps = {}
        for rep in ("cold", "warm"):
            if rep == "warm":
                tracing.reset_counters("kernel.")
            t0 = time.perf_counter()
            th = c.import_table(host)
            s_imp = time.perf_counter() - t0
            t0 = time.perf_counter()
            blobs = c.convert_to_rows(th)
            s_to = time.perf_counter() - t0
            t0 = time.perf_counter()
            offs, raw = c.export_rows_column(blobs[0])
            s_expc = time.perf_counter() - t0
            t0 = time.perf_counter()
            th2 = c.convert_from_rows(blobs[0], dev_table.dtypes())
            s_from = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = c.export_table(th2)
            s_expt = time.perf_counter() - t0
            steps[rep] = {"import_s": s_imp, "to_rows_ms": s_to * 1e3,
                          "export_column_s": s_expc,
                          "from_rows_ms": s_from * 1e3,
                          "export_table_s": s_expt}
            if rep == "cold":
                for h in (th, th2, *blobs):
                    c.release(h)
        wire_launches = kernel_launches(tracing)
        wire.update(steps)
        warm = steps["warm"]
        wire["import_gbps"] = nbytes / warm["import_s"] / 1e9
        wire["export_gbps"] = nbytes / warm["export_table_s"] / 1e9
        wire["rows_gbps"] = len(raw) / warm["export_column_s"] / 1e9
        check(len(blobs) == 1 and len(offs) == n + 1
              and int(offs[-1]) == len(raw) == 48 * n,
              "one 48-byte-row blob over the wire")
        local_blob = convert_to_rows(dev_table, device=DEV)[0]
        check(np.array_equal(raw, local_blob.children[0].data.cpu().numpy()
                             .view(np.uint8)),
              "the exported row blob == the in-process K1 blob")
        for (name, _, _, data, valid), got in zip(cols, back.columns):
            g = got.data.cpu().numpy()
            check(np.array_equal(g.view(np.uint8),
                                 np.ascontiguousarray(data).view(np.uint8))
                  if valid is None else
                  np.array_equal(g[valid].view(np.uint8),
                                 data[valid].view(np.uint8)),
                  f"wire round trip of {name} is bit-exact")
            check(np.array_equal(got.validity_numpy(),
                                 np.ones(n, bool) if valid is None
                                 else valid),
                  f"wire round trip keeps {name}'s validity")
        del back, raw, offs
        hh = c.hash(th, "murmur3", seed=42)
        t0 = time.perf_counter()
        gh = c.groupby(th, [2], [(0, P.AGG_SUM), (0, P.AGG_COUNT),
                                 (1, P.AGG_MIN), (1, P.AGG_MAX),
                                 (3, P.AGG_MEAN), (4, P.AGG_COUNT)])
        wire["groupby_ms"] = (time.perf_counter() - t0) * 1e3
        hth = c.make_table([hh])
        got_h = c.export_table(hth)
        want_h = murmur3_hash(dev_table, 42, device=DEV)
        check(np.array_equal(got_h.columns[0].data.cpu().numpy(),
                             want_h.data.cpu().numpy()),
              "murmur3 seed 42 over the wire == in process")
        got_g = c.export_table(gh)
        cn = [f"c{i}" for i in range(len(names))]
        want_g = groupby(_named(dev_table, cn), ["c2"],
                         [("c0", "sum"), ("c0", "count"), ("c1", "min"),
                          ("c1", "max"), ("c3", "mean"), ("c4", "count")],
                         device=DEV)
        check(all(bits_equal(torch, a.data.to(b.data.device), b.data)
                  and torch.equal(a.valid_mask().to(b.data.device),
                                  b.valid_mask())
                  for a, b in zip(got_g.columns, want_g.columns)),
              "the stage's groupby over the wire == in process, bit-exact")
        del got_g, want_g, got_h, want_h, dev_table, host, local_blob
        for h in (th, th2, hh, hth, gh, *blobs):
            c.release(h)
        check(c.live_count() == 0, "the wire half released every handle")
        out["wire"] = wire

        # -- 3. engine q5 as one PLAN_EXECUTE -----------------------------
        q5 = {}
        plan = q5_engine_plan(root, *Q5_DATES)
        q5_names = ["s_store_name", "sales", "profit", "n"]
        opt = pe.optimize(plan)
        local, q5["in_process_cold_s"] = wall(
            torch, lambda: pe.execute(opt, device=DEV))
        want = engine_result(local)

        def over_wire(p):
            """One PLAN_EXECUTE of ``p``: the exported table and the wall
            up to the server's work done on the card."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hs = c.execute_plan(p)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            got = c.export_table(hs[0])
            c.release(hs[0])
            return got, s

        for rep in ("cold", "warm"):
            if rep == "warm":
                tracing.reset_counters("kernel.")
            got, q5[f"{rep}_s"] = over_wire(plan)
            if rep == "warm":
                q5["launches"] = {k: v for k, v in
                                  kernel_launches(tracing).items()
                                  if k in DECODE_KERNELS}
            check(q5_matches(engine_result(_named(got, q5_names)), want),
                  f"q5 over PLAN_EXECUTE ({rep}) == in-process execute")
        check(all(v > 0 for v in q5["launches"].values()),
              "K3/W1/W2 launched in the server for q5")
        # the bridge's own overhead: paired warm runs, in process then over
        # the wire, so a drift of the card or the host hits both alike
        s_local, s_wire = [], []
        for _ in range(OVERHEAD_REPS):
            s_local.append(wall(torch, lambda: pe.execute(opt,
                                                          device=DEV))[1])
            got, s = over_wire(plan)
            s_wire.append(s)
            check(q5_matches(engine_result(_named(got, q5_names)), want),
                  "q5 over PLAN_EXECUTE (paired run) == in-process execute")
        diffs = [w - x for w, x in zip(s_wire, s_local)]
        q5["in_process_s"] = _percentile(s_local, 50)
        q5["wire_s"] = _percentile(s_wire, 50)
        q5["in_process_s_range"] = [min(s_local), max(s_local)]
        q5["wire_s_range"] = [min(s_wire), max(s_wire)]
        q5["bridge_overhead_s"] = _percentile(diffs, 50)
        q5["bridge_overhead_s_range"] = [min(diffs), max(diffs)]
        # a PLAN_EXECUTE the result cache serves: deserialize, verify, the
        # files' versions, the lookup and the reply, with no execution
        hits = []
        with settings(result_cache=8):
            c.release(c.execute_plan(plan)[0])
            for _ in range(CACHE_HIT_REPS):
                t0 = time.perf_counter()
                hs = c.execute_plan(plan)
                hits.append(time.perf_counter() - t0)
                c.release(hs[0])
            check(c.metrics()["last_plan"].get("served_from_cache") is True,
                  "the repeated q5 was served from the result cache")
        q5["cache_hit_ms"] = {"p50": _percentile(hits, 50) * 1e3,
                              "p95": _percentile(hits, 95) * 1e3}
        out["q5"] = q5
        # the wire half's K1/K2 and the plan half's K3/W1/W2, each from
        # its warm run
        out["launches"] = {**{k: wire_launches[k] for k in (
            "interleave_planes", "deinterleave_wire")}, **q5["launches"]}
        check(all(v > 0 for v in out["launches"].values()),
              "every kernel launched in the bridge's warm runs")

        # -- 4. serving ---------------------------------------------------
        fpath = root / "aqe_fact.parquet"
        scan_plan = pe.Aggregate(pe.Scan(fpath, chunk_bytes=16 << 20), ["u"],
                                 [("v", "sum")], names=["s"])
        point_plan = pe.Filter(pe.Scan(root / "store.parquet"),
                               ("==", pe.col("s_store_sk"),
                                pe.lit(N_STORES // 2)))
        slo = f"5000,{point_plan.fingerprint()[:12]}={POINT_OBJECTIVE_MS}"
        serving = {"point_clients": POINT_CLIENTS,
                   "objective_ms": POINT_OBJECTIVE_MS}

        def run_plan(p, lat=None, errs=None, client=None):
            cc = client or BridgeClient(sock, device="cpu")
            try:
                t0 = time.perf_counter()
                hs = cc.execute_plan(p)
                if lat is not None:
                    lat.append(time.perf_counter() - t0)
                for h in hs:
                    cc.release(h)
            except Exception as e:  # noqa: BLE001 -- collected, checked
                if errs is None:
                    raise
                errs.append(e)
            finally:
                if client is None:
                    cc.close()

        def serve_round(lat, errs, scan=True):
            """Lookups from every client, a think time apart, for as long
            as one scan runs (or for ``BASELINE_S`` with no scan); returns
            the scan's wall."""
            ts, scan_lat = [], []
            if scan:
                sc = BridgeClient(sock, device="cpu")
                scan_t = threading.Thread(
                    target=run_plan, args=(scan_plan, scan_lat, errs, sc))
                scan_t.start()
                while scan_t.is_alive() and not c.query_status(
                        trace_id=sc.trace_id):
                    time.sleep(0.001)
                running = scan_t.is_alive
            else:
                stop = time.perf_counter() + BASELINE_S
                running = lambda: time.perf_counter() < stop  # noqa: E731

            def point(i):
                cc = BridgeClient(sock, device="cpu")
                time.sleep(THINK_S * i / POINT_CLIENTS)  # staggered starts
                while running():
                    run_plan(point_plan, lat, errs, cc)
                    time.sleep(THINK_S)
                cc.close()
            ts = [threading.Thread(target=point, args=(i,))
                  for i in range(POINT_CLIENTS)]
            for t in ts:
                t.start()
            if scan:
                ts.append(scan_t)
            for t in ts:
                t.join(timeout=600)
            if scan:
                sc.close()
            check(not any(t.is_alive() for t in ts), "serving round ended")
            return scan_lat[0] if scan_lat else None

        # the lookup's answer, and its latency with the server otherwise
        # idle: the yardstick of its objective
        hs = c.execute_plan(point_plan)
        got = c.export_table(hs[0])
        c.release(hs[0])
        local_pt = pe.execute(pe.optimize(point_plan), device=DEV)
        check(got.columns[0].to_pylist() == local_pt.columns[0].to_pylist()
              == [N_STORES // 2]
              and got.columns[1].to_pylist()
              == local_pt.columns[1].to_pylist(),
              "the point lookup over the wire == in process")
        alone = []
        for _ in range(POINT_ALONE_REPS):
            run_plan(point_plan, alone, None, c)
        serving["point_alone_ms"] = {"p50": _percentile(alone, 50) * 1e3,
                                     "p95": _percentile(alone, 95) * 1e3}
        run_plan(scan_plan)  # warm the scan's segments
        for mode, scan, kw in (
                ("no_scan", False, {"sched": True}),
                ("sched_on", True, {"sched": True}),
                ("sched_off", True, {"sched": False}),
                ("serial", True, {"sched": True, "max_sessions": 1})):
            lat, errs, scans = [], [], []
            with settings(slo_ms=slo, **kw):
                r0 = SCHEDULER.stats()["rounds"]
                t0 = time.perf_counter()
                for _ in range(SERVING_ROUNDS if scan else 1):
                    scans.append(serve_round(lat, errs, scan))
                wall_s = time.perf_counter() - t0
                rounds = SCHEDULER.stats()["rounds"] - r0
            check(not errs, f"serving ({mode}): no error reply: {errs[:2]}")
            check(len(lat) >= POINT_CLIENTS,
                  f"serving ({mode}): every client's lookups ran")
            lat_ms = np.asarray(lat) * 1e3
            serving[mode] = {"p50_ms": _percentile(lat_ms, 50),
                             "p95_ms": _percentile(lat_ms, 95),
                             "max_ms": float(lat_ms.max()),
                             "met_objective": float(np.mean(
                                 lat_ms <= POINT_OBJECTIVE_MS)),
                             "points": len(lat),
                             "scan_s": [x for x in scans if x is not None],
                             "wall_s": wall_s, "drr_rounds": rounds}

        # max_sessions=2 with both slots held by sessions: four q5s queue,
        # then run two at a time once the slots free
        q0 = SCHEDULER.stats()
        with settings(max_sessions=2):
            holds = [SCHEDULER.admit(fingerprint="hold" * 4,
                                     trace_id=f"hold{i}") for i in range(2)]
            errs = []
            ts = [threading.Thread(target=run_plan, args=(plan, None, errs))
                  for _ in range(POINT_CLIENTS)]
            for t in ts:
                t.start()
            time.sleep(0.3)
            for h in holds:
                h.release()
            for t in ts:
                t.join(timeout=600)
        q1 = SCHEDULER.stats()
        check(not errs, f"max_sessions=2: no error reply: {errs[:2]}")
        serving["queued"] = q1["queued"] - q0["queued"]
        check(serving["queued"] == POINT_CLIENTS,
              "max_sessions=2 queued every q5 behind the held slots")

        # a fingerprint already burning its SLO is shed at once when full
        burn_plan = pe.Filter(pe.Scan(root / "store.parquet"),
                              (">=", pe.col("s_store_sk"), pe.lit(0)))
        prof_dir = root / "bridge_profiles"
        with settings(profile_dir=str(prof_dir),
                      slo_ms=f"{burn_plan.fingerprint()[:12]}=0.001"):
            run_plan(burn_plan)  # one run, over its 1 us objective
            check(blackbox.slo_burn_for(burn_plan.fingerprint()) == 1.0,
                  "the burning fingerprint's burn rate is 1.0")
            with settings(max_sessions=1):
                shed = []
                hold = SCHEDULER.admit(fingerprint="hold" * 4,
                                       trace_id="hold")
                s0 = SCHEDULER.stats()["shed"]
                t0 = time.perf_counter()
                run_plan(burn_plan, None, shed)
                serving["shed_after_s"] = time.perf_counter() - t0
                hold.release()
        check(len(shed) == 1 and isinstance(shed[0], AdmissionRejectedError)
              and "slo-burn" in str(shed[0]) and shed[0].trace_id,
              f"the burning fingerprint was shed typed: {shed}")
        serving["shed"] = SCHEDULER.stats()["shed"] - s0
        check(serving["shed"] == 1, "one shed")

        # OP_CANCEL of a running scan (each chunk's decode slowed 50 ms by
        # the timeout seam, so the scan is in flight when the cancel lands)
        base = c.live_count()
        ca = BridgeClient(sock, device="cpu")
        errs = []
        with settings(faults="parquet.device_decode:*:timeout"):
            faults.reset()
            scan_t = threading.Thread(target=run_plan,
                                      args=(scan_plan, None, errs, ca))
            scan_t.start()
            for _ in range(5000):
                if c.query_status(trace_id=ca.trace_id):
                    break
                time.sleep(0.001)
            serving["cancelled"] = c.cancel(ca.trace_id)
            scan_t.join(timeout=600)
        ca.close()
        check(serving["cancelled"] == 1 and len(errs) == 1
              and isinstance(errs[0], QueryCancelledError)
              and errs[0].trace_id == ca.trace_id,
              f"OP_CANCEL stopped the running scan: {errs}")
        c.ping()
        check(c.live_count() == base, "live_count back at its base")

        # a one-shot device-decode fault recovers to the same answer
        r0 = tracing.counter_value("engine.retries.parquet.device_decode")
        with settings(faults="parquet.device_decode:1:io_error",
                      retry_backoff_s=0.001):
            faults.reset()
            hs = c.execute_plan(plan)
        got = engine_result(_named(c.export_table(hs[0]), q5_names))
        c.release(hs[0])
        serving["fault_retries"] = tracing.counter_value(
            "engine.retries.parquet.device_decode") - r0
        check(q5_matches(got, want) and serving["fault_retries"] == 1,
              "a parquet.device_decode fault was retried to the same q5")

        # a failing query leaves a bundle that names its trace
        bb = root / "bridge_bundles"
        with settings(blackbox_dir=str(bb)):
            errs = []
            run_plan(pe.Scan(root / "no_such.parquet"), None, errs, c)
        check(len(errs) == 1 and isinstance(errs[0], TransientError)
              and errs[0].bundle_path, f"the failing query: {errs}")
        doc = blackbox.read_bundle(errs[0].bundle_path)
        check(doc["trace_id"] == c.trace_id == errs[0].trace_id,
              "the bundle names the client's trace id")
        serving["bundles"] = len(blackbox.list_bundles(str(bb)))
        out["serving"] = serving
        m = c.metrics()
        out["server"] = {"errors": m["errors"], "ops": m["ops"],
                         "busy_s": m["busy_s"],
                         "scheduler": {k: m["scheduler"][k] for k in (
                             "admitted", "queued", "shed", "rounds")},
                         "blackbox": m["blackbox"]}
        # the deliberate errors only: shed, cancel, missing file
        check(m["errors"] == 3, f"no unexpected error reply: {m['errors']}")
        check(c.live_count() == 0, "every handle released")
    finally:
        if spawned is not None:
            spawned.kill()
            spawned.wait(timeout=60)
        try:
            c.shutdown_server()
        finally:
            st.join(timeout=60)
            shutil.rmtree(sock_dir, ignore_errors=True)
    check(not st.is_alive(), "the in-process server stopped")
    fpath.unlink()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# 16. nested: STRUCT and LIST columns through Parquet, ORC and CSV
# ---------------------------------------------------------------------------

NESTED_GROUP_ROWS = 1 << 20    # 4 row groups at the default 2^22 rows
NESTED_KEYS = 1_000_000        # the key's domain
NESTED_CUT = 500_000           # both plans keep key < NESTED_CUT
NESTED_PASS = 96 << 20         # the chunked reader's pass limit
NESTED_SIDE_ROWS = 1 << 20     # rows of the ORC and CSV round trips
NESTED_FIELDS = ["id", "name", "price"]


def _ragged(rng, lens, valid, values):
    """(int64 offsets, valid) of rows with ``lens`` items, null rows
    emptied, and the flat items ``values(total)``."""
    lens = np.where(valid, lens, 0)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs, values(int(offs[-1]))


def nested_columns(n: int, seed: int):
    """The nested phase's fact table as port Columns on the CPU, every null
    (at any level) holding zeros or no bytes: an INT64 key and a FLOAT64
    measure with nulls, a STRING, an optional STRUCT<id INT64, name
    STRING, price FLOAT64> with nulls at both levels, LIST<INT32> (0-16
    items, mean 8, 5% null lists, 5% null items) and LIST<LIST<INT64>>."""
    import torch
    from spark_rapids_jni_tpu_torch import dtypes as pdt
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    rng = np.random.default_rng([seed, 16])

    def fixed(dtype, vals, valid=None):
        if valid is not None:
            vals = np.where(valid, vals, 0).astype(vals.dtype)
        return Column.fixed(dtype, vals, valid, device="cpu")

    def text(valid, lo, hi):
        offs, chars = _ragged(rng, rng.integers(lo, hi + 1, n), valid,
                              lambda t: rng.integers(97, 123, t,
                                                     dtype=np.uint8))
        return Column.string(chars, offs.astype(np.int32), valid,
                             device="cpu")

    kv = rng.random(n) >= 0.02
    vv = rng.random(n) >= 0.03
    sv = rng.random(n) >= 0.05
    idv = rng.random(n) >= 0.03
    namev = sv & (rng.random(n) >= 0.04)
    st = Column(pdt.STRUCT, validity=torch.from_numpy(sv), children=(
        fixed(pdt.INT64, rng.integers(0, 1 << 40, n) * sv, idv),
        text(namev, 5, 16),
        fixed(pdt.FLOAT64, np.where(sv, np.round(
            rng.random(n) * 1000, 2), 0.0))))
    lv = rng.random(n) >= 0.05
    loffs, items = _ragged(rng, rng.integers(0, 17, n), lv,
                           lambda t: rng.integers(-10**6, 10**6, t)
                           .astype(np.int32))
    iv = rng.random(len(items)) >= 0.05
    l_col = Column.list_(fixed(pdt.INT32, items, iv),
                         loffs.astype(np.int32), lv, device="cpu")
    ov = rng.random(n) >= 0.03
    ooffs, _ = _ragged(rng, rng.integers(0, 5, n), ov, lambda t: None)
    m = int(ooffs[-1])
    inv = rng.random(m) >= 0.03
    ioffs, leaf = _ragged(rng, rng.integers(0, 7, m), inv,
                          lambda t: rng.integers(-2**40, 2**40, t))
    inner = Column.list_(fixed(pdt.INT64, leaf), ioffs.astype(np.int32),
                         inv, device="cpu")
    ll_col = Column.list_(inner, ooffs.astype(np.int32), ov, device="cpu")
    return Table([
        fixed(pdt.INT64, rng.integers(0, NESTED_KEYS, n), kv),
        fixed(pdt.FLOAT64, rng.standard_normal(n) * 100, vv),
        text(rng.random(n) >= 0.01, 5, 20),
        st, l_col, ll_col], ["k", "v", "s", "st", "l", "ll"])


def nested_mismatch(got, want, where: str, live=None):
    """The first place two columns differ, or None: validity (a field of a
    null struct row counts as null), offsets and chars exactly, fixed-width
    values bit for bit where valid.  ``got`` may sit on the card."""
    gv = got.valid_mask().cpu().numpy()
    wv = want.valid_mask().cpu().numpy()
    if live is not None:
        wv = wv & live
    if int(got.dtype.id) != int(want.dtype.id):
        return where + ".dtype"
    if not np.array_equal(gv, wv):
        return where + ".validity"
    if got.offsets is not None and not np.array_equal(
            got.offsets.cpu().numpy(), want.offsets.cpu().numpy()):
        return where + ".offsets"
    if got.dtype.id.name == "STRUCT":
        for i, (a, b) in enumerate(zip(got.children, want.children)):
            bad = nested_mismatch(a, b, f"{where}.{i}", wv)
            if bad:
                return bad
        return None
    if got.dtype.id.name == "LIST":
        return nested_mismatch(got.children[0], want.children[0],
                               where + ".item")
    g, w = got.data.cpu().numpy(), want.data.cpu().numpy()
    if got.dtype.is_string:
        return None if np.array_equal(g, w) else where + ".chars"
    if len(g) != len(w):
        return where + ".data"
    if not len(g):
        return None
    eq = g.view(np.uint8).reshape(len(g), -1) == \
        w.view(np.uint8).reshape(len(w), -1)
    return None if eq.all(axis=1)[wv].all() else where + ".data"


def tables_match(got, want, what: str, device=None) -> None:
    check(list(got.names) == list(want.names) and
          got.num_rows == want.num_rows, f"{what}: names and rows")
    for name, a, b in zip(got.names, got.columns, want.columns):
        if device is not None:
            check(a.device.type == device, f"{what}: {name} on {device}")
        bad = nested_mismatch(a, b, name)
        check(bad is None, f"{what}: {bad} equals the written arrays")


def same_bits(a, b) -> bool:
    """Two columns bit for bit: the same buffers (None where None) at every
    nesting level."""
    for x, y in ((a.data, b.data), (a.validity, b.validity),
                 (a.offsets, b.offsets)):
        if (x is None) != (y is None):
            return False
        if x is not None and not np.array_equal(
                x.cpu().numpy().view(np.uint8), y.cpu().numpy().view(np.uint8)):
            return False
    return len(a.children) == len(b.children) and all(
        same_bits(x, y) for x, y in zip(a.children, b.children))


def csv_columns(table, n: int):
    """The CSV round trip's 6 columns from the fact's first ``n`` rows:
    the key, the struct's 2-decimal price (exact through pandas' float
    parse), the STRING, a bool, an INT32 and a note that needs quoting."""
    from spark_rapids_jni_tpu_torch import dtypes as pdt
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.ops.selection import slice_table
    head = slice_table(table, 0, n)
    st = head["st"]
    rng = np.random.default_rng(161)
    bv = rng.random(n) >= 0.04
    notes = [None if i % 19 == 0 else
             f'say "{i % 97}", then {i % 7}' if i % 3 == 0 else
             f"line {i % 1009}\nnext" if i % 3 == 1 else f"plain{i % 5003}"
             for i in range(n)]
    price = Column.fixed(pdt.FLOAT64, st.children[2].data, st.validity,
                         device="cpu")
    return Table([
        head["k"], price, head["s"],
        Column.fixed(pdt.BOOL8, (rng.random(n) < 0.5) & bv, bv,
                     device="cpu"),
        Column.fixed(pdt.INT32, rng.integers(-2**31, 2**31, n), device="cpu"),
        Column.from_pylist(notes, device="cpu")],
        ["k", "price", "s", "flag", "qty", "note"])


@contextlib.contextmanager
def without_modules(*names):
    """The body runs as on a host without the named packages: importing
    one of them raises ImportError until the body ends."""
    saved = {m: sys.modules.get(m) for m in names}
    sys.modules.update({m: None for m in names})
    try:
        yield
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def phase_nested(torch, root, tracing, n: int, seed: int) -> dict:
    """``_phase_nested`` with pyarrow and pandas blocked: the port's own
    snappy encoder writes the file and its own tokenizer reads the CSV, as
    on a host that has neither package."""
    host_had = {m: _importable(m) for m in ("pyarrow", "pandas")}
    with without_modules("pyarrow", "pandas"):
        out = _phase_nested(torch, root, tracing, n, seed)
    out["host_has"] = host_had
    return out


def _importable(name: str) -> bool:
    import importlib.util
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def _phase_nested(torch, root, tracing, n: int, seed: int) -> dict:
    """Nested columns and the rest of I/O on the card: the port's Parquet
    writer (snappy, with its own encoder where pyarrow is absent), the
    whole and chunked reads of STRUCT and LIST onto the card against the
    written arrays, the first group against the CPU read, two engine
    plans (the scalar projection by the device route, K3/W1/W2; the
    nested one by the host route, reason "nested", gathered on the card),
    an ORC round trip with the STRUCT and the LIST, a CSV round trip."""
    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.engine.plan import (
        Filter, Project, Scan, col, lit, topo_nodes)
    from spark_rapids_jni_tpu_torch.io import (
        ParquetChunkedReader, ParquetFile, read_csv, read_orc,
        read_parquet, write_csv, write_orc, write_parquet)
    from spark_rapids_jni_tpu_torch.io.parquet import arrow_codec
    from spark_rapids_jni_tpu_torch.ops.selection import (concat_tables,
                                                          gather_table,
                                                          slice_table)
    out = {"phase": "nested", "rows": n, "group_rows": NESTED_GROUP_ROWS,
           "snappy_encoder": "pyarrow" if arrow_codec("snappy")[0]
           else "port (io/snappy.py compress, literal tokens)"}
    t0 = time.perf_counter()
    src = nested_columns(n, seed)
    out["build_s"] = time.perf_counter() - t0
    out["source_bytes"] = sum(column_bytes(c) for c in src.columns)
    path = root / "nested_fact.parquet"
    t0 = time.perf_counter()
    write_parquet(src, path, compression="snappy",
                  row_group_size=NESTED_GROUP_ROWS,
                  struct_fields={"st": NESTED_FIELDS})
    out["write_s"] = time.perf_counter() - t0
    out["file_bytes"] = path.stat().st_size
    pf = ParquetFile(path)
    check(pf.num_row_groups == -(-n // NESTED_GROUP_ROWS),
          "the nested file has one row group per 2^20 rows")
    check([f.name for f in pf.schema[3].fields] == NESTED_FIELDS,
          "the struct's field names are in the footer")

    got, out["read_s"] = wall(torch, lambda: read_parquet(path, device=DEV))
    tables_match(got, src, "read_parquet", DEV)
    out["device_bytes"] = sum(column_bytes(c) for c in got.columns)
    del got
    torch.cuda.empty_cache()

    def chunked():
        with ParquetChunkedReader(path, pass_read_limit=NESTED_PASS,
                                  device=DEV) as r:
            return list(r)
    chunks, out["chunked_s"] = wall(torch, chunked)
    out["chunks"] = len(chunks)
    check(len(chunks) > pf.num_row_groups,
          "the pass limit splits the row groups")
    tables_match(concat_tables(chunks), src, "ParquetChunkedReader",
                 DEV)
    del chunks
    torch.cuda.empty_cache()

    g0, out["group0_s"] = wall(torch, lambda: pf.read_row_group(
        0, device=DEV))
    g0_cpu = pf.read_row_group(0, device="cpu")
    check(all(same_bits(a, b) for a, b in zip(g0.columns, g0_cpu.columns)),
          "row group 0 on the card == the port's CPU read, bit for bit")
    del g0, g0_cpu

    kv = src["k"].valid_mask().numpy()
    keep = np.flatnonzero(kv & (src["k"].data.numpy() < NESTED_CUT))
    want = gather_table(src, torch.from_numpy(keep))
    cut = ("<", col("k"), lit(NESTED_CUT))

    def plan_of(cols):
        return pe.optimize(Project(Filter(Scan(path, chunk_bytes=64 << 20),
                                          cut), cols))
    scalar = plan_of(["k", "v"])
    scan = [x for x in topo_nodes(scalar) if isinstance(x, Scan)][0]
    out["scalar_scan_columns"] = list(scan.columns or ())
    check(sorted(out["scalar_scan_columns"]) == ["k", "v"],
          "the optimizer prunes the scan to the key and the measure")
    res, out["scalar_cold_s"] = wall(torch, lambda: pe.execute(
        scalar, device=DEV))
    f0 = tracing.counter_value("io.device_decode.fallbacks")
    tracing.reset_counters("kernel.")
    res, out["scalar_warm_s"] = wall(torch, lambda: pe.execute(
        scalar, device=DEV))
    out["launches"] = kernel_launches(tracing)
    check(tracing.counter_value("io.device_decode.fallbacks") == f0,
          "the scalar projection keeps the device route")
    check(all(out["launches"][k] > 0 for k in DECODE_KERNELS),
          "the scalar projection launches K3, W1 and W2")
    tables_match(res, want.select(["k", "v"]), "scalar plan", DEV)
    out["scalar_rows"] = res.num_rows
    del res

    nested = plan_of(["k", "st", "l"])
    nested_reason = "io.device_decode.fallback.nested"
    r0 = tracing.counter_value(nested_reason)
    res, out["nested_plan_s"] = wall(torch, lambda: pe.execute(
        nested, device=DEV))
    out["nested_fallbacks"] = tracing.counter_value(nested_reason) - r0
    check(out["nested_fallbacks"] == pf.num_row_groups,
          'every group of the nested plan went to the host as "nested"')
    tables_match(res, want.select(["k", "st", "l"]), "nested plan", DEV)
    out["nested_rows"] = res.num_rows
    del res, want
    torch.cuda.empty_cache()

    side = min(NESTED_SIDE_ROWS, n)
    orc_src = slice_table(src.select(["k", "st", "l"]), 0, side)
    orc_path = root / "nested.orc"
    t0 = time.perf_counter()
    write_orc(orc_src, orc_path, compression="zlib",
              struct_fields={"st": NESTED_FIELDS})
    out["orc_write_s"] = time.perf_counter() - t0
    out["orc_bytes"] = orc_path.stat().st_size
    back, out["orc_read_s"] = wall(torch, lambda: read_orc(orc_path,
                                                          device=DEV))
    tables_match(back, orc_src, "ORC round trip", DEV)
    del back, orc_src

    csv_src = csv_columns(src, side)
    csv_path = root / "nested.csv"
    t0 = time.perf_counter()
    write_csv(csv_src, csv_path)
    out["csv_write_s"] = time.perf_counter() - t0
    out["csv_bytes"] = csv_path.stat().st_size
    back, out["csv_read_s"] = wall(torch, lambda: read_csv(csv_path,
                                                          device=DEV))
    check([c.dtype.id.name for c in back.columns] ==
          ["INT64", "FLOAT64", "STRING", "BOOL8", "INT64", "STRING"],
          "CSV types inferred as the JAX reader infers them")
    for name, a, b in zip(back.names, back.columns, csv_src.columns):
        check(a.device.type == DEV, f"CSV {name} on the card")
        if name == "qty":  # written from INT32, inferred INT64
            check(np.array_equal(a.data.cpu().numpy(),
                                 b.data.numpy().astype(np.int64)),
                  "CSV qty reads back")
            continue
        bad = nested_mismatch(a, b, name)
        check(bad is None, f"CSV round trip: {bad}")
    out["csv_rows"] = back.num_rows
    del back
    return out


# ---------------------------------------------------------------------------
# 17. ranks: the mesh over processes, one torch.distributed rank each
# ---------------------------------------------------------------------------

RANKS_TIMEOUT = 300.0   # seconds a rank's collective may wait
RANK_AGGS = [("i64", "sum"), ("i64", "count"), ("f64", "min"),
             ("f64", "max")]


def _rank_wall(torch, dev, fn):
    """``wall`` on a rank's own device (a CPU rank has nothing to sync)."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _rank_shuffle(torch, ranks, table, key, mesh, one) -> dict:
    """This rank's block of ``table`` shuffled over the ranks: timed, and
    every received slot and live mask held bit for bit against this rank's
    slice of the one-process 8-shard shuffle of the whole table."""
    from spark_rapids_jni_tpu_torch.ops.row_conversion import \
        fixed_width_layout
    from spark_rapids_jni_tpu_torch.ops.selection import slice_table
    from spark_rapids_jni_tpu_torch.parallel import shuffle as sh
    from spark_rapids_jni_tpu_torch.parallel.stringplane import \
        explode_strings
    r, w, dev = ranks.rank, ranks.world, ranks.device
    n = table.num_rows
    block = slice_table(table, r * n // w, (r + 1) * n // w - r * n // w)

    def run():
        return sh.shuffle_table_padded(block, mesh, [key])

    rec = {"rows": block.num_rows}
    _, rec["cold_s"] = _rank_wall(torch, dev, run)
    warm = sorted(_rank_wall(torch, dev, run)[1] for _ in range(3))
    rec["ms"] = warm[1] * 1e3
    got, ok, ovf = run()
    want, wok, wovf = sh.shuffle_table_padded(table, one, [key])
    half = want.num_rows // w
    check(int(ovf) == int(wovf) == 0
          and torch.equal(ok, wok[r * half:(r + 1) * half])
          and _tables_equal(torch, got, slice_table(want, r * half, half),
                            exact=True),
          f"rank {r} ({ranks.backend}): {key} shuffle slots bit for bit == "
          "its slice of the one-process 8-shard shuffle")
    nl = SHARDS // w
    cap = got.num_rows // (nl * SHARDS)
    flat = explode_strings(block, ranks=ranks)[0] if any(
        c.dtype.is_string for c in block.columns) else block
    row_size = fixed_width_layout(flat.dtypes()).row_size
    rec.update(capacity=cap, row_bytes=row_size,
               grid_bytes=nl * SHARDS * cap * row_size,
               cross_bytes=nl * SHARDS * cap * row_size * (w - 1) // w,
               live_rows=int(ok.sum()))
    return rec


def _rank_stage_table(torch, n: int, seed: int, dev):
    """The stage's table (the exchange phase's), with a unique ``row``."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.interop import (
        HostColumn, table_from_numpy)
    from spark_rapids_jni_tpu_torch.dtypes import INT64
    cols = stage_columns(n, seed)
    table = table_from_numpy([HostColumn(t, s_, d, v)
                              for _, t, s_, d, v in cols],
                             [c[0] for c in cols], device=dev)
    return Table(list(table.columns) + [Column(INT64, data=torch.arange(
        n, device=dev))], list(table.names) + ["row"])


def rank_phase(ranks, root, n: int, n_str: int, seed: int,
               plans: bool) -> dict:
    """One rank of the ranks phase (run in its own process by
    ``parallel.ranks.spawn``): the INT32-key and STRING-key shuffles and,
    with ``plans``, the distributed groupby and join and engine q5."""
    import torch
    from spark_rapids_jni_tpu_torch import engine as pe
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import INT32, INT64
    from spark_rapids_jni_tpu_torch.ops.aggregate import groupby
    from spark_rapids_jni_tpu_torch.ops.join import inner_join
    from spark_rapids_jni_tpu_torch.ops.selection import slice_table
    from spark_rapids_jni_tpu_torch.parallel import distributed as dist
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
    from spark_rapids_jni_tpu_torch.utils import tracing
    check(not {"jax", "spark_rapids_jni_tpu"} & set(sys.modules),
          "a rank imports neither jax nor the JAX package")
    r, w, dev = ranks.rank, ranks.world, ranks.device
    mesh = pmesh.make_mesh(SHARDS, device=dev, ranks=ranks)
    one = pmesh.make_mesh(SHARDS, device=dev)
    out = {"rank": r, "world": w, "backend": ranks.backend,
           "device": str(dev)}
    table = _rank_stage_table(torch, n, seed, dev)
    tracing.reset_counters("kernel.")
    out["int32_key"] = _rank_shuffle(torch, ranks, table, "i32", mesh, one)
    rng = np.random.default_rng(seed + 6)
    chars, offsets, valid = text_strings(rng, n_str)
    stbl = Table([Column.string(chars, offsets, valid, device=dev),
                  Column.fixed(INT64, np.arange(n_str), device=dev)],
                 ["s", "row"])
    out["string_key"] = _rank_shuffle(torch, ranks, stbl, "s", mesh, one)
    del stbl
    launches = kernel_launches(tracing)
    if not plans:
        out["launches"] = launches
        return out

    # the distributed groupby and join: this rank's block in, the
    # gathered answer against one device
    blk = slice_table(table, r * n // w, (r + 1) * n // w - r * n // w)
    tracing.reset_counters("kernel.")
    got, gs = _rank_wall(torch, dev, lambda: dist.distributed_groupby(
        blk, mesh, ["i32"], RANK_AGGS))
    got = _sorted_by(torch, pmesh.gather_table(got, ranks), "i32")
    one_gb = groupby(table, ["i32"], RANK_AGGS, device=dev)
    check(got.num_rows == one_gb.num_rows and all(
        _same_values(torch, a, b)
        for a, b in zip(got.columns, one_gb.columns)),
          f"rank {r}: distributed groupby over the ranks == one device")
    out["groupby"] = {"s": gs, "groups": got.num_rows}
    m = min(n, 1 << 22)
    fact = Table([col_head(table["i32"], m), col_head(table["row"], m)],
                 ["k", "row"])
    dk = torch.arange(100_000, device=dev)
    dim = Table([Column(INT32, data=dk.to(torch.int32)),
                 Column(INT64, data=dk * 3)], ["k", "v"])
    got, js = _rank_wall(torch, dev, lambda: dist.distributed_join(
        slice_table(fact, r * m // w, (r + 1) * m // w - r * m // w),
        slice_table(dim, r * 100_000 // w, 100_000 // w), mesh, ["k"]))
    got = pmesh.gather_table(got, ranks)
    check(_tables_equal(torch, _sorted_by(torch, got, "row"),
                        _sorted_by(torch, inner_join(fact, dim, ["k"],
                                                     device=dev), "row")),
          f"rank {r}: distributed join over the ranks == one device")
    out["join"] = {"s": js, "rows_out": got.num_rows}
    for k, v in kernel_launches(tracing).items():
        launches[k] += v
    del table, blk, fact

    # engine q5: rank 0 plans, every rank runs its row groups
    plan = q5_engine_plan(root, *Q5_DATES)
    base = pe.execute(pe.optimize(plan), device=dev)
    with settings(shards=SHARDS):
        opt = pe.optimize(plan, distribute=True, ranks=ranks)
        eng = {}
        _, eng["cold_s"] = _rank_wall(torch, dev, lambda: pe.execute(
            opt, device=dev, ranks=ranks))
        stats = pe.new_stats()
        tracing.reset_counters("kernel.")
        res, eng["warm_s"] = _rank_wall(torch, dev, lambda: pe.execute(
            opt, stats=stats, device=dev, ranks=ranks))
        eng["launches"] = kernel_launches(tracing)
    eng.update(exchanges=stats["exchanges"],
               row_groups_read=stats["row_groups_read"],
               plan=opt.fingerprint())
    check(q5_matches(engine_result(res), engine_result(base)),
          f"rank {r}: engine q5 with distribute=True across the ranks == "
          "the one-process plan")
    if dev.type == "cuda":
        check(all(eng["launches"][k] > 0 for k in DECODE_KERNELS),
              f"rank {r}: engine q5 launched K3, W1 and W2 on this rank")
    for k, v in eng["launches"].items():
        launches[k] += v
    out["engine_q5"] = eng
    out["launches"] = launches
    return out


def rank_nccl_one(ranks, n: int, seed: int) -> dict:
    """One NCCL rank: the same INT32-key shuffle (over one rank nothing
    crosses) held against the one-process shuffle, then NCCL's own
    collectives over the group at the grid's size, timed."""
    import torch
    import torch.distributed as tdist
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
    check(not {"jax", "spark_rapids_jni_tpu"} & set(sys.modules),
          "a rank imports neither jax nor the JAX package")
    dev = ranks.device
    table = _rank_stage_table(torch, n, seed, dev)
    mesh = pmesh.make_mesh(SHARDS, device=dev, ranks=ranks)
    out = {"rank": ranks.rank, "world": ranks.world,
           "backend": ranks.backend, "device": str(dev)}
    out["int32_key"] = _rank_shuffle(torch, ranks, table, "i32", mesh,
                                     pmesh.make_mesh(SHARDS, device=dev))
    grid = torch.randint(0, 1 << 30, (out["int32_key"]["grid_bytes"] // 4,),
                         dtype=torch.int32, device=dev)
    recv = torch.empty_like(grid)

    def a2a():
        tdist.all_to_all_single(recv, grid, group=ranks.group)

    _, out["a2a_cold_s"] = _rank_wall(torch, dev, a2a)
    out["a2a_ms"] = sorted(_rank_wall(torch, dev, a2a)[1]
                           for _ in range(5))[2] * 1e3
    red = grid[:1024].to(torch.int64)
    tdist.all_reduce(red, group=ranks.group)
    gath = [torch.empty_like(grid[:1024]) for _ in range(ranks.world)]
    tdist.all_gather(gath, grid[:1024], group=ranks.group)
    check(torch.equal(recv, grid) and torch.equal(
        red, grid[:1024].to(torch.int64) * ranks.world)
          and all(torch.equal(g, grid[:1024]) for g in gath),
          "NCCL all_to_all, all_reduce and all_gather over the group")
    return out


def phase_ranks(torch, root, n: int, n_str: int, seed: int) -> dict:
    """Two gloo ranks sharing the card, one NCCL rank, NCCL's refusal of
    two ranks on one card, and NCCL one rank a card where there are two
    cards or more.  Any rank's failure, or a run past its timeout, raises
    here."""
    from spark_rapids_jni_tpu_torch.parallel import ranks as pranks
    out = {"phase": "ranks", "shards": SHARDS, "rows": n,
           "string_rows": n_str}
    t0 = time.perf_counter()
    gloo = pranks.spawn(rank_phase, 2, "gloo", ["cuda:0", "cuda:0"],
                        RANKS_TIMEOUT, args=(str(root), n, n_str, seed,
                                             True))
    out["gloo_s"] = time.perf_counter() - t0
    out["gloo"] = gloo
    check(gloo[0]["engine_q5"]["plan"] == gloo[1]["engine_q5"]["plan"],
          "both ranks ran rank 0's physical plan")
    t0 = time.perf_counter()
    (nccl,) = pranks.spawn(rank_nccl_one, 1, "nccl", ["cuda:0"],
                           RANKS_TIMEOUT, args=(n, seed))
    out["nccl_s"] = time.perf_counter() - t0
    out["nccl"] = nccl
    t0 = time.perf_counter()
    try:
        pranks.spawn(rank_nccl_one, 2, "nccl", ["cuda:0", "cuda:0"], 60.0,
                     args=(1 << 16, seed))
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    check("two ranks on one device" in refused,
          "NCCL is refused for two ranks on one card, before it can hang")
    out["nccl_two_on_one_card_refused_s"] = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    world = max((k for k in (8, 4, 2) if k <= cards), default=0)
    if world:
        t0 = time.perf_counter()
        out["nccl_cards"] = pranks.spawn(
            rank_phase, world, "nccl", [f"cuda:{i}" for i in range(world)],
            RANKS_TIMEOUT, args=(str(root), n, n_str, seed, False))
        out["nccl_cards_s"] = time.perf_counter() - t0
    else:
        print(f"ranks: NCCL with one rank a card not run: this host has "
              f"{cards} card", flush=True)
        out["nccl_cards"] = f"not run: {cards} card"
    for name, recs in (("gloo, host-staged, 2 ranks on one card", gloo),
                       ("nccl, 1 rank", [nccl])):
        for rec in recs:
            for key in ("int32_key", "string_key"):
                if key in rec:
                    k = rec[key]
                    print(f"ranks: {name}: rank {rec['rank']} {key} shuffle "
                          f"{k['ms']:.3f} ms, grid {k['grid_bytes']} B, "
                          f"{k['cross_bytes']} B to the other ranks",
                          flush=True)
    out["launches"] = {k: sum(g["launches"][k] for g in gloo)
                       for k in ALL_KERNELS}
    out["launches_per_rank"] = {k: [g["launches"][k] for g in gloo]
                                for k in ALL_KERNELS}
    return out


def _build_all(modules) -> dict:
    """nvcc for every CUDA source at once, one process each."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(modules)) as ex:
        futs = {name: ex.submit(mod.build, True) for name, mod in modules}
        return {name: f.result() for name, f in futs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--string-rows", type=int, default=1 << 22)
    ap.add_argument("--fact-rows", type=int, default=1 << 24)
    ap.add_argument("--ops-rows", type=int, default=1 << 24)
    ap.add_argument("--ops-string-rows", type=int, default=1 << 22)
    ap.add_argument("--nds-rows", type=int, default=1 << 24)
    ap.add_argument("--orc-rows", type=int, default=1 << 22)
    ap.add_argument("--exchange-rows", type=int, default=1 << 24)
    ap.add_argument("--exchange-string-rows", type=int, default=1 << 22)
    ap.add_argument("--adaptive-rows", type=int, default=1 << 24)
    ap.add_argument("--bridge-rows", type=int, default=1 << 24)
    ap.add_argument("--nested-rows", type=int, default=1 << 22)
    ap.add_argument("--ranks-rows", type=int, default=1 << 24)
    ap.add_argument("--ranks-string-rows", type=int, default=1 << 22)
    args = ap.parse_args()
    # 16 row groups, so q5's footer pruning has groups to skip; the
    # decode matrix is one group of at most 2^20 rows
    group_rows = max(args.fact_rows // 16, 1)
    matrix_rows = min(1 << 20, group_rows)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.columnar.interop import (
        HostColumn, table_from_numpy)
    from spark_rapids_jni_tpu_torch.kernels import parquet_decode as pqk
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
    built = _build_all([("row_wire", row_wire), ("parquet_decode", pqk)])
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          **{name: {"seconds": b["seconds"],
                    "ptxas": [ln.strip() for ln in b["log"].splitlines()
                              if "registers" in ln or "smem" in ln]}
             for name, b in built.items()}})

    kernels = phase_kernels(torch, row_wire, args.seed, args.rows)
    emit({"phase": "kernels", **kernels})

    cols = stage_columns(args.rows, args.seed)
    stage = phase_stage(torch, port, cols, args.seed)
    del cols
    torch.cuda.empty_cache()
    emit(stage)

    emit(phase_strings(torch, port, args.string_rows, args.seed))
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t1 = time.perf_counter()
        fact = fact_columns(args.fact_rows, args.seed)
        dates, stores = dim_columns()
        write_parquet(root / "store_sales.parquet", fact, group_rows,
                      "snappy")
        write_parquet(root / "date_dim.parquet", dates, 1 << 20, "snappy")
        write_parquet(root / "store.parquet", stores, 1 << 20, "snappy")
        emit({"phase": "files", "seconds": time.perf_counter() - t1,
              "fact_rows": args.fact_rows, "group_rows": group_rows,
              "bytes": {p.name: p.stat().st_size
                        for p in sorted(root.iterdir())}})

        decode = phase_decode(torch, root, fact, args.seed, matrix_rows)
        emit(decode)
        torch.cuda.empty_cache()

        dk = phase_decode_kernels(torch, root, root / "store_sales.parquet",
                                  args.seed, matrix_rows)
        emit({"phase": "decode_kernels", **dk})
        torch.cuda.empty_cache()

        q5 = phase_q5(torch, root, fact, dates, stores, pqk, tracing)
        emit(q5)
        torch.cuda.empty_cache()

        k1 = kernels["interleave_planes"]
        copy_gbps = k1["bound_ms"] * HBM_BYTES_PER_S / k1["library_ms"] / 1e9
        engine = phase_engine(torch, root, fact, dates, stores, pqk, tracing,
                              q5, copy_gbps)
        emit(engine)
        del fact
        torch.cuda.empty_cache()

        ops = phase_ops(torch, tracing, args.ops_rows, args.ops_string_rows,
                        args.seed)
        emit({k: v for k, v in ops.items() if k != "ops"})
        torch.cuda.empty_cache()

        nds = phase_nds(torch, root, pqk, tracing, args.nds_rows, args.seed)
        emit(nds)
        torch.cuda.empty_cache()

        orc = phase_orc(torch, root, tracing, args.orc_rows, args.seed)
        emit(orc)
        torch.cuda.empty_cache()

        exchange = phase_exchange(torch, root, tracing, args.exchange_rows,
                                  args.exchange_string_rows, args.seed)
        emit(exchange)
        torch.cuda.empty_cache()

        adaptive = phase_adaptive(torch, root, tracing, args.adaptive_rows,
                                  args.seed)
        emit(adaptive)
        torch.cuda.empty_cache()

        bridge = phase_bridge(torch, root, tracing, args.bridge_rows,
                              args.seed)
        emit(bridge)
        torch.cuda.empty_cache()

        nested = phase_nested(torch, root, tracing, args.nested_rows,
                              args.seed)
        emit(nested)
        torch.cuda.empty_cache()

        ranks = phase_ranks(torch, root, args.ranks_rows,
                            args.ranks_string_rows, args.seed)
        emit(ranks)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    pkg = "spark_rapids_jni_tpu_torch/kernels/csrc/"
    jax_pkg = "spark_rapids_jni_tpu/ops/"
    rows = [
        {"name": name, "route": "cuda", "source": pkg + "row_wire.cu",
         "replaces": jax_pkg + ref, "launches": stage["launches"][name],
         "orc_launches": orc["launches"][name],
         "exchange_launches": exchange["launches"][name],
         "adaptive_launches": adaptive["launches"][name],
         "bridge_launches": bridge["launches"][name],
         "nested_launches": nested["launches"][name],
         "ranks_launches": ranks["launches"][name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": "bytes",
         "library_ms": k["library_ms"], "shape": k["shape"]}
        for (name, k), ref in zip(kernels.items(), ("pallas_kernels.py:28",
                                                    "pallas_kernels.py:34"))]
    contract = dk["plain_gather"]["cases"][0]
    rows.append({
        "name": "plain_gather", "route": "cuda",
        "source": pkg + "parquet_decode.cu",
        "replaces": jax_pkg + "parquet_decode.py:336",
        "launches": q5["launches"]["plain_gather"],
        "engine_launches": engine["launches"]["plain_gather"],
        "nds_launches": nds["launches"]["plain_gather"],
        "orc_launches": orc["launches"]["plain_gather"],
        "exchange_launches": exchange["launches"]["plain_gather"],
        "adaptive_launches": adaptive["launches"]["plain_gather"],
        "bridge_launches": bridge["launches"]["plain_gather"],
        "nested_launches": nested["launches"]["plain_gather"],
        "ranks_launches": ranks["launches"]["plain_gather"],
        "ranks_launches_per_rank":
            ranks["launches_per_rank"]["plain_gather"],
        "max_abs_err": dk["plain_gather"]["max_abs_err"],
        "ms": contract["ms"], "kernel_ms": contract["ms"],
        "plain_ms": contract["plain_ms"], "bound_ms": contract["bound_ms"],
        "bound_by": "bytes", "library_ms": contract["library_ms"],
        "library_call": "torch.gather(unc, 1, flat_offsets)"
                        ".view(torch.int32), int64 offsets built outside",
        "shape": contract["shape"]})
    for name, ref in (("snappy_walk", "parquet_decode.py:130"),
                      ("hybrid_decode", "parquet_decode.py:247")):
        case = max(dk[name]["cases"], key=lambda c: c["longest_walk"])
        rows.append({
            "name": name, "route": "cuda",
            "source": pkg + "parquet_decode.cu", "replaces": jax_pkg + ref,
            "launches": q5["launches"][name],
            "engine_launches": engine["launches"][name],
            "nds_launches": nds["launches"][name],
            "orc_launches": orc["launches"][name],
            "exchange_launches": exchange["launches"][name],
            "adaptive_launches": adaptive["launches"][name],
            "bridge_launches": bridge["launches"][name],
            "nested_launches": nested["launches"][name],
            "ranks_launches": ranks["launches"][name],
            "ranks_launches_per_rank": ranks["launches_per_rank"][name],
            "max_abs_err": dk[name]["max_abs_err"], "ms": case["ms"],
            "kernel_ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": "bytes",
            "longest_walk": case["longest_walk"],
            "ns_per_step": case["ns_per_step"], "hop_ns": case["hop_ns"],
            "library_ms": None,
            "library_note": "a header walk; no PyTorch call does it",
            "case": case["case"]})
    emit({"kernels": rows})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
