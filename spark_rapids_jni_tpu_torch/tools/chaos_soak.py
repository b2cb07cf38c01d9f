"""Chaos soak of the port: the fault-injection matrix against the pipeline.

The robustness acceptance test: build the bench warehouse (the port's
Parquet writer), compute oracle results with no fault armed on
``--device``, then re-run the same plans under a rotating
``config.faults`` schedule covering every injection site x kind.  Each
run must end one of exactly two ways, within the ``query_timeout_s``
deadline:

- **parity** — the recovery layer absorbed the fault (retry, interpreted
  fallback, exchange degradation ladder) and the result equals the
  fault-free run on the same device bit for bit after key-sorting; or
- **typed error** — a classified, non-fatal ``utils.errors`` kind
  (transient / resource / cancelled) surfaced.

Anything else fails the soak: a fatal or unclassified error, a result
mismatch, a spec whose runs injected no fault (``faults.injected.*`` did
not move: its seam lies off the plans' route, so it tested nothing), a
leaked prefetch thread (``io.prefetch.reap_timeouts`` must stay 0), or an
orphaned spill file.  The schedule and the concurrent passes run on the
host decoder (``device_decode=False``), whose seams a scan passes on a
card as on the CPU; the device route has a pass of its own under
``DEVICE_DECODE_SCHEDULE``.  The report's ``fired`` gives each spec's
injections and ``unfired`` the runs that saw none.

The flight recorder is held to the same oracle: a typed error must cut
EXACTLY one post-mortem bundle whose trace_id matches the one the raised
exception carries (``e.trace_id``), a parity run cuts at most one (the
degradation ladder bundles too), the clean oracle runs cut none, and the
bundle directory stays bounded.

A concurrent-clients pass repeats the contract under multi-tenant
contention: four clients run distinct plans at once against a server
subprocess with faults armed by its ``--set``: an absorbed fault must
leave every client's result bit-exact (nothing leaks between clients), and
an unabsorbable fault must hand every client a typed error joined 1:1 to
a fresh server-side bundle by trace id.

    python -m spark_rapids_jni_tpu_torch.tools.chaos_soak [--device cpu]
        [--rows 120000] [--rounds 1] [--dir DIR] [--out REPORT.json]
        [--set shards=2 ...]

``--set field=value`` sets a field of ``utils.config.config`` here and in
the server (``--set shards=N`` gives the spill pass's mesh N shards).
Exit code 0 when every run met the contract, 1 otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the soak schedule: every site, both deterministic-nth and every-time
# rules, all three kinds.  timeout-kind sleeps are tiny (faults.HANG_S)
# so the soak stays fast; the point is that deadline plumbing engages.
SCHEDULE = [
    "parquet.chunk:1:io_error",
    "parquet.chunk:*:io_error",
    "parquet.chunk:2:oom",
    "parquet.prefetch:1:io_error",
    "parquet.prefetch:*:io_error",
    "staging.transfer:1:oom",
    "staging.transfer:2:io_error",
    "exchange.dispatch:1:oom",
    "exchange.dispatch:*:oom",
    "spill.write:1:io_error",
    "bridge.op:1:io_error",
    "parquet.chunk:1:timeout",
    "parquet.chunk:3:io_error,staging.transfer:1:oom",
]

#: the device-decode seam's specs (the chunked plan on the device route)
DEVICE_DECODE_SCHEDULE = (
    "parquet.device_decode:1:io_error",
    "parquet.device_decode:*:io_error",
    "parquet.device_decode:1:oom",
)

#: sites no plan run in this process passes: the spill pass arms
#: spill.write on its own shuffle, and bridge.op is the server's op
#: dispatch (tests/test_torch_faults_blackbox.py); a schedule spec naming
#: only these is listed as unfired, not failed
OFF_PLAN_SITES = ("spill.write", "bridge.op")
#: the distributed q5's mesh when ``--set shards=N`` gives none (the fuzz
#: matrix's 8 shards of one device)
DIST_SHARDS = 8

#: the chunk-boundary deadline: generous enough for cold compiles, small
#: enough that a real hang converts to a typed timeout
DEADLINE_S = 120.0
CLIENTS = 4


# -- the bench warehouse and its plans (bench.py's, on the port) -------------

def _write(path: str, names, arrays, row_group_size: int = 1 << 20) -> None:
    from ..columnar import Column, Table
    from ..io.parquet_writer import write_parquet
    write_parquet(Table([Column.from_numpy(a, device="cpu") for a in arrays],
                        names), path, row_group_size=row_group_size)


def pipeline_warehouse(root, n: int, rng) -> None:
    """q5-lite warehouse for the local-executor pipeline (bench.py
    ``_pipeline_warehouse``)."""
    _write(os.path.join(root, "store_sales.parquet"),
           ["ss_sold_date_sk", "ss_store_sk", "ss_ext_sales_price",
            "ss_net_profit"],
           [np.sort(rng.integers(0, 400, n)).astype(np.int64),
            rng.integers(1, 13, n).astype(np.int64),
            rng.uniform(0.5, 300.0, n),
            rng.uniform(-50.0, 120.0, n)], max(1, n // 8))
    _write(os.path.join(root, "date_dim.parquet"), ["d_date_sk"],
           [np.arange(100, 300, dtype=np.int64)])
    _write(os.path.join(root, "store.parquet"), ["s_store_sk", "s_mgr"],
           [np.arange(1, 13, dtype=np.int64),
            np.arange(1, 13, dtype=np.int64) % 4])


def pipeline_plans(root, chunk_bytes: int):
    """(q5-lite plan, chunked-scan aggregate plan) over the warehouse
    (bench.py ``_pipeline_plans``)."""
    from ..engine import Aggregate, Filter, Join, Scan, Sort, col, lit
    dates_f = Filter(Scan(os.path.join(root, "date_dim.parquet")),
                     ("&", (">=", col("d_date_sk"), lit(100)),
                      ("<", col("d_date_sk"), lit(300))))
    sales = Scan(os.path.join(root, "store_sales.parquet"))
    kept = Filter(Join(sales, dates_f, ["ss_sold_date_sk"], ["d_date_sk"],
                       how="semi"),
                  ("&", (">", col("ss_net_profit"), lit(0.0)),
                   (">=", col("ss_sold_date_sk"), lit(100))))
    totals = Aggregate(kept, ["ss_store_sk"],
                       [("ss_ext_sales_price", "sum"),
                        ("ss_net_profit", "sum"),
                        ("ss_ext_sales_price", "count")],
                       names=["sales", "profit", "n"])
    joined = Join(totals, Scan(os.path.join(root, "store.parquet")),
                  ["ss_store_sk"], ["s_store_sk"], how="inner")
    q5 = Sort(Aggregate(joined, ["s_mgr"],
                        [("sales", "sum"), ("profit", "sum"), ("n", "sum")],
                        names=["sales", "profit", "n"]),
              (("s_mgr", True),))
    chunked = Aggregate(
        Filter(Scan(os.path.join(root, "store_sales.parquet"),
                    chunk_bytes=chunk_bytes),
               (">", col("ss_ext_sales_price"), lit(1.0))),
        ["ss_store_sk"],
        [("ss_ext_sales_price", "sum"), ("ss_net_profit", "sum"),
         ("ss_net_profit", "min"), ("ss_net_profit", "max"),
         ("ss_ext_sales_price", "count")],
        names=["sales", "profit", "lo", "hi", "n"])
    return q5, chunked


def serving_plans(root, chunk_bytes: int, k: int, base: float = 1.0):
    """``k`` distinct-fingerprint chunked aggregates over the warehouse
    (bench.py ``_serving_plans``): one shape, a different filter literal a
    plan, like k tenants running k queries of one family."""
    from ..engine import Aggregate, Filter, Scan, col, lit
    sales = os.path.join(root, "store_sales.parquet")
    return [Aggregate(
        Filter(Scan(sales, chunk_bytes=chunk_bytes),
               (">", col("ss_ext_sales_price"), lit(base + 0.25 * i))),
        ["ss_store_sk"],
        [("ss_ext_sales_price", "sum"), ("ss_net_profit", "sum"),
         ("ss_ext_sales_price", "count")],
        names=["sales", "profit", "n"]) for i in range(k)]


# -- parity ------------------------------------------------------------------

#: a float column's parity: on a card the engine sums in atomic or chunk
#: order, so two runs of one plan over uniform floats differ in the last
#: bits (the repo holds every query sum within rel 1e-9)
FLOAT_REL = 1e-9


def _sorted_columns(table, idx: int) -> list:
    cols = [c.to_numpy() for c in table.columns]
    order = np.argsort(cols[idx], kind="stable")
    return [c[order] for c in cols]


def parity(base, out, key=0) -> str:
    """``"bit-exact"``, ``"close"`` (every float within ``FLOAT_REL``,
    every other value equal) or ``""`` (diverged), after sorting both by
    column ``key`` (a name, or an index: tables exported by the server
    carry no names)."""
    if base.num_rows != out.num_rows or base.num_columns != out.num_columns:
        return ""
    idx = list(base.names).index(key) if isinstance(key, str) else key
    exact = True
    for x, y in zip(_sorted_columns(base, idx), _sorted_columns(out, idx)):
        if x.dtype.kind != "f" and y.dtype.kind != "f":
            if not np.array_equal(x, y):
                return ""
            continue
        x, y = x.astype(np.float64), y.astype(np.float64)
        if np.array_equal(x.view(np.int64), y.view(np.int64)):
            continue
        exact = False
        if not np.all(np.abs(x - y) <= FLOAT_REL * np.maximum(np.abs(x),
                                                              np.abs(y))):
            return ""
    return "bit-exact" if exact else "close"


@contextlib.contextmanager
def _settings(**kw):
    from ..utils.config import config
    saved = {k: getattr(config, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(config, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def _injected() -> int:
    """Faults injected in this process so far (``faults.injected.*``)."""
    from ..utils import tracing
    return sum(tracing.counters_snapshot("faults.injected.").values())


class _Soak:
    """Counts and failures of one soak."""

    def __init__(self, bb_dir: str, log):
        self.bb_dir = bb_dir
        self.log = log
        self.failures: list = []
        self.runs = self.parity = self.bit_exact = self.typed = 0
        self.longest_s = 0.0
        self.fired: dict = {}      # spec -> faults injected by its runs
        self.unfired: list = []    # runs whose spec injected nothing

    def run(self, spec: str, tag: str, fn, oracle, key) -> None:
        """One run of ``fn`` under ``spec``, held to the contract; counts
        the faults the run injected under ``spec``."""
        n = _injected()
        self._run(tag, fn, oracle, key)
        n = _injected() - n
        self.fired[spec] = self.fired.get(spec, 0) + n
        if not n:
            self.unfired.append(tag)

    def check_fired(self, specs) -> None:
        """A spec whose runs passed none of its armed seams tested
        nothing: a failure, not a parity (``OFF_PLAN_SITES`` excepted)."""
        for spec in specs:
            sites = {r.split(":")[0] for r in spec.split(",")}
            if not self.fired.get(spec) and not sites <= set(OFF_PLAN_SITES):
                self.failures.append(f"[{spec}] never fired: its runs "
                                     "passed no armed seam")

    def _run(self, tag: str, fn, oracle, key) -> None:
        from ..utils import blackbox, errors
        self.runs += 1
        before = set(os.listdir(self.bb_dir))
        t0 = time.monotonic()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — the soak classifies
            self._timed(tag, t0)
            kind, _ = errors.classify(e)
            fresh = sorted(set(os.listdir(self.bb_dir)) - before)
            if kind == errors.KIND_FATAL:
                self.failures.append(f"{tag}: FATAL {type(e).__name__}: {e}")
                return
            self.typed += 1
            tid = getattr(e, "trace_id", "")
            if len(fresh) != 1:
                self.failures.append(f"{tag}: typed error cut {len(fresh)} "
                                     f"bundle(s), want exactly 1: {fresh}")
            else:
                doc = blackbox.read_bundle(os.path.join(self.bb_dir,
                                                        fresh[0]))
                if not tid or doc.get("trace_id") != tid:
                    self.failures.append(
                        f"{tag}: bundle trace {doc.get('trace_id')!r} != "
                        f"client-observed {tid!r}")
            self.log(f"  {tag}: typed error ({kind}) {type(e).__name__} "
                     f"trace={tid[:12] or '?'}")
            return
        self._timed(tag, t0)
        fresh = sorted(set(os.listdir(self.bb_dir)) - before)
        if len(fresh) > 1:  # 0 ok; 1 = degradation post-mortem
            self.failures.append(f"{tag}: parity run cut {len(fresh)} "
                                 f"bundles: {fresh}")
        self.matched(tag, parity(oracle, out, key))

    def matched(self, tag: str, how: str) -> None:
        if how:
            self.parity += 1
            self.bit_exact += how == "bit-exact"
        else:
            self.failures.append(f"{tag}: result diverged from the "
                                 "fault-free run")

    def _timed(self, tag: str, t0: float) -> None:
        s = time.monotonic() - t0
        self.longest_s = max(self.longest_s, s)
        if s > DEADLINE_S:
            self.failures.append(f"{tag}: ran {s:.1f} s, past the "
                                 f"{DEADLINE_S} s deadline")


def _start_server(spec: str, bb: str, device, settings: dict) -> tuple:
    """A server subprocess on ``device`` with ``spec`` armed, its bundles
    into ``bb``: ``(socket dir, socket, process)``."""
    from ..bridge.client import spawn_server
    # a short path: a unix socket's name is at most 107 bytes
    sock_dir = tempfile.mkdtemp(prefix="srjt-chaos-srv-")
    sock = os.path.join(sock_dir, "srv.sock")
    try:
        proc = spawn_server(sock, device=str(device), settings={
            "device_decode": False, **settings, "faults": spec,
            "blackbox_dir": bb,
            "retry_backoff_s": 0.001, "query_timeout_s": DEADLINE_S})
    except BaseException:
        shutil.rmtree(sock_dir, ignore_errors=True)
        raise
    return sock_dir, sock, proc


def _concurrent_pass(soak: _Soak, tag: str, server: tuple, plans,
                     device):
    """One client a plan, all at once, against ``server``; returns
    ``(results, errors, faults the server injected)`` and shuts the server
    down."""
    from ..bridge.client import BridgeClient
    sock_dir, sock, proc = server
    results: dict = {}
    errs: dict = {}
    injected = 0
    barrier = threading.Barrier(len(plans))

    def one(i):
        try:
            c = BridgeClient(sock, device=device)
            barrier.wait()
            hs = c.execute_plan(plans[i])
            results[i] = c.export_table(hs[0])
            for h in hs:
                c.release(h)
            c.close()
        except Exception as e:  # noqa: BLE001 — classified below
            errs[i] = e
    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(plans))]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        ctl = BridgeClient(sock, device="cpu")
        injected = sum(ctl.metrics("faults.injected.")["counters"].values())
        ctl.shutdown_server()
        ctl.close()
    except Exception as e:  # noqa: BLE001 — the soak classifies
        soak.failures.append(f"{tag}: harness error {e!r}")
        proc.kill()
    finally:
        proc.wait(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    return results, errs, injected


def soak(device, rows: int = 120_000, rounds: int = 1,
         settings: dict | None = None, log=print,
         work_dir: str | None = None) -> dict:
    """The whole soak on ``device``; returns its report (``failures``
    empty when every run met the contract).  ``settings`` are config
    fields set for the soak and passed to its servers.  The warehouse,
    the bundles and the spill files go under ``work_dir`` (default: a
    fresh temporary directory), which is left in place for the bundles to
    be read."""
    from .. import device as _device
    from ..utils import faults, tracing
    from ..utils.config import config
    dev = _device.resolve(device)
    settings = dict(settings or {})
    work = work_dir or tempfile.mkdtemp(prefix="srjt-chaos-")
    bb_dir = os.path.join(work, "bundles")
    os.makedirs(bb_dir, exist_ok=True)
    before = tracing.counters_snapshot("kernel.")
    # the schedule runs on the host decoder, where every spec's seam lies
    # on a card as on the CPU (a card's default, the device route, passes
    # none of parquet.chunk's); the device route has a pass of its own
    with _settings(**{"faults": "", "query_timeout_s": DEADLINE_S,
                      "retry_backoff_s": 0.001, "blackbox_dir": bb_dir,
                      "device_decode": False, **settings}):
        faults.reset()
        try:
            rep = _soak(dev, rows, rounds, settings, work, bb_dir, log)
        finally:
            config.faults = ""
            faults.reset()
    after = tracing.counters_snapshot("kernel.")
    # this process's kernel launches (its servers count their own)
    rep["launches"] = {k[len("kernel."):]: v - before.get(k, 0)
                       for k, v in after.items() if v != before.get(k, 0)}
    rep["device"] = str(dev)
    return rep


def _soak(dev, rows, rounds, settings, work, bb_dir, log) -> dict:
    t0 = time.monotonic()
    rng = np.random.default_rng(7)
    root = os.path.join(work, "warehouse")
    os.makedirs(root, exist_ok=True)
    pipeline_warehouse(root, rows, rng)
    took = {"warehouse": time.monotonic() - t0}
    # the concurrent passes' servers start now, beside the in-process runs
    bb_absorb = os.path.join(work, "bundles-absorbed")
    bb_hard = os.path.join(work, "bundles-typed")
    with ThreadPoolExecutor(2) as pool:
        servers = {"absorbed": pool.submit(
                       _start_server, "parquet.chunk:2:io_error", bb_absorb,
                       dev, settings),
                   "typed": pool.submit(
                       _start_server, "parquet.chunk:*:io_error", bb_hard,
                       dev, settings)}
        try:
            return _soak_runs(dev, rows, rounds, work, bb_dir, log, rng,
                              root, servers, bb_absorb, bb_hard, took)
        finally:
            for f in servers.values():
                if f.exception() is None and f.result()[2].poll() is None:
                    f.result()[2].kill()
                    f.result()[2].wait()
                    shutil.rmtree(f.result()[0], ignore_errors=True)


def _soak_runs(dev, rows, rounds, work, bb_dir, log, rng, root, servers,
               bb_absorb, bb_hard, took) -> dict:
    from ..engine import execute, optimize
    from ..utils import blackbox, errors, faults, metrics, tracing
    from ..utils.config import config

    q5, chunked = pipeline_plans(root, chunk_bytes=256_000)
    plans = [("q5", optimize(q5), "s_mgr"),
             ("chunked", optimize(chunked), "ss_store_sk")]
    # q5 over the mesh: the plans that pass the exchange seam, run under
    # the specs that arm it
    mesh = {"shards": config.shards or DIST_SHARDS}
    with _settings(**mesh):
        dist = ("q5-dist", optimize(q5, distribute=True), "s_mgr")
    t = time.monotonic()
    oracle = {name: execute(opt, device=dev) for name, opt, _ in plans}
    with _settings(**mesh):
        oracle[dist[0]] = execute(dist[1], device=dev)
    took["oracle"] = time.monotonic() - t
    thread_floor = threading.active_count()
    s = _Soak(bb_dir, log)
    # fault-free runs must not post-mortem anything
    if os.listdir(bb_dir):
        s.failures.append(
            f"clean oracle runs cut bundle(s): {os.listdir(bb_dir)}")
    t_start = time.monotonic()
    for rnd in range(rounds):
        for spec in SCHEDULE:
            config.faults = spec
            for name, opt, key in plans:
                faults.reset()
                s.run(spec, f"round{rnd} [{spec}] {name}",
                      lambda: execute(opt, device=dev), oracle[name], key)
            if "exchange.dispatch" in spec:
                name, opt, key = dist
                faults.reset()
                with _settings(**mesh):
                    s.run(spec, f"round{rnd} [{spec}] {name}",
                          lambda: execute(opt, device=dev), oracle[name],
                          key)
    config.faults = ""
    faults.reset()
    took["schedule"] = time.monotonic() - t_start

    # spill path under injection, with a real spill_dir: the sweep plus
    # finalizers must leave the directory empty
    from ..columnar import Column, Table
    from ..parallel.mesh import make_mesh
    from ..parallel.spill import shuffle_table_spilled
    t = time.monotonic()
    sd = os.path.join(work, "spill")
    os.makedirs(sd, exist_ok=True)
    st = Table([Column.from_numpy(rng.integers(0, 64, 50_000)
                                  .astype("int64"), device=dev),
                Column.from_numpy(rng.integers(-99, 99, 50_000)
                                  .astype("int64"), device=dev)],
               ["k", "v"])
    config.faults = "spill.write:1:io_error"
    faults.reset()
    n_inj = _injected()
    spilled = shuffle_table_spilled(st, make_mesh(device=dev), ["k"],
                                    hbm_budget_bytes=1 << 18, spill_dir=sd)
    if spilled.num_rows != st.num_rows:
        s.failures.append("spill: row count diverged under injection")
    if _injected() == n_inj:
        s.failures.append("spill: spill.write:1:io_error never fired")
    del spilled  # finalizers unlink the memmaps
    gc.collect()
    left = [n for n in os.listdir(sd) if n.startswith("spill-")]
    if left:
        s.failures.append(f"spill: {len(left)} file(s) left in {sd}: {left}")
    config.faults = ""
    took["spill"] = time.monotonic() - t

    # the device-decode route under injection (device_decode pinned on):
    # the chunked plan with the parquet.device_decode transfer seam
    # faulted.  A one-shot transient is absorbed by the retry ladder; a
    # persistent fault and an OOM re-plan the chunk onto the host decoder
    # on the CPU, and on a card end in a typed error (work on a card stays
    # on it); the route must prove it engaged (counter delta > 0)
    t = time.monotonic()
    dd0 = tracing.counter_value("io.device_decode.chunks")
    with _settings(device_decode=True):
        for spec in DEVICE_DECODE_SCHEDULE:
            config.faults = spec
            faults.reset()
            s.run(spec, f"device-decode [{spec}]",
                  lambda: execute(plans[1][1], device=dev),
                  oracle["chunked"], "ss_store_sk")
    dd = tracing.counter_value("io.device_decode.chunks") - dd0
    if metrics.enabled() and dd <= 0:
        s.failures.append("device-decode: the pass never engaged the "
                          "device route (io.device_decode.chunks did not "
                          "move)")
    config.faults = ""
    faults.reset()
    s.check_fired(SCHEDULE + list(DEVICE_DECODE_SCHEDULE))
    took["device_decode"] = time.monotonic() - t

    # concurrent clients against a server subprocess, faults armed there:
    # an nth-shot fault the recovery layer absorbs leaves every client ITS
    # OWN plan's result bit-exact; an every-time fault hands every client
    # a typed error with its own trace id, one server bundle each.  The
    # two servers take their clients at once
    t = time.monotonic()
    conc_plans = serving_plans(root, 64_000, CLIENTS)
    conc_oracle = [execute(optimize(p), device=dev) for p in conc_plans]
    srvs = {k: f.result() for k, f in servers.items()}
    took["servers_waited"] = time.monotonic() - t
    with ThreadPoolExecutor(2) as pool:
        passes = {k: pool.submit(_concurrent_pass, s, f"concurrent/{k}",
                                 srv, conc_plans, dev)
                  for k, srv in srvs.items()}
    res, errs, s.fired["concurrent/absorbed"] = \
        passes["absorbed"].result()
    if not s.fired["concurrent/absorbed"]:
        s.failures.append("concurrent/absorbed: the server's fault never "
                          "fired")
    s.runs += CLIENTS
    for i in range(CLIENTS):
        if i in errs:
            s.failures.append(f"concurrent/absorbed: client {i} errored "
                              f"({errs[i]!r}), want recovery parity")
        else:
            # a divergence is a leak between clients or a lost chunk
            s.matched(f"concurrent/absorbed: client {i}",
                      parity(conc_oracle[i], res[i]) if i in res else "")
    log(f"  concurrent/absorbed: {len(res)}/{CLIENTS} parity under "
        f"nth-shot fault, {len(errs)} error(s)")

    res, errs, s.fired["concurrent/typed"] = passes["typed"].result()
    s.runs += CLIENTS
    bundles = {blackbox.read_bundle(p).get("trace_id"): p
               for p in blackbox.list_bundles(bb_hard)}
    for i in range(CLIENTS):
        e = errs.get(i)
        if e is None:
            s.failures.append("concurrent/typed: client "
                              f"{i} succeeded under an every-time fault")
            continue
        kind, _ = errors.classify(e)
        if kind == errors.KIND_FATAL:
            s.failures.append(f"concurrent/typed: client {i} got FATAL "
                              f"{type(e).__name__}: {e}")
            continue
        s.typed += 1
        tid = getattr(e, "trace_id", "")
        if not tid or tid not in bundles:
            s.failures.append(f"concurrent/typed: client {i} trace "
                              f"{tid!r} has no joined bundle "
                              f"(bundles: {sorted(bundles)})")
    if len(blackbox.list_bundles(bb_hard)) != len(errs):
        s.failures.append(
            f"concurrent/typed: {len(blackbox.list_bundles(bb_hard))} "
            f"bundle(s) for {len(errs)} typed error(s), want 1:1")
    log(f"  concurrent/typed: {len(errs)}/{CLIENTS} typed errors, "
        f"{len(bundles)} trace-joined bundle(s)")
    took["concurrent"] = time.monotonic() - t

    # leak checks: every prefetch producer was reaped inside its join
    # window, and no soak run left a live worker behind
    reaps = tracing.counters_snapshot("io.prefetch.reap_timeouts")
    if any(reaps.values()):
        s.failures.append(f"prefetch reap timeouts: {reaps}")
    time.sleep(0.2)  # producers parked on a full queue exit on drain/close
    leaked = threading.active_count() - thread_floor
    if leaked > 0:
        names = [t.name for t in threading.enumerate()]
        s.failures.append(f"{leaked} leaked thread(s): {names}")

    # bundle-dir bound: the writer prunes to its on-disk ring size
    n_bundles = len(blackbox.list_bundles(bb_dir))
    if n_bundles > blackbox._DIR_KEEP:
        s.failures.append(f"bundle dir unbounded: {n_bundles} files "
                          f"(cap {blackbox._DIR_KEEP})")
    counters = {k: v for k, v in tracing.counters_snapshot("engine.").items()
                if k.startswith(("engine.retries", "engine.degraded",
                                 "engine.errors"))}
    return {"rows": rows, "rounds": rounds, "runs": s.runs,
            "parity": s.parity, "bit_exact": s.bit_exact, "typed": s.typed,
            "fired": s.fired, "unfired": s.unfired, "bundles": n_bundles,
            "bundle_dir": bb_dir, "device_decode_chunks": dd,
            "seconds": took,
            "longest_run_s": s.longest_s,
            "wall_s": time.monotonic() - t_start, "counters": counters,
            "failures": s.failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chaos_soak",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1,
                    help="full passes over the fault schedule")
    ap.add_argument("--rows", type=int, default=120_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every run (default cuda)")
    ap.add_argument("--dir", default=None,
                    help="directory of the warehouse, bundles and spill "
                         "files (default: a fresh temporary one, kept)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="set a field of utils.config.config here and in "
                         "the server (repeatable)")
    ap.add_argument("--out", default=None,
                    help="write the report JSON to this path")
    args = ap.parse_args(argv)
    from ..utils.config import parse_setting
    settings = dict(parse_setting(t) for t in args.set)
    rep = soak(args.device, args.rows, args.rounds, settings,
               work_dir=args.dir)
    print(f"chaos soak: {rep['runs']} runs in {rep['wall_s']:.1f}s — "
          f"{rep['parity']} parity ({len(rep['unfired'])} with no fault "
          f"fired), {rep['typed']} typed errors, "
          f"{rep['bundles']} bundle(s) in {rep['bundle_dir']}, "
          f"{len(rep['failures'])} failure(s)")
    for k in sorted(rep["counters"]):
        print(f"  {k} = {rep['counters'][k]}")
    for f in rep["failures"]:
        print(f"  FAIL: {f}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2, default=str)
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
