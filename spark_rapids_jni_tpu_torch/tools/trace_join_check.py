"""End-to-end trace-join check of the port's server.

Proves the serving path's observability contract across a real process
boundary — a client in this process, the port's server in a subprocess
(``bridge.spawn_server``) on ``--device`` — twice:

- **clean query**: the client-minted trace id rides the frame into the
  server, shows up on the server's ``OP_METRICS`` per-query summary AND
  in the stored profile, and no post-mortem bundle is cut;
- **fault-injected query** (``FAULTS``: every Parquet chunk read raises,
  on the host decoder or the device route, until retries exhaust): the
  typed client exception carries the same trace id as (a) the server's
  post-mortem bundle, (b) the wire error doc's bundle pointer
  (``e.bundle_path`` names that exact file), and (c) the profile-store
  entry of the failed run.

    python -m spark_rapids_jni_tpu_torch.tools.trace_join_check \\
        [--device cpu] [--dir DIR]

Exit code 0 when every join holds, 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

#: every Parquet read of the second server raises, by either route: the
#: host decoder's row-group reads and the device route's page transfers
#: (a scan on a card takes the device route, where ``parquet.chunk`` never
#: fires; its failed transfers re-plan onto the host decoder)
FAULTS = "parquet.chunk:*:io_error,parquet.device_decode:*:io_error"


def _with_trace(dir_path: str, reader, lister, tid: str) -> list:
    out = []
    for p in lister(dir_path):
        try:
            doc = reader(p)
        except (OSError, ValueError):
            continue
        if doc.get("trace_id") == tid:
            out.append((p, doc))
    return out


def _write_input(path: str) -> None:
    import numpy as np

    from ..columnar import Column, Table
    from ..io.parquet_writer import write_parquet
    rng = np.random.default_rng(5)
    write_parquet(Table([
        Column.from_numpy(rng.integers(0, 16, 4_000).astype(np.int64),
                          device="cpu"),
        Column.from_numpy(rng.uniform(0.0, 1.0, 4_000), device="cpu"),
    ], ["k", "v"]), path, row_group_size=500)


def check(device: str, root: str) -> list:
    """Run both queries against servers on ``device``, their files under
    ``root``; returns the failed joins (empty when all hold)."""
    from ..bridge.client import spawn_server
    from ..engine import Aggregate, Scan

    bb_dir = os.path.join(root, "bundles")
    prof_dir = os.path.join(root, "profiles")
    os.makedirs(bb_dir, exist_ok=True)
    os.makedirs(prof_dir, exist_ok=True)
    path = os.path.join(root, "join.parquet")
    _write_input(path)
    plan = Aggregate(Scan(path, chunk_bytes=1 << 16), ["k"],
                     [("v", "sum")], names=["s"])
    settings = {"blackbox_dir": bb_dir, "profile_dir": prof_dir,
                "metrics": True}
    # both servers start at once; the second has every Parquet read armed
    socks = [os.path.join(root, "bridge.sock"),
             os.path.join(root, "bridge2.sock")]
    with ThreadPoolExecutor(2) as pool:
        starts = [pool.submit(spawn_server, socks[0], device=device,
                              settings=settings),
                  pool.submit(spawn_server, socks[1], device=device,
                              settings={**settings, "faults": FAULTS,
                                        "retry_backoff_s": 0.001})]
    try:
        proc, proc2 = (f.result() for f in starts)
    except BaseException:
        for f in starts:
            if f.exception() is None:
                f.result().kill()
                f.result().wait()
        raise

    try:
        return _joins(plan, socks, proc, proc2, device, bb_dir, prof_dir)
    finally:
        for p in (proc, proc2):
            if p.poll() is None:
                p.kill()
                p.wait()


def _joins(plan, socks, proc, proc2, device, bb_dir, prof_dir) -> list:
    from ..bridge.client import BridgeClient
    from ..utils import blackbox, errors, profile
    failures: list = []

    # -- phase 1: clean query, trace joins client -> server summary/profile
    client = BridgeClient(socks[0], device=device)
    clean_tid = client.trace_id
    try:
        for h in client.execute_plan(plan):
            client.release(h)
        queries = (client.metrics() or {}).get("queries") or []
        if not any(q.get("trace_id") == clean_tid for q in queries):
            failures.append(
                f"no OP_METRICS summary carries client trace {clean_tid!r}: "
                f"{[q.get('trace_id') for q in queries]}")
        client.shutdown_server()
    finally:
        client.close()
        proc.wait(timeout=30)
    if os.listdir(bb_dir):
        failures.append(f"clean query cut bundle(s): {os.listdir(bb_dir)}")
    if not _with_trace(prof_dir, profile.read, profile.list_profiles,
                       clean_tid):
        failures.append(
            f"no stored profile carries client trace {clean_tid!r}")
    print(f"trace join (clean): summary+profile matched {clean_tid[:12]}, "
          f"0 bundles")

    # -- phase 2: injected fault -> typed error + bundle + profile, one id
    client2 = BridgeClient(socks[1], device=device)
    fault_tid = client2.trace_id
    err = None
    try:
        try:
            client2.execute_plan(plan)
            failures.append("fault-injected plan unexpectedly succeeded")
        except Exception as e:  # noqa: BLE001 — classified below
            err = e
        client2.shutdown_server()
    finally:
        client2.close()
        proc2.wait(timeout=30)
    if err is not None:
        kind, _ = errors.classify(err)
        if kind == errors.KIND_FATAL:
            failures.append(f"fault surfaced unclassified: "
                            f"{type(err).__name__}: {err}")
        tid = getattr(err, "trace_id", "")
        if tid != fault_tid:
            failures.append(f"exception trace {tid!r} != client-minted "
                            f"{fault_tid!r}")
        matching = [p for p, _ in _with_trace(
            bb_dir, blackbox.read_bundle, blackbox.list_bundles, fault_tid)]
        if len(matching) != 1:
            failures.append(f"want exactly 1 bundle for {fault_tid!r}, "
                            f"got {len(matching)}")
        bp = getattr(err, "bundle_path", "")
        if not bp or not matching or \
                os.path.basename(bp) != os.path.basename(matching[0]):
            failures.append(f"wire bundle pointer {bp!r} does not name the "
                            f"matching bundle {matching!r}")
        fhit = [doc for _, doc in _with_trace(
            prof_dir, profile.read, profile.list_profiles, fault_tid)]
        if not fhit:
            failures.append(
                f"no stored profile carries fault trace {fault_tid!r}")
        elif (fhit[0].get("outcome") or {}).get("status") != "error":
            failures.append(f"fault profile outcome not error: "
                            f"{fhit[0].get('outcome')!r}")
        print(f"trace join (fault): {type(err).__name__} ({kind}) "
              f"exception==bundle==profile trace {fault_tid[:12]}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trace_join_check",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the servers' torch device (default cuda)")
    ap.add_argument("--dir", default=None,
                    help="directory for the input file, bundles and "
                         "profiles (default: a fresh temporary one)")
    args = ap.parse_args(argv)
    from .. import device as _device
    _device.resolve(args.device)
    root = args.dir or tempfile.mkdtemp(prefix="srjt-tracejoin-")
    failures = check(args.device, root)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("trace join check: OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
