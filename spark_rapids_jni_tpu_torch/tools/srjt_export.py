"""Prometheus text-exposition exporter for the port's metrics registries.

One scrape = one dump of the counter/gauge/histogram registries (plus the
live-query progress gauges and, when ``config.slo_ms`` declares
objectives, the per-fingerprint ``srjt_slo_*`` burn-rate gauges) in
Prometheus text exposition format v0.0.4.  Two sources:

- ``--socket PATH``: scrape a running server of the port over
  ``OP_METRICS`` (a second connection; in-flight queries are not
  disturbed).  ``--prefix`` narrows the blocks on the server before they
  cross the wire.
- no socket: dump this process's own registries.  ``--warm`` first runs
  one tiny aggregate on ``--device`` over a file of the port's Parquet
  writer, so the registries have content.

    python -m spark_rapids_jni_tpu_torch.tools.srjt_export --socket S \\
        [--prefix engine.]
    python -m spark_rapids_jni_tpu_torch.tools.srjt_export --warm \\
        [--device cpu] [--prefix engine.stream]

Exit code 0 on success, 2 on usage errors (dead socket, empty registry
without --warm).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ..utils import metrics
from . import _cli


def _warm_query(device) -> None:
    """Run one tiny in-process aggregate so the registries have content —
    scan + groupby over a generated Parquet file, a few KB of work."""
    import numpy as np

    from ..columnar import Column, Table
    from ..engine import Aggregate, Scan, execute, optimize
    from ..io.parquet_writer import write_parquet

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "warm.parquet")
        rng = np.random.default_rng(11)
        write_parquet(Table([
            Column.from_numpy(rng.integers(0, 8, 512).astype(np.int64),
                              device="cpu"),
            Column.from_numpy(rng.uniform(0.0, 1.0, 512), device="cpu"),
        ], ["k", "v"]), path, row_group_size=128)
        plan = Aggregate(Scan(path, chunk_bytes=2_048), ["k"],
                         [("v", "sum")], names=["s"])
        with metrics.query("export:warm"):
            execute(optimize(plan), device=device)


def exposition_faults(text: str) -> list:
    """What keeps ``text`` from being a scrape in text exposition format:
    every line a ``# TYPE`` comment or an ``srjt_`` sample whose value
    parses as a number, at least one sample and one histogram bucket, and
    each histogram's buckets cumulative up to ``+Inf`` = ``_count``.
    Empty when it is one."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    bad: list = []
    samples = 0
    buckets: dict = {}
    counts: dict = {}
    for ln in lines:
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "histogram"):
                bad.append(f"bad TYPE line {ln!r}")
            continue
        if not ln.startswith("srjt_"):
            bad.append(f"non-exposition line {ln!r}")
            continue
        name_labels, _, value = ln.rpartition(" ")
        try:
            v = float(value)
        except ValueError:
            bad.append(f"value of {ln!r} is no number")
            continue
        samples += 1
        name, _, labels = name_labels.partition("{")
        if name.endswith("_bucket") and labels.startswith('le="'):
            le = labels[4:labels.index('"', 4)]
            buckets.setdefault(name[:-len("_bucket")], []).append(
                (float("inf") if le == "+Inf" else float(le), v))
        elif name.endswith("_count"):
            counts[name[:-len("_count")]] = v
    if not samples:
        bad.append("no sample")
    if not buckets:
        bad.append("no histogram bucket")
    for name, bs in buckets.items():
        les = [le for le, _ in bs]
        vals = [v for _, v in bs]
        if les != sorted(les) or vals != sorted(vals) or \
                les[-1] != float("inf") or vals[-1] != counts.get(name):
            bad.append(f"histogram {name} buckets not cumulative: {bs}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srjt_export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--socket", default=None,
                    help="server unix socket to scrape over OP_METRICS "
                         "(default: this process's registries)")
    ap.add_argument("--prefix", default="",
                    help="metric-name prefix filter (e.g. engine.stream)")
    ap.add_argument("--warm", action="store_true",
                    help="no-socket mode: run a tiny query first so the "
                         "local registries have content")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the --warm query (default cuda)")
    args = ap.parse_args(argv)

    if args.socket:
        from ..bridge.client import BridgeClient
        try:
            # the scrape exports no table: the client needs no card
            client = BridgeClient(args.socket, device="cpu")
        except OSError as e:
            print(f"cannot connect to {args.socket}: {e}", file=sys.stderr)
            return 2
        try:
            snap = client.metrics(prefix=args.prefix)
        finally:
            client.close()
        # the server already applied the prefix; render its snapshot
        sys.stdout.write(metrics.prometheus_text(snap=snap))
        return 0

    if args.warm:
        from .. import device as _device
        _warm_query(_device.resolve(args.device))
    text = metrics.prometheus_text(prefix=args.prefix)
    if not text.strip():
        print("local registries are empty (run under a query, or pass "
              "--warm / --socket)", file=sys.stderr)
        return 2
    sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    _cli.run(main)
