"""Flight-recorder bundle CLI of the port: list / show / grep post-mortem
bundles.

The reading half of ``utils/blackbox.py``: on a classified error, timeout,
cancel or degradation the engine writes one post-mortem bundle into
``config.blackbox_dir`` (the server's ``--set blackbox_dir=DIR``); this
tool renders the bundle ring without touching a device: pure JSON over
the files on disk.

    python -m spark_rapids_jni_tpu_torch.tools.srjt_blackbox list --dir DIR
    ... show [PATH|-1] [--ring]
    ... grep TRACE_ID

``show`` defaults to the newest bundle; ``--ring`` appends the captured
flight-recorder tail as one event per line.  ``grep`` matches bundles
whose trace_id starts with the given hex prefix (the id a failed client
call carries as ``e.trace_id``).  Exit code 0 on success (grep: at least
one match), 1 on no match, 2 on usage errors (no directory, empty ring,
bad index).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils import blackbox
from ..utils.config import config
from . import _cli


def _dir_of(args) -> str:
    return _cli.dir_of(args, config.blackbox_dir, "bundle")


def _describe(path: str) -> str:
    try:
        doc = blackbox.read_bundle(path)
    except (OSError, ValueError) as e:
        return f"{os.path.basename(path)}  <unreadable: {e}>"
    err = doc.get("error") or {}
    q = doc.get("query") or {}
    bits = [os.path.basename(path),
            f"trace={doc.get('trace_id', '')[:12] or '?'}",
            f"reason={doc.get('reason', '?')}"]
    if err:
        bits.append(f"error={err.get('type', '?')}/{err.get('kind', '?')}")
    if q:
        bits.append(f"query={q.get('name', '')!r} wall={q.get('wall_s')}s")
    bits.append(f"ring={len(doc.get('ring') or ())}ev")
    return "  ".join(bits)


def cmd_list(args) -> int:
    d = _dir_of(args)
    paths = blackbox.list_bundles(d)
    for p in paths:
        print(_describe(p))
    print(f"-- {len(paths)} bundle(s) in {d}")
    return 0


def cmd_show(args) -> int:
    d = _dir_of(args)
    path = _cli.resolve(d, args.path, blackbox.list_bundles(d), "bundle")
    doc = blackbox.read_bundle(path)
    ring = doc.pop("ring", [])
    print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    if args.ring:
        print(f"-- flight-recorder tail ({len(ring)} events):")
        for ev in ring:
            print("  " + json.dumps(ev, sort_keys=True, default=str))
    return 0


def cmd_grep(args) -> int:
    """Bundles whose trace_id starts with the given hex prefix — the
    client-to-server join: paste ``e.trace_id`` from a failed call."""
    d = _dir_of(args)
    want = args.trace_id.strip().lower()
    if not want:
        print("empty trace id", file=sys.stderr)
        return 2
    hits = 0
    for p in blackbox.list_bundles(d):
        try:
            doc = blackbox.read_bundle(p)
        except (OSError, ValueError):
            continue
        if str(doc.get("trace_id", "")).lower().startswith(want):
            hits += 1
            print(_describe(p))
    if not hits:
        print(f"no bundle matches trace {want!r}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srjt_blackbox", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=None,
                    help="bundle directory (default config.blackbox_dir)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="one line per stored bundle")
    p_show = sub.add_parser("show", help="pretty-print one bundle")
    p_show.add_argument("path", nargs="?", default=None,
                        help="path, filename, or negative index "
                             "(-1 = newest)")
    p_show.add_argument("--ring", action="store_true",
                        help="append the flight-recorder tail, one event "
                             "per line")
    p_grep = sub.add_parser("grep",
                            help="bundles matching a trace-id prefix")
    p_grep.add_argument("trace_id", help="hex trace id (prefix ok)")
    args = ap.parse_args(argv)
    return {"list": cmd_list, "show": cmd_show,
            "grep": cmd_grep}[args.cmd](args)


if __name__ == "__main__":
    _cli.run(main)
