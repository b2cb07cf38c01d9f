"""Query-profile store CLI of the port: list / show / diff persisted query
profiles, a profile's decision ledger, SLO burn rates.

The reading half of ``utils/profile.py``: the engine writes one compact
JSON profile per query into ``config.profile_dir`` (the server's ``--set
profile_dir=DIR``); this tool renders the store without touching a
device: pure JSON over the ring on disk.

    python -m spark_rapids_jni_tpu_torch.tools.srjt_profile list --dir DIR
    ... show      [PATH|-1]
    ... diff      [BASE CAND] [--json]
    ... decisions [PATH|-1]
    ... slo       --slo-ms SPEC

``diff`` with no positional arguments picks the two newest profiles
sharing a plan fingerprint (the cross-run EXPLAIN ANALYZE comparison);
with explicit paths it diffs exactly those.  ``slo`` renders per-source-
fingerprint burn rates against the ``--slo-ms`` objectives
(``default_ms[,fp_prefix=ms,...]``), evaluated from the stored history by
``utils/blackbox.py``.  Exit code 0 on success, 2 on usage errors (empty
store, no fingerprint pair, no objectives declared).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils import blackbox, profile
from ..utils.config import config
from . import _cli


def _dir_of(args) -> str:
    return _cli.dir_of(args, config.profile_dir, "profile store")


def _resolve(d: str, spec: str | None) -> str:
    return _cli.resolve(d, spec, profile.list_profiles(d), "profile")


def cmd_list(args) -> int:
    d = _dir_of(args)
    paths = profile.list_profiles(d)
    for p in paths:
        try:
            prof = profile.read(p)
        except (OSError, ValueError) as e:
            print(f"{os.path.basename(p)}  <unreadable: {e}>")
            continue
        nex = len(prof.get("exchanges", ()))
        print(f"{os.path.basename(p)}  name={prof.get('name', '')!r} "
              f"wall={prof.get('wall_s')}s nodes={len(prof.get('nodes', ()))} "
              f"exchanges={nex}")
    summ = profile.store_summary(d)
    print(f"-- {summ['profiles']} profiles, "
          f"top_exchange_skew={summ['top_exchange_skew']}, "
          f"chunk_latency_p99_s={summ['chunk_latency_p99_s']}")
    return 0


def cmd_show(args) -> int:
    path = _resolve(_dir_of(args), args.path)
    print(json.dumps(profile.read(path), indent=2, sort_keys=True))
    return 0


def _newest_pair(paths: list):
    """The two newest profiles of the newest fingerprint with two runs."""
    by_fp: dict = {}
    for p in paths:
        try:
            fp = profile.read(p).get("fingerprint", "")
        except (OSError, ValueError):
            continue
        by_fp.setdefault(fp, []).append(p)
    for p in reversed(paths):
        fp = next((f for f, ps in by_fp.items() if p in ps), "")
        if len(by_fp.get(fp, ())) >= 2:
            return by_fp[fp][-2:]
    return None


def cmd_diff(args) -> int:
    d = _dir_of(args)
    if args.base and args.cand:
        base = _resolve(d, args.base)
        cand = _resolve(d, args.cand)
    else:
        pair = _newest_pair(profile.list_profiles(d))
        if pair is None:
            print("no two profiles share a fingerprint; pass BASE CAND "
                  "explicitly", file=sys.stderr)
            return 2
        base, cand = pair
    d_out = profile.diff(base, cand)
    if args.json:
        print(json.dumps(d_out, indent=2, sort_keys=True))
    else:
        print(profile.render_diff(d_out))
    return 0


def _decision_bits(d: dict) -> list:
    bits = [d.get("kind", "?")]
    if d.get("path"):
        bits.append(f"path={d['path']}")
    if "triggered" in d:
        # adaptive (runtime) entry: the verdict and the measured value
        # that fired or declined it, then before -> after
        bits.append("triggered=yes" if d.get("triggered")
                    else "triggered=no")
    for k in ("side", "how", "exchange", "inner", "n"):
        if d.get(k) is not None:
            bits.append(f"{k}={d[k]}")
    if d.get("keys"):
        bits.append("keys=" + ",".join(map(str, d["keys"])))
    if d.get("aggs"):
        bits.append("aggs=" + ",".join(map(str, d["aggs"])))
    if d.get("before") is not None and d.get("after") is not None:
        bits.append(f"{d['before']}->{d['after']}")
    if "measured_rows" in d:
        bits.append(f"measured_rows={d['measured_rows']}")
    if "measured_skew" in d:
        bits.append(f"measured_skew={d['measured_skew']:.2f}")
    if d.get("post_skew") is not None:
        bits.append(f"post_skew={d['post_skew']:.2f}")
    if d.get("hot_devices"):
        bits.append("hot_devices=" + ",".join(map(str, d["hot_devices"])))
    if d.get("combined_rows") is not None:
        bits.append(f"combined_rows={d['combined_rows']}")
    if "est_before" in d:
        bits.append(f"est_before={d['est_before']}")
    if "est_rows" in d:
        bits.append(f"est={d['est_rows'] if d['est_rows'] is not None else '?'}")
    for k in ("choice", "prior_kind"):
        if d.get(k):
            bits.append(f"{k}={d[k]}")
    if d.get("threshold") is not None:
        bits.append(f"threshold={d['threshold']}")
    if "actual_rows" in d:
        bits.append(f"actual={d['actual_rows']}")
    if d.get("q_error") is not None:
        bits.append(f"q_error={d['q_error']:.2f}")
    return bits


def cmd_decisions(args) -> int:
    """Render one profile's optimizer decision ledger, scored against the
    run's actuals: the EXPLAIN footer, replayable after the fact."""
    path = _resolve(_dir_of(args), args.path)
    prof = profile.read(path)
    dec = prof.get("decisions") or []
    print(f"{os.path.basename(path)}  name={prof.get('name', '')!r} "
          f"decisions={len(dec)}")
    if not dec:
        print("  (no decisions recorded — pre-ledger profile or "
              "single-device plan with no rewrites)")
        return 0
    for d in dec:
        flag = "  ! MISESTIMATE" if d.get("misestimate") else ""
        if d.get("verify_rejected"):
            flag += "  ! VERIFY_REJECTED"
        print("  " + " ".join(_decision_bits(d)) + flag)
    return 0


def cmd_slo(args) -> int:
    """Per-source-fingerprint SLO burn table from profile-store history."""
    d = _dir_of(args)
    saved = config.slo_ms
    if args.slo_ms is not None:
        config.slo_ms = args.slo_ms
    try:
        rep = blackbox.slo_report(d)
    finally:
        config.slo_ms = saved
    if not rep["enabled"]:
        print("no SLO objectives declared (pass --slo-ms, e.g. '500' or "
              "'500,ab12cd34ef56=200')", file=sys.stderr)
        return 2
    print(f"SLO objectives: default={rep['default_ms']}ms "
          f"({len(rep['entries'])} fingerprint(s) with history)")
    for e in rep["entries"]:
        print(f"  {e['fingerprint']}  objective={e['objective_ms']}ms "
              f"runs={e['runs']} breaches={e['breaches']} "
              f"(errors={e['errors']}) worst={e['worst_ms']}ms "
              f"burn_rate={e['burn_rate']}")
    if not rep["entries"]:
        print("  (no stored runs match the objectives)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srjt_profile", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=None,
                    help="profile store directory (default "
                         "config.profile_dir)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="one line per stored profile + store summary")
    p_show = sub.add_parser("show", help="pretty-print one profile")
    p_show.add_argument("path", nargs="?", default=None,
                        help="path, filename, or negative index (-1 = newest)")
    p_diff = sub.add_parser("diff",
                            help="per-node deltas between two runs")
    p_diff.add_argument("base", nargs="?", default=None)
    p_diff.add_argument("cand", nargs="?", default=None)
    p_diff.add_argument("--json", action="store_true",
                        help="emit the structured diff instead of the table")
    p_dec = sub.add_parser(
        "decisions", help="optimizer decision ledger of one profile, "
                          "scored against the run's actuals")
    p_dec.add_argument("path", nargs="?", default=None,
                       help="path, filename, or negative index (-1 = newest)")
    p_slo = sub.add_parser(
        "slo", help="per-fingerprint SLO burn rates from stored history")
    p_slo.add_argument("--slo-ms", default=None,
                       help="objectives spec (default_ms[,fp_prefix=ms,...];"
                            " default config.slo_ms)")
    args = ap.parse_args(argv)
    return {"list": cmd_list, "show": cmd_show, "diff": cmd_diff,
            "decisions": cmd_decisions, "slo": cmd_slo}[args.cmd](args)


if __name__ == "__main__":
    _cli.run(main)
