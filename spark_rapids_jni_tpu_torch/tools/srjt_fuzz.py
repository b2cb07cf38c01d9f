"""Seeded plan-space fuzzer CLI of the port.

Drives ``engine/fuzz.py`` on ``--device``: synthesize random valid plans
over a seeded Parquet warehouse, sweep each through the variant matrix
(interpreted, fused, and the distributed variants on a mesh of 8 shards),
and check the rewrite-soundness invariants (verify-after-rewrite,
ledger==census, exchange census==executed counter, sync whitelist,
bit-exact executor parity, numpy-oracle parity).  A failure is shrunk to
a minimal plan and reported as ``seed + case + plan JSON``.

    python -m spark_rapids_jni_tpu_torch.tools.srjt_fuzz --smoke
    python -m spark_rapids_jni_tpu_torch.tools.srjt_fuzz --seed N \\
        --count M --full --out fuzz-repro.json [--device cpu]

Exit status 0 = zero soundness violations (a plan the numpy oracle cannot
evaluate is skipped and counted); 1 = failures (the report JSON on stdout
and, with ``--out``, in that file).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

#: the premerge smoke contract: fixed seed, 50 plans, core matrix
SMOKE_SEED = 20260805
SMOKE_COUNT = 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="srjt_fuzz",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help=f"fixed-seed gate corpus (seed {SMOKE_SEED}, "
                         f"{SMOKE_COUNT} plans, core variant matrix)")
    ap.add_argument("--seed", type=int, default=SMOKE_SEED)
    ap.add_argument("--count", type=int, default=SMOKE_COUNT)
    ap.add_argument("--full", action="store_true",
                    help="sweep the extended variant matrix "
                         "(adds dist-nofuse, interp-notopk, dist-fused-aqe)")
    ap.add_argument("--out", default=None,
                    help="write the failure report (seed + shrunk "
                         "minimal plan JSON) to this path on failure")
    ap.add_argument("--no-shrink", action="store_true",
                    help="report raw failing plans without minimizing")
    ap.add_argument("--device", default="cuda",
                    help="torch device the plans execute on (default cuda)")
    args = ap.parse_args(argv)

    from .. import device as _device
    from ..engine import fuzz

    dev = _device.resolve(args.device)
    if args.smoke:
        seed, count, variants = SMOKE_SEED, SMOKE_COUNT, fuzz.VARIANTS
    else:
        seed, count = args.seed, args.count
        variants = fuzz.FULL_VARIANTS if args.full else fuzz.VARIANTS

    with tempfile.TemporaryDirectory(prefix="srjt-fuzz-") as tmp:
        report = fuzz.run_corpus(
            seed, count, Path(tmp), variants=variants,
            log=lambda m: print(f"srjt_fuzz: {m}", file=sys.stderr),
            shrink_failures=not args.no_shrink, device=dev)

    report["variants"] = [v["name"] for v in variants]
    if report["failures"]:
        print(json.dumps(report, indent=2, default=str))
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2, default=str)
            print(f"srjt_fuzz: repro artifact at {args.out}",
                  file=sys.stderr)
        print(f"srjt_fuzz: {len(report['failures'])} soundness "
              f"violation(s) in {count} plans (seed {seed})",
              file=sys.stderr)
        return 1
    skipped = f", {len(report['skipped'])} skipped (the oracle refused " \
        "them)" if report["skipped"] else ""
    print(f"srjt_fuzz: OK — {count} plans x {len(variants)} variants, "
          f"0 soundness violations{skipped} (seed {seed}, device {dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
