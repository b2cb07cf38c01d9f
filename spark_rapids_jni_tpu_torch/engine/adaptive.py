"""Adaptive query execution (``config.aqe``): runtime stats close the
planner loop.

The port of ``spark_rapids_jni_tpu/engine/adaptive.py``; the ledger entries
are the JAX package's field for field.  Three rules, each re-verified
through :class:`verify.RewriteChecker` before it is allowed to change
anything, and each recorded as an ``adaptive:*`` entry in the plan's
decision ledger (the same ``_decisions`` list the optimizer stamps; EXPLAIN
and the profile store render them):

1. **Mid-query broadcast flip** (``adaptive:broadcast_flip``): at
   ``_exec_exchange`` the build side of a planned hash exchange is already
   materialized, so its true row count is known before the shuffle runs.
   When it lands under the runtime threshold (``config.aqe_broadcast_rows``,
   default: follow ``config.broadcast_rows``), the executor abandons the
   planned hash exchange and runs ``_broadcast_exchange`` instead.

2. **Hot-key skew split** (``adaptive:skew_split``): the exchange counts
   pass measures the per-(src, dest) row matrix before the payload shuffle.
   When ``device_load_stats`` on that matrix shows skew above
   ``config.aqe_skew``, the hot destinations' rows are re-dealt round-robin
   across all shards (``parallel/shuffle.py`` ``split=``) and, when the
   consumer is a self-composable aggregate, merged back with a
   post-exchange partial-combine.

3. **Profile-warmed planning** (``adaptive:history_warmed``): on the
   second run of a source-plan fingerprint, ``optimize()`` consults
   ``utils/profile.history(fp)`` and overrides the footer build-side
   estimates with the measured actuals of run 1.

Runtime entries carry ``"runtime": True`` so :func:`reset` can strip a
prior execution's entries when a cached plan is re-executed.  All ledger
mutation goes through the module lock below: the executor may append while
EXPLAIN or a metrics summary copies the list.  The shard count is
``config.shards`` (the JAX package reads ``len(jax.devices())``).
"""

from __future__ import annotations

import threading
import zlib
from typing import Optional, Tuple

from ..utils import metrics
from ..utils.config import config
from .plan import Aggregate, Exchange, Join, PlanNode, topo_nodes

#: Guards every adaptive mutation of cross-thread shared state: the plan
#: root's ``_decisions`` ledger (appended mid-execution while a concurrent
#: EXPLAIN/summary copy may iterate it) and post-facto entry updates.
_AQE_LOCK = threading.Lock()

#: Join hows whose build side may be broadcast (mirrors the optimizer's
#: ``_BROADCAST_HOWS``; kept local to avoid an import cycle — optimizer
#: imports this module).
_FLIP_HOWS = ("inner", "left", "semi", "anti", "cross")

#: Aggregate ops that compose with themselves (op(op(g1), op(g2)) ==
#: op(g1 ∪ g2)) — the only ops a post-exchange partial-combine may
#: re-apply.  count/mean are NOT in this set (count of counts != count).
_SELF_COMBINING = ("sum", "min", "max")


def enabled() -> bool:
    """True when the adaptive layer is on (``config.aqe``)."""
    return bool(config.aqe)


def flip_threshold() -> int:
    """Runtime broadcast-flip row threshold.

    ``config.aqe_broadcast_rows`` when set (>= 0), else the planner's own
    ``config.broadcast_rows``: a separate knob so a caller can force hash
    placement at plan time (broadcast_rows=0) yet still flip at run time.
    """
    t = int(config.aqe_broadcast_rows)
    return t if t >= 0 else int(config.broadcast_rows)


# -- ledger plumbing --------------------------------------------------------

def record(root: Optional[PlanNode], entry: dict) -> dict:
    """Append one adaptive entry to the root's decision ledger.

    Marks it ``runtime=True`` (so :func:`reset` can strip it on
    re-execution of a cached plan) and returns the LIVE dict so the caller
    can fold in post-facto measurements (e.g. post-split skew) before the
    executor's feedback stamp copies the ledger into the query metrics.
    """
    entry = dict(entry)
    entry["runtime"] = True
    if root is None:
        return entry
    with _AQE_LOCK:
        dec = getattr(root, "_decisions", None)
        if dec is None:
            dec = []
            object.__setattr__(root, "_decisions", dec)
        dec.append(entry)
    return entry


def update(entry: dict, **fields) -> None:
    """Fold post-facto measurements into a live ledger entry."""
    with _AQE_LOCK:
        entry.update(fields)


def reset(root: PlanNode) -> None:
    """Strip a prior execution's runtime entries from the ledger.

    PlanCache hands the same optimized plan object to every execution of a
    fingerprint; without this, adaptive entries would accumulate across
    runs and the ledger == decision_census invariant would drift.
    """
    with _AQE_LOCK:
        dec = getattr(root, "_decisions", None)
        if dec:
            dec[:] = [d for d in dec if not d.get("runtime")]


def runtime_entries(root: PlanNode) -> list:
    """Copies of the ledger's runtime (adaptive) entries."""
    with _AQE_LOCK:
        dec = getattr(root, "_decisions", None) or ()
        return [dict(d) for d in dec if d.get("runtime")]


def record_fused_dispatch(root: Optional[PlanNode], node: PlanNode,
                          skew: float, threshold: float,
                          dispatched: str) -> Optional[dict]:
    """Ledger the fused-stage escape-hatch probe's routing decision.

    The whole-stage fusion (``config.fuse_exchange``) erases the exchange
    boundary the skew-split rule fires at, so when AQE is on the executor
    runs a cheap counts probe first and dispatches either the fused
    program or the host-orchestrated path (where ``try_skew_split`` still
    sees the exchange).  ``dispatched`` is ``"fused"`` or ``"host"``.
    """
    if root is None:
        return None
    return record(root, {
        "kind": "fused_stage",
        "path": _path(root, node),
        "measured_skew": round(float(skew), 6),
        "threshold": float(threshold),
        "dispatch": dispatched,
    })


# -- eligibility stamping (called at the end of optimize()) -----------------

def stamp_eligibility(plan: PlanNode) -> None:
    """Mark the Exchange nodes the runtime rules may touch.

    Runs as the optimizer's LAST pass — later structural passes rebuild
    nodes via ``dataclasses.replace`` and would drop these plain-attribute
    stamps (like ``_decisions``, they are set with ``object.__setattr__``
    so plan fingerprints stay byte-identical).

    * ``_aqe_flip`` — a hash Exchange feeding the build (right) side of a
      broadcast-capable Join: the one placement the flip rule may rewrite.
    * ``_aqe_split`` — a hash Exchange feeding an Aggregate: splitting its
      hot keys is content-safe (the executor merges the exchange output
      into one host table before the aggregate runs), and when every
      parent op is self-composable a post-exchange partial-combine spec
      (``_aqe_combine``) is stamped alongside.
    """
    for n in topo_nodes(plan):
        if isinstance(n, Join) and n.how in _FLIP_HOWS \
                and isinstance(n.right, Exchange) and n.right.kind == "hash":
            object.__setattr__(n.right, "_aqe_flip", True)
        if isinstance(n, Aggregate) and isinstance(n.child, Exchange) \
                and n.child.kind == "hash":
            object.__setattr__(n.child, "_aqe_split", True)
            object.__setattr__(n.child, "_aqe_combine", _combine_spec(n))


def _combine_spec(agg: Aggregate) -> Optional[tuple]:
    """(keys, aggs, out_names) for a post-exchange partial-combine, or None.

    The combine re-runs ``(col, op)`` naming its outputs back to ``col``,
    so the parent aggregate consumes the combined table unchanged.  Only
    sound when every op is self-composable, each col is distinct (else the
    renamed outputs would collide), and no col shadows a group key.
    """
    cols = [c for c, _ in agg.aggs]
    if (not agg.keys
            or any(op not in _SELF_COMBINING for _, op in agg.aggs)
            or any(c is None for c in cols)
            or len(set(cols)) != len(cols)
            or set(cols) & set(agg.keys)):
        return None
    return (tuple(agg.keys), tuple(tuple(a) for a in agg.aggs),
            tuple(cols))


# -- rewrite verification ---------------------------------------------------

def _substitute(node: PlanNode, old: PlanNode, new: PlanNode,
                memo: dict) -> PlanNode:
    """Copy of the tree rooted at ``node`` with ``old`` replaced by ``new``.

    Only the root→old spine is rebuilt (untouched subtrees are shared), so
    the substituted tree is cheap and the original plan — the one the
    executor keeps walking — is never mutated.
    """
    from .plan import rebuild
    if id(node) in memo:
        return memo[id(node)]
    if node is old:
        memo[id(node)] = new
        return new
    changes = {}
    for f in ("child", "left", "right"):
        c = getattr(node, f, None)
        if isinstance(c, PlanNode):
            rc = _substitute(c, old, new, memo)
            if rc is not c:
                changes[f] = rc
    out = rebuild(node, **changes) if changes else node
    memo[id(node)] = out
    return out


def verify_rewrite(root: Optional[PlanNode], old: PlanNode, new: PlanNode,
                   rule: str) -> bool:
    """Re-verify a candidate runtime rewrite through RewriteChecker.

    Models the rewrite on a substituted COPY of the plan (root schema +
    nullability must not move) and reports soundness; the caller keeps the
    planned physical op when this returns False.  Verification off
    (``config.verify`` off) trusts the rule, exactly like optimizer
    rewrites.
    """
    if not config.verify:
        return True
    if root is None:
        return False
    from .verify import PlanVerificationError, RewriteChecker
    try:
        checker = RewriteChecker(root)
        checker.check(rule, _substitute(root, old, new, {}))
    except PlanVerificationError:
        metrics.count("engine.aqe.verify_rejected")
        return False
    return True


# -- rule 1: mid-query broadcast flip ---------------------------------------

def try_broadcast_flip(node: Exchange, table, root: Optional[PlanNode],
                       stats: dict, rows: Optional[int] = None) -> bool:
    """Decide + verify + record the broadcast flip for one hash exchange.

    ``table`` is the materialized build side; ``rows`` its row count over
    every rank when it is split over ranks, so every rank decides alike.
    Returns True when the executor should run ``_broadcast_exchange``
    instead of the planned hash exchange; a ledger entry is recorded
    either way (triggered or not) so EXPLAIN shows the rule was consulted.
    """
    measured = int(table.num_rows if rows is None else rows)
    threshold = flip_threshold()
    entry = {"kind": "adaptive:broadcast_flip", "path": _path(root, node),
             "measured_rows": measured, "threshold": threshold,
             "before": "hash", "after": "hash", "triggered": False}
    if measured > threshold:
        record(root, entry)
        return False
    flipped = Exchange(node.child, (), "broadcast")
    if not verify_rewrite(root, node, flipped, "adaptive:broadcast_flip"):
        entry["verify_rejected"] = True
        record(root, entry)
        return False
    entry["after"] = "broadcast"
    entry["triggered"] = True
    record(root, entry)
    stats["aqe_flips"] = stats.get("aqe_flips", 0) + 1
    metrics.count("engine.aqe.broadcast_flips")
    return True


# -- rule 2: hot-key skew split ---------------------------------------------

def plan_skew_split(node: Exchange, counts, ndev: int):
    """From the measured counts matrix, plan the hot-key split.

    Returns ``(split, cap_rows, stats)``: ``split`` is the static
    ``(hot_dests, salt)`` tuple the shuffle remaps with (None when the
    measured skew is under ``config.aqe_skew``), ``cap_rows`` the
    projected post-split per-(src, dest) row maximum the capacity must
    cover, ``stats`` the pre-split ``device_load_stats``.

    Hot destinations are those loaded above the mean; their rows are
    re-dealt round-robin (a per-shard running index, salted so the deal's
    phase is deterministic per key set), which bounds every destination's
    share of the hot rows at ``ceil(hot_rows_per_shard / ndev)`` — an
    adversarial single-key skew provably cannot overflow the projected
    capacity, unlike a salted re-hash whose buckets could collide.
    """
    import numpy as np
    from ..parallel.shuffle import device_load_stats
    cm = np.asarray(counts, dtype=np.int64)
    loads = cm.sum(axis=0)
    st = device_load_stats(loads)
    if ndev <= 1 or st["skew"] <= float(config.aqe_skew):
        return None, None, st
    mean = st["total_rows"] / float(ndev)
    hot = tuple(int(d) for d in range(ndev) if loads[d] > mean)
    if not hot or len(hot) >= ndev:
        hot = (int(np.argmax(loads)),)
    salt = zlib.crc32(",".join(node.keys).encode("utf-8")) % ndev
    proj = cm.copy()
    hot_per_src = proj[:, list(hot)].sum(axis=1)
    proj[:, list(hot)] = 0
    proj += (-(-hot_per_src // ndev))[:, None]
    return (hot, int(salt)), int(proj.max()), st


def try_skew_split(node: Exchange, counts, ndev: int,
                   root: Optional[PlanNode], stats: dict):
    """Decide + verify + record the hot-key split for one hash exchange.

    ``counts`` is the measured phase-1 matrix.  Returns ``(split,
    cap_rows, entry, combine)``: ``split``/``cap_rows`` as
    :func:`plan_skew_split` (split None when not triggered or rejected),
    ``entry`` the LIVE ledger dict (the executor folds ``post_skew`` in
    after the payload pass), ``combine`` True when the post-exchange
    partial-combine was verified sound.
    """
    split, cap_rows, st = plan_skew_split(node, counts, ndev)
    entry = {"kind": "adaptive:skew_split", "path": _path(root, node),
             "measured_skew": st["skew"],
             "threshold": float(config.aqe_skew),
             "triggered": False, "combine": False}
    if split is None:
        return None, None, record(root, entry), False
    split_ok, combine_ok = verify_split(node, root)
    if not split_ok:
        entry["verify_rejected"] = True
        return None, None, record(root, entry), False
    entry.update(triggered=True, hot_devices=list(split[0]),
                 salt=split[1], combine=combine_ok)
    entry = record(root, entry)
    stats["aqe_splits"] = stats.get("aqe_splits", 0) + 1
    metrics.count("engine.aqe.skew_splits")
    return split, cap_rows, entry, combine_ok


def verify_split(node: Exchange, root: Optional[PlanNode]) -> Tuple[bool,
                                                                    bool]:
    """(split_ok, combine_ok) for a triggered skew split.

    The split itself is placement-only — the executor merges the exchange
    output into one host table, so the row multiset downstream consumes is
    unchanged; it is modeled as an identity substitution (a fresh equal
    Exchange) through RewriteChecker.  The partial-combine DOES change the
    tree (an Aggregate inserted above the exchange); it is verified as
    that insertion and dropped — split kept — if the root schema or
    nullability would move.
    """
    same = Exchange(node.child, node.keys, node.kind)
    split_ok = verify_rewrite(root, node, same, "adaptive:skew_split")
    spec = getattr(node, "_aqe_combine", None)
    if not split_ok or spec is None:
        return split_ok, False
    keys, aggs, names = spec
    pre = Aggregate(same, keys, aggs, names)
    combine_ok = verify_rewrite(root, node, pre,
                                "adaptive:skew_split-combine")
    return split_ok, combine_ok


def apply_precombine(node: Exchange, table):
    """Post-exchange partial-combine over the merged exchange output.

    Collapses the (now round-robin-scattered) hot keys' rows back to one
    row per group before downstream ops run, on the table's device.
    Returns the table unchanged when no self-composable spec was stamped.
    """
    spec = getattr(node, "_aqe_combine", None)
    if spec is None:
        return table, False
    keys, aggs, names = spec
    from ..ops.aggregate import groupby
    out = groupby(table, list(keys), [tuple(a) for a in aggs],
                  names=list(names), device=table.columns[0].device)
    return out, True


# -- rule 3: profile-warmed planning ----------------------------------------

def history_overrides(source_fingerprint: str) -> Optional[dict]:
    """Measured build-side actuals from the newest stored run of this
    SOURCE (pre-optimization) fingerprint, as an ordered queue for
    ``_plan_exchanges`` to consume join-by-join.

    Keyed on the source fingerprint, not the optimized one: warming exists
    precisely to CHANGE the optimized plan, so run 2's optimized
    fingerprint differs from run 1's while the source is stable.  Returns
    None when no prior run is stored or it recorded no join placements.
    """
    from ..utils import profile
    hist = profile.history(source_fingerprint)
    if hist is None:
        return None
    builds = []
    for d in hist.get("decisions") or ():
        k = d.get("kind")
        if k == "broadcast" or (k == "shuffle"
                                and d.get("side") == "right"):
            builds.append({"actual_rows": d.get("actual_rows"),
                           "est_rows": d.get("est_rows"),
                           "prior_kind": k})
    if not builds:
        return None
    return {"source_fingerprint": source_fingerprint,
            "runs": int(hist.get("runs", 1)), "builds": builds, "next": 0}


def next_build_actual(warm: Optional[dict]) -> Optional[dict]:
    """Pop the next prior-run build measurement (postorder join order).

    Joins are planned in the same deterministic postorder every run of a
    source fingerprint, so a simple queue aligns run 2's joins with run
    1's recorded placements; a structure divergence merely exhausts or
    misaligns the queue — a perf no-op, never a correctness issue (verify
    still guards every choice).
    """
    if warm is None:
        return None
    i = warm["next"]
    if i >= len(warm["builds"]):
        return None
    warm["next"] = i + 1
    return warm["builds"][i]


def _path(root: Optional[PlanNode], node: PlanNode) -> Optional[str]:
    if root is None:
        return None
    from .verify import node_paths
    return node_paths(root).get(id(node))
