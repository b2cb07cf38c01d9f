"""Where a plan's rows live when the engine runs over ranks.

Every rank runs the same physical plan (rank 0 optimizes it and broadcasts
it, ``optimizer.optimize(ranks=)``) over its share of the scans, as Spark
plans a query once and runs it as tasks over splits.  Each node's output on
a rank has a placement, told in the planner's own vocabulary
(``plan.Partitioning``):

- ``REP`` (kind ``"broadcast"``): the whole table, the same on every rank;
- ``SPLIT`` (kind ``"split"``, which only a ranked run has): this rank's
  rows of it, the ranks' rows together being the table;
- ``Partitioning("hash", keys)``: a split whose rows sit on the rank owning
  ``pmod(murmur3(keys), shards)``, as a hash Exchange leaves them.

The rules follow ``plan.partitioning`` (a hash placement survives Filter
and a Project that keeps its keys; an Exchange places its rows; a join
keeps its probe side's placement), with what only the run can know on
top.  A parquet Scan splits its row groups over the ranks (rank r reads
the groups ``r, r + W, ...``) when every path from it to the root reaches
an Exchange through nodes that do not care about row order (Filter,
Project, Join, an Aggregate without ``first``/``last``/``collect_list``):
the exchange re-places the rows anyway.  Any other scan is read whole on
every rank.  A split scan is ``SPLIT`` even where its ``partitioned_by``
claims a hash placement: a rank reads row groups, not hash buckets, so
where the optimizer elided an exchange over such a scan, the node above
gathers or combines.  A node whose input placement does not give its
answer gathers that input first; a decomposable Aggregate over split rows
instead gathers its per-rank groups and combines them.  The one
exception is a partial the optimizer split off (``_partial``, stamped by
``optimizer._stamp_partials``): its combine above the exchange finishes
the groups.  A skew split or a passthrough leaves a hash exchange's rows
``SPLIT``, a broadcast flip leaves them ``REP``: the executor records
those (``Placement.record``).  The root's result is gathered at the end,
so every rank holds the answer.  With no group (or one rank) none of this
runs.
"""

from __future__ import annotations

from .plan import (BROADCAST_PARTITIONING, ORDER_SENSITIVE_AGGS, Aggregate,
                   Exchange, Filter, Join, Partitioning, PlanNode, Project,
                   Scan, co_partitioned, topo_nodes)

REP = BROADCAST_PARTITIONING
SPLIT = Partitioning("split", ())

#: joins whose output is driven by the left rows: a replicated right side
#: emits each result row once (optimizer._BROADCAST_HOWS)
_LEFT_DRIVEN = ("inner", "left", "semi", "anti", "cross")


def hashed(keys) -> Partitioning:
    return Partitioning("hash", tuple(keys))


def _order_free(node: PlanNode) -> bool:
    if isinstance(node, (Filter, Project, Join)):
        return True
    return isinstance(node, Aggregate) and not any(
        op in ORDER_SENSITIVE_AGGS for _, op in node.aggs)


def split_scans(root: PlanNode) -> set:
    """ids of the parquet Scans whose row groups split over the ranks."""
    parents: dict = {}
    for n in topo_nodes(root):
        for c in n.children():
            parents.setdefault(id(c), []).append(n)
    memo: dict = {}

    def feeds_exchange(n) -> bool:
        if id(n) not in memo:
            ps = parents.get(id(n), [])
            memo[id(n)] = bool(ps) and all(
                isinstance(p, Exchange) or (_order_free(p)
                                            and feeds_exchange(p))
                for p in ps)
        return memo[id(n)]

    return {id(n) for n in topo_nodes(root)
            if isinstance(n, Scan) and n.format == "parquet"
            and feeds_exchange(n)}


class Placement:
    """The placements of one ranked execution of ``root``: what the plan
    implies, overridden by what the run recorded."""

    def __init__(self, root: PlanNode):
        self.split = split_scans(root)
        self._recorded: dict = {}

    def record(self, node: PlanNode, p: Partitioning) -> None:
        self._recorded[id(node)] = p

    def settle(self, node: PlanNode) -> None:
        """Fix an executed node's placement, so a later record of its
        inputs cannot change it."""
        self._recorded.setdefault(id(node), self.of(node))

    def of(self, node: PlanNode) -> Partitioning:
        p = self._recorded.get(id(node))
        if p is not None:
            return p
        if isinstance(node, Scan):
            return SPLIT if id(node) in self.split else REP
        if isinstance(node, Filter):
            return self.of(node.child)
        if isinstance(node, Project):
            p = self.of(node.child)
            if p.kind == "hash" and not set(p.keys) <= set(node.columns):
                return SPLIT  # the rows stay; the claim goes
            return p
        if isinstance(node, Exchange):
            return hashed(node.keys) if node.kind == "hash" else REP
        if isinstance(node, Join):
            return self.join(node)[2]
        if isinstance(node, Aggregate):
            return self.aggregate(node)[1]
        return REP  # Sort, Limit, TopK gather their input

    def join(self, node: Join) -> tuple:
        """``(gather left, gather right, output placement)``."""
        left, right = self.of(node.left), self.of(node.right)
        if left == REP and right == REP:
            return False, False, REP
        if right == REP and node.how in _LEFT_DRIVEN:
            return False, False, left
        if left == REP and node.how in ("inner", "cross"):
            return False, False, SPLIT
        if node.how != "cross" and co_partitioned(
                left, right, node.left_keys, node.right_keys):
            return False, False, left
        return left != REP, right != REP, REP

    def aggregate(self, node: Aggregate) -> tuple:
        """``(mode, output placement)``: ``"local"`` runs it on this rank's
        rows as they are; ``"combine"`` runs it locally, gathers the
        per-rank groups and combines them; ``"gather"`` gathers the input
        first."""
        from .executor import _STREAM_COMBINE
        child = self.of(node.child)
        if child == REP:
            return "local", REP
        if child.kind == "hash" and node.keys \
                and set(child.keys) <= set(node.keys):
            return "local", child
        if getattr(node, "_partial", False):
            return "local", SPLIT
        if all(op in _STREAM_COMBINE for _, op in node.aggs):
            return "combine", REP
        return "gather", REP
