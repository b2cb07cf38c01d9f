"""Static plan verification: schema and nullability inference over the plan.

The port of the plan-level half of ``spark_rapids_jni_tpu/engine/verify.py``
(pure Python there too, apart from its footer reads):

- **Plan verifier**: schema/dtype inference propagated bottom-up over the
  plan DAG.  Every plan-node class has an ``infer_schema`` rule in the
  ``_INFER`` dispatch table, producing an ordered ``{name: DType}`` for the
  node's output.  Build-time checks fire during inference (unknown columns,
  join-key dtype-family mismatches, invalid casts, aggregating strings with
  numeric ops) and raise a structured :class:`PlanVerificationError` that
  carries the node path from the root (``root.child.left`` ...).
  ``optimizer.optimize`` runs a :class:`RewriteChecker` after every rewrite
  rule, so a rule that changes the root schema or nullability fails at plan
  time instead of giving a wrong result.
- **Nullability lattice** (``infer_nullability``): footer statistics prove
  a column ``"never"`` null; filters prove the columns they reference.
- The static censuses the optimizer's ledger and EXPLAIN read
  (``node_paths``, ``plan_exchanges``, ``decision_census``,
  ``check_partitioning``).
- The plan-level models of the executor's segments and deliberate host
  syncs (``plan_segments``, ``sync_budget``, ``check_sync_budget``),
  ``fused-stage`` entries included: the static charge equals the runtime
  ``engine.host_sync`` counter (``metrics.host_sync``).

Scan schemas come from the port's ``ParquetFile`` and ``ORCFile`` footers.

The JAX package's jaxpr lints (``lint_segment``, ``lint_decode_segment``,
``lint_fused_stage``, ``lint_plan_artifacts``, ``lint_segment_cache``) have
no torch counterpart: the repo lint's ``--segments`` pass
(``tools/srjt_lint.py``) runs the fused segment bodies on a card under
``torch.cuda.set_sync_debug_mode("error")`` instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..dtypes import BOOL8, FLOAT64, INT64, LIST, STRING, DType
from .plan import (ORDER_SENSITIVE_AGGS, Aggregate, Exchange, Filter, Join,
                   Limit, PlanNode, Project, Scan, Sort, TopK, co_partitioned,
                   expr_columns, node_label, partitioning, topo_nodes)

#: aggregate ops that require a numeric (or decimal) input column
_NUMERIC_AGGS = frozenset({"sum", "mean", "var", "std", "sumsq", "fsum"})

#: the two-point nullability lattice flowing through the abstract
#: interpreter: ``"never"`` (proven non-null by footer stats or a filter
#: over the column) ⊑ ``"maybe"`` (top — anything unproven).  A rewrite
#: moving a root column between the two is ``rewrite-nullability-change``.
NULL_NEVER = "never"
NULL_MAYBE = "maybe"

#: past ±2^53 a float64 can no longer represent every integer, so a
#: comparison that promotes an integral column (or integral literal) into
#: the float domain silently collapses neighbouring values
_FLOAT64_EXACT_INT = 2 ** 53


class PlanVerificationError(ValueError):
    """A plan failed a build-time check.

    Structured so the bridge can ship it as a machine-parseable error
    reply: ``code`` names the check (``unknown-column``,
    ``join-key-dtype-mismatch``, ``invalid-cast``, ``overflow-unsafe-cast``,
    ``aggregate-over-string``, ``order-sensitive-exchange``,
    ``rewrite-schema-change``, ``rewrite-nullability-change``,
    ``unknown-node``), ``node_path`` locates the offending node from the
    root (``root.child.left`` ...).
    """

    def __init__(self, code: str, node_path: str, message: str):
        self.code = code
        self.node_path = node_path
        self.message = message
        super().__init__(f"{code} at {node_path}: {message}")

    def __reduce__(self):
        # pickles whole, so another rank can raise it (parallel/ranks.py)
        return type(self), (self.code, self.node_path, self.message)

    def to_dict(self) -> dict:
        return {"code": self.code, "node_path": self.node_path,
                "message": self.message}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanVerificationError":
        return cls(d.get("code", "unknown"), d.get("node_path", "?"),
                   d.get("message", ""))


class SchemaResolver:
    """Caches scan-file footer schemas as ordered ``{name: DType}``.

    Unreadable/missing files resolve to ``None`` (schema unknown): the
    verifier then skips schema-dependent checks for that subtree and the
    executor surfaces the I/O error at run time, exactly as before — a
    missing file is an execution failure, not a plan-verification one.
    """

    def __init__(self):
        self._files: dict = {}
        self._nulls: dict = {}

    def file_nullability(self, node: Scan) -> Optional[dict]:
        """Footer-derived nullability facts: ``{name: "never"|"maybe"}``.

        A parquet column whose every row group carries statistics with a
        zero null count is proven ``"never"`` null; a missing stats block,
        an unknown null count, or a non-parquet source degrades to
        ``"maybe"`` (the lattice top).  Unreadable files resolve to
        ``None``, exactly like :meth:`file_schema`.
        """
        key = (node.format, node.path)
        if key not in self._nulls:
            try:
                if node.format == "parquet":
                    from ..io import ParquetFile
                    pf = ParquetFile(node.path)
                    out = {}
                    for c in pf.schema:
                        never = pf.num_row_groups > 0
                        for gi in range(pf.num_row_groups):
                            st = pf.group_stats(gi, c.name)
                            if st is None or st[2] is None or st[2] > 0:
                                never = False
                                break
                        out[c.name] = NULL_NEVER if never else NULL_MAYBE
                    self._nulls[key] = out
                else:
                    from ..io import ORCFile
                    self._nulls[key] = {nm: NULL_MAYBE for nm, _dt
                                        in ORCFile(node.path).schema}
            except Exception:
                self._nulls[key] = None
        nl = self._nulls[key]
        return None if nl is None else dict(nl)

    def file_schema(self, node: Scan) -> Optional[dict]:
        key = (node.format, node.path)
        if key not in self._files:
            try:
                if node.format == "parquet":
                    from ..io import ParquetFile
                    self._files[key] = {c.name: c.dtype
                                        for c in ParquetFile(node.path).schema}
                else:
                    from ..io import ORCFile
                    self._files[key] = dict(ORCFile(node.path).schema)
            except Exception:
                self._files[key] = None
        sc = self._files[key]
        return None if sc is None else dict(sc)


# -- dtype classification ---------------------------------------------------

def _lit_dtype(value) -> Optional[DType]:
    if isinstance(value, bool):
        return BOOL8
    if isinstance(value, int):
        return INT64
    if isinstance(value, float):
        return FLOAT64
    if isinstance(value, str):
        return STRING
    return None  # None/other literals: unknown, checks skip


def _cast_family(dt: Optional[DType]) -> Optional[str]:
    """Coarse comparability family: comparisons may mix anything scalar
    (ints, floats, bools, timestamps-as-ints) but never string vs
    non-string or nested."""
    if dt is None:
        return None
    if dt.is_string:
        return "string"
    if dt.is_nested:
        return "nested"
    return "scalar"

def _key_family(dt: Optional[DType]) -> Optional[str]:
    """Join-key family: stricter than comparability because equi-joins
    hash the RAW storage — int64 and float64 keys hash differently, so an
    integral-vs-floating key pair silently matches nothing."""
    if dt is None:
        return None
    if dt.is_string:
        return "string"
    if dt.is_decimal:
        return ("decimal", dt.scale)
    if dt.is_timestamp:
        return "timestamp"
    if dt.is_floating:
        return "floating"
    if dt.is_numeric or dt.id.name == "BOOL8":
        return "integral"
    return "other"


def _agg_out_dtype(op: str, dt: Optional[DType]) -> Optional[DType]:
    """Output dtype of one aggregate op (mirrors ops.aggregate)."""
    if op in ("count", "count_all"):
        return INT64
    if op in ("mean", "var", "std", "sumsq", "fsum"):
        return FLOAT64
    if op == "collect_list":
        return LIST
    if dt is None:
        return None
    if op == "sum":
        if dt.is_floating:
            return FLOAT64
        if dt.is_integral:
            return INT64
        return dt  # decimal sums keep their scale
    return dt  # min/max/first/last


# -- expression type checking -----------------------------------------------

def _expr_dtype(expr, schema: dict, path: str,
                node: PlanNode) -> Optional[DType]:
    """Dtype of a filter expression over ``schema``; raises on unknown
    columns and string-vs-non-string comparisons (the invalid-cast check —
    the executor would lower these to a nonsense tensor comparison)."""
    head = expr[0]
    if head == "col":
        if expr[1] not in schema:
            raise PlanVerificationError(
                "unknown-column", path,
                f"{node_label(node)} references unknown column {expr[1]!r} "
                f"(available: {sorted(schema)})")
        return schema[expr[1]]
    if head == "lit":
        return _lit_dtype(expr[1])
    if head == "not":
        _expr_dtype(expr[1], schema, path, node)
        return BOOL8
    a = _expr_dtype(expr[1], schema, path, node)
    b = _expr_dtype(expr[2], schema, path, node)
    if head in ("&", "|"):
        for side in (a, b):
            if side is not None and (side.is_string or side.is_nested):
                raise PlanVerificationError(
                    "invalid-cast", path,
                    f"{node_label(node)}: boolean operator {head!r} over "
                    f"non-boolean operand {side!r}")
        return BOOL8
    fa, fb = _cast_family(a), _cast_family(b)
    if "nested" in (fa, fb):
        raise PlanVerificationError(
            "invalid-cast", path,
            f"{node_label(node)}: comparison {head!r} over nested type")
    if fa is not None and fb is not None and fa != fb:
        raise PlanVerificationError(
            "invalid-cast", path,
            f"{node_label(node)}: comparison {head!r} between {a!r} and "
            f"{b!r} — string vs non-string needs an explicit cast")
    if "string" in (fa, fb) and head not in ("==", "!="):
        raise PlanVerificationError(
            "invalid-cast", path,
            f"{node_label(node)}: ordering comparison {head!r} over STRING "
            f"operands — the string kernel set defines only ==/!=")
    for lit_side, dt_side in ((expr[1], b), (expr[2], a)):
        if lit_side[0] == "lit":
            _check_lit_overflow(head, dt_side, lit_side[1], path, node)
    return BOOL8


def _check_lit_overflow(head, col_dt: Optional[DType], value, path: str,
                        node: PlanNode) -> None:
    """Cast/overflow legality of one ``col <op> lit`` comparison: the
    executor lowers both sides into the column's tensor domain, so a literal
    the domain cannot represent exactly makes the comparison silently
    wrong instead of merely slow (``overflow-unsafe-cast``)."""
    if col_dt is None or isinstance(value, bool):
        return
    if col_dt.is_integral and isinstance(value, int):
        info = np.iinfo(col_dt.storage)
        if not (int(info.min) <= value <= int(info.max)):
            raise PlanVerificationError(
                "overflow-unsafe-cast", path,
                f"{node_label(node)}: literal {value} overflows the "
                f"{col_dt!r} column domain [{info.min}, {info.max}] in "
                f"comparison {head!r}")
    elif col_dt.is_integral and isinstance(value, float):
        if abs(value) > _FLOAT64_EXACT_INT:
            raise PlanVerificationError(
                "overflow-unsafe-cast", path,
                f"{node_label(node)}: float literal {value!r} promotes the "
                f"{col_dt!r} column to float64 beyond the 2^53 exact-integer "
                f"range in comparison {head!r}")
    elif col_dt.is_floating and isinstance(value, int):
        if abs(value) > _FLOAT64_EXACT_INT:
            raise PlanVerificationError(
                "overflow-unsafe-cast", path,
                f"{node_label(node)}: integer literal {value} is not exactly "
                f"representable as {col_dt!r} (past 2^53) in comparison "
                f"{head!r}")


# -- per-node infer_schema rules (the verifier dispatch table) --------------

class _Ctx:
    __slots__ = ("resolver", "memo", "nmemo")

    def __init__(self, resolver: SchemaResolver):
        self.resolver = resolver
        self.memo: dict = {}
        self.nmemo: dict = {}


def _infer_scan(node: Scan, path: str, ctx: _Ctx) -> Optional[dict]:
    file_schema = ctx.resolver.file_schema(node)
    if node.predicate is not None and file_schema is not None:
        pcol = node.predicate[0]
        if pcol not in file_schema:
            raise PlanVerificationError(
                "unknown-column", path,
                f"scan pruning predicate over unknown column {pcol!r} "
                f"(file has: {sorted(file_schema)})")
        pdt = file_schema[pcol]
        if pdt is not None and (pdt.is_string or pdt.is_nested):
            raise PlanVerificationError(
                "invalid-cast", path,
                f"scan pruning predicate needs a numeric column, "
                f"{pcol!r} is {pdt!r}")
    if node.partitioned_by is not None and file_schema is not None:
        missing = [c for c in node.partitioned_by if c not in file_schema]
        if missing:
            raise PlanVerificationError(
                "unknown-column", path,
                f"scan partitioned_by references unknown column(s) "
                f"{missing} (file has: {sorted(file_schema)})")
    if node.columns is not None:
        if file_schema is None:
            # names known, dtypes not: unknown-column checks still work
            return {c: None for c in node.columns}
        missing = [c for c in node.columns if c not in file_schema]
        if missing:
            raise PlanVerificationError(
                "unknown-column", path,
                f"scan selects unknown column(s) {missing} "
                f"(file has: {sorted(file_schema)})")
        return {c: file_schema[c] for c in node.columns}
    return file_schema


def _infer_filter(node: Filter, path: str, ctx: _Ctx) -> Optional[dict]:
    child = _infer(node.child, path + ".child", ctx)
    if child is not None:
        _expr_dtype(node.predicate, child, path, node)
    return child


def _infer_project(node: Project, path: str, ctx: _Ctx) -> Optional[dict]:
    child = _infer(node.child, path + ".child", ctx)
    if child is None:
        return None
    missing = [c for c in node.columns if c not in child]
    if missing:
        raise PlanVerificationError(
            "unknown-column", path,
            f"project selects unknown column(s) {missing} "
            f"(child has: {sorted(child)})")
    return {c: child[c] for c in node.columns}


def _infer_join(node: Join, path: str, ctx: _Ctx) -> Optional[dict]:
    left = _infer(node.left, path + ".left", ctx)
    right = _infer(node.right, path + ".right", ctx)
    if node.how != "cross":
        for keys, schema, side in ((node.left_keys, left, "left"),
                                   (node.right_keys, right, "right")):
            if schema is None:
                continue
            for k in keys:
                if k not in schema:
                    raise PlanVerificationError(
                        "unknown-column", path,
                        f"join {side} key {k!r} not in {side} input "
                        f"(has: {sorted(schema)})")
        if left is not None and right is not None:
            for lk, rk in zip(node.left_keys, node.right_keys):
                lf, rf = _key_family(left[lk]), _key_family(right[rk])
                if lf is not None and rf is not None and lf != rf:
                    raise PlanVerificationError(
                        "join-key-dtype-mismatch", path,
                        f"join key {lk!r} ({left[lk]!r}) vs {rk!r} "
                        f"({right[rk]!r}): families {lf} vs {rf} hash "
                        f"differently and would silently match nothing")
    if node.how in ("semi", "anti"):
        return left
    if left is None or right is None:
        return None
    rkeys = set(node.right_keys) if node.how != "cross" else set()
    out = dict(left)
    for nm, dt in right.items():
        if nm in rkeys:
            continue
        out[nm + ("_r" if nm in left else "")] = dt
    return out


def _infer_aggregate(node: Aggregate, path: str, ctx: _Ctx) -> Optional[dict]:
    if any(op in ORDER_SENSITIVE_AGGS for _c, op in node.aggs):
        below = node.child
        while isinstance(below, (Filter, Project, Limit)):
            below = below.child  # order-preserving unaries
        if isinstance(below, Exchange) and below.kind == "hash":
            raise PlanVerificationError(
                "order-sensitive-exchange", path,
                f"order-sensitive aggregate "
                f"({[op for _c, op in node.aggs if op in ORDER_SENSITIVE_AGGS]}) "
                f"fed by a hash exchange: the shuffle destroys the row order "
                f"first/last/collect_list depend on")
    child = _infer(node.child, path + ".child", ctx)
    if child is None:
        return None
    for k in node.keys:
        if k not in child:
            raise PlanVerificationError(
                "unknown-column", path,
                f"aggregate key {k!r} not in input (has: {sorted(child)})")
    out = {k: child[k] for k in node.keys}
    for (cname, op), outname in zip(node.aggs, node.names):
        if cname is None:
            out[outname] = INT64  # count_all
            continue
        if cname not in child:
            raise PlanVerificationError(
                "unknown-column", path,
                f"aggregate {op!r} over unknown column {cname!r} "
                f"(input has: {sorted(child)})")
        dt = child[cname]
        if dt is not None and op in _NUMERIC_AGGS and \
                (dt.is_string or dt.is_nested):
            raise PlanVerificationError(
                "aggregate-over-string", path,
                f"aggregate {op!r} needs a numeric column, "
                f"{cname!r} is {dt!r}")
        out[outname] = _agg_out_dtype(op, dt)
    return out


def _check_order_keys(node, keys, path: str, ctx: _Ctx) -> Optional[dict]:
    child = _infer(node.child, path + ".child", ctx)
    if child is not None:
        for c, _asc in keys:
            if c not in child:
                raise PlanVerificationError(
                    "unknown-column", path,
                    f"{node_label(node)} key {c!r} not in input "
                    f"(has: {sorted(child)})")
    return child


def _infer_sort(node: Sort, path: str, ctx: _Ctx) -> Optional[dict]:
    return _check_order_keys(node, node.keys, path, ctx)


def _infer_topk(node: TopK, path: str, ctx: _Ctx) -> Optional[dict]:
    return _check_order_keys(node, node.keys, path, ctx)


def _infer_limit(node: Limit, path: str, ctx: _Ctx) -> Optional[dict]:
    return _infer(node.child, path + ".child", ctx)


def _infer_exchange(node: Exchange, path: str, ctx: _Ctx) -> Optional[dict]:
    """Exchange is schema-transparent: output columns/dtypes equal the
    child's.  Hash keys must exist in the child schema — a key the executor
    can't hash is a build-time error, not a runtime KeyError."""
    child = _infer(node.child, path + ".child", ctx)
    if node.kind == "hash" and child is not None:
        missing = [k for k in node.keys if k not in child]
        if missing:
            raise PlanVerificationError(
                "unknown-column", path,
                f"exchange hash key(s) {missing} not in input "
                f"(has: {sorted(child)})")
    return child


#: plan-node class -> infer_schema rule, total over plan._NODE_TYPES
_INFER = {
    Scan: _infer_scan,
    Filter: _infer_filter,
    Project: _infer_project,
    Join: _infer_join,
    Aggregate: _infer_aggregate,
    Sort: _infer_sort,
    Limit: _infer_limit,
    TopK: _infer_topk,
    Exchange: _infer_exchange,
}


def _infer(node: PlanNode, path: str, ctx: _Ctx) -> Optional[dict]:
    if id(node) in ctx.memo:
        return ctx.memo[id(node)]
    fn = _INFER.get(type(node))
    if fn is None:
        raise PlanVerificationError(
            "unknown-node", path,
            f"plan node {type(node).__name__} has no infer_schema rule "
            f"(register it in verify._INFER)")
    out = fn(node, path, ctx)
    ctx.memo[id(node)] = out
    return out


def verify(plan: PlanNode,
           resolver: Optional[SchemaResolver] = None) -> Optional[dict]:
    """Type-check ``plan`` bottom-up; returns the root output schema as an
    ordered ``{name: DType}`` (``None`` when no scan schema resolved).

    Raises :class:`PlanVerificationError` on the first violated build-time
    check, carrying the check code and the node path from the root.
    """
    return _infer(plan, "root", _Ctx(resolver or SchemaResolver()))


# -- nullability abstract interpretation ------------------------------------

def _nulls_scan(node: Scan, path: str, ctx: _Ctx) -> Optional[dict]:
    nl = ctx.resolver.file_nullability(node)
    if nl is None:
        return None
    if node.columns is not None:
        return {c: nl.get(c, NULL_MAYBE) for c in node.columns}
    return nl


def _nulls_filter(node: Filter, path: str, ctx: _Ctx) -> Optional[dict]:
    child = _nulls(node.child, path + ".child", ctx)
    if child is None:
        return None
    # the executor ANDs the validity of EVERY predicate-referenced column
    # into the keep-mask (engine/executor._eval_expr), so survivors are
    # proven non-null in those columns regardless of the operator tree
    out = dict(child)
    for c in expr_columns(node.predicate):
        if c in out:
            out[c] = NULL_NEVER
    return out


def _nulls_project(node: Project, path: str, ctx: _Ctx) -> Optional[dict]:
    child = _nulls(node.child, path + ".child", ctx)
    if child is None:
        return None
    return {c: child[c] for c in node.columns if c in child}


def _nulls_join(node: Join, path: str, ctx: _Ctx) -> Optional[dict]:
    left = _nulls(node.left, path + ".left", ctx)
    right = _nulls(node.right, path + ".right", ctx)
    if node.how in ("semi", "anti"):
        return left
    if left is None or right is None:
        return None
    # outer joins pad the unmatched side with nulls, widening every one of
    # its columns to "maybe" — the precise fact the lattice exists to track
    if node.how in ("left", "full"):
        right = {c: NULL_MAYBE for c in right}
    if node.how in ("right", "full"):
        left = {c: NULL_MAYBE for c in left}
    rkeys = set(node.right_keys) if node.how != "cross" else set()
    out = dict(left)
    for nm, nu in right.items():
        if nm in rkeys:
            continue
        out[nm + ("_r" if nm in left else "")] = nu
    return out


def _nulls_aggregate(node: Aggregate, path: str, ctx: _Ctx) -> Optional[dict]:
    child = _nulls(node.child, path + ".child", ctx)
    if child is None:
        return None
    out = {k: child.get(k, NULL_MAYBE) for k in node.keys}
    for (cname, op), outname in zip(node.aggs, node.names):
        if op in ("count", "count_all") or op == "collect_list":
            out[outname] = NULL_NEVER  # counts and lists always materialize
        elif cname is None:
            out[outname] = NULL_NEVER
        else:
            out[outname] = child.get(cname, NULL_MAYBE)
    return out


def _nulls_child(node, path: str, ctx: _Ctx) -> Optional[dict]:
    """Sort/Limit/TopK/Exchange: row-set reshapes, nullability-transparent."""
    return _nulls(node.child, path + ".child", ctx)


#: plan-node class -> nullability rule, total over plan._NODE_TYPES
_NULLS = {
    Scan: _nulls_scan,
    Filter: _nulls_filter,
    Project: _nulls_project,
    Join: _nulls_join,
    Aggregate: _nulls_aggregate,
    Sort: _nulls_child,
    Limit: _nulls_child,
    TopK: _nulls_child,
    Exchange: _nulls_child,
}


def _nulls(node: PlanNode, path: str, ctx: _Ctx) -> Optional[dict]:
    if id(node) in ctx.nmemo:
        return ctx.nmemo[id(node)]
    fn = _NULLS.get(type(node))
    if fn is None:
        raise PlanVerificationError(
            "unknown-node", path,
            f"plan node {type(node).__name__} has no nullability rule "
            f"(register it in verify._NULLS)")
    out = fn(node, path, ctx)
    ctx.nmemo[id(node)] = out
    return out


def infer_nullability(plan: PlanNode,
                      resolver: Optional[SchemaResolver] = None
                      ) -> Optional[dict]:
    """Abstract interpretation over the nullability lattice: the root's
    ``{name: "never"|"maybe"}``, or ``None`` when no scan footer resolved.

    Companion pass to :func:`verify` — where ``verify`` proves dtype
    shape, this proves null behaviour, so :class:`RewriteChecker` can
    reject a rewrite that silently turns a proven-non-null column nullable
    (or claims the reverse) even though the dtypes still line up.
    """
    return _nulls(plan, "root", _Ctx(resolver or SchemaResolver()))


class RewriteChecker:
    """Asserts optimizer rewrites preserve the root output schema AND the
    root nullability vector.

    Built on the ORIGINAL plan (which also runs the build-time checks up
    front); ``check(rule, plan)`` re-verifies after each rule and raises
    ``rewrite-schema-change`` if the root schema moved, or
    ``rewrite-nullability-change`` if a root column's position in the
    nullability lattice moved — an optimizer bug caught at plan time
    instead of a silently wrong result.
    """

    def __init__(self, plan: PlanNode):
        self.resolver = SchemaResolver()
        self.base = verify(plan, self.resolver)
        self.base_nulls = infer_nullability(plan, self.resolver)

    def check(self, rule: str, plan: PlanNode) -> None:
        after = verify(plan, self.resolver)
        if self.base is not None and after is not None:
            if list(self.base.items()) != list(after.items()):
                raise PlanVerificationError(
                    "rewrite-schema-change", "root",
                    f"optimizer rule {rule!r} changed the root schema from "
                    f"{list(self.base)} to {list(after)}")
        after_nulls = infer_nullability(plan, self.resolver)
        if self.base_nulls is not None and after_nulls is not None:
            if self.base_nulls != after_nulls:
                moved = sorted(set(self.base_nulls.items())
                               ^ set(after_nulls.items()))
                raise PlanVerificationError(
                    "rewrite-nullability-change", "root",
                    f"optimizer rule {rule!r} changed root nullability: "
                    f"{moved}")


# -- static censuses ---------------------------------------------------------

def node_paths(root: PlanNode) -> dict:
    """id(node) -> dotted path from the root (first-visit path for shared
    nodes), matching the paths PlanVerificationError reports."""
    paths: dict = {}

    def visit(n: PlanNode, p: str) -> None:
        if id(n) in paths:
            return
        paths[id(n)] = p
        for f in ("child", "left", "right"):
            c = getattr(n, f, None)
            if isinstance(c, PlanNode):
                visit(c, f"{p}.{f}")

    visit(root, "root")
    return paths


def plan_exchanges(plan: PlanNode) -> list:
    """Static census of the Exchange nodes in a plan, in postorder — one
    entry ``{"path", "kind", "keys"}`` per node.  The executor bumps
    ``stats["exchanges"]`` once per Exchange regardless of degenerate
    early-outs (1 device, 0 rows), so ``len(plan_exchanges(p))`` equals the
    executed count exactly."""
    paths = node_paths(plan)
    return [{"path": paths[id(n)], "kind": n.kind, "keys": list(n.keys)}
            for n in topo_nodes(plan) if isinstance(n, Exchange)]


def decision_census(plan: PlanNode, dist: bool = False) -> list:
    """Static census of decision-evidencing structures in an OPTIMIZED
    plan, in postorder — one entry ``{"kind", "path"}`` per structure.

    The planner's structural decisions all leave a fingerprint in the
    plan shape: a broadcast choice is an ``Exchange(broadcast)``, a hash
    placement is an ``Exchange(hash)``, a partial-agg split is the
    ``Aggregate(Exchange(hash, Aggregate))`` sandwich (whose inner
    exchange belongs to the split, not counted separately), a TopK
    rewrite is the ``TopK`` node, and an order-sensitive revert is a
    distributed Aggregate still carrying order-sensitive ops.  So for a
    planner-optimized plan (no hand-placed exchanges) this census equals,
    kind for kind, the structural entries of the plan's ``_decisions``
    ledger (the EXPLAIN footer renders both).  Elimination/fold decisions
    remove structure and are deliberately absent here.

    ``dist`` gates the order-sensitive-revert entries (the revert only
    happens when exchange planning ran).
    """
    from .plan import ORDER_SENSITIVE_AGGS
    paths = node_paths(plan)
    partial_exchanges = set()
    for n in topo_nodes(plan):
        if isinstance(n, Aggregate) and isinstance(n.child, Exchange) \
                and n.child.kind == "hash" \
                and isinstance(n.child.child, Aggregate) \
                and tuple(n.child.child.keys) == tuple(n.keys) \
                and tuple(n.child.child.names) == tuple(n.names):
            partial_exchanges.add(id(n.child))
    out = []
    for n in topo_nodes(plan):
        if isinstance(n, TopK):
            out.append({"kind": "topk", "path": paths[id(n)]})
        elif isinstance(n, Scan) and getattr(n, "_decode_pages", False):
            # device-decode page-routing stamp: the structure IS the
            # attribute (fingerprint-neutral), but it evidences a planner
            # decision, so the ledger entry must get a census path too
            out.append({"kind": "scan:device_decode", "path": paths[id(n)]})
        elif isinstance(n, Exchange):
            if id(n) in partial_exchanges:
                continue  # owned by the combine Aggregate's split entry
            out.append({"kind": "broadcast" if n.kind == "broadcast"
                        else "shuffle", "path": paths[id(n)]})
        elif isinstance(n, Aggregate):
            if isinstance(n.child, Exchange) \
                    and id(n.child) in partial_exchanges:
                out.append({"kind": "partial_agg", "path": paths[id(n)]})
            elif dist and any(op in ORDER_SENSITIVE_AGGS
                              for _, op in n.aggs):
                out.append({"kind": "order_sensitive_revert",
                            "path": paths[id(n)]})
    return out


def check_partitioning(plan: PlanNode) -> None:
    """Partitioning-consistency check for distributed plans.

    Only meaningful once Exchanges are placed (a plan with none is a plain
    single-device plan and vacuously consistent).  Raises
    ``partitioning-mismatch`` when a Join's two sides are hash-placed on
    different key sets (matching rows could sit on different devices) or an
    Aggregate's child is hash-placed on keys that are not a subset of the
    group keys (a group's rows would be split across devices)."""
    if not any(isinstance(n, Exchange) for n in topo_nodes(plan)):
        return
    paths = node_paths(plan)
    memo: dict = {}
    # an Aggregate feeding an Exchange is a partial by construction (the
    # partial-agg pushdown splits one grouped agg into partial-below /
    # combine-above); its per-device split groups are intended, so the
    # subset check applies only to the combine side
    partial_aggs = {id(n.child) for n in topo_nodes(plan)
                    if isinstance(n, Exchange)}
    for node in topo_nodes(plan):
        if isinstance(node, Join) and node.how != "cross":
            lp = partitioning(node.left, memo)
            rp = partitioning(node.right, memo)
            if rp.kind == "broadcast":
                continue
            if lp.kind == "hash" and rp.kind == "hash" and \
                    not co_partitioned(lp, rp, node.left_keys,
                                       node.right_keys):
                raise PlanVerificationError(
                    "partitioning-mismatch", paths[id(node)],
                    f"join inputs hash-placed on {list(lp.keys)} vs "
                    f"{list(rp.keys)} but joined on "
                    f"{list(node.left_keys)}={list(node.right_keys)}: "
                    f"matching rows may sit on different devices")
        elif isinstance(node, Aggregate) and node.keys \
                and id(node) not in partial_aggs:
            p = partitioning(node.child, memo)
            if p.kind == "hash" and not set(p.keys) <= set(node.keys):
                raise PlanVerificationError(
                    "partitioning-mismatch", paths[id(node)],
                    f"aggregate groups on {list(node.keys)} but its input "
                    f"is hash-placed on {list(p.keys)}: groups would be "
                    f"split across devices")


#: the deliberate host syncs the engine's fused paths may pay, by site
#: label (``metrics.host_sync(label=...)`` at each call site)
SYNC_WHITELIST = (
    "segment-boundary-compaction",  # run_map_segment's survivor count
    "combine-sizing",               # combine_partials' max(ngroups) fetch
    "groupby-compaction",           # _compact_padded's ngroups fetch
    "exchange-counts-sizing",       # hash exchange phase-1 counts fetch
    "exchange-compaction",          # hash exchange live-count fetch
)

#: the deliberate host syncs a ranked run pays beyond ``SYNC_WHITELIST``:
#: ``sync_budget`` leaves them out of its static model (a gather's sizing
#: fetch depends on the ranks' row counts, not on the plan alone), so they
#: stay out of the whitelist the budget and the fuzzer check
RANKS_SYNCS = (
    "ranks-gather-sizing",          # mesh.gather_table's STRING sizing fetch
)


def plan_segments(plan: PlanNode, cfg=None, ndev: Optional[int] = None,
                  resolver: Optional[SchemaResolver] = None) -> list:
    """The fused segments the executor would form for ``plan``: the same
    selection logic as ``_exec``/``_exec_streamed``, run statically.  Each
    entry is ``{"kind": "map"|"agg"|"stream-agg", "segment", "node",
    "path"}``.  Interior chain nodes are consumed by their segment, so the
    walk (parents before children) never double-roots a chain.

    With ``cfg.fuse_exchange`` on a mesh of more than one shard, a
    partial/final aggregate sandwich lowers to a single ``{"kind":
    "fused-stage", "stage": FusedStage, ...}`` entry (the whole distributed
    stage is one device pass; the combine, exchange and partial nodes are
    all consumed by it, and the walk continues below the partial's child,
    where the runtime roots its lower segments).  ``resolver`` feeds the
    static dtype eligibility check; ``ndev`` defaults to the engine's shard
    count (``mesh.default_shards``)."""
    from ..utils.config import config as _config
    from . import segment as sg
    from .executor import _stream_scan_of
    cfg = cfg or _config
    fuse_x = getattr(cfg, "fuse_exchange", False)
    if fuse_x and ndev is None:
        from ..parallel.mesh import default_shards
        ndev = default_shards()
    fuse_x = fuse_x and (ndev or 0) > 1
    if not cfg.fuse and not fuse_x:
        return []
    nparents = sg.parent_counts(plan)
    paths = node_paths(plan)
    out: list = []
    consumed: set = set()
    for node in reversed(topo_nodes(plan)):
        if id(node) in consumed:
            continue
        if fuse_x and isinstance(node, Aggregate):
            stage = sg.fused_sandwich(node)
            if stage is not None \
                    and nparents.get(id(stage.exchange), 1) == 1 \
                    and nparents.get(id(stage.partial), 1) == 1:
                schema = (verify(stage.partial.child, resolver)
                          if resolver is not None else None)
                if sg.fused_static_eligible(stage, schema):
                    for nd in (node, stage.exchange, stage.partial):
                        consumed.add(id(nd))
                    out.append({"kind": "fused-stage", "stage": stage,
                                "node": node, "path": paths[id(node)]})
                    continue
        if not cfg.fuse:
            continue
        if isinstance(node, Aggregate):
            scan = _stream_scan_of(node)
            if scan is not None:
                cand = sg.build_stream_segment(node, scan, nparents,
                                               fuse_join=cfg.fuse_join)
                if cand is not None and cand.input is scan \
                        and sg.worthwhile(cand, streaming=True):
                    for nd in cand.nodes():
                        consumed.add(id(nd))
                    out.append({"kind": "stream-agg", "segment": cand,
                                "node": node, "path": paths[id(node)]})
                continue  # streamed-interpreted: no fused artifact
        if isinstance(node, (Aggregate, Filter, Project)):
            seg = sg.build_segment(node, nparents)
            if seg is not None and sg.worthwhile(seg):
                for nd in seg.nodes():
                    consumed.add(id(nd))
                out.append({"kind": "agg" if seg.agg is not None else "map",
                            "segment": seg, "node": node,
                            "path": paths[id(node)]})
    return out


def _statically_eligible(seg, resolver: SchemaResolver) -> bool:
    """Static shadow of ``runtime_eligible``: a string/nested computed-on
    column makes the executor fall back to the interpreter (the segment
    never runs, no tracked sync).  Unknown dtypes assume eligible."""
    schema = verify(seg.input, resolver)
    if schema is None:
        return True
    used = set(seg.columns_used())
    for j in seg.joins():
        used |= set(j.left_keys)
    for name in used:
        dt = schema.get(name)
        if dt is not None and (dt.is_string or dt.is_nested):
            return False
    return True


def sync_budget(plan: PlanNode, resolver: Optional[SchemaResolver] = None,
                cfg=None, ndev: Optional[int] = None) -> list:
    """Static model of the deliberate host syncs an optimized plan pays on
    the fused paths: one entry per sync, ``site`` naming the whitelisted
    call site.  Mirrors the runtime ``engine.host_sync`` counter: a map
    segment pays one boundary compaction, an agg segment one groupby
    compaction, a streamed agg segment a combine-sizing fetch plus the
    compaction, however many chunks stream through.

    ``ndev`` is the shard count the exchange entries assume (default: the
    engine's, ``mesh.default_shards``; a ranked caller passes
    ``default_shards(ranks)``).  Over ranks each rank pays these syncs
    too: the counts are gathered and the overflows summed on the device
    before the one fetch each makes.  A ranked run also pays what this
    model leaves out: one ``ranks-gather-sizing`` fetch for every gather
    of a table with STRING columns (the gathers engine/placement.py asks
    for and the root's result, ``mesh.gather_table``), and under gloo a
    host round trip for every device collective, since gloo stages a
    CUDA tensor through the host (NCCL's stay on the device).  A
    hash exchange pays its counts fetch
    and its compaction fetch, empty input included.  A ``fused-stage``
    entry charges exactly one ``groupby-compaction`` for the whole
    sandwich (partial + exchange + combine), plus one
    ``exchange-counts-sizing`` when AQE is on and the exchange carries the
    ``_aqe_split`` stamp (the probe always pays its counts fetch before
    picking the fused or the host path).  The overflow and AQE-routed host
    fallbacks are runtime re-plans outside this static model.  One
    upper-bound case remains: an agg segment whose input turns out empty
    at run time falls back to the interpreted groupby and pays no sync
    where this model charges one.
    """
    from ..utils.config import config as _config
    resolver = resolver or SchemaResolver()
    entries: list = []
    fused_exchanges: set = set()
    for s in plan_segments(plan, cfg, ndev=ndev, resolver=resolver):
        if s["kind"] == "fused-stage":
            stage, path = s["stage"], s["path"]
            fused_exchanges.add(id(stage.exchange))
            aqe = getattr(cfg or _config, "aqe", False)
            if aqe and getattr(stage.exchange, "_aqe_split", False):
                entries.append({"site": "exchange-counts-sizing",
                                "path": path, "count": 1})
            entries.append({"site": "groupby-compaction", "path": path,
                            "count": 1})
            continue
        seg, path = s["segment"], s["path"]
        if not _statically_eligible(seg, resolver):
            entries.append({"site": "interpreted-fallback", "path": path,
                            "count": 0})
            continue
        if s["kind"] == "map":
            entries.append({"site": "segment-boundary-compaction",
                            "path": path, "count": 1})
        elif s["kind"] == "agg":
            entries.append({"site": "groupby-compaction", "path": path,
                            "count": 1})
        else:  # stream-agg
            entries.append({"site": "combine-sizing", "path": path,
                            "count": 1})
            entries.append({"site": "groupby-compaction", "path": path,
                            "count": 1})
    # hash exchanges pay one counts-sizing fetch and one compaction fetch
    # each; a broadcast is a replica and pays none.  On one shard the
    # exchange is the identity and skips both.  An exchange lowered into a
    # fused stage is charged by its fused-stage entry above, never here.
    if ndev is None:
        from ..parallel.mesh import default_shards
        ndev = default_shards()
    if ndev > 1:
        paths = node_paths(plan)
        for n in topo_nodes(plan):
            if isinstance(n, Exchange) and n.kind == "hash" \
                    and id(n) not in fused_exchanges:
                entries.append({"site": "exchange-counts-sizing",
                                "path": paths[id(n)], "count": 1})
                entries.append({"site": "exchange-compaction",
                                "path": paths[id(n)], "count": 1})
    return entries


def check_sync_budget(plans, cfg=None, ndev: Optional[int] = None) -> tuple:
    """``(entries, violations)`` over a set of optimized plans: every
    entry with a nonzero count must name a whitelisted sync site."""
    entries: list = []
    for p in plans:
        entries += sync_budget(p, cfg=cfg, ndev=ndev)
    bad = [e for e in entries
           if e["count"] and e["site"] not in SYNC_WHITELIST]
    return entries, bad
