"""The port's plan layer against the JAX package's, on the CPU.

- Serialization: a JAX plan crosses into the port as bytes and back, with
  the same canonical bytes and fingerprint both ways.
- ``verify``: the bad and good plans of tests/test_engine_verify.py's
  check matrix and the verify cases of tests/test_fuzz.py give the same
  ``PlanVerificationError`` code and node path in both packages, and the
  good plans the same schema.
- ``infer_nullability`` and ``RewriteChecker`` agree with JAX.
- The optimizer's rewrites (TopK fusion, filter pushdown, scan predicates,
  projection pruning, exchange elimination) give byte-identical plans.
"""

import importlib

import numpy as np
import pytest

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import plan as jplan
from spark_rapids_jni_tpu_torch import engine as pe
from test_engine_e2e import q5_plan, warehouse  # noqa: F401
from test_engine_verify import _CHECK_MATRIX, files  # noqa: F401
from test_fuzz import tiny  # noqa: F401

# the packages' ``engine.verify`` attribute is the function; the modules:
jv = importlib.import_module("spark_rapids_jni_tpu.engine.verify")
pv = importlib.import_module("spark_rapids_jni_tpu_torch.engine.verify")
col, lit = je.col, je.lit


def to_port(plan):
    return pe.deserialize(plan.serialize())


def schema_key(schema):
    """A verified schema as comparable data: names and dtype ids/scales."""
    if schema is None:
        return None
    return [(name, None if dt is None else (dt.id.name, dt.scale))
            for name, dt in schema.items()]


def verify_both(plan):
    """(outcome in JAX, outcome in the port): the schema, or the error's
    (code, node_path)."""
    out = []
    for verify, err, p in ((jv.verify, jv.PlanVerificationError, plan),
                           (pv.verify, pv.PlanVerificationError,
                            to_port(plan))):
        try:
            out.append(("ok", schema_key(verify(p))))
        except err as e:
            out.append(("error", e.code, e.node_path))
    return out


def plan_corpus(root):
    """Plans over the q5 warehouse that exercise every node type."""
    sales = je.Scan(root / "store_sales.parquet", chunk_bytes=96_000)
    store = je.Scan(root / "store.parquet")
    return {
        "q5": q5_plan(root),
        "topk": je.Limit(je.Sort(je.Project(store, ("s_store_sk",)),
                                 (("s_store_sk", False),)), 3),
        "exchange": je.Aggregate(
            jplan.Exchange(sales, ("ss_store_sk",), "hash"), ("ss_store_sk",),
            (("ss_net_profit", "sum"),), ("p",)),
        "nested_exchange": je.Sort(
            jplan.Exchange(jplan.Exchange(store, kind="broadcast"),
                        ("s_store_sk",)), (("s_store_sk", True),)),
        "cross_not": je.Filter(
            je.Join(store, je.Scan(root / "date_dim.parquet"), (), (),
                    "cross"),
            ("not", ("|", ("==", col("s_store_name"), lit("ese")),
                     (">", col("d_month_seq"), lit(3))))),
        "outer": je.Join(sales, store, ("ss_store_sk",), ("s_store_sk",),
                         "full"),
    }


@pytest.mark.parametrize("name", ["q5", "topk", "exchange",
                                  "nested_exchange", "cross_not", "outer"])
def test_serialization_crosses_both_ways(warehouse, name):  # noqa: F811
    plan = plan_corpus(warehouse[0])[name]
    blob = plan.serialize()
    port = pe.deserialize(blob)
    assert port.serialize() == blob
    assert port.fingerprint() == plan.fingerprint()
    back = je.deserialize(port.serialize())
    assert back.serialize() == blob


@pytest.mark.parametrize("name", ["q5", "topk", "exchange",
                                  "nested_exchange", "cross_not", "outer"])
def test_optimize_matches_jax(warehouse, name):  # noqa: F811
    plan = plan_corpus(warehouse[0])[name]
    jopt = je.optimize(plan)
    popt = pe.optimize(to_port(plan))
    assert popt.serialize() == jopt.serialize()
    assert popt._decisions == jopt._decisions
    assert [n._est_rows for n in pe.plan.topo_nodes(popt)] == \
        [n._est_rows for n in je.plan.topo_nodes(jopt)]
    assert pv.decision_census(popt) == jv.decision_census(jopt)
    assert pv.plan_exchanges(popt) == jv.plan_exchanges(jopt)


@pytest.mark.parametrize("code,bad,good", _CHECK_MATRIX,
                         ids=[f"{c}-{i}" for i, (c, _, _)
                              in enumerate(_CHECK_MATRIX)])
def test_check_matrix_matches_jax(files, code, bad, good):  # noqa: F811
    f, d = files / "fact.parquet", files / "dim.parquet"
    jout, pout = verify_both(bad(f, d))
    assert pout == jout
    assert pout[0] == "error" and pout[1] == code
    assert pout[2].startswith("root")
    jgood, pgood = verify_both(good(f, d))
    assert pgood == jgood and pgood[0] == "ok" and pgood[1] is not None


def test_error_structure_and_node_path(files):  # noqa: F811
    deep = je.Limit(je.Filter(je.Scan(files / "fact.parquet"),
                              (">", col("nope"), lit(0))), 5)
    with pytest.raises(pv.PlanVerificationError) as ei:
        pv.verify(to_port(deep))
    e = ei.value
    assert (e.code, e.node_path) == ("unknown-column", "root.child")
    back = pv.PlanVerificationError.from_dict(e.to_dict())
    assert (back.code, back.node_path, back.message) == \
        (e.code, e.node_path, e.message)
    with pytest.raises(pv.PlanVerificationError) as ei:
        pe.optimize(to_port(deep))
    assert ei.value.code == "unknown-column"


def _fuzz_cases(t):
    """The verify cases of tests/test_fuzz.py over its ``tiny`` file."""
    scan = je.Scan(t)
    return [
        je.Aggregate(jplan.Exchange(scan, ("k",), "hash"), ("k",),
                     (("v", "first"),), ("f",)),
        je.Aggregate(jplan.Exchange(scan, ("k",), "hash"), ("k",),
                     (("v", "sum"),), ("sv",)),
        je.Filter(scan, (">", col("i"), lit(2 ** 40))),
        je.Filter(scan, ("<", col("v"), lit(2 ** 54))),
        je.Filter(scan, (">", col("i"), lit(1000))),
        je.Filter(scan, ("<", col("s"), lit("m"))),
        je.Filter(scan, ("==", col("s"), lit("m"))),
        je.Filter(scan, ("==", col("s"), col("s2"))),
        je.Join(scan, scan, ("k",), ("k",), how="left"),
        je.Aggregate(scan, ("k",), (("s", "count"),), ("n",)),
        je.Scan("/nonexistent/q.parquet"),
    ]


@pytest.mark.parametrize("i", range(11))
def test_fuzz_verify_cases_match_jax(tiny, i):  # noqa: F811
    plan = _fuzz_cases(tiny)[i]
    jout, pout = verify_both(plan)
    assert pout == jout
    if jout[0] == "ok":
        assert pv.infer_nullability(to_port(plan)) == \
            jv.infer_nullability(plan)


def test_nullability_lattice(tiny):  # noqa: F811
    nulls = pv.infer_nullability(pe.Scan(tiny))
    assert nulls["k"] == pv.NULL_NEVER and nulls["s"] == pv.NULL_MAYBE
    f = pe.Filter(pe.Scan(tiny), ("==", col("s"), lit("ash")))
    assert pv.infer_nullability(f)["s"] == pv.NULL_NEVER
    jn = pv.infer_nullability(pe.Join(pe.Scan(tiny), pe.Scan(tiny), ("k",),
                                      ("k",), how="left"))
    assert (jn["v"], jn["v_r"]) == (pv.NULL_NEVER, pv.NULL_MAYBE)


def test_rewrite_checker_matches_jax(tiny):  # noqa: F811
    base = je.Filter(je.Scan(tiny), ("==", col("s"), lit("ash")))
    codes = []
    for mod, b, dropped in ((jv, base, je.Scan(tiny)),
                            (pv, to_port(base), pe.Scan(tiny))):
        rc = mod.RewriteChecker(b)
        rc.check("noop", b)
        with pytest.raises(mod.PlanVerificationError) as ei:
            rc.check("drop-filter", dropped)
        codes.append((ei.value.code, ei.value.node_path, ei.value.message))
    assert codes[1] == codes[0]
    assert codes[1][0] == "rewrite-nullability-change"


def test_broken_rewrite_rule_is_caught(files, monkeypatch):  # noqa: F811
    from spark_rapids_jni_tpu_torch.engine import optimizer
    plan = pe.Filter(pe.Scan(files / "fact.parquet"),
                     (">", col("f_key"), lit(3)))
    monkeypatch.setattr(
        optimizer, "_push_filters",
        lambda node, schema, memo: pe.Project(node, ("f_key",)))
    with pytest.raises(pv.PlanVerificationError) as ei:
        pe.optimize(plan)
    assert ei.value.code == "rewrite-schema-change"
    assert "push_filters" in ei.value.message


def test_string_literal_plan_round_trip():
    """Literals of every kind survive the JSON form unchanged."""
    for v in (0, -7, 2 ** 40, 1.25, -0.5, True, "ash", None):
        plan = je.Filter(je.Scan("/x.parquet"), ("==", col("c"), lit(v)))
        port = to_port(plan)
        assert port.predicate == plan.predicate
        assert isinstance(port.predicate[2][1], type(v))


def test_q5_plan_nodes_carry_estimates(warehouse):  # noqa: F811
    popt = pe.optimize(to_port(q5_plan(warehouse[0])))
    ests = {type(n).__name__: n._est_rows
            for n in pe.plan.topo_nodes(popt)}
    assert ests["Scan"] is not None
    assert np.all([hasattr(n, "_est_rows")
                   for n in pe.plan.topo_nodes(popt)])


def test_check_partitioning_matches_jax(files):  # noqa: F811
    f, d = files / "fact.parquet", files / "dim.parquet"
    x = jplan.Exchange
    mismatched = je.Join(x(je.Scan(f), ("f_key",)), x(je.Scan(d), ("d_name",)),
                         ("f_key",), ("d_key",))
    split = je.Aggregate(x(je.Scan(f), ("f_key",)), ("f_store",),
                         (("f_price", "sum"),), ("s",))
    aligned = je.Aggregate(x(je.Scan(f), ("f_store",)), ("f_store",),
                           (("f_price", "sum"),), ("s",))
    for plan, want in ((mismatched, "partitioning-mismatch"),
                       (split, "partitioning-mismatch"), (aligned, None)):
        got = []
        for mod, p in ((jv, plan), (pv, to_port(plan))):
            try:
                mod.check_partitioning(p)
                got.append(None)
            except mod.PlanVerificationError as e:
                got.append((e.code, e.node_path))
        assert got[1] == got[0]
        assert (got[1] and got[1][0]) == want
