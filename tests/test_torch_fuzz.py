"""The port's plan-space fuzzer (spark_rapids_jni_tpu_torch/engine/fuzz.py)
against the JAX package's (spark_rapids_jni_tpu/engine/fuzz.py).

- ``gen_warehouse`` draws the same rows: for rng [7, 0] and three more
  seeds each table equals the JAX package's frame column for column, read
  back by the port's reader and by pyarrow, with the same row-group count;
- ``gen_plan`` for rng [7, i], i = 1..64, serializes to the JAX package's
  bytes, and the numpy oracle equals the pandas oracle on each plan, row
  for row and exactly;
- ``run_corpus`` on the CPU gives zero violations, and a sabotaged rule is
  caught under the JAX package's check name and shrunk; a plan the oracle
  refuses (the JAX package's fault, kept) is skipped, not a crash;
- the new modules import on a host without pandas and pyarrow.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu.engine import fuzz as jfuzz
from spark_rapids_jni_tpu_torch.engine import fuzz, optimizer
from spark_rapids_jni_tpu_torch.engine.plan import Filter, topo_nodes
from spark_rapids_jni_tpu_torch.io import read_parquet

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TABLES = ("fact", "dimfull", "dimpart", "dimstr")


def df_frame(df) -> fuzz.Frame:
    """A pandas frame as the port's Frame (strings as objects)."""
    cols = []
    for c in df.columns:
        a = df[c].to_numpy()
        cols.append(a.astype(object) if a.dtype.kind in "OUT" or
                    str(df[c].dtype) in ("str", "string") else a)
    return fuzz.Frame([str(c) for c in df.columns], cols)


def same_rows(a: fuzz.Frame, b: fuzz.Frame) -> None:
    """Equal names, row order and values (nulls equal nulls)."""
    assert a.names == b.names
    assert len(a) == len(b)
    for name, x, y in zip(a.names, a.cols, b.cols):
        assert fuzz._first_mismatch(np.asarray(x), np.asarray(y),
                                    exact=True) is None, name


@pytest.mark.parametrize("seed", [7, 1, 42, 20260805])
def test_warehouse_matches_jax(tmp_path, seed):
    jcat = jfuzz.gen_warehouse(tmp_path / "jax",
                               np.random.default_rng([seed, 0]))
    pcat = fuzz.gen_warehouse(tmp_path / "port",
                              np.random.default_rng([seed, 0]))
    for name in TABLES:
        want = df_frame(jcat[name]["df"])
        same_rows(pcat[name]["frame"], want)
        path = pcat[name]["path"]
        back = fuzz._as_frame(read_parquet(path, device="cpu"))
        same_rows(back, want)
        same_rows(df_frame(pq.read_table(path).to_pandas()), want)
        assert pq.ParquetFile(path).num_row_groups == \
            pq.ParquetFile(jcat[name]["path"]).num_row_groups
        assert pq.ParquetFile(path).metadata.row_group(0).num_rows == \
            min(len(want), max(8, len(want) // 4))


@pytest.fixture(scope="module")
def jcat(tmp_path_factory):
    return jfuzz.gen_warehouse(tmp_path_factory.mktemp("fz"),
                               np.random.default_rng([7, 0]))


@pytest.fixture(scope="module")
def pcat(jcat):
    """The port's catalog over the JAX package's files (the same paths, so
    plans serialize alike), with the port's in-memory columns."""
    return {name: {"path": e["path"], "frame": df_frame(e["df"])}
            for name, e in jcat.items()}


@pytest.mark.parametrize("case", range(1, 65))
def test_plan_bytes_and_oracle_match_jax(jcat, pcat, case):
    jplan = jfuzz.gen_plan(np.random.default_rng([7, case]), jcat)
    pplan = fuzz.gen_plan(np.random.default_rng([7, case]), pcat)
    assert pplan.serialize() == jplan.serialize()
    assert fuzz.has_manual_structure(pplan) == \
        jfuzz.has_manual_structure(jplan)
    try:
        want = df_frame(jfuzz.oracle(jplan, jcat))
    except Exception as e:  # the pandas oracle's own refusal
        with pytest.raises(type(e)):
            fuzz.oracle(pplan, pcat)
        return
    same_rows(fuzz.oracle(pplan, pcat), want)


def test_oracle_covers_every_node_type():
    from spark_rapids_jni_tpu_torch.engine import plan
    assert set(fuzz._ORACLE) == set(plan._NODE_TYPES.values())
    assert [v["name"] for v in fuzz.VARIANTS] == \
        [v["name"] for v in jfuzz.VARIANTS]
    assert [v["name"] for v in fuzz.FULL_VARIANTS] == \
        [v["name"] for v in jfuzz.FULL_VARIANTS]
    for pv, jv in zip(fuzz.FULL_VARIANTS, jfuzz.FULL_VARIANTS):
        extra = {k: v for k, v in pv.items() if k not in jv}
        assert {k: pv[k] for k in jv} == jv
        assert extra == ({"shards": 8} if jv.get("distribute") else {})


def test_frames_match_multiset_and_tolerance():
    a = fuzz.Frame(["k", "v"], [np.array([1, 2]), np.array([0.5, 1.0])])
    b = fuzz.Frame(["k", "v"], [np.array([2, 1]), np.array([1.0, 0.5])])
    assert fuzz._frames_match(a, b, exact=True) is None
    c = fuzz.Frame(["k", "v"], [np.array([2, 1]),
                                np.array([1.0 + 1e-12, 0.5])])
    assert fuzz._frames_match(a, c, exact=True) is not None
    assert fuzz._frames_match(a, c, exact=False) is None
    assert "column order" in fuzz._frames_match(
        a, fuzz.Frame(["v", "k"], b.cols[::-1]), exact=True)
    assert "row count" in fuzz._frames_match(a, a.take([0]), exact=True)


def test_run_corpus_clean_on_cpu(tmp_path):
    seen = []
    rep = fuzz.run_corpus(20260805, 6, tmp_path, variants=fuzz.VARIANTS[:2],
                          device="cpu",
                          on_case=lambda i, p, r: seen.append(len(r)))
    assert rep["failures"] == [], rep["failures"]
    assert rep["cases"] == 6 and seen == [2] * 6


def _negate_first_filter(opt):
    for n in topo_nodes(opt):
        if isinstance(n, Filter):
            return fuzz._replace(opt, n,
                                 Filter(n.child, ("not", n.predicate)))
    return opt


def test_sabotaged_rule_caught_and_shrunk(tmp_path):
    """tests/test_fuzz.py::test_broken_rule_caught_and_shrunk on the port:
    a predicate negation after the optimizer sails through verify() and
    must surface as ``oracle-parity``, shrunk to (near) Scan + Filter."""
    def sabotaged(plan, distribute=False):
        return _negate_first_filter(
            optimizer.optimize(plan, distribute=distribute))

    rep = fuzz.run_corpus(99, 3, tmp_path, variants=fuzz.VARIANTS[:2],
                          optimize_fn=sabotaged, device="cpu")
    assert rep["failures"], "sabotaged optimizer escaped the harness"
    for f in rep["failures"]:
        assert f["minimal_nodes"] <= f["plan_nodes"]
        assert f["minimal_plan"]["nodes"]
    parity = [f for f in rep["failures"] if f["check"] == "oracle-parity"]
    assert parity, "predicate negation must surface as an oracle mismatch"
    assert min(f["minimal_nodes"] for f in parity) <= 3


NO_PANDAS = """
import sys
sys.modules.update({"pandas": None, "pyarrow": None})
import tempfile
from pathlib import Path
import numpy as np
from spark_rapids_jni_tpu_torch.engine import fuzz
from spark_rapids_jni_tpu_torch.tools import (chaos_soak, srjt_blackbox,
    srjt_export, srjt_fuzz, srjt_profile, trace_join_check)
with tempfile.TemporaryDirectory() as d:
    cat = fuzz.gen_warehouse(Path(d), np.random.default_rng([7, 0]))
    plan = fuzz.gen_plan(np.random.default_rng([7, 1]), cat)
    print(len(fuzz.oracle(plan, cat)) >= 0, "jax" in sys.modules)
"""


def test_modules_import_without_pandas_and_pyarrow():
    r = subprocess.run([sys.executable, "-c", NO_PANDAS], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["True", "False"]


def test_double_cross_join_refused_like_jax(tmp_path):
    """A fault of the JAX package, kept: seed 7's case 234 joins dimpart
    twice by cross join, pandas names the two ``dk2`` columns ``dk2_x``
    and ``dk2_y``, and the oracle's next stage raises ``KeyError``.  The
    port's generator gives the same plan and its oracle the same
    refusal."""
    jcat = jfuzz.gen_warehouse(tmp_path, np.random.default_rng([7, 0]))
    pcat = {name: {"path": e["path"], "frame": df_frame(e["df"])}
            for name, e in jcat.items()}
    jplan = jfuzz.gen_plan(np.random.default_rng([7, 235]), jcat)
    pplan = fuzz.gen_plan(np.random.default_rng([7, 235]), pcat)
    assert pplan.serialize() == jplan.serialize()
    assert sum(isinstance(n, jfuzz.Join) and n.how == "cross"
               for n in topo_nodes(jplan)) == 2
    with pytest.raises(KeyError):
        jfuzz.oracle(jplan, jcat)
    with pytest.raises(KeyError, match="dk2"):
        fuzz.oracle(pplan, pcat)


def test_corpus_skips_a_plan_the_oracle_refuses(tmp_path):
    """The JAX package's corpus stops at that plan with the oracle's
    KeyError; the port's records it as skipped and goes on to the next."""
    rep = fuzz.run_corpus(7, 2, tmp_path, variants=fuzz.VARIANTS[:1],
                          device="cpu", first=234)
    assert rep["failures"] == []
    assert [(s["case"], "dk2" in s["reason"]) for s in rep["skipped"]] \
        == [(234, True)]
    cat = fuzz.gen_warehouse(tmp_path / "w", np.random.default_rng([7, 0]))
    plan = fuzz.gen_plan(np.random.default_rng([7, 235]), cat)
    with pytest.raises(fuzz.OracleRefusal, match="dk2"):
        fuzz.run_case(plan, cat, fuzz.VARIANTS[:1], device="cpu")
