"""The plan-space fuzzer's corpus through the port, against the JAX package.

One seeded warehouse (``engine/fuzz.py::gen_warehouse``, rng [7, 0]) and
16 generated plans (``gen_plan``, rng [7, i] for i = 1..16, as
``fuzz.run_corpus`` draws them): plans 1-8 here, 9-16 in
tests/test_torch_engine_fuzz2.py (the JAX side's compiles take most of a
file's time, and tier-1 splits by file).  Each plan crosses into the port as
bytes and runs under the fuzzer's ``interp`` and ``fused`` variants, the
port with ``device="cpu"``.  In each variant the optimized plans serialize
identically with the same decision ledger, the port's structural ledger
equals its ``decision_census``, its executed exchange count equals
``plan_exchanges``, and its result equals JAX's exactly (the warehouse's
floats are quarter-valued, so every sum is exact in any order) and the
pandas oracle within the fuzzer's own rel 1e-9.  No plan is skipped: a path
the port has not ported raises, and that fails the test.
"""

import contextlib
import importlib

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import fuzz
from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.utils.config import config as pconfig

pv = importlib.import_module("spark_rapids_jni_tpu_torch.engine.verify")
torch.set_num_threads(1)
VARIANTS = fuzz.VARIANTS[:2]  # interp, fused: the single-device variants
assert [v["name"] for v in VARIANTS] == ["interp", "fused"]


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = tmp_path_factory.mktemp("fuzz_wh")
    return fuzz.gen_warehouse(root, np.random.default_rng([7, 0]))


@contextlib.contextmanager
def port_flags(**kw):
    saved = {k: getattr(pconfig, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(pconfig, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(pconfig, k, v)


def frame(table) -> pd.DataFrame:
    """A result as a DataFrame, nulls as NaN (either package's Table)."""
    names = table.names or [f"c{i}" for i in range(table.num_columns)]
    cols = {}
    for n, c in zip(names, table.columns):
        vals = c.to_pylist()
        if c.dtype.is_string:
            cols[n] = np.array(vals, dtype=object)
        else:
            cols[n] = np.array([np.nan if v is None else v for v in vals])
    return pd.DataFrame(cols)


def structural_ledger(opt) -> list:
    return sorted((d["kind"], d.get("path"))
                  for d in getattr(opt, "_decisions", ())
                  if d["kind"] in fuzz._STRUCTURAL_KINDS)


def check_case(catalog, case: int):
    plan = fuzz.gen_plan(np.random.default_rng([7, case]), catalog)
    manual = fuzz.has_manual_structure(plan)
    ref = fuzz.oracle(plan, catalog)
    for v in VARIANTS:
        flags = {k: val for k, val in v.items() if k != "name"}
        with fuzz._flags(verify=True, **flags):
            jopt = je.optimize(plan, distribute=False)
            jres = frame(je.execute(jopt))
        with port_flags(verify=True, fuse=flags["fuse"]):
            popt = pe.optimize(pe.deserialize(plan.serialize()))
            assert popt.serialize() == jopt.serialize(), v["name"]
            assert popt._decisions == jopt._decisions, v["name"]
            pv.verify(popt)
            if not manual:
                assert structural_ledger(popt) == sorted(
                    (c["kind"], c["path"])
                    for c in pv.decision_census(popt, dist=False))
            stats = pe.new_stats()
            pres = frame(pe.execute(popt, stats, device="cpu"))
        assert stats["exchanges"] == len(pv.plan_exchanges(popt))
        assert fuzz._frames_match(pres, jres, exact=True) is None, v["name"]
        assert fuzz._frames_match(pres, ref, exact=False) is None, v["name"]


@pytest.mark.parametrize("case", range(1, 9))
def test_fuzz_plan_matches_jax_and_oracle(catalog, case):
    check_case(catalog, case)
