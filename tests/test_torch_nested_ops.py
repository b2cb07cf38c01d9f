"""STRUCT and LIST columns through ``ops/selection.py`` and the engine: the
port against the JAX package on the CPU.

- ``gather_column`` of a STRUCT (fields of every kind, nulls at both
  levels, out-of-bounds and invalid gather rows: cudf NULLIFY);
- ``concat_tables``, ``distinct(subset=...)``, ``slice_table`` and
  ``apply_boolean_mask`` over tables that carry STRUCT and LIST payload
  columns;
- the engine: a Parquet scan with a STRUCT and a LIST, a filter on a
  scalar key and a projection, by the host and the device route, fused
  and interpreted; a comparison over a nested column is refused by plan
  verification in both packages.

Every result is held bit for bit at every nesting level.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.engine.plan import Filter, Project, Scan, col, lit
from spark_rapids_jni_tpu.ops import selection as jsel
from spark_rapids_jni_tpu.utils import config as jconfig_mod

from spark_rapids_jni_tpu_torch import dtypes as pdt
from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import selection as psel
from spark_rapids_jni_tpu_torch.utils.config import config as pconfig

from test_torch_parquet_nested import same_column, same_table

torch.set_num_threads(1)
CPU = "cpu"


def nested_tables(n, seed):
    """(JAX, port) tables: an INT64 key, a STRUCT<INT64, STRING,
    LIST<INT32>> with nulls at both levels, a LIST<STRING>."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 7, n)
    kvalid = rng.random(n) > 0.1
    sv = rng.random(n) > 0.2
    ids = rng.integers(-10**9, 10**9, n)
    idv = rng.random(n) > 0.15
    names = [None if i % 5 == 0 else f"nm{i % 13}" for i in range(n)]
    inner = [None if i % 6 == 0 else list(range(i % 4)) for i in range(n)]
    tags = [None if i % 8 == 0 else [f"t{j}" for j in range(i % 3)]
            for i in range(n)]
    jt = JTable([
        JColumn.from_numpy(key, validity=kvalid),
        JColumn(jdt.DType(jdt.TypeId.STRUCT), validity=jnp.asarray(sv),
                children=(JColumn.from_numpy(ids, validity=idv),
                          JColumn.from_pylist(names),
                          JColumn.from_pylist(inner))),
        JColumn.from_pylist(tags)], ["k", "st", "tags"])
    pt = Table([
        Column.from_numpy(key, validity=kvalid, device=CPU),
        Column(pdt.STRUCT, validity=torch.from_numpy(sv),
               children=(Column.from_numpy(ids, validity=idv, device=CPU),
                         Column.from_pylist(names, device=CPU),
                         Column.from_pylist(inner, device=CPU))),
        Column.from_pylist(tags, device=CPU)], ["k", "st", "tags"])
    return jt, pt


def test_struct_gather_nullify():
    jt, pt = nested_tables(300, 1)
    idx = np.array([5, -1, 0, 299, 300, 17, 17, 120, 2], np.int64)
    ivalid = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1], np.bool_)
    same_column(jsel.gather_column(jt["st"], jnp.asarray(idx)),
                psel.gather_column(pt["st"], torch.from_numpy(idx)))
    same_column(jsel.gather_column(jt["st"], jnp.asarray(idx),
                                   jnp.asarray(ivalid)),
                psel.gather_column(pt["st"], torch.from_numpy(idx),
                                   torch.from_numpy(ivalid)))
    got = psel.gather_column(pt["st"], torch.from_numpy(idx)).to_pylist()
    assert got[1] is None and got[4] is None
    assert got == jsel.gather_column(jt["st"],
                                     jnp.asarray(idx)).to_pylist()


def test_concat_distinct_slice_mask_with_nested_payload():
    ja, pa_ = nested_tables(200, 2)
    jb, pb = nested_tables(150, 3)
    jc = jsel.concat_tables([ja, jb])
    pc = psel.concat_tables([pa_, pb])
    same_table(jc, pc)
    same_table(jsel.distinct(jc, subset=["k"]),
               psel.distinct(pc, subset=["k"]))
    same_table(jsel.slice_table(jc, 180, 40), psel.slice_table(pc, 180, 40))
    mask = np.random.default_rng(4).random(350) > 0.5
    same_table(jsel.apply_boolean_mask(jc, jnp.asarray(mask)),
               psel.apply_boolean_mask(pc, torch.from_numpy(mask)))


@contextlib.contextmanager
def flags(**kw):
    jc = jconfig_mod.config
    saved = [(c, k, getattr(c, k)) for c in (jc, pconfig) for k in kw]
    try:
        for c in (jc, pconfig):
            for k, v in kw.items():
                setattr(c, k, v)
        yield
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


@pytest.fixture(scope="module")
def nested_file(tmp_path_factory):
    n = 6_000
    rng = np.random.default_rng(9)
    sv = rng.random(n) > 0.1
    lens = rng.integers(0, 6, n)
    flat = rng.integers(-99, 99, int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    lists = [flat[offs[i]:offs[i + 1]].tolist() if rng.random() > 0.05
             else None for i in range(n)]
    t = pa.table({
        "k": pa.array(rng.integers(0, 1000, n), mask=rng.random(n) < 0.05),
        "v": pa.array(rng.standard_normal(n)),
        "st": pa.StructArray.from_arrays(
            [pa.array(rng.integers(0, 10**6, n), mask=rng.random(n) < 0.1),
             pa.array([f"n{i % 29}" for i in range(n)]),
             pa.array(rng.standard_normal(n))],
            ["id", "name", "price"], mask=pa.array(~sv)),
        "l": pa.array(lists, pa.list_(pa.int32())),
    })
    p = tmp_path_factory.mktemp("nested") / "fact.parquet"
    pq.write_table(t, p, row_group_size=1_500, use_dictionary=False)
    return p


@pytest.mark.parametrize("device_decode", [False, True])
@pytest.mark.parametrize("fused", [None, False])
def test_engine_scan_filter_project_nested(nested_file, device_decode,
                                           fused):
    """A nested payload column rides a scan, a filter on the scalar key
    and a projection, equal to the JAX engine's result."""
    plan = Project(Filter(Scan(nested_file, chunk_bytes=40_000),
                          ("<", col("k"), lit(300))), ["k", "st", "l"])
    with flags(device_decode=device_decode):
        jt = je.execute(je.optimize(plan), fused=fused)
        pt = pe.execute(pe.optimize(pe.deserialize(plan.serialize())),
                        fused=fused, device=CPU)
    assert pt.num_rows > 1000
    same_table(jt, pt)


def test_engine_refuses_comparison_over_nested(nested_file):
    plan = Filter(Scan(nested_file), ("==", col("st"), lit(1)))
    with pytest.raises(je.PlanVerificationError, match="nested"):
        je.optimize(plan)
    with pytest.raises(pe.PlanVerificationError, match="nested"):
        pe.optimize(pe.deserialize(plan.serialize()))
