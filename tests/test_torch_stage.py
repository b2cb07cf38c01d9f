"""The whole stage at a small size: RowToColumnar -> partial HashAggregate ->
HashPartitioning -> ColumnarToRow, through the torch port on the CPU and
through the JAX package, step by step.

The input has the stage's schema (bench.py build_host_table, as
chip_smoke.py drives it on the card), made with numpy from a fixed seed;
the port runs with ``device="cpu"``.  Tolerance: bit-exact at every step.
The float columns are quarter-valued (k/4) so the float mean's sums are
exact in float64 and the two packages' summation orders cannot differ.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import hash as jhash
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar.interop import (
    HostColumn, table_from_numpy, table_to_numpy)
from spark_rapids_jni_tpu_torch.kernels import row_wire
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import hash as phash
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.utils import tracing

torch.set_num_threads(1)
CPU = "cpu"
AGGS = [("i64", "sum"), ("i64", "count"), ("f64", "min"), ("f64", "max"),
        ("f32", "mean"), ("i16", "count")]
PARTITIONS = 200  # spark.sql.shuffle.partitions default


def stage_input(n, nkeys, seed):
    rng = np.random.default_rng(seed)
    cols = [
        (jdt.INT64, rng.integers(-2**62, 2**62, n).astype(np.int64), None),
        (jdt.FLOAT64, rng.integers(-4000, 4000, n) / 4.0,
         rng.random(n) > 0.1),
        (jdt.INT32, rng.integers(0, nkeys, n).astype(np.int32), None),
        (jdt.FLOAT32, (rng.integers(-4000, 4000, n) / 4.0)
         .astype(np.float32), None),
        (jdt.INT16, rng.integers(-2**15, 2**15 - 1, n).astype(np.int16),
         rng.random(n) > 0.5),
        (jdt.INT8, rng.integers(-128, 128, n).astype(np.int8), None),
        (jdt.BOOL8, rng.integers(0, 2, n).astype(np.uint8), None),
        (jdt.decimal64(-4), rng.integers(-10**15, 10**15, n)
         .astype(np.int64), None),
    ]
    return JTable([JColumn.fixed(d, v, validity=m) for d, v, m in cols],
                  ["i64", "f64", "i32", "f32", "i16", "i8", "bool", "dec64"])


def host_cols(table):
    return [HostColumn.of(c) for c in table.columns]


def assert_same_bits(jcols, pcols):
    for jc, pc in zip(jcols, pcols):
        assert (jc.type_id, jc.scale) == (pc.type_id, pc.scale)
        assert (jc.validity is None) == (pc.validity is None)
        if jc.validity is not None:
            np.testing.assert_array_equal(jc.validity, pc.validity)
        np.testing.assert_array_equal(
            np.ascontiguousarray(jc.data).view(np.uint8),
            np.ascontiguousarray(pc.data).view(np.uint8))


def assert_blobs_equal(jblobs, pblobs):
    assert len(jblobs) == len(pblobs)
    for jb, pb in zip(jblobs, pblobs):
        np.testing.assert_array_equal(np.asarray(jb.offsets),
                                      pb.offsets.numpy())
        np.testing.assert_array_equal(
            np.asarray(jb.children[0].data).view(np.uint8),
            pb.children[0].bytes_numpy())


@pytest.mark.parametrize("n,nkeys", [(1000, 60), (77, 9)])
def test_stage_matches_jax(n, nkeys):
    jt = stage_input(n, nkeys, seed=n)
    pt = table_from_numpy(host_cols(jt), jt.names, device=CPU)
    tracing.reset_counters("kernel.")

    # 1. ColumnarToRow of the incoming batch, and RowToColumnar back
    jblobs = jrc.convert_to_rows(jt)
    pblobs = prc.convert_to_rows(pt, device=CPU)
    assert_blobs_equal(jblobs, pblobs)
    back = prc.convert_from_rows(pblobs[0], pt.dtypes(), device=CPU)
    for a, b in zip(pt.columns, back.columns):
        assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))
        assert torch.equal(a.valid_mask(), b.valid_mask())

    # 2. partial HashAggregate
    jagged = jagg.groupby(jt, ["i32"], AGGS)
    pagged = pagg.groupby(Table(back.columns, pt.names), ["i32"], AGGS,
                          device=CPU)
    assert_same_bits(host_cols(jagged), table_to_numpy(pagged))

    # 3. HashPartitioning: Spark's pmod(murmur3(key, 42), partitions)
    jh = np.asarray(jhash.murmur3_hash(jagged.select(["i32"])).data)
    ph = phash.murmur3_hash(pagged.select(["i32"]), device=CPU).data
    np.testing.assert_array_equal(ph.numpy(), jh)
    pids = torch.remainder(ph.to(torch.int64), PARTITIONS)
    np.testing.assert_array_equal(pids.numpy(), np.mod(jh, PARTITIONS))

    # 4. ColumnarToRow of the aggregate, and of the input in batches
    assert_blobs_equal(jrc.convert_to_rows(jagged),
                       prc.convert_to_rows(pagged, device=CPU))
    cap = 8 * 32 * prc.fixed_width_layout(pt.dtypes()).row_size
    jb = jrc.convert_to_rows(jt, max_batch_bytes=cap)
    pb = prc.convert_to_rows(pt, max_batch_bytes=cap, device=CPU)
    assert_blobs_equal(jb, pb)
    assert all(b.size % 32 == 0 for b in pb[:-1])

    # CPU tensors take the wrappers' plain versions: no kernel launched
    assert row_wire.launches("interleave_planes") == 0
    assert row_wire.launches("deinterleave_wire") == 0
