"""Hash parity: the torch port's murmur3_hash / xxhash64 against the JAX
package's, on every lane kind (int, long, bytes), with nulls chaining the
seed through.  Inputs are made with numpy from fixed seeds; the port runs
with ``device="cpu"``.  Tolerance: bit-exact (hashes are integers).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import dtypes as jdt
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.ops import hash as jhash

from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         table_from_numpy)
from spark_rapids_jni_tpu_torch.ops import hash as phash

torch.set_num_threads(1)


def port_table(jt):
    return table_from_numpy([HostColumn.of(c) for c in jt.columns],
                            device="cpu")


def assert_hashes_equal(jt):
    pt = port_table(jt)
    for jfn, pfn in [(jhash.murmur3_hash, phash.murmur3_hash),
                     (jhash.xxhash64, phash.xxhash64)]:
        want = np.asarray(jfn(jt).data)
        got = pfn(pt, device="cpu").data.numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def values(d, n, rng):
    store = d.storage
    if store.kind == "f":
        v = rng.standard_normal(n).astype(store) * 1e3
        specials = np.array([0.0, -0.0, np.nan, np.inf, -np.inf], store)
        v[:len(specials)] = specials[:n]
        if n > 6:  # a NaN with another payload: Spark makes NaNs one
            v.view(np.uint64 if store.itemsize == 8 else np.uint32)[5] |= 7
        return v
    if d == jdt.BOOL8:
        return rng.integers(0, 2, n).astype(np.uint8)
    info = np.iinfo(store)
    return rng.integers(info.min, info.max, size=n, dtype=store)


LANE_DTYPES = [
    # int lane
    jdt.INT8, jdt.INT16, jdt.INT32, jdt.BOOL8, jdt.UINT8, jdt.UINT16,
    jdt.UINT32, jdt.TIMESTAMP_DAYS, jdt.FLOAT32,
    # long lane
    jdt.INT64, jdt.UINT64, jdt.TIMESTAMP_MICROSECONDS, jdt.FLOAT64,
    jdt.decimal32(-2), jdt.decimal64(-4),
]


@pytest.mark.parametrize("d", LANE_DTYPES, ids=repr)
def test_fixed_lanes_match_jax(d):
    rng = np.random.default_rng(int(d.id) + 100)
    n = 1000
    valid = rng.random(n) > 0.2
    assert_hashes_equal(JTable([JColumn.fixed(d, values(d, n, rng),
                                              validity=valid)]))


def test_bytes_lane_all_lengths_match_jax():
    """Every length 0..70 and a few past 100 (murmur's 4-byte blocks and
    tail bytes; xxhash's 32-byte stripes, 8- and 4-byte words, tail)."""
    rng = np.random.default_rng(7)
    lens = list(range(71)) + [100, 129, 200]
    strs = [bytes(rng.integers(0, 256, L, dtype=np.uint8)).decode("latin-1")
            for L in lens]
    valid = [i % 5 != 3 for i in range(len(strs))]
    jt = JTable([JColumn.from_pylist([s if ok else None
                                      for s, ok in zip(strs, valid)])])
    assert_hashes_equal(jt)


@pytest.mark.parametrize("n", [0, 77])
def test_multicolumn_chaining_matches_jax(n):
    rng = np.random.default_rng(n)
    words = ["", "a", "abcd", "héllo ✓", "x" * 33]
    jt = JTable([
        JColumn.fixed(jdt.INT32, values(jdt.INT32, n, rng),
                      validity=rng.random(n) > 0.3),
        JColumn.from_pylist([words[k] if k else None
                             for k in rng.integers(0, len(words), n)],
                            dtype=jdt.STRING),
        JColumn.fixed(jdt.FLOAT64, values(jdt.FLOAT64, n, rng),
                      validity=rng.random(n) > 0.3),
        JColumn.fixed(jdt.INT64, values(jdt.INT64, n, rng)),
    ])
    assert_hashes_equal(jt)


def test_other_seeds_match_jax():
    rng = np.random.default_rng(3)
    jt = JTable([JColumn.fixed(jdt.INT64, values(jdt.INT64, 64, rng)),
                 JColumn.from_pylist(["ab", "cde", None, "f"] * 16)])
    pt = port_table(jt)
    for seed in (0, 1, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(
            phash.murmur3_hash(pt, seed, device="cpu").data.numpy(),
            np.asarray(jhash.murmur3_hash(jt, seed).data))
        np.testing.assert_array_equal(
            phash.xxhash64(pt, seed, device="cpu").data.numpy(),
            np.asarray(jhash.xxhash64(jt, seed).data))
