"""``correct`` comes out false when the timed path is broken underneath,
and the control (the reference one precision down) fails the limit.

Each fault is planted in the program for one run on the CPU, the rest of
the run as the benchmark drives it (only its look for a card skipped): half
of the batch left out, and an answer altered where it is produced, in each
cell of ``BENCHMARK.json`` and of ``pending/``.  These
cells have no training state and no exchange between chips, so those
faults do not apply.
"""

from __future__ import annotations

import pytest
import torch

import spark_rapids_jni_tpu_torch.ops.aggregate as agg_mod
import spark_rapids_jni_tpu_torch.ops.hash as hash_mod
import spark_rapids_jni_tpu_torch.ops.parquet_decode as dec_mod
import spark_rapids_jni_tpu_torch.ops.row_conversion as rc_mod
from spark_rapids_jni_tpu_torch.columnar import Column, Table


def _half_groupby(real):
    def groupby(table, *a, **k):
        n = table.num_rows // 2
        return real(table.gather(torch.arange(n, device=table[0].data.device)),
                    *a, **k)
    return groupby


def _altered_hash(real):
    def murmur3_hash(*a, **k):
        h = real(*a, **k)
        d = h.data.clone()
        d[0] += 1
        return Column(h.dtype, data=d)
    return murmur3_hash


def _altered_from_rows(real):
    def convert_from_rows(*a, **k):
        t = real(*a, **k)
        c = t.columns[-1]
        d = c.data.clone()
        d[3] = d[3] + 0.01
        return Table(list(t.columns[:-1]) + [Column(c.dtype, data=d,
                                                    validity=c.validity)])
    return convert_from_rows


def _altered_to_rows(real):
    def convert_to_rows(*a, **k):
        rows = real(*a, **k)
        words = rows[0].children[0].data
        words[1] ^= 1
        return rows
    return convert_to_rows


def _half_to_rows(real):
    def convert_to_rows(table, *a, **k):
        n = table.num_rows // 2
        return real(table.gather(torch.arange(n, device=table[0].data.device)),
                    *a, **k)
    return convert_to_rows


def _decode_half_prices(real):
    """The price column of every decoded chunk with its second half null."""
    def decode_table(planes, geom):
        t = real(planes, geom)
        if "ss_ext_sales_price" not in t.names:
            return t
        cols = list(t.columns)
        i = t.names.index("ss_ext_sales_price")
        c = cols[i]
        ok = c.valid_mask().clone()
        ok[ok.shape[0] // 2:] = False
        cols[i] = Column(c.dtype, data=c.data, validity=ok)
        return Table(cols, t.names)
    return decode_table


def _decode_altered_profit(real):
    def decode_table(planes, geom):
        t = real(planes, geom)
        if "ss_net_profit" not in t.names:
            return t
        cols = list(t.columns)
        i = t.names.index("ss_net_profit")
        c = cols[i]
        d = c.data.clone()
        d[0] += 1.0
        cols[i] = Column(c.dtype, data=d, validity=c.validity)
        return Table(cols, t.names)
    return decode_table


STAGE_FAULTS = [
    ("half the batch", agg_mod, "groupby", _half_groupby, "agg_mismatches"),
    ("a hash altered", hash_mod, "murmur3_hash", _altered_hash,
     "partition_mismatches"),
    ("a value altered", rc_mod, "convert_from_rows", _altered_from_rows,
     "rows_mismatches"),
    ("a row byte altered", rc_mod, "convert_to_rows", _altered_to_rows,
     "agg_rows_mismatches"),
]
ROUNDTRIP_FAULTS = [
    ("half the batch to rows", rc_mod, "convert_to_rows", _half_to_rows,
     "to_rows_mismatches"),
    ("a row byte altered to rows", rc_mod, "convert_to_rows",
     _altered_to_rows, "to_rows_mismatches"),
    ("a value altered from rows", rc_mod, "convert_from_rows",
     _altered_from_rows, "rows_mismatches"),
]
Q5_FAULTS = [
    ("half the prices", dec_mod, "decode_table", _decode_half_prices,
     "q5_mismatches"),
    ("a profit altered", dec_mod, "decode_table", _decode_altered_profit,
     "q5_sum_gap"),
]


FAULTS = [("ss_agg_partition", f) for f in STAGE_FAULTS] + [
    ("ss_rows_roundtrip", f) for f in ROUNDTRIP_FAULTS] + [
    ("q5_year_1task", f) for f in Q5_FAULTS]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=lambda f: f[0])
def test_a_planted_fault_is_not_correct(cell, fault, small_plan, run_small,
                                        monkeypatch):
    from spark_rapids_jni_tpu_torch.engine.segment import SEGMENT_CACHE
    what, mod, name, plant, caught_by = fault
    plan = small_plan(cell)
    monkeypatch.setattr(mod, name, plant(getattr(mod, name)))
    SEGMENT_CACHE.clear()  # compiled segments bind decode_table once
    try:
        res = run_small(plan, seed=2**31 + 3)
    finally:
        SEGMENT_CACHE.clear()
    assert not res["correct"]
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("cell", ["q5_year_1task", "ss_agg_partition",
                                  "ss_rows_roundtrip"])
def test_the_control_fails_what_the_program_passes(cell, small_plan,
                                                   run_small):
    from benchmark import control
    plan = small_plan(cell)
    for seed in (1, 2, 3):
        r = control.reading(plan, seed)
        # a gap ten times over its limit, or an exact number missed
        assert any(v > 10 * control.limit(plan, k) if k.endswith("_gap")
                   else v > 0 for k, v in r.items()), r
    res = run_small(plan, seed=4)
    assert res["correct"]
    for k, c in res["checks"].items():
        assert c["value"] <= (c["limit"] / 10 if k.endswith("_gap") else 0)
