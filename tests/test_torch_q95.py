"""q95-lite and engine ORC scans: the port against the JAX package.

q95-lite (``tests/test_query_nds.py::test_q95_lite_matches_pandas``) runs
through both packages on the same pyarrow-written zlib ORC files, and on
files the port's own writer makes of the same rows (as the card writes
its own); the port's side is ``chip_smoke.q95_lite`` with
``device="cpu"``.  Tolerance: the order count exactly, the sums within rel
1e-9 (the JAX test's own: the port sums in another order).  An engine plan
scans a multi-stripe ORC file with a pruning predicate: the port prunes
stripes by their statistics, and its result equals the JAX engine's.
"""

import numpy as np
import pyarrow as pa
import pyarrow.orc as porc
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import plan as jplan
from spark_rapids_jni_tpu.io import read_orc as j_read_orc
from test_query_nds import D_HI, D_LO, q95_oracle, q95_warehouse  # noqa

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.io import read_orc, write_orc

torch.set_num_threads(1)
CPU = "cpu"


def jax_q95(ws, wr):
    """tests/test_query_nds.py's q95-lite wiring through the JAX package."""
    from spark_rapids_jni_tpu.ops.aggregate import groupby
    from spark_rapids_jni_tpu.ops.join import inner_join, left_semi_join
    from spark_rapids_jni_tpu.ops.selection import apply_boolean_mask
    sub = ws.select(["ws_order_number", "ws_warehouse_sk"])
    pairs = inner_join(sub, sub, ["ws_order_number"])
    diff = apply_boolean_mask(pairs, pairs["ws_warehouse_sk"].data
                              != pairs["ws_warehouse_sk_r"].data)
    multi = groupby(diff, ["ws_order_number"],
                    [("ws_order_number", "count_all")], names=["n"])
    in_window = apply_boolean_mask(
        ws, (ws["ws_ship_date_sk"].data >= D_LO)
        & (ws["ws_ship_date_sk"].data <= D_HI))
    kept = left_semi_join(in_window, multi, ["ws_order_number"])
    kept = left_semi_join(kept, wr, ["ws_order_number"], ["wr_order_number"])
    distinct = groupby(kept, ["ws_order_number"],
                       [("ws_ext_ship_cost", "sum"),
                        ("ws_net_profit", "sum")], names=["ship", "profit"])
    return (distinct.num_rows, float(sum(distinct["ship"].to_pylist())),
            float(sum(distinct["profit"].to_pylist())))


def assert_q95_equal(got, want):
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], rel=1e-9)
    assert got[2] == pytest.approx(want[2], rel=1e-9)


def test_q95_lite_matches_jax_and_pandas(q95_warehouse):
    root, ws_df, wr_df = q95_warehouse
    want = jax_q95(j_read_orc(root / "web_sales.orc"),
                   j_read_orc(root / "web_returns.orc"))
    got = chip_smoke.q95_lite(read_orc(root / "web_sales.orc", device=CPU),
                              read_orc(root / "web_returns.orc", device=CPU),
                              D_LO, D_HI)
    assert_q95_equal(got, want)
    assert_q95_equal(got, q95_oracle(ws_df, wr_df))
    assert got[0] > 0


def test_q95_lite_on_port_written_files(q95_warehouse, tmp_path):
    """The card's path: the port's writer (zlib, 3 stripes) on the same
    rows, both readers, both q95s and chip_smoke's numpy oracle agree."""
    _, ws_df, wr_df = q95_warehouse
    ws = {c: ws_df[c].to_numpy() for c in ws_df.columns}
    wr = {c: wr_df[c].to_numpy() for c in wr_df.columns}
    write_orc(Table.from_pydict(ws, device=CPU), tmp_path / "ws.orc",
              compression="zlib", stripe_rows=1 << 13)
    write_orc(Table.from_pydict(wr, device=CPU), tmp_path / "wr.orc",
              compression="zlib")
    got = chip_smoke.q95_lite(read_orc(tmp_path / "ws.orc", device=CPU),
                              read_orc(tmp_path / "wr.orc", device=CPU),
                              D_LO, D_HI)
    want = jax_q95(j_read_orc(tmp_path / "ws.orc"),
                   j_read_orc(tmp_path / "wr.orc"))
    assert_q95_equal(got, want)
    assert_q95_equal(got, chip_smoke.q95_oracle_np(ws, wr, D_LO, D_HI))


@pytest.fixture(scope="module")
def dated_orc(tmp_path_factory):
    """web_sales sorted by ship date in 8 stripes: stripe statistics let a
    date predicate skip most of them."""
    rng = np.random.default_rng(7)
    n = 120_000
    t = pa.table({
        "ws_ship_date_sk": pa.array(np.sort(
            rng.integers(2_450_800, 2_451_100, n))),
        "ws_warehouse_sk": pa.array(rng.integers(1, 6, n)),
        "ws_net_profit": pa.array(np.round(rng.uniform(-20, 80, n), 2))})
    p = tmp_path_factory.mktemp("q95scan") / "ws.orc"
    porc.write_table(t, p, compression="zlib", stripe_size=64 << 10)
    return p


def scan_plan(path, predicate):
    scan = jplan.Scan(str(path), format="orc",
                      columns=("ws_ship_date_sk", "ws_warehouse_sk",
                               "ws_net_profit"),
                      predicate=predicate)
    c, lit = jplan.col("ws_ship_date_sk"), jplan.lit
    f = jplan.Filter(scan, ("&", (">=", c, lit(D_LO)),
                            ("<=", c, lit(D_HI))))
    return jplan.Aggregate(f, ("ws_warehouse_sk",),
                           (("ws_net_profit", "sum"),
                            ("ws_net_profit", "count")), ("p", "n"))


@pytest.mark.parametrize("predicate", [None, ("ws_ship_date_sk", D_LO, D_HI)])
def test_engine_orc_scan_prunes_stripes(dated_orc, predicate):
    plan = scan_plan(dated_orc, predicate)
    jt = je.execute(je.optimize(plan))
    pst = pe.new_stats()
    pt = pe.execute(pe.optimize(pe.deserialize(plan.serialize())),
                    stats=pst, device=CPU)

    def rows(t):
        return sorted(zip(*[c.to_pylist() for c in t.columns]))
    got, want = rows(pt), rows(jt)
    assert [(k, n) for k, _p, n in got] == [(k, n) for k, _p, n in want]
    for (_, gp, _), (_, wp, _) in zip(got, want):
        assert gp == pytest.approx(wp, rel=1e-9)
    assert sum(n for *_, n in got) > 0
    if predicate is not None:
        assert pst["row_groups_pruned"] > 0
        assert pst["row_groups_read"] > 0
    else:
        assert pst["row_groups_pruned"] == 0
