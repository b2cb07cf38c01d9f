"""Both drivers composed end to end on the CPU at a tiny size: the window,
the check against the reference, the metrics of a plain and a traced run."""

from __future__ import annotations

import pytest

CELLS = ["q5_year_1task", "ss_agg_partition", "ss_rows_roundtrip"]


@pytest.mark.parametrize("cell", CELLS)
def test_plain_run_is_correct_and_reports_end_to_end(cell, small_plan,
                                                     run_small):
    plan = small_plan(cell)
    res = run_small(plan, seed=2**31 + 11)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in plan["end_to_end"]}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for k, m in res["metrics"].items()
               if not k.endswith("_gib"))  # no card: no device memory
    assert list(res)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layer_metrics(cell, small_plan, run_small):
    plan = small_plan(cell)
    res = run_small(plan, seed=7, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert res["device"]["window_s"] > 0
    # on the CPU there is no device trace: those readers give nothing,
    # the program's counters and the benchmark's clock do
    names = set(res["metrics"])
    assert not names & {"decode_roofline_pct", "rowconv_roofline_pct",
                        "groupby_roofline_pct", "device_idle_pct.query",
                        "device_idle_pct"}
    if cell.startswith("q5"):
        assert {"q5_task_p95_ms", "host_syncs_per_query",
                "scan_wait_ms_per_query"} <= names
    assert len(res["breakdown"]["idle_gaps"]) >= 1


def test_same_seed_same_inputs(small_plan):
    from benchmark.core import harness as H
    plan = small_plan("ss_agg_partition")
    gen = H.load_module(plan["generator"], "g")
    a = gen.make(plan["config"], 2**31 + 99)
    b = gen.make(plan["config"], 2**31 + 99)
    c = gen.make(plan["config"], 5)
    assert all((x["rows"] == y["rows"]).all()
               for x, y in zip(a["batches"], b["batches"]))
    assert not (a["batches"][0]["rows"] == c["batches"][0]["rows"]).all()


def test_split_files_cached_by_seed(small_plan, tmp_path):
    from benchmark.core import harness as H
    plan = small_plan("q5_year_1task")
    gen = H.load_module(plan["generator"], "g")
    cache = tmp_path / "cache"
    first = gen.make(plan["config"], 3, cache)
    again = gen.make(plan["config"], 3, cache)
    other = gen.make(plan["config"], 4, cache)
    assert first["wrote_files"] and not again["wrote_files"]
    assert other["wrote_files"]
    assert [p.name for p in cache.iterdir()] == ["seed4"]  # one kept
    assert len(first["layout"]) == 16
    assert sorted(first["years"]) == [1998, 1999, 2000, 2001, 2002]


def test_split_holds_every_store_sales_column_under_one_null_model(
        small_plan, tmp_path):
    pytest.importorskip("torch")
    from benchmark.core import harness as H
    from spark_rapids_jni_tpu_torch.io import read_parquet
    plan = small_plan("q5_year_1task")
    rows_cfg = H.cell_plan(H.manifest(), "ss_agg_partition")["config"]
    t = plan["config"]["tables"]["store_sales"]
    assert t["columns"] == rows_cfg["columns"]
    assert t["null_rate"] == rows_cfg["null_rate"]
    gen = H.load_module(plan["generator"], "g")
    data = gen.make(plan["config"], 2**31 + 21, tmp_path / "cache")
    names = [c["name"] for c in t["columns"]]
    assert list(data["layout"][0]["columns"]) == names
    back = read_parquet(data["root"] / "store_sales.parquet", device="cpu")
    assert list(back.names) == names
    date = back["ss_sold_date_sk"]
    ok = date.valid_mask().numpy()
    k = int((~ok).sum())
    assert 0 < k and not ok[:k].any() and ok[k:].all()  # nulls first
    d = date.data.numpy()[k:]
    assert (d[1:] >= d[:-1]).all()
    for c in t["columns"]:
        nulls = int((~back[c["name"]].valid_mask().numpy()).sum())
        assert (nulls == 0) == bool(c.get("key")), c["name"]
