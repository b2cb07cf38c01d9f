"""q5-lite through the port, by both scan routes, against the JAX package.

The warehouse of tests/test_query_e2e.py (30,000 store_sales rows in
2,000-row groups, sorted by date so footer pruning engages; pyarrow writes
it).  ``chip_smoke.q5_lite`` runs the composition of that test's
``run_engine`` through the port on the CPU, once by the host route (the
chunked reader's ``__iter__``) and once by the device route
(``iter_device`` -> ``decode_table``; the STRING store file falls back to
the host route with reason ``physical_type``).  Both must equal the JAX
``run_engine`` and the pandas oracle: group keys and counts exactly, sums
within rel 1e-9 (the JAX test's own tolerance; the port's groupby sums in
scatter order).
"""

import pytest
import torch

import chip_smoke
from test_query_e2e import (DATE_HI, DATE_LO, oracle, run_engine,  # noqa
                            warehouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_result(warehouse):
    return run_engine(warehouse[0])


@pytest.mark.parametrize("route", ["host", "device"])
def test_q5_lite_matches_jax_and_pandas(warehouse, jax_result, route):
    root, sales_df, dates_df, stores_df = warehouse
    got, info = chip_smoke.q5_lite(root, route, "cpu", DATE_LO, DATE_HI,
                                   limit=96_000)
    assert info["groups_pruned"] >= 1 and info["groups_read"] >= 2
    want_fallbacks = [("store.parquet", "physical_type")] \
        if route == "device" else []
    assert info.get("fallbacks", []) == want_fallbacks
    for want in (jax_result, oracle(sales_df, dates_df, stores_df)):
        assert set(got) == set(want)
        for name, (ws, wp, wn) in want.items():
            gs, gp, gn = got[name]
            assert gn == wn, name
            assert gs == pytest.approx(ws, rel=1e-9), name
            assert gp == pytest.approx(wp, rel=1e-9), name
    assert chip_smoke.q5_matches(got, jax_result)
