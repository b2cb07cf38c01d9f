"""Adaptive execution (``config.aqe``, engine/adaptive.py): the port with
``config.shards = 8`` against the JAX package on its 8-device CPU mesh
(tests/conftest.py).

The cases of ``tests/test_adaptive.py``, each with the JAX package's
answer beside the port's where the two can be compared:

- config and eligibility: the flip threshold, the eligibility stamps and
  the combine spec, equal in both;
- skew-split planning (host math): the same split, capacity and stats;
- the split in the shuffle: an adversarial single hot key re-deals with no
  loss, and the split's slots (data, validity, live mask) equal JAX's bit
  for bit, with and without padding rows;
- end to end: the flip, the split and the combine fire, the ledger's
  ``adaptive:*`` entries equal JAX's field for field, and results equal the
  one-shard answer and JAX's (INT64 sums, exact);
- profile-warmed planning: run 2 of a source plan reads run 1's profile
  and plans the broadcast, as JAX's does;
- the EXPLAIN decision lines of adaptive entries, string for string.

Not ported: ``test_profile_cli_decisions_renders_adaptive``; ``tools/``
(the profile CLI) is not a port target.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import engine as je
from spark_rapids_jni_tpu.engine import adaptive as jad
from spark_rapids_jni_tpu.engine.explain import _decision_line as j_line
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import shuffle as jsh
from spark_rapids_jni_tpu.utils import metrics as jmetrics
from spark_rapids_jni_tpu.utils import profile as jprofile
from test_adaptive import N_DIM, _join_agg, warehouse  # noqa: F401
from test_torch_engine_dist import flags, rows, to_port
from test_torch_exchange import assert_same_shuffle, jnp_live
from test_torch_exchange import meshes  # noqa: F401
from test_torch_exchange import to_port as table_to_port

from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.engine import adaptive
from spark_rapids_jni_tpu_torch.engine.explain import _decision_line
from spark_rapids_jni_tpu_torch.engine.plan import Exchange, topo_nodes
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel import shuffle as psh
from spark_rapids_jni_tpu_torch.utils import metrics, profile

torch.set_num_threads(1)
CPU = "cpu"
NDEV = 8

#: hash-planned joins that flip at run time, a split at skew 1.5
AQE_ON = dict(aqe=True, aqe_skew=1.5, broadcast_rows=0,
              aqe_broadcast_rows=1_000_000)


@pytest.fixture(autouse=True)
def eight_shards():
    with flags(shards=NDEV):
        yield


def both_run(plan):
    """Optimize + execute ``plan`` in both packages; returns the two
    optimized plans and results."""
    jopt = je.optimize(plan, distribute=True)
    popt = pe.optimize(to_port(plan), distribute=True)
    assert popt.serialize() == jopt.serialize()
    jstats, pstats = je.new_stats(), pe.new_stats()
    jout = je.execute(jopt, jstats)
    pout = pe.execute(popt, pstats, device=CPU)
    return (jopt, jout, jstats), (popt, pout, pstats)


# -- config / eligibility ---------------------------------------------------

def test_flip_threshold_follows_broadcast_rows():
    with flags(broadcast_rows=123, aqe_broadcast_rows=-1):
        assert adaptive.flip_threshold() == jad.flip_threshold() == 123
    with flags(broadcast_rows=123, aqe_broadcast_rows=7):
        assert adaptive.flip_threshold() == jad.flip_threshold() == 7


def _stamped_plan(mod):
    build = mod.Exchange(mod.Scan("/tmp/d.parquet"), ("dk",), "hash")
    j = mod.Join(mod.Scan("/tmp/f.parquet"), build, ("k",), ("dk",),
                 "inner")
    aggx = mod.Exchange(j, ("grp",), "hash")
    return mod.Aggregate(aggx, ("grp",), (("v", "sum"),), ("total",))


def test_stamp_eligibility_marks_exchanges():
    from spark_rapids_jni_tpu.engine import plan as jplan
    from spark_rapids_jni_tpu_torch.engine import plan as pplan
    jp, pp = _stamped_plan(jplan), _stamped_plan(pplan)
    jad.stamp_eligibility(jp)
    adaptive.stamp_eligibility(pp)
    build, aggx = pp.child.child.right, pp.child
    assert getattr(build, "_aqe_flip", False)        # join build side
    assert getattr(aggx, "_aqe_split", False)        # aggregate child
    assert getattr(aggx, "_aqe_combine") == \
        (("grp",), (("v", "sum"),), ("v",)) == jp.child._aqe_combine
    assert not getattr(pp.child.child.left, "_aqe_flip", False)
    assert getattr(jp.child.child.right, "_aqe_flip", False)


def test_combine_spec_rules():
    from spark_rapids_jni_tpu.engine import plan as jplan
    from spark_rapids_jni_tpu_torch.engine import plan as pplan
    for mod, spec in ((pplan, adaptive._combine_spec),
                      (jplan, jad._combine_spec)):
        ex = mod.Exchange(mod.Scan("/t"), ("g",), "hash")
        ok = mod.Aggregate(ex, ("g",), (("a", "sum"), ("b", "min")),
                           ("x", "y"))
        assert spec(ok) == (("g",), (("a", "sum"), ("b", "min")),
                            ("a", "b"))
        # mean does not self-compose; duplicate source cols collide on
        # rename; a col shadowing a group key would corrupt the keys
        for bad in (
            mod.Aggregate(ex, ("g",), (("a", "mean"),), ("x",)),
            mod.Aggregate(ex, ("g",), (("a", "sum"), ("a", "max")),
                          ("x", "y")),
            mod.Aggregate(ex, ("g",), (("g", "sum"),), ("x",)),
            mod.Aggregate(ex, (), (("a", "sum"),), ("x",)),
        ):
            assert spec(bad) is None


# -- skew-split planning (host math) ----------------------------------------

def _both_split(counts):
    from spark_rapids_jni_tpu.engine.plan import Exchange as JExchange
    from spark_rapids_jni_tpu.engine.plan import Scan as JScan
    got = adaptive.plan_skew_split(Exchange(pe.Scan("/t"), ("k",), "hash"),
                                   counts, NDEV)
    want = jad.plan_skew_split(JExchange(JScan("/t"), ("k",), "hash"),
                               counts, NDEV)
    assert got == want
    return got


def test_plan_skew_split_balanced_declines():
    split, cap, st = _both_split(np.full((8, 8), 100, dtype=np.int64))
    assert split is None and cap is None
    assert st["skew"] == 1.0


def test_plan_skew_split_hot_dest_capacity_bound():
    counts = np.full((8, 8), 10, dtype=np.int64)
    counts[:, 2] = 500                       # one hot destination
    split, cap, st = _both_split(counts)
    assert split is not None and split[0] == (2,)
    assert 0 <= split[1] < 8                 # salt is a shard index
    # the round-robin deal bounds every (src, dest) cell at base +
    # ceil(hot_per_src / nshards): the capacity the executor projects
    assert cap == 10 + -(-500 // 8)
    assert st["skew"] > 4.0


# -- the split in the shuffle -------------------------------------------------

def _hot_key(dest=2):
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import INT64
    pool = torch.arange(4096, dtype=torch.int64)
    d = psh.partition_ids(Table([Column(INT64, data=pool)], ["k"]), NDEV)
    return int(pool[d == dest][0])


def test_skew_split_single_key_no_row_loss(meshes):  # noqa: F811
    """Every row carries one key: without the split all 1,600 rows land on
    one shard; with it they re-deal evenly, nothing overflows the projected
    capacity, no row is lost or duplicated, and the slots equal JAX's
    8-device mesh bit for bit."""
    from spark_rapids_jni_tpu.columnar import Column as JColumn
    from spark_rapids_jni_tpu.columnar import Table as JTable
    jm, pm = meshes
    n = 1600
    jt = JTable([JColumn.from_numpy(np.full(n, _hot_key(), np.int64)),
                 JColumn.from_numpy(np.arange(n, dtype=np.int64))],
                ["k", "v"])
    pt = table_to_port(jt)
    counts = psh.partition_counts(pt, pm, ["k"], n_valid_rows=n)
    node = Exchange(pe.Scan("/tmp/x.parquet"), ("k",), "hash")
    with flags(aqe_skew=1.5):
        split, cap_need, st = adaptive.plan_skew_split(node, counts, NDEV)
    assert split is not None and st["skew"] == pytest.approx(8.0)
    cap = psh.cap_bucket(cap_need)
    pout = psh.shuffle_table_padded(pt, pm, ["k"], capacity=cap,
                                    split=split)
    out, ok, ovf = pout
    assert int(ovf) == 0
    per_dest = ok.reshape(NDEV, NDEV, -1).sum(dim=(1, 2))
    assert int(per_dest.sum()) == n
    # the staggered deal spreads the single key across every shard
    assert int(per_dest.max()) <= -(-n // NDEV) + NDEV
    assert sorted(out["v"].data[ok].tolist()) == list(range(n))
    jout = jsh.shuffle_table_padded(jmesh.shard_table(jt, jm), jm, ["k"],
                                    capacity=cap, split=split)
    assert_same_shuffle(jout, pout)


def test_skew_split_slots_with_padding_match_jax(meshes):  # noqa: F811
    """Two hot destinations and padding rows (which must not advance the
    per-shard deal): slots bit for bit against JAX's."""
    from test_torch_exchange import fixed_table
    jm, pm = meshes
    jt = fixed_table(1001, 5, nkeys=6)
    jp, n = jmesh.pad_to_multiple(jt, NDEV)
    pp, pn = pmesh.pad_to_multiple(table_to_port(jt), NDEV)
    live = np.arange(jp.num_rows) < n
    split = ((1, 6), 3)
    jout = jsh.shuffle_table_padded(jmesh.shard_table(jp, jm), jm, ["k"],
                                    capacity=128, live=jnp_live(live, jm),
                                    split=split)
    pout = psh.shuffle_table_padded(pp, pm, ["k"], capacity=128,
                                    live=torch.from_numpy(live),
                                    split=split)
    assert_same_shuffle(jout, pout)
    assert int(pout[1].sum()) == n and int(pout[2]) == 0


def test_shuffle_split_requires_projected_capacity():
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.dtypes import INT64
    mesh = pmesh.make_mesh(NDEV, device=CPU)
    t = Table([Column(INT64, data=torch.arange(64))], ["k"])
    with pytest.raises(ValueError, match="projected capacity"):
        psh.shuffle_table_padded(t, mesh, ["k"], split=((2,), 0))
    with pytest.raises(ValueError, match="projected capacity"):
        list(psh.shuffle_chunks_pipelined([t], mesh, ["k"],
                                          split=((2,), 0)))


# -- end to end: flip + split + combine, with parity --------------------------

def test_aqe_rules_fire_with_parity(warehouse):  # noqa: F811
    """Hash-planned join over the hot-key fact: the flip replaces the build
    exchange at run time, the split re-deals the partial-agg exchange's hot
    destinations, the combine collapses them back; the ledger's runtime
    entries equal JAX's and the result is the one-shard answer."""
    base = pe.execute(pe.optimize(to_port(_join_agg(warehouse))),
                      device=CPU)
    with flags(**AQE_ON):
        (jopt, jout, jstats), (popt, pout, stats) = both_run(
            _join_agg(warehouse))
    assert stats["aqe_flips"] == jstats["aqe_flips"] >= 1
    assert stats["aqe_splits"] == jstats["aqe_splits"] >= 1
    rt = adaptive.runtime_entries(popt)
    assert rt == jad.runtime_entries(jopt)
    (flip,) = [d for d in rt if d["kind"] == "adaptive:broadcast_flip"
               and d["triggered"]]
    assert flip["measured_rows"] == N_DIM
    assert (flip["before"], flip["after"]) == ("hash", "broadcast")
    assert flip["path"]
    (split,) = [d for d in rt if d["kind"] == "adaptive:skew_split"
                and d["triggered"]]
    assert split["measured_skew"] > 1.5
    assert split["hot_devices"]
    # the re-deal flattened the hot destinations, and the combine
    # collapsed the scattered groups (7 grp values) back to one row each
    assert split["post_skew"] < split["measured_skew"]
    assert split["combine"] is True and split["combined_rows"] == 7
    assert rows(pout) == rows(base) == rows(jout)


def test_aqe_declines_are_recorded_not_applied(warehouse):  # noqa: F811
    """Thresholds that nothing crosses: the rules are consulted and
    recorded (triggered=no) but the planned strategies execute."""
    with flags(aqe=True, broadcast_rows=0, aqe_broadcast_rows=10,
               aqe_skew=4.0):
        (jopt, jout, _), (popt, pout, stats) = both_run(
            _join_agg(warehouse))
    assert stats["aqe_flips"] == 0
    assert stats["aqe_splits"] == 0          # skew 4.0 holds
    rt = adaptive.runtime_entries(popt)
    assert rt and all(not d["triggered"] for d in rt)
    assert rt == jad.runtime_entries(jopt)
    assert rows(pout) == rows(jout)


def test_aqe_off_leaves_no_runtime_entries(warehouse):  # noqa: F811
    with flags(broadcast_rows=0, aqe=False):
        opt = pe.optimize(to_port(_join_agg(warehouse)), distribute=True)
        stats = pe.new_stats()
        pe.execute(opt, stats, device=CPU)
    assert stats["aqe_flips"] == 0
    assert adaptive.runtime_entries(opt) == []


def test_reset_strips_runtime_entries_across_executions(
        warehouse):  # noqa: F811
    """A cached plan is re-executed as the same object: runtime entries
    must not accumulate run over run."""
    with flags(**AQE_ON):
        opt = pe.optimize(to_port(_join_agg(warehouse)), distribute=True)
        pe.execute(opt, pe.new_stats(), device=CPU)
        first = adaptive.runtime_entries(opt)
        pe.execute(opt, pe.new_stats(), device=CPU)
        assert adaptive.runtime_entries(opt) == first


# -- profile-warmed planning ------------------------------------------------

def test_history_overrides_queue(monkeypatch):
    fake = {"runs": 2, "decisions": [
        {"kind": "shuffle", "side": "left", "actual_rows": 999},
        {"kind": "broadcast", "actual_rows": 40, "est_rows": 40},
        {"kind": "partial_agg"},
        {"kind": "shuffle", "side": "right", "actual_rows": 50,
         "est_rows": 500},
    ]}
    monkeypatch.setattr(profile, "history", lambda fp, **kw: dict(fake))
    monkeypatch.setattr(jprofile, "history", lambda fp, **kw: dict(fake))
    warm = adaptive.history_overrides("f" * 64)
    assert warm == jad.history_overrides("f" * 64)
    assert warm["runs"] == 2
    # only build-side placements queue: broadcast + shuffle(side=right)
    assert [b["prior_kind"] for b in warm["builds"]] == \
        ["broadcast", "shuffle"]
    assert adaptive.next_build_actual(warm)["actual_rows"] == 40
    assert adaptive.next_build_actual(warm)["actual_rows"] == 50
    assert adaptive.next_build_actual(warm) is None      # exhausted
    assert adaptive.next_build_actual(None) is None
    monkeypatch.setattr(profile, "history", lambda fp, **kw: None)
    assert adaptive.history_overrides("f" * 64) is None


def warm_plan(mod, root):
    dim = mod.Filter(mod.Scan(root / "dim.parquet"),
                     ("<", mod.col("dk"), mod.lit(50)))
    j = mod.Join(mod.Scan(root / "fact.parquet", chunk_bytes=100_000),
                 dim, ("k",), ("dk",), "inner")
    return mod.Aggregate(j, ("grp",), (("v", "sum"),), ("total",))


def warm_run(mod, mets, root, name, **kw):
    """Optimize + execute the warm plan in ``mod`` (``je`` or ``pe``)
    inside one query of ``mets`` (its package's metrics); returns the
    optimized plan, the result and the exchange kinds."""
    opt = mod.optimize(warm_plan(mod, root), distribute=True)
    with mets.query(name):
        out = mod.execute(opt, mod.new_stats(), **kw)
    kinds = sorted(e.kind for e in topo_nodes(opt)
                   if type(e).__name__ == "Exchange")
    return opt, out, kinds


def test_history_warms_rerun_to_broadcast(warehouse, tmp_path):  # noqa: F811
    """Run 1 plans a shuffle join from the footer estimate (400 dim rows >
    threshold 100); its profile records the measured build (50 rows after
    the filter).  Run 2 of the same source plan reads that actual and
    plans the broadcast join outright, with the same result; the JAX
    package decides the same."""
    for mod, mets, sub, kw in ((pe, metrics, "port", {"device": CPU}),
                               (je, jmetrics, "jax", {})):
        with flags(aqe=True, metrics=True, profile_dir=str(tmp_path / sub),
                   broadcast_rows=100):
            opt1, out1, kinds1 = warm_run(mod, mets, warehouse, "aqe-warm-1",
                                          **kw)
            opt2, out2, kinds2 = warm_run(mod, mets, warehouse, "aqe-warm-2",
                                          **kw)
        assert "broadcast" not in kinds1
        assert "broadcast" in kinds2
        assert opt1._source_fingerprint == opt2._source_fingerprint
        (warm,) = [d for d in opt2._decisions
                   if d.get("kind") == "adaptive:history_warmed"]
        assert warm["choice"] == "broadcast"
        assert warm["est_before"] == N_DIM       # the footer estimate
        assert warm["est_rows"] == 50            # run 1's measured actual
        assert warm["prior_kind"] == "shuffle"
        assert warm["threshold"] == 100
        assert not [d for d in opt1._decisions
                    if d.get("kind") == "adaptive:history_warmed"]
        assert rows(out1) == rows(out2)
        if mod is pe:
            port = (opt1, opt2, out2)
    # the two packages planned and ledgered alike, from their own stores
    assert port[1].serialize() == opt2.serialize()
    assert port[1]._decisions == opt2._decisions
    assert port[0]._source_fingerprint == opt1._source_fingerprint
    assert rows(port[2]) == rows(out2)


# -- rendering --------------------------------------------------------------

LINES = [
    ({"kind": "adaptive:broadcast_flip", "path": "root.child.right",
      "runtime": True, "triggered": True, "before": "hash",
      "after": "broadcast", "measured_rows": 42, "threshold": 100},
     ("adaptive:broadcast_flip", "triggered=yes", "hash->broadcast",
      "measured_rows=42")),
    ({"kind": "adaptive:skew_split", "path": "root.child",
      "runtime": True, "triggered": True, "measured_skew": 5.5,
      "post_skew": 1.12, "hot_devices": [2, 5], "combine": True,
      "combined_rows": 7, "threshold": 4.0},
     ("measured_skew=5.50", "post_skew=1.12", "hot_devices=2,5",
      "combined_rows=7")),
    ({"kind": "adaptive:skew_split", "path": "root.child",
      "runtime": True, "triggered": False, "measured_skew": 1.2,
      "threshold": 4.0, "verify_rejected": True},
     ("triggered=no",)),
    ({"kind": "adaptive:history_warmed", "est_before": 400,
      "est_rows": 50, "choice": "broadcast", "prior_kind": "shuffle",
      "runs": 1, "threshold": 100},
     ("est_before=400", "est_rows=50", "choice=broadcast",
      "prior_kind=shuffle")),
]


@pytest.mark.parametrize("i", range(len(LINES)))
def test_explain_decision_line_renders_adaptive_fields(i):
    entry, want = LINES[i]
    line = _decision_line(entry, {})
    assert all(w in line for w in want), line
    assert line == j_line(entry, {})
