"""The exchange layer's shuffle: the port on 8 shards against the JAX
package's 8-device CPU mesh (tests/conftest.py).

Pinned bit for bit (tolerance: none): ``shuffle_table_padded``'s received
slots (data, validity) and live masks for fixed-width, null-bearing,
padded (``live``) and STRING tables; the overflow of an explicit capacity
with a hot key; ``partition_counts`` against JAX's and against the
destinations themselves; ``partition_ids`` and string-key placement
against Spark's murmur3 (JAX's hash and a Python oracle,
``chip_smoke.spark_partition_py``); the exploded string columns; the
2 x 4 multislice mesh; the pipelined chunk stream; and the capacity and
skew helpers.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import shuffle as jsh
from spark_rapids_jni_tpu.parallel import stringplane as jsp

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar.interop import (HostColumn,
                                                         column_from_numpy)
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel import shuffle as psh
from spark_rapids_jni_tpu_torch.parallel import stringplane as psp

torch.set_num_threads(1)
NDEV = 8


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(NDEV), pmesh.make_mesh(NDEV, device="cpu")


def to_port(jt):
    return Table([column_from_numpy(HostColumn.of(c), device="cpu")
                  for c in jt.columns], jt.names)


def same_column(a, b):
    ha, hb = HostColumn.of(a), HostColumn.of(b)
    assert (ha.type_id, ha.scale) == (hb.type_id, hb.scale)
    va = np.ones(a.size, bool) if ha.validity is None else ha.validity
    vb = np.ones(b.size, bool) if hb.validity is None else hb.validity
    np.testing.assert_array_equal(va, vb)
    if ha.chars is not None:
        np.testing.assert_array_equal(ha.offsets, hb.offsets)
        np.testing.assert_array_equal(ha.chars, hb.chars)
    else:
        np.testing.assert_array_equal(
            np.ascontiguousarray(ha.data).view(np.uint8),
            np.ascontiguousarray(hb.data).view(np.uint8))


def fixed_table(n, seed=0, nkeys=16):
    rng = np.random.default_rng(seed)
    return JTable([
        JColumn.from_numpy(rng.integers(0, nkeys, n).astype(np.int64),
                           validity=rng.random(n) > 0.1),
        JColumn.from_numpy(rng.integers(-100, 100, n).astype(np.int32),
                           validity=rng.random(n) > 0.2),
        JColumn.from_numpy(rng.standard_normal(n)),
        JColumn.from_numpy((rng.random(n) > 0.5).astype(np.int8)),
    ], ["k", "v", "f", "b"])


def string_table(n, seed=1):
    rng = np.random.default_rng(seed)
    words = ["", "a", "abc", "abcd", "abcde", "héllo wörld", "δδδ",
             "exactly8", "a-longer-string-past-one-word", "\U0001F600!"]
    vals = [None if i % 11 == 3 else words[int(j)]
            for i, j in enumerate(rng.integers(0, len(words), n))]
    return JTable([JColumn.from_pylist(vals),
                   JColumn.from_numpy(np.arange(n, dtype=np.int64))],
                  ["s", "v"])


def assert_same_shuffle(jout, pout):
    jt, jok, jovf = jout
    pt, pok, povf = pout
    assert list(jt.names) == list(pt.names)
    np.testing.assert_array_equal(np.asarray(jok), pok.numpy())
    assert int(jovf) == int(povf)
    for a, b in zip(jt.columns, pt.columns):
        same_column(a, b)


CASES = {
    "one-key": (lambda: fixed_table(1024), ["k"], None),
    "two-keys": (lambda: fixed_table(512, 2, 5), ["k", "v"], None),
    "float-key": (lambda: fixed_table(256, 3), ["f"], None),
    "hot-key-capacity-4": (lambda: JTable([JColumn.from_numpy(
        np.zeros(512, np.int64))], ["k"]), ["k"], 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shuffle_slots_match_jax(meshes, case):
    jm, pm = meshes
    make, keys, cap = CASES[case]
    jt = make()
    jout = jsh.shuffle_table_padded(jmesh.shard_table(jt, jm), jm, keys,
                                    capacity=cap)
    pout = psh.shuffle_table_padded(pmesh.shard_table(to_port(jt), pm), pm,
                                    keys, capacity=cap)
    assert_same_shuffle(jout, pout)
    if cap is not None:
        assert int(pout[2]) == 512 - NDEV * 4


def test_shuffle_with_live_mask_matches_jax(meshes):
    """pad_to_multiple padding rows are never sent."""
    jm, pm = meshes
    jt = fixed_table(1001, 4)
    jp, n = jmesh.pad_to_multiple(jt, NDEV)
    pp, pn = pmesh.pad_to_multiple(to_port(jt), NDEV)
    assert pn == n and pp.num_rows == jp.num_rows
    for a, b in zip(jp.columns, pp.columns):
        same_column(a, b)
    live = np.arange(jp.num_rows) < n
    jout = jsh.shuffle_table_padded(jmesh.shard_table(jp, jm), jm, ["k"],
                                    live=jnp_live(live, jm))
    pout = psh.shuffle_table_padded(pp, pm, ["k"],
                                    live=torch.from_numpy(live))
    assert_same_shuffle(jout, pout)
    assert int(pout[1].sum()) == n


def jnp_live(live, jm):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    return jax.device_put(live, NamedSharding(jm, PartitionSpec("shard")))


def test_string_payloads_and_keys_match_jax(meshes):
    jm, pm = meshes
    jt = string_table(512)
    for keys in (["s"], ["v"]):
        assert_same_shuffle(jsh.shuffle_table_padded(jt, jm, keys),
                            psh.shuffle_table_padded(to_port(jt), pm, keys))


def test_explode_and_reassemble_match_jax():
    jt = string_table(300, 5)
    for overrides in (None, {"s": 64}):
        je_t, jplan = jsp.explode_strings(jt, overrides)
        pe_t, pplan = psp.explode_strings(to_port(jt), overrides)
        assert (pplan.names, pplan.specs) == (jplan.names, jplan.specs)
        assert list(pe_t.names) == list(je_t.names)
        for a, b in zip(je_t.columns, pe_t.columns):
            same_column(a, b)
        back = psp.reassemble_strings(pe_t, pplan)
        for a, b in zip(jt.columns, back.columns):
            same_column(a, b)


def test_partition_ids_and_string_placement_spark_exact():
    jt = string_table(400, 6)
    pt = to_port(jt)
    ids = psh.partition_ids(pt.select(["v"]), NDEV).numpy()
    np.testing.assert_array_equal(
        ids, np.asarray(jsh.partition_ids(jt.select(["v"]), NDEV)))
    exploded, plan = psp.explode_strings(pt)
    specs = psh.key_specs_for(exploded, ["s"], plan)
    assert specs[0][0] == "string"
    got = psh.partition_ids_specs(exploded.columns, specs, NDEV).numpy()
    jex, jplan = jsp.explode_strings(jt)
    want = np.asarray(jsh.partition_ids_specs(
        jex.columns, jsh.key_specs_for(jex, ["s"], jplan), NDEV))
    np.testing.assert_array_equal(got, want)
    oracle = [chip_smoke.spark_partition_py(s, NDEV)
              for s in jt["s"].to_pylist()]
    np.testing.assert_array_equal(got, oracle)
    ints = [chip_smoke.spark_partition_py(int(v), NDEV)
            for v in np.arange(400) - 200]
    from spark_rapids_jni_tpu_torch.dtypes import INT32
    from spark_rapids_jni_tpu_torch.columnar import Column
    icol = Column.fixed(INT32, np.arange(400) - 200, device="cpu")
    np.testing.assert_array_equal(
        psh.partition_ids(Table([icol], ["k"]), NDEV).numpy(), ints)


def test_partition_counts_match_destinations(meshes):
    jm, pm = meshes
    jt = fixed_table(2048, 7, 50)
    pt = to_port(jt)
    got = psh.partition_counts(pt, pm, ["k"])
    want = np.asarray(jsh.partition_counts(jmesh.shard_table(jt, jm), jm,
                                           ["k"]))
    np.testing.assert_array_equal(got, want)
    dest = psh.partition_ids(pt.select(["k"]), NDEV).numpy()
    per_shard = dest.reshape(NDEV, -1)
    for s in range(NDEV):
        np.testing.assert_array_equal(
            got[s], np.bincount(per_shard[s], minlength=NDEV))
    masked = psh.partition_counts(pt, pm, ["k"], n_valid_rows=2000)
    assert masked.sum() == 2000


def test_multislice_mesh_matches_jax():
    jm = jmesh.make_multislice_mesh(2, 4)
    pm = pmesh.make_multislice_mesh(2, 4, device="cpu")
    axis = ("dcn", "shard")
    assert pm.shape == {"dcn": 2, "shard": 4}
    assert pmesh.axis_size(pm, axis) == jmesh.axis_size(jm, axis) == NDEV
    jt = fixed_table(640, 8, 13)
    from jax.sharding import NamedSharding, PartitionSpec
    import jax
    sharding = NamedSharding(jm, PartitionSpec(axis))
    jst = JTable([JColumn(c.dtype, data=jax.device_put(c.data, sharding),
                          validity=jax.device_put(c.validity, sharding))
                  for c in jt.columns], jt.names)
    jout = jsh.shuffle_table_padded(jst, jm, ["k"], axis=axis)
    pout = psh.shuffle_table_padded(to_port(jt), pm, ["k"], axis=axis)
    assert_same_shuffle(jout, pout)


def test_pipelined_chunks_equal_one_by_one(meshes):
    _, pm = meshes
    chunks = [to_port(fixed_table(256, s)) for s in range(3)]
    piped = list(psh.shuffle_chunks_pipelined(iter(chunks), pm, ["k"],
                                              capacity=64, depth=2))
    for c, (t, ok, ovf) in zip(chunks, piped):
        one = psh.shuffle_table_padded(c, pm, ["k"], capacity=64)
        assert torch.equal(ok, one[1]) and int(ovf) == int(one[2])
        for a, b in zip(t.columns, one[0].columns):
            same_column(a, b)


def test_capacity_and_skew_helpers():
    for c in (0, 1, 31, 32, 33, 100, 129, 1000, 1 << 20, (1 << 20) + 1):
        assert psh.cap_bucket(c) == jsh.cap_bucket(c)
        assert psh.cap_bucket_fine(c) == jsh.cap_bucket_fine(c)
    for rows in ([5, 5, 5, 5], [20, 0, 0, 0], [], [0, 0]):
        assert psh.device_load_stats(rows) == jsh.device_load_stats(rows)


def test_spilled_shuffle_matches_jax_and_one_shot(meshes, tmp_path):
    """A budget of a few passes: the host-resident result equals the JAX
    package's spilled shuffle row for row (pass-major, destination order)
    and the one-shot shuffle's live rows as a multiset; its memmaps sit
    under ``spill_dir`` while the result lives, and ``sweep_orphans``
    reaps a dead process's file."""
    import os
    from spark_rapids_jni_tpu.parallel import spill as jspill
    from spark_rapids_jni_tpu_torch.parallel import spill as pspill
    jm, pm = meshes
    jt = fixed_table(3001, 9, 40)
    pt = to_port(jt)
    budget = 4 * NDEV * NDEV * 40 * 2
    got = pspill.shuffle_table_spilled(pt, pm, ["k"], budget,
                                       spill_dir=str(tmp_path))
    assert len(os.listdir(tmp_path)) == 4
    want = jspill.shuffle_table_spilled(jt, jm, ["k"], budget)
    assert got.num_rows == want.num_rows == 3001
    for a, b in zip(want.columns, got.columns):
        same_column(a, b)
    padded, n = pmesh.pad_to_multiple(pt, NDEV)
    one, ok, _ = psh.shuffle_table_padded(
        padded, pm, ["k"], live=torch.arange(padded.num_rows) < n)

    def rows(t, keep=None):
        cols = [c.to_pylist() for c in t.columns]
        rs = list(zip(*cols))
        if keep is not None:
            rs = [r for r, k in zip(rs, keep) if k]
        return sorted(rs, key=lambda r: tuple((v is not None, v)
                                              for v in r))
    assert rows(got) == rows(one, ok.tolist())
    orphan = tmp_path / "spill-999999999-1-col0.npy"
    orphan.write_bytes(b"x")
    assert pspill.sweep_orphans(str(tmp_path)) == 1
    assert not orphan.exists()


def test_port_and_chip_smoke_never_import_jax(tmp_path):
    """No module of the port, and not chip_smoke.py, names jax or the JAX
    package in an import (a grep over the sources), and a fresh interpreter
    runs ORC, the exchange layer and distributed planning without loading
    either."""
    import re
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    pat = re.compile(r"^\s*(import|from)\s+(jax|spark_rapids_jni_tpu)\b"
                     r"(?!_torch)", re.M)
    sources = sorted((repo / "spark_rapids_jni_tpu_torch").rglob("*.py"))
    sources.append(repo / "chip_smoke.py")
    assert len(sources) > 60
    bad = [str(p) for p in sources if pat.search(p.read_text())]
    assert bad == []
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import chip_smoke
        from spark_rapids_jni_tpu_torch import engine
        from spark_rapids_jni_tpu_torch.columnar import Table
        from spark_rapids_jni_tpu_torch.io import read_orc, write_orc
        from spark_rapids_jni_tpu_torch.parallel import (
            distributed_groupby, make_mesh, shuffle_table_padded)
        from spark_rapids_jni_tpu_torch.parallel.spill import (
            shuffle_table_spilled)
        ws, wr = chip_smoke.q95_columns(4096, 0)
        p = {str(tmp_path / "ws.orc")!r}
        write_orc(Table.from_pydict(ws, device="cpu"), p, compression="zlib")
        t = read_orc(p, device="cpu")
        m = make_mesh(8, device="cpu")
        shuffle_table_padded(t, m, ["ws_order_number"])
        shuffle_table_spilled(t, m, ["ws_order_number"], 1 << 12)
        distributed_groupby(t, m, ["ws_warehouse_sk"],
                            [("ws_net_profit", "sum")])
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "spark_rapids_jni_tpu"
                     or m.startswith("spark_rapids_jni_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
