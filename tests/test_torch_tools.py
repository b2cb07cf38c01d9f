"""The port's reading and export CLIs (spark_rapids_jni_tpu_torch/tools/)
against the JAX package's (tools/srjt_blackbox.py, tools/srjt_profile.py):

- bundles written by the port's ``post_mortem`` and profiles of port plans
  run on the CPU; on that directory every subcommand of the port's
  ``srjt_blackbox`` and ``srjt_profile`` prints the JAX tool's stdout and
  returns its exit code, the 1 and 2 codes included;
- ``srjt_export --socket`` against a ``device="cpu"`` port server prints
  well-formed Prometheus exposition (the check of ci/premerge.sh), with
  the prefix applied by the server; ``--warm --device cpu`` too.
"""

import contextlib
import importlib.util
import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.utils import config as jcfg
from spark_rapids_jni_tpu_torch import engine as pe
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.io.parquet_writer import write_parquet
from spark_rapids_jni_tpu_torch.tools import (srjt_blackbox, srjt_export,
                                              srjt_profile)
from spark_rapids_jni_tpu_torch.utils import blackbox as pbb
from spark_rapids_jni_tpu_torch.utils import errors as perrors
from spark_rapids_jni_tpu_torch.utils.config import config as pcfg

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", str(ROOT / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(main, argv) -> tuple:
    """(exit code, stdout) of one CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A bundle directory (three post-mortems of the port) and a profile
    store (port plans on the CPU: one plan twice, one distributed)."""
    root = tmp_path_factory.mktemp("tools")
    bb, prof = str(root / "bundles"), str(root / "profiles")
    os.makedirs(bb)
    os.makedirs(prof)
    tids = []
    for i, exc in enumerate((perrors.TransientError("boom"),
                             perrors.ResourceExhaustedError("oom"), None)):
        with pbb.query_scope() as s:
            pbb.record("retry", site="unit", attempt=i)
            pbb.post_mortem(f"unit{i}", exc=exc, dir_path=bb)
        tids.append(s.trace_id)
    path = str(root / "t.parquet")
    rng = np.random.default_rng(3)
    write_parquet(Table([
        Column.from_numpy(rng.integers(0, 6, 4096).astype(np.int64),
                          device="cpu"),
        Column.from_numpy(rng.integers(0, 99, 4096).astype(np.int64),
                          device="cpu")], ["k", "v"]),
        path, row_group_size=1024)
    agg = pe.Aggregate(pe.Scan(path, chunk_bytes=1 << 14), ["k"],
                       [("v", "sum"), ("v", "count")], names=["s", "n"])
    saved = (pcfg.profile_dir, pcfg.shards)
    pcfg.profile_dir = prof
    try:
        for _ in range(2):
            pe.execute(pe.optimize(agg), device="cpu")
        pcfg.shards = 8
        pe.execute(pe.optimize(agg, distribute=True), device="cpu")
    finally:
        pcfg.profile_dir, pcfg.shards = saved
    return {"bb": bb, "prof": prof, "tids": tids,
            "empty": str(root / "none")}


BLACKBOX_CASES = [
    ["list"], ["show"], ["show", "-1", "--ring"], ["show", "0"],
    ["show", "-99"], ["grep", "TID0"], ["grep", "TID2"], ["grep", "f" * 32],
    ["grep", " "],
]


@pytest.mark.parametrize("argv", BLACKBOX_CASES, ids=" ".join)
def test_blackbox_cli_matches_jax(stores, argv):
    jbbx = _load_tool("srjt_blackbox")
    argv = [a.replace("TID0", stores["tids"][0][:8])
            .replace("TID2", stores["tids"][2]) for a in argv]
    want = _call(jbbx.main, ["--dir", stores["bb"]] + argv)
    got = _call(srjt_blackbox.main, ["--dir", stores["bb"]] + argv)
    assert got == want
    assert want[0] == (2 if argv in (["show", "-99"], ["grep", " "]) else
                       1 if argv[0] == "grep" and argv[1] == "f" * 32
                       else 0)


def test_blackbox_cli_usage_errors_match_jax(stores):
    jbbx = _load_tool("srjt_blackbox")
    assert not pcfg.blackbox_dir and not jcfg.config.blackbox_dir
    for argv in (["list"], ["--dir", stores["empty"], "show"]):
        assert _call(srjt_blackbox.main, argv) == \
            _call(jbbx.main, argv) == (2, "")


PROFILE_CASES = [
    ["list"], ["show"], ["show", "-1"], ["show", "0"], ["show", "-99"],
    ["diff"], ["diff", "0", "1"], ["diff", "--json"], ["decisions"],
    ["decisions", "0"], ["slo", "--slo-ms", "500"],
    ["slo", "--slo-ms", "0.001,abc=1"], ["slo"],
]


@pytest.mark.parametrize("argv", PROFILE_CASES, ids=" ".join)
def test_profile_cli_matches_jax(stores, argv, monkeypatch):
    jprof = _load_tool("srjt_profile")
    # the JAX tool leaves --slo-ms on its config: restore it after
    monkeypatch.setattr(jcfg.config, "slo_ms", jcfg.config.slo_ms)
    want = _call(jprof.main, ["--dir", stores["prof"]] + argv)
    got = _call(srjt_profile.main, ["--dir", stores["prof"]] + argv)
    assert got == want
    assert want[0] == (2 if argv in (["show", "-99"], ["slo"]) else 0)
    assert not pcfg.slo_ms


def test_profile_cli_no_pair_and_empty_match_jax(stores, tmp_path):
    jprof = _load_tool("srjt_profile")
    one = tmp_path / "one"
    one.mkdir()
    first = sorted(os.listdir(stores["prof"]))[0]
    (one / first).write_bytes(Path(stores["prof"], first).read_bytes())
    for argv in (["--dir", str(one), "diff"],
                 ["--dir", stores["empty"], "show"], ["list"]):
        want = _call(jprof.main, argv)
        assert _call(srjt_profile.main, argv) == want
        assert want[0] == 2


def test_export_scrapes_a_cpu_server(tmp_path):
    from spark_rapids_jni_tpu_torch.bridge import BridgeClient, spawn_server
    sock = str(tmp_path / "s.sock")
    path = str(tmp_path / "w.parquet")
    write_parquet(Table([
        Column.from_numpy(np.arange(2048, dtype=np.int64) % 7,
                          device="cpu"),
        Column.from_numpy(np.arange(2048, dtype=np.float64),
                          device="cpu")], ["k", "v"]),
        path, row_group_size=256)
    proc = spawn_server(sock, device="cpu")
    try:
        c = BridgeClient(sock, device="cpu")
        for h in c.execute_plan(pe.Aggregate(
                pe.Scan(path, chunk_bytes=4096), ["k"], [("v", "sum")],
                names=["s"])):
            c.release(h)
        code, text = _call(srjt_export.main, ["--socket", sock])
        assert code == 0 and srjt_export.exposition_faults(text) == []
        assert "srjt_io_parquet_chunks" in text and "srjt_engine_" in text
        code, part = _call(srjt_export.main,
                           ["--socket", sock, "--prefix", "engine."])
        assert code == 0
        names = {ln.split()[2] for ln in part.splitlines()
                 if ln.startswith("# TYPE ")}
        assert names and all(n.startswith(("srjt_engine_", "srjt_queries",
                                           "srjt_query_")) for n in names)
        c.shutdown_server()
        c.close()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert _call(srjt_export.main, ["--socket", sock])[0] == 2


def test_export_warm_and_faults_of_bad_text():
    code, text = _call(srjt_export.main, ["--warm", "--device", "cpu"])
    assert code == 0 and srjt_export.exposition_faults(text) == []
    assert srjt_export.exposition_faults("") == ["no sample",
                                                 "no histogram bucket"]
    bad = ("# TYPE srjt_h histogram\nsrjt_h_bucket{le=\"1\"} 3\n"
           "srjt_h_bucket{le=\"2\"} 2\nsrjt_h_bucket{le=\"+Inf\"} 3\n"
           "srjt_h_count 3\nother 1\n")
    faults = srjt_export.exposition_faults(bad)
    assert any("non-exposition" in f for f in faults)
    assert any("not cumulative" in f for f in faults)


@pytest.mark.parametrize("argv", [
    ("srjt_fuzz", ["--count", "1"]),
    ("srjt_export", ["--warm"]),
    ("trace_join_check", []),
    ("chaos_soak", ["--rows", "64"]),
], ids=lambda a: a[0])
def test_entry_points_default_to_the_card(argv, tmp_path, monkeypatch):
    """Asked for no device, an entry point that executes plans takes
    ``cuda``: on a host without a card it raises the device error before
    any work, and never carries on on the CPU."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name, rest = argv
    mod = importlib.import_module(f"spark_rapids_jni_tpu_torch.tools.{name}")
    if name == "chaos_soak":
        rest = rest + ["--dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(rest)
    assert not os.listdir(tmp_path)
