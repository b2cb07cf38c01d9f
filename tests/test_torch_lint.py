"""The port's repo lint (``spark_rapids_jni_tpu_torch/tools/srjt_lint.py``)
against the JAX package's (``tools/srjt_lint.py``), on the CPU:

- rule parity: each synthetic source of tests/test_engine_verify.py and
  tests/test_fuzz.py, and a few more, gives the same violation codes and
  lines through both ``_FileLint``s (each with its package's relpath and
  whitelist); the port's own host ops (``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``) and its ranked sync label;
- the port's tree is clean against its baseline (the one ``bridge/client.py``
  key), the CLI exits 0 there and 1 on a synthetic bad package;
- ``--write-metrics`` reproduces the committed catalog byte for byte, and
  the names it has and lacks against the JAX catalog are pinned;
- the dispatch pass flags a table with an entry removed or added;
- ``--segments --device cpu``: 3 deliberate syncs on the smoke pair and 1
  on the fused sandwich at 8 shards, the runtime labels equal to
  ``sync_budget``, and a sync the budget does not know is caught;
- the lint imports no JAX;
- the two repairs it found: the prefetch pipeline's two timers, and the
  server's shutdown past an export it cannot close.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.engine.verify import SYNC_WHITELIST as J_WHITELIST
from spark_rapids_jni_tpu_torch.engine.verify import (RANKS_SYNCS,
                                                      SYNC_WHITELIST)
from spark_rapids_jni_tpu_torch.tools import srjt_lint as L
from spark_rapids_jni_tpu_torch.utils import tracing as ptracing

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BASELINE = str(ROOT / L.BASELINE)
P_WHITELIST = tuple(SYNC_WHITELIST) + tuple(RANKS_SYNCS)


def _load_jax_lint():
    spec = importlib.util.spec_from_file_location(
        "jax_srjt_lint", str(ROOT / "tools" / "srjt_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_jax_lint()


def _codes(lint_mod, src: str, rel: str, whitelist) -> list:
    tree = ast.parse(src)
    fl = lint_mod._FileLint(rel, whitelist,
                            lint_mod._module_mutable_globals(tree))
    fl.visit(tree)
    return [(v["code"], v["line"]) for v in fl.out]


def _port(src: str, where: str) -> list:
    return _codes(L, src, f"{L.PKG}/{where}", P_WHITELIST)


def _jax(src: str, where: str) -> list:
    rel = where if where.startswith("tools/") else f"{J.PKG}/{where}"
    return _codes(J, src, rel, tuple(J_WHITELIST))


# -- rule parity with the JAX lint --------------------------------------------

_BAD_GLOBALS = '''
import threading
_REGISTRY = {}
_EVENTS = []
_lock = threading.Lock()

def record(k, v):
    _REGISTRY[k] = v      # unguarded write: must be flagged
    _EVENTS.append(v)     # unguarded mutation: must be flagged

_REGISTRY["boot"] = 1     # module scope (import time): exempt
'''

_GOOD_GLOBALS = '''
import threading
_REGISTRY = {}
_lock = threading.Lock()

def record(k, v):
    with _lock:
        _REGISTRY[k] = v

def _record_locked(k, v):
    """Write one entry (lock held)."""
    _REGISTRY[k] = v
'''

_EXEC = "engine/executor.py"
_SEG = "engine/segment.py"

#: (source, file under the package or under tools/): tests/test_engine_
#: verify.py's and tests/test_fuzz.py's synthetic sources, then more of
#: each rule
SHARED = [
    ("def _eval_expr(e, t):\n    return float(x.sum())\n", _EXEC),
    ("def _eval_expr(e, t):\n    return x.item()\n", _EXEC),
    ("def _eval_expr(e, t):\n    return np.asarray(x)\n", _EXEC),
    ("def _eval_expr(e, t):\n    return float('nan')\n", _EXEC),
    ("def helper(x):\n    return x.item()\n", _EXEC),
    ("metrics.host_sync()\n", _SEG),
    ("metrics.host_sync(label='rogue-sync')\n", _SEG),
    ("metrics.host_sync(label='combine-sizing')\n", _SEG),
    ("import os\nv = os.environ.get('X')\n", _SEG),
    ("import os\nv = os.environ.get('X')\n", "utils/config.py"),
    (_BAD_GLOBALS, "bad.py"),
    (_GOOD_GLOBALS, "bad.py"),
    ("def _build_fn(seg):\n    def fn(t):\n        n = int(t.n)\n"
     "        return x.tolist(), bool(1)\n    return fn\n", _SEG),
    ("def _probe_join_node(nd):\n    return np.array(nd)\n", _SEG),
    ("def _build_fused_fn(s):\n    return int(k) + float(2)\n", _SEG),
    ("import os\nos.environ['X'] = '1'\nos.environ.setdefault('Y', '2')\n"
     "del os.environ['X']\nv = os.getenv('Z')\n", "parallel/ranks.py"),
    ("try:\n    f()\nexcept:\n    pass\n", "bridge/server.py"),
    ("try:\n    f()\nexcept:\n    pass\n", "ops/cast.py"),
    ("try:\n    f()\nexcept:\n    pass\n", "tools/x.py"),
    ("try:\n    f()\nexcept Exception:\n    pass\n", "engine/fuzz.py"),
    ("_C = {}\n\ndef f():\n    global _C\n    _C = {}\n    _C['a'] += 1\n"
     "    del _C['a']\n    _C.setdefault('b', 1)\n", "utils/faults.py"),
    ("_Q = []\n_cond = object()\n\ndef f():\n    with _cond:\n"
     "        _Q.append(1)\n    _Q.clear()\n", "engine/scheduler.py"),
]


@pytest.mark.parametrize("src,where", SHARED)
def test_rule_parity_with_jax(src, where):
    assert _port(src, where) == _jax(src, where)


def test_parity_cases_fire():
    """The shared cases exercise every AST rule (not only clean code)."""
    codes = {c for src, where in SHARED for c, _ in _port(src, where)}
    assert codes == {"traced-host-op", "host-sync-site", "config-env-read",
                     "unlocked-global-write", "bare-except"}


@pytest.mark.parametrize("src,detail", [
    ("def _eval_expr(e, t):\n    return x.cpu()\n", ".cpu() in traced code"),
    ("def _eval_expr(e, t):\n    return x.numpy()\n",
     ".numpy() in traced code"),
    ("def _eval_expr(e, t):\n    torch.cuda.synchronize()\n",
     "torch.cuda.synchronize() in traced code"),
])
def test_torch_host_ops_in_traced_code(src, detail):
    tree = ast.parse(src)
    fl = L._FileLint(f"{L.PKG}/{_EXEC}", P_WHITELIST)
    fl.visit(tree)
    assert [(v["code"], v["line"], v["detail"]) for v in fl.out] == \
        [("traced-host-op", 2, detail)]
    # the same call outside a segment body is fine
    assert _port(src.replace("_eval_expr", "helper"), _EXEC) == []


def test_ranked_sync_label():
    """``ranks-gather-sizing`` (``verify.RANKS_SYNCS``) is a whitelisted
    site, kept out of ``SYNC_WHITELIST`` (the budget's and the fuzzer's)."""
    assert "ranks-gather-sizing" not in SYNC_WHITELIST
    assert _port("metrics.host_sync(label='ranks-gather-sizing')\n",
                 "parallel/mesh.py") == []
    assert _port("metrics.host_sync(label='ranks-rogue')\n",
                 "parallel/mesh.py") == [("host-sync-site", 1)]


def test_conditional_metric_names_catalog_both_branches():
    src = ('metrics.observe("a.trace_s" if k else "a.replay_s", dt)\n'
           'metrics.count(f"a.{kind}")\nmetrics.count(name)\n')
    fl = L._FileLint(f"{L.PKG}/{_SEG}", P_WHITELIST)
    fl.visit(ast.parse(src))
    assert [(n, k, ln) for n, k, _, ln in fl.metric_sites] == [
        ("a.trace_s", "histogram", 1), ("a.replay_s", "histogram", 1),
        ("a.<kind>", "counter", 2)]


def test_sync_points_catalog_as_op_host_syncs():
    src = ('with sync_point("a.b"):\n    pass\n'
           'with tracing.sync_point(f"c.{k}"):\n    pass\n'
           'with sync_point(site):\n    pass\n')
    fl = L._FileLint(f"{L.PKG}/{_SEG}", P_WHITELIST)
    fl.visit(ast.parse(src))
    assert [(n, k, ln) for n, k, _, ln in fl.metric_sites] == [
        ("ops.host_sync.a.b", "counter", 1),
        ("ops.host_sync.c.<k>", "counter", 3)]


# -- the tree, the baseline and the CLI ---------------------------------------

def test_port_tree_is_clean_against_its_baseline(capsys):
    violations = L.ast_pass(P_WHITELIST) + L.dispatch_pass()
    with open(BASELINE) as f:
        grandfathered = set(json.load(f)["grandfathered"])
    # the one key the port keeps: spawn_server(env=) adds variables to a
    # child's environment, which Popen needs whole (README)
    assert grandfathered == {
        "config-env-read|spark_rapids_jni_tpu_torch/bridge/client.py|"
        "os.environ outside utils/config.py"}
    assert [v for v in violations
            if L.baseline_key(v) not in grandfathered] == []
    assert {L.baseline_key(v) for v in violations} == grandfathered
    assert L.main(["--baseline", BASELINE]) == 0
    assert "srjt-lint: 0 new violation(s), 1 grandfathered" in \
        capsys.readouterr().out


def test_cli_exits_nonzero_on_a_synthetic_package(tmp_path, monkeypatch,
                                                  capsys):
    pkg = tmp_path / L.PKG
    (pkg / "engine").mkdir(parents=True)
    (pkg / "bad.py").write_text(_BAD_GLOBALS)
    (pkg / "engine" / "executor.py").write_text(
        "def _eval_expr(e, t):\n    return t.cpu()\n")
    monkeypatch.setattr(L, "REPO", str(tmp_path))
    monkeypatch.setattr(L, "dispatch_pass", lambda: [])
    assert L.main([]) == 1
    out = capsys.readouterr().out
    assert out.count("unlocked-global-write") == 2  # module scope exempt
    assert "traced-host-op: spark_rapids_jni_tpu_torch/engine/" \
           "executor.py:2" in out
    (pkg / "bad.py").write_text(_GOOD_GLOBALS)
    (pkg / "engine" / "executor.py").write_text("x = 1\n")
    assert L.main([]) == 0


# -- the metric catalog -------------------------------------------------------

#: the JAX catalog's names the port records under another form of call
JAX_ONLY = {
    "engine.segment.compile": "engine.segment.<kind> (an f-string)",
    "engine.segment.replay": "engine.segment.<kind> (an f-string)",
}
#: the port's names the JAX catalog lacks, each with why
PORT_ONLY = {
    "engine.fused_stage.fallbacks": "the fused stage's give-ways to the "
                                    "host path, counted by the port alone",
    "engine.sched.handoffs": "the ranked group's turn passing between "
                             "plans (bridge/ranked.py)",
    "engine.segment.<kind>": "the template of JAX's compile and replay",
    "kernel_device.<fn_name>.<device>": "each CUDA launch by card "
                                        "(kernels/nvcc.py)",
    **{f"ops.host_sync.{site}": "a device-to-host read inside an op "
                                "(utils/tracing.py::sync_point)"
       for site in ("row_conversion.row_width",
                    "row_conversion.var_sizes.total",
                    "row_conversion.var_sizes.batches",
                    "row_conversion.var_sizes.check",
                    "row_conversion.var_sizes.chars",
                    "groupby.ngroups", "groupby.key_nulls",
                    "groupby.collect_host")},
}


def _catalog(path) -> set:
    return L._registered_metrics(str(path))


def test_write_metrics_reproduces_the_committed_catalog(tmp_path,
                                                        monkeypatch):
    out = tmp_path / "METRICS.md"
    monkeypatch.setattr(L, "METRICS_DOC", str(out))
    assert L.main(["--write-metrics"]) == 0
    assert out.read_bytes() == (ROOT / L.METRICS_DOC).read_bytes()


def test_catalog_against_the_jax_catalog():
    port = _catalog(ROOT / L.METRICS_DOC)
    jax = _catalog(ROOT / "docs" / "METRICS.md")
    assert jax - port == set(JAX_ONLY)
    assert port - jax == set(PORT_ONLY)
    # the two repairs: the prefetch timers and the shutdown's count
    assert {"io.parquet.prefetch.producer_stall_s",
            "io.parquet.prefetch.consumer_idle_s",
            "bridge.straggler_remaps"} <= port
    # a conditional expression catalogs both of its names
    assert {"engine.segment.trace_s",
            "engine.segment.replay_dispatch_s"} <= port


# -- dispatch exhaustiveness --------------------------------------------------

def test_dispatch_pass_flags_a_table_missing_an_entry(monkeypatch):
    from spark_rapids_jni_tpu_torch.engine import explain
    from spark_rapids_jni_tpu_torch.engine.plan import Limit
    assert L.dispatch_pass() == []
    cut = {k: v for k, v in explain._DESCRIBE.items() if k is not Limit}
    monkeypatch.setattr(explain, "_DESCRIBE", cut)
    assert [(v["code"], v["detail"]) for v in L.dispatch_pass()] == [
        ("dispatch-missing", "Limit not registered in explain._DESCRIBE")]
    monkeypatch.setattr(explain, "_DESCRIBE", {**cut, Limit: None,
                                               int: None})
    assert [v["detail"] for v in L.dispatch_pass()] == [
        "explain._DESCRIBE entry int is not a plan node"]


# -- the sync pass on the CPU -------------------------------------------------

def test_segments_pass_on_the_cpu(capsys):
    """3 deliberate syncs on the smoke pair and 1 on the fused sandwich at
    8 shards, budget and runtime alike, label for label; the chunked
    fact's group 0 plans and runs through the decode-prefixed segment."""
    rep = {}
    assert L.segments_pass(device="cpu", report=rep) == []
    assert rep["smoke_syncs"] == {"budget": 3, "runtime": 3}
    assert rep["fused"] == {"shards": 8, "stages": 1, "budget": 1,
                            "runtime": 1}
    for name, plan in rep["plans"].items():
        want = {}
        for site, n in plan["budget"]:
            want[site] = want.get(site, 0) + n
        assert plan["runtime"] == {k: v for k, v in want.items() if v}, name
        assert plan["error"] is None
    assert rep["plans"]["dist-fused"]["runtime"] == {"groupby-compaction": 1}
    assert rep["decode"]["groups"] > 0
    assert "segment-host-sync: not run (cpu)" in capsys.readouterr().out


def test_segments_pass_catches_a_sync_the_budget_lacks(monkeypatch):
    from spark_rapids_jni_tpu_torch.engine import segment as sg
    from spark_rapids_jni_tpu_torch.utils import metrics
    run_map = sg.run_map_segment

    def paying(compiled, table, nvalid=None):
        metrics.host_sync(label="rogue-sync")
        return run_map(compiled, table, nvalid)
    monkeypatch.setattr(sg, "run_map_segment", paying)
    got = {(v["code"], v["file"]) for v in L.segments_pass(device="cpu")}
    assert got == {("unwhitelisted-host-sync", "<plan:q5>"),
                   ("sync-budget-mismatch", "<plan:q5>"),
                   ("sync-budget-mismatch", "<smoke>")}


def test_segments_cli_with_settings(capsys):
    assert L.main(["--segments", "--device", "cpu", "--set", "shards=4",
                   "--baseline", BASELINE]) == 0
    out = capsys.readouterr().out
    assert "dist-fused: 1 fused-stage segment(s), budget 1 sync(s), " \
           "runtime 1 on 4 shard(s)" in out
    assert "srjt-lint: 0 new violation(s), 1 grandfathered" in out
    from spark_rapids_jni_tpu_torch.utils.config import config
    assert config.shards is None  # --set is undone


def test_lint_imports_no_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['spark_rapids_jni_tpu'] = None; "
            "from spark_rapids_jni_tpu_torch.tools import srjt_lint as L; "
            f"sys.exit(L.main(['--baseline', {BASELINE!r}]))")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new violation(s)" in r.stdout


# -- the repairs --------------------------------------------------------------

def test_prefetch_records_its_two_timers(tmp_path):
    """A prefetched chunked read under a metrics query records the
    producer's stall and the consumer's idle time, in both packages under
    the same names (the values are timings, not compared)."""
    from spark_rapids_jni_tpu.io.parquet import \
        ParquetChunkedReader as JReader
    from spark_rapids_jni_tpu.utils import metrics as jmetrics
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    from spark_rapids_jni_tpu_torch.io.parquet import \
        ParquetChunkedReader as PReader
    from spark_rapids_jni_tpu_torch.io.parquet_writer import write_parquet
    from spark_rapids_jni_tpu_torch.utils import metrics as pmetrics
    rng = np.random.default_rng(5)
    path = tmp_path / "f.parquet"
    write_parquet(Table([Column.from_numpy(rng.integers(0, 9, 4096),
                                           device="cpu")], ["a"]),
                  path, row_group_size=512)
    names = {"io.parquet.prefetch.producer_stall_s",
             "io.parquet.prefetch.consumer_idle_s"}
    got = {}
    for tag, metrics, reader in (
            ("port", pmetrics, lambda: PReader(path, 4096, prefetch=1,
                                               device="cpu")),
            ("jax", jmetrics, lambda: JReader(str(path), 4096,
                                              prefetch=1))):
        with metrics.query("prefetch") as qm:
            chunks = sum(1 for _ in reader())
        assert chunks > 1, tag
        got[tag] = {k for k in qm.timers if k.startswith("io.parquet.")}
    assert got["port"] == got["jax"] == names


def _serve(server):
    """``server.serve_forever`` in a thread; its exception, if any, lands
    in the returned dict."""
    box = {}

    def run():
        try:
            server.serve_forever()
        except BaseException as e:  # noqa: BLE001 -- the test reads it
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    for _ in range(500):
        if os.path.exists(server.sock_path):
            break
        time.sleep(0.01)
    return t, box


def test_shutdown_goes_past_an_export_it_cannot_close(tmp_path):
    """Two leftover exports, the first held by a live memoryview: the
    port's server shuts down without raising, unlinks both and counts one
    straggler, as the JAX server counts one on the same sequence."""
    from spark_rapids_jni_tpu.bridge import BridgeClient
    from spark_rapids_jni_tpu.bridge import shm as jshm
    from spark_rapids_jni_tpu.bridge.server import BridgeServer as JServer
    from spark_rapids_jni_tpu.utils import tracing as jtracing
    from spark_rapids_jni_tpu_torch.bridge import shm as pshm
    from spark_rapids_jni_tpu_torch.bridge.server import \
        BridgeServer as PServer
    tag = f"{os.getpid()}-{time.monotonic_ns()}"
    counts = {}
    for side, server, shm, tracing in (
            ("port", PServer(str(tmp_path / "p.sock"), "cpu"), pshm,
             ptracing),
            ("jax", JServer(str(tmp_path / "j.sock")), jshm, jtracing)):
        names = [f"srjt-lint-{side}-{tag}-{i}" for i in range(2)]
        maps = [shm.create(n, 64) for n in names]
        server._exports.update(zip(names, maps))
        held = memoryview(maps[0])
        before = tracing.counter_value("bridge.straggler_remaps")
        t, box = _serve(server)
        BridgeClient(server.sock_path).shutdown_server()
        t.join(timeout=30)
        assert not t.is_alive(), side
        counts[side] = tracing.counter_value("bridge.straggler_remaps") \
            - before
        held.release()
        if side == "port":
            assert "error" not in box, box.get("error")
            assert not any(os.path.exists(shm.shm_path(n)) for n in names)
        for n, m in zip(names, maps):
            m.close()
            shm.unlink(n)
    assert counts == {"port": 1, "jax": 1}
