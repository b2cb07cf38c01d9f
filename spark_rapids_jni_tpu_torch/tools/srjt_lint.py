"""Repo lint for the port's static invariants.

The port of ``tools/srjt_lint.py``, over ``spark_rapids_jni_tpu_torch/``
(its ``tools/`` included) only.  Six stdlib-``ast`` rules:

- **traced-host-op** — no ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` / ``np.asarray`` / ``np.array`` / ``torch.cuda.synchronize()``
  / non-literal ``float()`` / ``int()`` / ``bool()`` in the bodies the fused
  paths run between their labelled syncs (``segment._build_fn``,
  ``segment._probe_join_node``, ``segment._build_fused_fn``,
  ``executor._eval_expr``): each is a device-to-host round trip inside a
  segment, a per-chunk sync where the design pays none.
- **config-env-read** — ``os.environ`` / ``os.getenv`` only in
  ``utils/config.py``.  Env *writes* (``os.environ[k] = v``,
  ``os.environ.setdefault``) are exempt.  Sites the port keeps on purpose
  are baseline keys (``tools/lint-baseline.json``; README says why).
- **unlocked-global-write** — a write to a module-level mutable container
  from inside a function must sit under a ``with <lock>:`` block (mutating
  method calls, subscript stores, ``del``, augmented assigns, rebinds via
  ``global``); module scope and functions whose docstring carries
  ``(lock held)`` are exempt.
- **host-sync-site** — every ``metrics.host_sync(...)`` call carries a
  ``label=`` that is a literal member of ``verify.SYNC_WHITELIST`` or
  ``verify.RANKS_SYNCS``: a new deliberate sync is one reviewable diff.
- **bare-except** — no bare ``except:`` under ``bridge/`` / ``engine/`` /
  ``parallel/`` / ``utils/`` / ``tools/``: the recovery layer dispatches on
  the ``utils/errors`` taxonomy.
- **unregistered-metric** / **stale-metric** — every literal metric name
  recorded through ``metrics.count/observe/gauge_set/gauge_max/time_add``
  / ``tracing.count`` (and every literal ``node_set`` label, and every
  literal ``sync_point`` site as ``ops.host_sync.<site>``) appears in the
  generated catalog ``tools/METRICS.md``, and every catalog row has a call
  site.  f-strings catalog with ``<var>`` placeholders; a conditional
  expression with literal branches catalogs both.

Plus two import-time passes:

- **dispatch exhaustiveness** — every class of ``plan._NODE_TYPES`` is in
  ``executor._EXEC_DISPATCH``, ``explain._DESCRIBE``, ``verify._INFER``,
  ``verify._NULLS`` and ``fuzz._ORACLE``, and nothing else is.
- **``--segments``** — the sync pass, run on ``--device``.  It builds the
  bench smoke warehouse (``tools/chaos_soak.py``'s copy) in a temporary
  directory, optimizes and executes the q5-lite and chunked plans with
  ``prefetch=0`` and holds each plan's runtime ``engine.host_sync`` labels
  against ``verify.sync_budget`` entry for entry (exactly 3 deliberate
  syncs for the pair); the fused partial -> exchange -> final sandwich on
  8 shards must plan a ``fused-stage`` and pay exactly 1; group 0 of the
  chunked fact must plan for device decode.  On a card every fused
  segment body runs under ``torch.cuda.set_sync_debug_mode("error")``
  (``segment-host-sync``: the counterpart of the jaxpr lints' "no host
  concretization inside the program") and every K3/W1/W2 call is held
  against its plain version.  ``--full`` adds the join and top-k plans.

Usage::

    python -m spark_rapids_jni_tpu_torch.tools.srjt_lint \\
        --baseline spark_rapids_jni_tpu_torch/tools/lint-baseline.json
    python -m spark_rapids_jni_tpu_torch.tools.srjt_lint --segments \\
        --device cpu --baseline spark_rapids_jni_tpu_torch/tools/lint-baseline.json
    python -m spark_rapids_jni_tpu_torch.tools.srjt_lint --write-baseline
    python -m spark_rapids_jni_tpu_torch.tools.srjt_lint --write-metrics

Settings come from ``--set field=value`` (a field of
``utils.config.config``), never from the environment.  Violations not
covered by the baseline exit nonzero.
"""

from __future__ import annotations

import argparse
import ast
import collections
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "spark_rapids_jni_tpu_torch"

#: file (repo-relative) -> function names whose bodies run inside a fused
#: segment, between its labelled syncs
TRACED_FUNCS = {
    f"{PKG}/engine/segment.py": {"_build_fn", "_probe_join_node",
                                 "_build_fused_fn"},
    f"{PKG}/engine/executor.py": {"_eval_expr"},
}

#: subtrees where a bare `except:` is a lint violation — the failure-domain
#: hardening (engine/recovery.py) depends on every catch being classifiable
_NO_BARE_EXCEPT = (f"{PKG}/bridge/", f"{PKG}/engine/", f"{PKG}/parallel/",
                   f"{PKG}/utils/", f"{PKG}/tools/")

#: attribute calls that pull data to the host (a sync on a card)
_HOST_ATTR_CALLS = {"item", "tolist", "block_until_ready", "cpu", "numpy"}
#: builtin casts that sync when applied to a device tensor
_HOST_NAME_CALLS = {"float", "int", "bool"}

#: constructors whose module-level assignment marks a name as shared
#: mutable state for the unlocked-global-write rule
_MUTABLE_CTORS = {"dict", "list", "set", "defaultdict", "deque",
                  "OrderedDict", "Counter", "WeakValueDictionary"}
#: method calls that mutate a container in place
_MUTATING_METHODS = {"append", "appendleft", "add", "update", "setdefault",
                     "pop", "popitem", "popleft", "clear", "extend",
                     "insert", "remove", "discard"}
#: identifier substrings that mark a `with` context as a mutual-exclusion
#: guard (threading.Lock/RLock/Condition naming conventions in this repo)
_LOCKISH = ("lock", "cond", "mutex", "_cv")
#: docstring marker asserting the caller already holds the guarding lock
_LOCK_HELD_DOC = "(lock held)"

#: registry entry points whose first argument is a metric name, and the
#: catalog kind each registers under (tools/METRICS.md)
_METRIC_FNS = {"count": "counter", "observe": "histogram",
               "gauge_set": "gauge", "gauge_max": "gauge",
               "time_add": "timer"}
#: receiver names that denote the metrics/tracing registries at call sites
_METRIC_BASES = {"metrics", "_metrics", "tracing"}
#: repo-relative paths of the generated metric-name catalog and of the
#: baseline of grandfathered violation keys
METRICS_DOC = os.path.join(PKG, "tools", "METRICS.md")
BASELINE = os.path.join(PKG, "tools", "lint-baseline.json")


def _literal_metric_name(arg) -> "str | None":
    """A metric-name argument as a catalogable string: literal strings
    verbatim, f-strings with each interpolation normalized to a ``<var>``
    placeholder (so ``f"engine.errors.{kind}"`` catalogs once as
    ``engine.errors.<kind>``), fully dynamic expressions -> None
    (plumbing forwarders like ``tracing.count(name, n)`` are not call
    sites)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for v in arg.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            elif isinstance(v, ast.FormattedValue):
                inner = v.value
                if isinstance(inner, ast.Name):
                    parts.append(f"<{inner.id}>")
                elif isinstance(inner, ast.Attribute):
                    parts.append(f"<{inner.attr}>")
                else:
                    parts.append("<?>")
        return "".join(parts)
    return None


def _literal_metric_names(arg) -> list:
    """Every catalogable name of a metric-name argument: both branches of
    a conditional expression (``"a" if c else "b"``), else the one name
    of ``_literal_metric_name`` (none for a dynamic expression)."""
    if isinstance(arg, ast.IfExp):
        return _literal_metric_names(arg.body) + \
            _literal_metric_names(arg.orelse)
    name = _literal_metric_name(arg)
    return [] if name is None else [name]


def _module_mutable_globals(tree: ast.Module) -> set:
    """Names bound at module scope to a mutable container literal/ctor."""
    names: set = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        mutable = isinstance(value, (ast.Dict, ast.List, ast.Set,
                                     ast.ListComp, ast.SetComp,
                                     ast.DictComp)) or (
            isinstance(value, ast.Call) and (
                (isinstance(value.func, ast.Name)
                 and value.func.id in _MUTABLE_CTORS) or
                (isinstance(value.func, ast.Attribute)
                 and value.func.attr in _MUTABLE_CTORS)))
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and \
                    not any(s in t.id.lower() for s in _LOCKISH):
                names.add(t.id)
    return names


def _is_os_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _mentions_lock(expr) -> bool:
    for n in ast.walk(expr):
        ident = n.id if isinstance(n, ast.Name) else \
            n.attr if isinstance(n, ast.Attribute) else None
        if ident is not None and \
                any(s in ident.lower() for s in _LOCKISH):
            return True
    return False


def _violation(code: str, path: str, line: int, detail: str) -> dict:
    return {"code": code, "file": path, "line": line, "detail": detail}


def baseline_key(v: dict) -> str:
    # line numbers excluded so unrelated edits above a grandfathered
    # site don't churn the baseline
    return f"{v['code']}|{v['file']}|{v['detail']}"


class _FileLint(ast.NodeVisitor):
    def __init__(self, relpath: str, whitelist: tuple,
                 mutable_globals: set = frozenset()):
        self.relpath = relpath
        self.traced = TRACED_FUNCS.get(relpath, set())
        self.whitelist = whitelist
        self.mutable_globals = mutable_globals
        self.out: list = []
        self.metric_sites: list = []  # (name, kind, relpath, line)
        self._traced_depth = 0
        self._func_depth = 0
        self._lock_depth = 0
        self._global_decls: set = set()
        self._env_writes: set = set()  # id()s of exempt os.environ nodes

    def visit_FunctionDef(self, node):
        entered = node.name in self.traced
        if entered:
            self._traced_depth += 1
        doc = ast.get_docstring(node)
        held = doc is not None and _LOCK_HELD_DOC in doc
        if held:
            self._lock_depth += 1
        self._func_depth += 1
        saved_decls = self._global_decls
        self._global_decls = set(saved_decls)
        self.generic_visit(node)
        self._global_decls = saved_decls
        self._func_depth -= 1
        if held:
            self._lock_depth -= 1
        if entered:
            self._traced_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        locked = any(_mentions_lock(item.context_expr)
                     for item in node.items)
        if locked:
            self._lock_depth += 1
        self.generic_visit(node)
        if locked:
            self._lock_depth -= 1

    visit_AsyncWith = visit_With

    def visit_Global(self, node: ast.Global) -> None:
        self._global_decls.update(node.names)

    # -- unlocked-global-write ---------------------------------------------

    def _flag_global_write(self, name: str, lineno: int, how: str) -> None:
        if name not in self.mutable_globals:
            return
        if self._func_depth == 0 or self._lock_depth > 0:
            return  # import-time init / guarded by a lock context
        self.out.append(_violation(
            "unlocked-global-write", self.relpath, lineno,
            f"{how} of module global {name!r} outside a lock context "
            f"(wrap in `with <lock>:` or document `(lock held)`)"))

    def _check_store_target(self, target, lineno: int) -> None:
        if isinstance(target, ast.Subscript) and \
                isinstance(target.value, ast.Name):
            self._flag_global_write(target.value.id, lineno,
                                    "subscript store")
        elif isinstance(target, ast.Name) and \
                target.id in self._global_decls:
            self._flag_global_write(target.id, lineno, "rebind")
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_store_target(elt, lineno)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript) and _is_os_environ(t.value):
                self._env_writes.add(id(t.value))  # env WRITE: exempt
            self._check_store_target(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_target(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name):
                self._flag_global_write(t.value.id, node.lineno,
                                        "subscript delete")
            if isinstance(t, ast.Subscript) and _is_os_environ(t.value):
                self._env_writes.add(id(t.value))
        self.generic_visit(node)

    def _check_traced_call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _HOST_ATTR_CALLS:
                self.out.append(_violation(
                    "traced-host-op", self.relpath, node.lineno,
                    f".{fn.attr}() in traced code"))
            elif fn.attr in ("asarray", "array") and \
                    isinstance(fn.value, ast.Name) and fn.value.id == "np":
                self.out.append(_violation(
                    "traced-host-op", self.relpath, node.lineno,
                    f"np.{fn.attr}() in traced code"))
            elif fn.attr == "device_get":
                self.out.append(_violation(
                    "traced-host-op", self.relpath, node.lineno,
                    "jax.device_get() in traced code"))
            elif fn.attr == "synchronize":
                self.out.append(_violation(
                    "traced-host-op", self.relpath, node.lineno,
                    f"{ast.unparse(fn.value)}.synchronize() in traced "
                    f"code"))
        elif isinstance(fn, ast.Name) and fn.id in _HOST_NAME_CALLS:
            if not (node.args and isinstance(node.args[0], ast.Constant)):
                self.out.append(_violation(
                    "traced-host-op", self.relpath, node.lineno,
                    f"{fn.id}() cast in traced code"))

    def _check_host_sync(self, node: ast.Call) -> None:
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "host_sync"
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "metrics"):
            return
        labels = [kw.value.value for kw in node.keywords
                  if kw.arg == "label"
                  and isinstance(kw.value, ast.Constant)]
        if not labels or labels[0] not in self.whitelist:
            self.out.append(_violation(
                "host-sync-site", self.relpath, node.lineno,
                f"metrics.host_sync label {labels[0]!r} not in "
                f"SYNC_WHITELIST or RANKS_SYNCS" if labels else
                "metrics.host_sync without a whitelisted literal label="))

    # -- unregistered-metric -----------------------------------------------

    def _collect_metric(self, node: ast.Call) -> None:
        fn = node.func
        callee = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else None
        if callee == "sync_point" and node.args:
            for site in _literal_metric_names(node.args[0]):
                self.metric_sites.append((f"ops.host_sync.{site}", "counter",
                                          self.relpath, node.lineno))
            return
        if not isinstance(fn, ast.Attribute):
            return
        if fn.attr in _METRIC_FNS and isinstance(fn.value, ast.Name) \
                and fn.value.id in _METRIC_BASES and node.args:
            for name in _literal_metric_names(node.args[0]):
                self.metric_sites.append(
                    (name, _METRIC_FNS[fn.attr], self.relpath, node.lineno))
        elif fn.attr == "node_set" and len(node.args) >= 2:
            for label in _literal_metric_names(node.args[1]):
                self.metric_sites.append(
                    (label, "span", self.relpath, node.lineno))

    def visit_Call(self, node: ast.Call) -> None:
        if self._traced_depth:
            self._check_traced_call(node)
        self._check_host_sync(node)
        self._collect_metric(node)
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and \
                    fn.attr in _MUTATING_METHODS:
                self._flag_global_write(fn.value.id, node.lineno,
                                        f".{fn.attr}() call")
            if fn.attr == "setdefault" and _is_os_environ(fn.value):
                self._env_writes.add(id(fn.value))  # env WRITE: exempt
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.relpath != f"{PKG}/utils/config.py" and \
                isinstance(node.value, ast.Name) and node.value.id == "os" \
                and node.attr in ("environ", "getenv") \
                and id(node) not in self._env_writes:
            self.out.append(_violation(
                "config-env-read", self.relpath, node.lineno,
                f"os.{node.attr} outside utils/config.py"))
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        # failure-domain code must classify what it catches (utils/errors
        # taxonomy): a bare `except:` swallows cancellation and OOM alike,
        # so none are allowed in the recovery-bearing subtrees
        if node.type is None and self.relpath.startswith(_NO_BARE_EXCEPT):
            self.out.append(_violation(
                "bare-except", self.relpath, node.lineno,
                "bare `except:` in failure-domain code (catch a type; "
                "see utils/errors taxonomy)"))
        self.generic_visit(node)


def _metric_catalog(sites: list) -> dict:
    """Aggregate (name, kind, file, line) sites into
    name -> {"kinds": set, "files": set}."""
    cat: dict = {}
    for name, kind, relpath, _line in sites:
        e = cat.setdefault(name, {"kinds": set(), "files": set()})
        e["kinds"].add(kind)
        e["files"].add(relpath)
    return cat


def _registered_metrics(doc_path: str) -> set:
    """Names from the catalog's table rows (first backticked token of
    each ``| `name` | ...`` line); prose backticks don't register."""
    names: set = set()
    if not os.path.exists(doc_path):
        return names
    with open(doc_path) as f:
        for line in f:
            if line.startswith("| `") and line.count("`") >= 2:
                names.add(line.split("`", 2)[1])
    return names


def render_metrics_doc(catalog: dict) -> str:
    lines = [
        "# Metric-name catalog of the port",
        "",
        "Generated by `python -m spark_rapids_jni_tpu_torch.tools.srjt_lint",
        "--write-metrics` from the literal names at `metrics.count` /",
        "`observe` / `gauge_set` / `gauge_max` / `time_add` /",
        "`tracing.count` / `node_set` call sites of",
        "`spark_rapids_jni_tpu_torch/`, and from the sites of",
        "`tracing.sync_point` as `ops.host_sync.<site>`; `<var>` marks an",
        "f-string interpolation (one row per template, however many",
        "concrete names it expands to), and a conditional expression",
        "catalogs both of its literal branches.  Do not edit by hand: a",
        "call site recording a name missing here fails the lint",
        "(`unregistered-metric`), and a row with no remaining call site",
        "fails it too (`stale-metric`) — every metric rename is one",
        "reviewable catalog diff.",
        "",
        "`ops.host_sync.<site>` counts the device-to-host reads an op makes",
        "on its own (`utils/tracing.py::sync_point`): one each time a call",
        "passes the site, which also opens the profiler range",
        "`sync.<site>`.  They are apart from `engine.host_sync`, the",
        "engine's budgeted syncs.  Like every flat counter they are in the",
        "device server's `OP_METRICS` snapshot (`counters`) and in",
        "`srjt_export`'s Prometheus text.",
        "",
        "| name | kind | call sites |",
        "|---|---|---|",
    ]
    for name in sorted(catalog):
        e = catalog[name]
        lines.append(f"| `{name}` | {', '.join(sorted(e['kinds']))} | "
                     f"{', '.join(sorted(e['files']))} |")
    lines += ["", f"{len(catalog)} names."]
    return "\n".join(lines) + "\n"


def metrics_doc_pass(catalog: dict, doc_path: str) -> list:
    """Two-way diff of the call-site catalog against tools/METRICS.md."""
    registered = _registered_metrics(doc_path)
    rel = os.path.relpath(doc_path, REPO)
    out: list = []
    for name in sorted(set(catalog) - registered):
        site = sorted(catalog[name]["files"])[0]
        out.append(_violation(
            "unregistered-metric", site, 0,
            f"metric name `{name}` not in {rel} "
            f"(regenerate: srjt_lint --write-metrics)"))
    for name in sorted(registered - set(catalog)):
        out.append(_violation(
            "stale-metric", rel, 0,
            f"catalog entry `{name}` has no remaining call site "
            f"(regenerate: srjt_lint --write-metrics)"))
    return out


def ast_pass(whitelist: tuple, roots: tuple = (PKG,),
             sites_out: "list | None" = None) -> list:
    violations: list = []
    sites: list = []
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(
                os.path.join(REPO, root)):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", "_build"))
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, REPO)
                with open(full) as f:
                    tree = ast.parse(f.read(), filename=rel)
                lint = _FileLint(rel, whitelist,
                                 _module_mutable_globals(tree))
                lint.visit(tree)
                violations += lint.out
                sites += lint.metric_sites
    if sites_out is not None:
        sites_out.extend(sites)
    violations += metrics_doc_pass(_metric_catalog(sites),
                                   os.path.join(REPO, METRICS_DOC))
    return violations


def dispatch_pass() -> list:
    import importlib

    from ..engine import executor, explain, plan

    # engine/__init__ re-exports the verify() function under the submodule's
    # name, so resolve the module through importlib
    verify_mod = importlib.import_module(f"{PKG}.engine.verify")
    fuzz_mod = importlib.import_module(f"{PKG}.engine.fuzz")
    tables = (("executor._EXEC_DISPATCH", executor._EXEC_DISPATCH),
              ("explain._DESCRIBE", explain._DESCRIBE),
              ("verify._INFER", verify_mod._INFER),
              ("verify._NULLS", verify_mod._NULLS),
              ("fuzz._ORACLE", fuzz_mod._ORACLE))
    out: list = []
    for cls in plan._NODE_TYPES.values():
        for name, table in tables:
            if cls not in table:
                out.append(_violation(
                    "dispatch-missing", f"{PKG}/engine/plan.py", 0,
                    f"{cls.__name__} not registered in {name}"))
    for name, table in tables:
        for cls in table:
            if cls not in plan._NODE_TYPES.values():
                out.append(_violation(
                    "dispatch-missing", f"{PKG}/engine/plan.py", 0,
                    f"{name} entry {cls.__name__} is not a plan node"))
    return out


#: the smoke pair's exact budget: q5's one fused map segment + the chunked
#: plan's streamed agg (sizing + compaction) — 3 syncs, one per whitelisted
#: site
SMOKE_EXPECTED_SYNCS = 3

#: the fused dist smoke sandwich's exact budget: the whole partial-agg ->
#: hash-exchange -> final-agg stage is ONE device pass paying ONE
#: groupby-compaction boundary sync (the host-orchestrated path pays 4)
FUSED_SMOKE_EXPECTED_SYNCS = 1

#: shards of the fused sandwich's mesh when ``config.shards`` is unset (the
#: JAX lint's 8-device CPU mesh)
FUSED_SHARDS = 8

#: the kernel wrappers the device route calls (``kernels/parquet_decode.py``)
DECODE_KERNELS = ("plain_gather", "snappy_walk", "hybrid_decode")


def _fused_plan(tmp: str):
    """The dist smoke sandwich for the fused-exchange check."""
    import numpy as np

    from ..engine import Aggregate, Scan
    from .chaos_soak import _write
    rng = np.random.default_rng(13)
    n = 4000
    fact = os.path.join(tmp, "lint_fused.parquet")
    _write(fact, ["k", "v"], [rng.integers(0, 512, n).astype(np.int64),
                              rng.integers(0, 400, n) * 0.25])
    return Aggregate(Scan(fact), ("k",),
                     (("v", "sum"), ("v", "count")), ("total", "n"))


def _full_plans(tmp: str):
    """The nightly extension: bench-shaped join + top-k plans."""
    import numpy as np

    from ..engine import Aggregate, Filter, Join, Limit, Scan, Sort, col, lit
    from .chaos_soak import _write
    rng = np.random.default_rng(11)
    n = 4000
    fact = os.path.join(tmp, "lint_fact.parquet")
    dim = os.path.join(tmp, "lint_dim.parquet")
    _write(fact, ["k", "v"], [rng.integers(0, 2000, n).astype(np.int64),
                              rng.uniform(-5, 50, n)], n // 8)
    _write(dim, ["dk", "grp"], [np.arange(2000, dtype=np.int64),
                                (np.arange(2000) % 7).astype(np.int64)])
    fscan = Scan(fact, chunk_bytes=24_000)
    join_agg = Aggregate(
        Join(Filter(fscan, (">", col("v"), lit(0.0))), Scan(dim),
             ("k",), ("dk",), "inner"),
        ("grp",), (("v", "sum"), ("v", "count")), ("total", "n"))
    topk = Limit(Sort(Scan(fact, chunk_bytes=24_000),
                      (("v", False), ("k", True))), 32)
    return {"join_agg": join_agg, "topk": topk}


def _sync_site(exc: BaseException) -> str:
    """``file:line (function)`` of the innermost frame of the port (the
    lint's own frames left out) in ``exc``'s traceback."""
    import traceback
    pkg = os.path.join(REPO, PKG) + os.sep
    here = os.path.abspath(__file__)
    site = "?"
    for fr in traceback.extract_tb(exc.__traceback__):
        path = os.path.abspath(fr.filename)
        if path.startswith(pkg) and path != here:
            site = f"{os.path.relpath(path, REPO)}:{fr.lineno} ({fr.name})"
    return site


class SyncProbe:
    """What one pass observes, wrapped around the engine for the pass and
    put back after (no switch in the engine itself):

    - ``labels``: every ``metrics.host_sync`` call by label;
    - on a card, every fused segment body (``CompiledSegment`` and its
      page-planes subclass, ``CompiledFusedStage``) runs under
      ``torch.cuda.set_sync_debug_mode("error")``: ``bodies`` counts them
      by class and ``body_syncs`` lists the sites that synchronized;
    - on a card, ``calls`` keeps every K3/W1/W2 call's arguments and a
      copy of its result, for :meth:`hold_kernels`."""

    def __init__(self, device):
        self.device = device
        self.labels: collections.Counter = collections.Counter()
        self.bodies: collections.Counter = collections.Counter()
        self.body_syncs: list = []
        self.calls: dict = {name: [] for name in DECODE_KERNELS}
        self.error: "str | None" = None

    @contextlib.contextmanager
    def active(self):
        from ..engine import segment as sg
        from ..kernels import parquet_decode as pqk
        from ..utils import metrics
        saved_sync = metrics.host_sync
        saved_calls = {cls: cls.__call__ for cls in (sg.CompiledSegment,
                                                     sg.CompiledFusedStage)}
        saved_kernels = {name: getattr(pqk, name) for name in DECODE_KERNELS}

        def host_sync(n: int = 1, key=None, label: str = "") -> None:
            self.labels[label] += n
            saved_sync(n, key=key, label=label)

        metrics.host_sync = host_sync
        on_card = self.device.type == "cuda"
        if on_card:
            for cls, call in saved_calls.items():
                cls.__call__ = self._guarded(call)
            for name, fn in saved_kernels.items():
                setattr(pqk, name, self._captured(name, fn))
        try:
            yield self
        finally:
            metrics.host_sync = saved_sync
            for cls, call in saved_calls.items():
                cls.__call__ = call
            for name, fn in saved_kernels.items():
                setattr(pqk, name, fn)

    def _guarded(self, call):
        import torch

        def guarded(obj, *args, **kw):
            self.bodies[type(obj).__name__] += 1
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return call(obj, *args, **kw)
            except RuntimeError as e:
                if "synchronizing" in str(e):
                    self.body_syncs.append(
                        f"{type(obj).__name__} body: {_sync_site(e)}")
                raise
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return guarded

    def _captured(self, name: str, fn):
        def captured(*args):
            got = fn(*args)
            keep = tuple(t.clone() for t in got) \
                if isinstance(got, tuple) else got.clone()
            self.calls[name].append((args, keep))
            return got
        return captured

    def hold_kernels(self) -> tuple:
        """Each captured call's result against its plain version on the
        same inputs, bit for bit: ``({kernel: calls}, [mismatch detail])``."""
        import torch

        from ..kernels import parquet_decode as pqk
        held, bad = {}, []
        for name, got in self.calls.items():
            plain = getattr(pqk, name + "_plain")
            for i, (args, res) in enumerate(got):
                want = plain(*args)
                a = res if isinstance(res, tuple) else (res,)
                b = want if isinstance(want, tuple) else (want,)
                same = len(a) == len(b) and all(
                    x.shape == y.shape and x.dtype == y.dtype
                    and torch.equal(x, y) for x, y in zip(a, b))
                if not same:
                    bad.append(f"{name} call {i}: differs from "
                               f"{name}_plain")
            held[name] = len(got)
        return held, bad


def run_counted(plan, device, probe: SyncProbe):
    """``execute(plan)`` on ``device`` with ``prefetch=0`` (only the
    plan's own thread issues work) under ``probe``: the result Table, or
    None when the run raised (the error is ``probe.error``)."""
    from ..engine import execute
    with probe.active():
        try:
            return execute(plan, prefetch=0, device=device)
        except Exception as e:  # noqa: BLE001 -- reported as a violation
            probe.error = f"{type(e).__name__}: {e}"
            return None


def budget_violations(where: str, budget: list, probe: SyncProbe) -> list:
    """The runtime ``engine.host_sync`` labels of one run against the
    static ``sync_budget`` entries of the same plan, entry for entry."""
    from ..engine.verify import SYNC_WHITELIST
    out: list = []
    if probe.body_syncs:
        for site in probe.body_syncs:
            out.append(_violation("segment-host-sync", where, 0, site))
        return out
    if probe.error is not None:
        return [_violation("plan-error", where, 0, probe.error)]
    want = collections.Counter()
    for e in budget:
        if e["count"]:
            want[e["site"]] += e["count"]
    for label in sorted(probe.labels):
        if label not in SYNC_WHITELIST:
            out.append(_violation("unwhitelisted-host-sync", where, 0,
                                  f"runtime host_sync label {label!r}"))
    if +probe.labels != want:
        out.append(_violation(
            "sync-budget-mismatch", where, 0,
            f"runtime {dict(sorted(probe.labels.items()))} != budget "
            f"{dict(sorted(want.items()))}"))
    return out


def segments_pass(full: bool = False, device="cuda",
                  report: "dict | None" = None) -> list:
    """The sync pass on ``device`` (see the module docstring).  ``report``
    (optional) receives each plan's budget, runtime labels and guarded
    bodies, and the kernel calls held."""
    import tempfile

    import numpy as np

    from .. import device as _device
    from ..engine import optimize
    from ..engine import segment as sg
    from ..engine.plan import Scan, topo_nodes
    from ..engine.verify import check_sync_budget, plan_segments, sync_budget
    from ..io.parquet import ParquetFile, plan_device_group
    from ..utils.config import config
    from .chaos_soak import _settings, pipeline_plans, pipeline_warehouse
    dev = _device.resolve(device)
    rep = report if report is not None else {}
    rep.update(device=str(dev), plans={})
    on_card = dev.type == "cuda"
    out: list = []
    held = collections.Counter()

    def run(name: str, plan, where: str, ndev=None) -> int:
        """Execute one optimized plan, its checks into ``out``; the
        runtime sync total."""
        budget = sync_budget(plan, ndev=ndev)
        probe = SyncProbe(dev)
        run_counted(plan, dev, probe)
        out.extend(budget_violations(where, budget, probe))
        calls, bad = probe.hold_kernels()
        held.update(calls)
        for detail in bad:
            out.append(_violation("kernel-mismatch", where, 0, detail))
        rep["plans"][name] = {
            "budget": [(e["site"], e["count"]) for e in budget],
            "runtime": dict(probe.labels), "bodies": dict(probe.bodies),
            "body_syncs": list(probe.body_syncs), "error": probe.error}
        guarded = f", {sum(probe.bodies.values())} segment body call(s) " \
            "guarded" if on_card else ""
        print(f"srjt-lint: {name}: budget "
              f"{sum(e['count'] for e in budget)} sync(s), runtime "
              f"{sum(probe.labels.values())}{guarded}")
        return sum(probe.labels.values())

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(7)
        pipeline_warehouse(tmp, 4000, rng)
        q5, chunked = pipeline_plans(tmp, 48_000)
        plans = {"q5": optimize(q5), "chunked": optimize(chunked)}
        entries, bad = check_sync_budget(list(plans.values()))
        smoke_syncs = sum(e["count"] for e in entries)
        for e in bad:
            out.append(_violation("unwhitelisted-host-sync", "<smoke>", 0,
                                  f"{e['site']} at {e['path']}"))
        if smoke_syncs != SMOKE_EXPECTED_SYNCS:
            out.append(_violation(
                "sync-budget-mismatch", "<smoke>", 0,
                f"smoke plans budget {smoke_syncs} syncs, expected "
                f"{SMOKE_EXPECTED_SYNCS} "
                f"({[(e['site'], e['count']) for e in entries]})"))
        if full:
            plans.update({k: optimize(p)
                          for k, p in _full_plans(tmp).items()})
        runtime = {name: run(name, plan, f"<plan:{name}>")
                   for name, plan in plans.items()}
        smoke_runtime = runtime["q5"] + runtime["chunked"]
        if smoke_runtime != SMOKE_EXPECTED_SYNCS:
            out.append(_violation(
                "sync-budget-mismatch", "<smoke>", 0,
                f"smoke plans paid {smoke_runtime} syncs at run time, "
                f"expected {SMOKE_EXPECTED_SYNCS}"))
        rep["smoke_syncs"] = {"budget": smoke_syncs,
                              "runtime": smoke_runtime}

        # the fused-exchange stage: the dist smoke sandwich under
        # fuse_exchange on a mesh of FUSED_SHARDS shards of the device,
        # one device pass and exactly one boundary sync
        ndev = config.shards if config.shards is not None else FUSED_SHARDS
        with _settings(fuse_exchange=True, shards=ndev):
            fused_opt = optimize(_fused_plan(tmp), distribute=True)
            entries, bad = check_sync_budget([fused_opt], ndev=ndev)
            for e in bad:
                out.append(_violation(
                    "unwhitelisted-host-sync", "<dist-fused>", 0,
                    f"{e['site']} at {e['path']}"))
            fused_syncs = sum(e["count"] for e in entries)
            if ndev > 1 and fused_syncs != FUSED_SMOKE_EXPECTED_SYNCS:
                out.append(_violation(
                    "sync-budget-mismatch", "<dist-fused>", 0,
                    f"fused smoke budget {fused_syncs} syncs, expected "
                    f"{FUSED_SMOKE_EXPECTED_SYNCS} "
                    f"({[(e['site'], e['count']) for e in entries]})"))
            stages = [s for s in plan_segments(fused_opt, ndev=ndev)
                      if s["kind"] == "fused-stage"]
            if ndev > 1 and not stages:
                out.append(_violation(
                    "missing-fused-artifact", "<plan:dist-fused>", 0,
                    f"no fused-stage segment planned on {ndev} shards"))
            paid = run("dist-fused", fused_opt, "<plan:dist-fused>", ndev)
            if ndev > 1 and paid != FUSED_SMOKE_EXPECTED_SYNCS:
                out.append(_violation(
                    "sync-budget-mismatch", "<dist-fused>", 0,
                    f"fused smoke paid {paid} syncs at run time, expected "
                    f"{FUSED_SMOKE_EXPECTED_SYNCS}"))
            if on_card and stages and not \
                    rep["plans"]["dist-fused"]["bodies"].get(
                        "CompiledFusedStage"):
                out.append(_violation(
                    "missing-fused-artifact", "<plan:dist-fused>", 0,
                    "the planned fused stage never ran its device pass"))
        rep["fused"] = {"shards": ndev, "stages": len(stages),
                        "budget": fused_syncs, "runtime": paid}
        print(f"srjt-lint: dist-fused: {len(stages)} fused-stage "
              f"segment(s), budget {fused_syncs} sync(s), runtime {paid} "
              f"on {ndev} shard(s)")

        # the device-decode segment: group 0 of the chunked fact planned
        # for device decode, then the decode-prefixed stream segment run
        # on its planes (on a card under the guard, its K3/W1 calls held)
        copt = plans["chunked"]
        sn = next(n for n in topo_nodes(copt) if isinstance(n, Scan))
        seg = sg.build_stream_segment(copt, sn, sg.parent_counts(copt))
        chunk, reason = plan_device_group(
            ParquetFile(os.path.join(tmp, "store_sales.parquet")), 0,
            None, 1 << 30, device=dev)
        if seg is None or chunk is None:
            out.append(_violation(
                "missing-decode-artifact", "<plan:chunked>", 0,
                f"no decode-prefixed stream segment to run "
                f"(segment={seg is not None}, plan reason={reason})"))
        else:
            probe = SyncProbe(dev)
            with probe.active():
                try:
                    compiled = sg.SEGMENT_CACHE.get_decode(seg, chunk.geom)
                    groups = int(compiled(chunk.to_device(dev),
                                          chunk.nrows)[4])
                except Exception as e:  # noqa: BLE001 -- reported below
                    probe.error = f"{type(e).__name__}: {e}"
                    groups = 0
            out.extend(budget_violations("<decode:chunked>", [], probe))
            calls, bad = probe.hold_kernels()
            held.update(calls)
            for detail in bad:
                out.append(_violation("kernel-mismatch", "<decode:chunked>",
                                      0, detail))
            if probe.error is None and groups <= 0:
                out.append(_violation(
                    "missing-decode-artifact", "<decode:chunked>", 0,
                    "the decode segment found no group in group 0"))
            rep["decode"] = {"rows": chunk.nrows, "groups": groups,
                             "bodies": dict(probe.bodies)}
            print(f"srjt-lint: device-decode: group 0 ({chunk.nrows} "
                  f"rows) -> {groups} partial group(s)")
    rep["kernel_calls"] = dict(held)
    if on_card:
        guarded = sum(sum(p["bodies"].values()) for p in
                      [*rep["plans"].values(), rep.get("decode", {})]
                      if "bodies" in p)
        print(f"srjt-lint: segment-host-sync: {guarded} segment body "
              f"call(s) under set_sync_debug_mode('error'); kernel calls "
              f"held: {dict(held)}")
        if not guarded:
            out.append(_violation("segment-host-sync", "<smoke>", 0,
                                  "no segment body ran under the guard"))
    else:
        print(f"srjt-lint: segment-host-sync: not run ({dev.type})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srjt_lint", description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="JSON baseline of grandfathered violation keys")
    ap.add_argument("--write-baseline", action="store_true",
                    help=f"rewrite --baseline (default {BASELINE}) from "
                         f"the current violations")
    ap.add_argument("--write-metrics", action="store_true",
                    help=f"regenerate {METRICS_DOC} from the metric-name "
                         f"call sites")
    ap.add_argument("--segments", action="store_true",
                    help="also run the sync pass on --device")
    ap.add_argument("--full", action="store_true",
                    help="with --segments: extend to the bench join/top-k "
                         "plan shapes")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sync pass (default cuda)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="set a field of utils.config.config (repeatable)")
    args = ap.parse_args(argv)

    from ..engine.verify import RANKS_SYNCS, SYNC_WHITELIST
    from ..utils.config import parse_setting
    from .chaos_soak import _settings

    sites: list = []
    violations = ast_pass(tuple(SYNC_WHITELIST) + tuple(RANKS_SYNCS),
                          sites_out=sites)
    if args.write_metrics:
        doc_path = os.path.join(REPO, METRICS_DOC)
        catalog = _metric_catalog(sites)
        os.makedirs(os.path.dirname(doc_path), exist_ok=True)
        with open(doc_path, "w") as f:
            f.write(render_metrics_doc(catalog))
        print(f"srjt-lint: wrote {len(catalog)} metric name(s) to "
              f"{os.path.relpath(doc_path, REPO)}")
        return 0
    violations += dispatch_pass()
    if args.segments or args.full:
        with _settings(**dict(parse_setting(t) for t in args.set)):
            violations += segments_pass(full=args.full, device=args.device)

    baseline_path = args.baseline or os.path.join(REPO, BASELINE)
    if args.write_baseline:
        keys = sorted({baseline_key(v) for v in violations})
        with open(baseline_path, "w") as f:
            json.dump({"grandfathered": keys}, f, indent=2)
            f.write("\n")
        print(f"srjt-lint: wrote {len(keys)} baseline key(s) to "
              f"{baseline_path}")
        return 0

    grandfathered: set = set()
    if args.baseline and os.path.exists(args.baseline):
        with open(args.baseline) as f:
            grandfathered = set(json.load(f).get("grandfathered", []))

    fresh = [v for v in violations if baseline_key(v) not in grandfathered]
    old = len(violations) - len(fresh)
    for v in fresh:
        print(f"srjt-lint: {v['code']}: {v['file']}:{v['line']}: "
              f"{v['detail']}")
    print(f"srjt-lint: {len(fresh)} new violation(s), {old} grandfathered")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
