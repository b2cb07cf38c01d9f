"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the configuration as it is run) beside
  ``configs/<config>.py`` (``make(cfg, seed, cache)``: the inputs);
- ``workloads/<cell>.json`` (the traffic's parameters and ``"driver"``);
- ``drivers/<driver>.py`` (``run(ctx)``: set-up, warm-up, the window, the
  check against the reference);
- ``metrics/<metric>.py`` (``read(run)``: one per-layer number or None;
  ``RANGES``: the profiler ranges it needs); a metric split by the
  end-to-end metric it moves, ``<quantity>.<part>``, may share
  ``metrics/<quantity>.py``.

The result is the last line of standard output; the numbers that decide
``correct`` are the last lines of standard error and the last key of the
result.  A host without enough CUDA cards, a missing program, or JAX or the
JAX package in ``sys.modules`` once the window has closed: no result and a
non-zero exit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_jni_tpu")


class Refused(Exception):
    """A run that may not print a result (exit code 2)."""


def load_module(path: Path, name: str):
    name = name.replace(".", "_")  # a metric's name may hold dots
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise Refused(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def with_pending(man: dict, bench: Path = BENCH) -> dict:
    """The manifest with the entries of each cell in ``pending/`` added, as
    a later ``BENCHMARK.json`` would add them: cells proven correct and not
    yet held to bounds, for the control and the tests (never for a run)."""
    out = json.loads(json.dumps(man))
    for p in sorted((bench / "pending").glob("*.json")):
        for key, entries in json.loads(p.read_text()).items():
            out[key] = out[key] + entries
    return out


def cell_plan(man: dict, cell: str, bench: Path = BENCH) -> dict:
    """The cell's entry, its configuration (entry, file, generator), its
    traffic file, and the metrics it reports."""
    cells = {w["name"]: w for w in man["workloads"]}
    if cell not in cells:
        raise Refused(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    root = bench.parent
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if cell in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in reported)]
    return {
        "cell": w, "config_entry": conf,
        "config": json.loads((root / conf["file"]).read_text()),
        "generator": bench / "configs" / f"{w['config']}.py",
        "traffic": json.loads(
            (bench / "workloads" / f"{w['traffic']}.json").read_text()),
        "end_to_end": e2e, "per_layer": layer,
    }


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Ctx:
    """What a driver gets: the plan of the cell, the run's arguments, the
    device, the cache directory and the profiler ranges its metrics read."""

    def __init__(self, plan: dict, seed: int, seconds: float, trace: bool,
                 device: str, ranges=()):
        self.cell = plan["cell"]
        self.config = plan["config"]
        self.traffic = plan["traffic"]
        self.generator = load_module(plan["generator"],
                                     f"bench_config_{self.cell['config']}")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.ranges = tuple(ranges)
        self.cache = BENCH / ".cache" / self.cell["config"]


def reader_path(bench: Path, name: str) -> Path:
    """``metrics/<name>.py``; for a name split by the end-to-end metric it
    moves (``<quantity>.<part>``) without a file of its own, the
    quantity's ``metrics/<quantity>.py``."""
    own = bench / "metrics" / f"{name}.py"
    base = bench / "metrics" / f"{name.split('.')[0]}.py"
    return own if own.exists() or not base.exists() else base


def run_cell(plan: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, bench: Path = BENCH) -> dict:
    """Drive one run; return the result object (without printing)."""
    readers = {m["name"]: load_module(reader_path(bench, m["name"]),
                                      f"bench_metric_{m['name']}")
               for m in (plan["per_layer"] if trace else ())}
    ranges = sorted({r for mod in readers.values()
                     for r in getattr(mod, "RANGES", ())})
    ctx = Ctx(plan, seed, seconds, trace, device, ranges)
    driver = load_module(bench / "drivers" / f"{ctx.traffic['driver']}.py",
                         f"bench_driver_{ctx.traffic['driver']}")
    out = driver.run(ctx)
    checks = out["checks"]
    correct = out["failed"] == 0 and out["attempted"] > 0 and all(
        v is not None and v <= lim for _, v, lim in checks)
    metrics = {}
    if trace:
        for m in plan["per_layer"]:
            v = readers[m["name"]].read(out["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"])
        values["setup_s"] = out["setup_end"] - t_start
        for m in plan["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    lat = sorted(out["layer"]["tasks_ms"])
    notes = ["window: " + json.dumps({
        "tasks": len(lat), "task_ms_p50": lat[len(lat) // 2] if lat else None,
        "task_ms_max": lat[-1] if lat else None,
        "segment_compiles": out["layer"].get("segment_compiles")})]
    t = out["layer"].get("trace")
    if t:
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = t["breakdown"]
        notes.append("trace: " + json.dumps({k: t[k] for k in (
            "device_ops", "attributed", "range_device_s")}))
    notes += [f"task error: {e}" for e in out.get("errors", ())]
    result["notes"] = notes  # standard error only
    result["checks"] = {name: {"value": float(v), "limit": lim}
                        for name, v, lim in checks}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        plan = cell_plan(manifest(), args.workload)
        import torch
        need = int(plan["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise Refused(f"needs {need} CUDA card(s); this host has "
                          f"{torch.cuda.device_count()}")
        try:
            import spark_rapids_jni_tpu_torch  # noqa: F401
        except ImportError as e:
            raise Refused(f"the program is not in this checkout: {e}")
        result = run_cell(plan, args.seed, args.seconds, bool(args.trace),
                          "cuda", t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    for line in result.pop("notes"):
        print(line, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"refused: these modules were loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
