"""The port's chaos soak and trace-join check (spark_rapids_jni_tpu_torch/
tools/chaos_soak.py, trace_join_check.py) on the CPU.

- the soak at small ``rows``: every ``SCHEDULE`` spec over q5-lite and the
  chunked aggregate (and q5 over the mesh under the exchange's specs),
  the spill pass, the device-decode route's seam, and the four concurrent
  clients against a ``device="cpu"`` server, with zero failures (parity,
  bit for bit on the CPU, or one typed error and one bundle with its
  trace id each) and every spec's fault injected but those of the seams
  no plan passes;
- ``SCHEDULE`` is ci/chaos_soak.py's, and every site it names is in the
  port's ``faults.SITES``;
- ``trace_join_check`` returns 0 against ``device="cpu"`` servers.
"""

import importlib.util
from pathlib import Path

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.tools import chaos_soak, trace_join_check
from spark_rapids_jni_tpu_torch.utils import faults
from spark_rapids_jni_tpu_torch.utils.config import config

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def test_schedule_is_ci_soaks_and_names_port_sites():
    spec = importlib.util.spec_from_file_location(
        "ci_chaos_soak", str(ROOT / "ci" / "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert chaos_soak.SCHEDULE == mod.SCHEDULE
    sites = {rule.split(":")[0] for s in chaos_soak.SCHEDULE +
             list(chaos_soak.DEVICE_DECODE_SCHEDULE) for rule in s.split(",")}
    assert sites <= set(faults.SITES)
    assert set(faults.SITES) - sites == set()


def test_soak_on_cpu_has_no_failure(tmp_path):
    before = (config.faults, config.blackbox_dir, config.query_timeout_s)
    lines = []
    rep = chaos_soak.soak("cpu", rows=8192, log=lines.append,
                          work_dir=str(tmp_path))
    assert rep["failures"] == []
    # two plans a spec, and q5 over the mesh under the exchange's specs
    sched = len(chaos_soak.SCHEDULE) * 2 + sum(
        "exchange.dispatch" in s for s in chaos_soak.SCHEDULE)
    want = sched + len(chaos_soak.DEVICE_DECODE_SCHEDULE) + \
        2 * chaos_soak.CLIENTS
    assert rep["runs"] == want == rep["parity"] + rep["typed"]
    # every spec injected a fault, but those of the seams no plan passes
    off = [s for s in chaos_soak.SCHEDULE
           if s.split(":")[0] in chaos_soak.OFF_PLAN_SITES]
    assert off == ["spill.write:1:io_error", "bridge.op:1:io_error"]
    assert all(rep["fired"][s] > 0 for s in
               chaos_soak.SCHEDULE + list(chaos_soak.DEVICE_DECODE_SCHEDULE)
               + ["concurrent/absorbed", "concurrent/typed"]
               if s not in off)
    assert [s for s in off if rep["fired"][s]] == []
    # on the CPU the engine's sums run in one order: every parity exact
    assert rep["bit_exact"] == rep["parity"]
    assert rep["typed"] >= chaos_soak.CLIENTS and rep["parity"] >= 4
    assert rep["device_decode_chunks"] > 0
    assert (config.faults, config.blackbox_dir, config.query_timeout_s) \
        == before


def test_a_spec_that_never_fires_fails_the_soak(tmp_path):
    """A run whose armed seam its plan never passes ends in parity and
    tests nothing: the soak counts it unfired and fails its spec, unless
    the spec arms only ``OFF_PLAN_SITES``."""
    from spark_rapids_jni_tpu_torch.columnar import Column, Table
    t = Table([Column.from_numpy(np.arange(3, dtype=np.int64),
                                 device="cpu")], ["k"])
    s = chaos_soak._Soak(str(tmp_path), print)
    for spec in ("parquet.chunk:1:io_error", "bridge.op:1:io_error"):
        s.run(spec, f"quiet [{spec}]", lambda: t, t, "k")
    assert (s.runs, s.parity, s.bit_exact) == (2, 2, 2)
    assert s.unfired == ["quiet [parquet.chunk:1:io_error]",
                         "quiet [bridge.op:1:io_error]"]
    s.check_fired(list(s.fired))
    assert s.failures == ["[parquet.chunk:1:io_error] never fired: its "
                          "runs passed no armed seam"]


def test_trace_join_check_on_cpu(tmp_path):
    assert trace_join_check.main(["--device", "cpu",
                                  "--dir", str(tmp_path)]) == 0


def test_retry_log_keeps_no_exception(caplog):
    """A retried failure's log record carries its message, not the
    exception: a handler that keeps records (pytest's capture here) must
    not pin the failed attempt's frames and buffers (the soak's spill pass
    left its memmapped files behind through such a record)."""
    from spark_rapids_jni_tpu_torch.utils import errors
    calls = []

    def fn():
        if not calls:
            calls.append(1)
            raise errors.TransientError("boom")
        return 7
    with caplog.at_level("WARNING"):
        assert errors.retry_call(fn, "spill.write", backoff_s=0.0) == 7
    assert any("boom" in r.getMessage() for r in caplog.records)
    assert not any(isinstance(a, BaseException)
                   for r in caplog.records for a in (r.args or ()))


def test_parity_exact_close_and_diverged():
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    def table(k, v):
        return Table([Column.from_numpy(np.asarray(k, np.int64),
                                        device="cpu"),
                      Column.from_numpy(np.asarray(v, np.float64),
                                        device="cpu")], ["k", "v"])
    base = table([2, 1], [0.1 + 0.2, 5.0])
    assert chaos_soak.parity(base, table([1, 2], [5.0, 0.1 + 0.2]),
                             "k") == "bit-exact"
    assert chaos_soak.parity(base, table([1, 2], [5.0, 0.3]), 0) == "close"
    assert chaos_soak.parity(base, table([1, 2], [5.0, 0.3001]), "k") == ""
    assert chaos_soak.parity(base, table([1, 3], [5.0, 0.3]), "k") == ""
    assert chaos_soak.parity(base, table([1], [5.0]), "k") == ""
