"""The device server over ranks: rank 0 serves, every rank executes.

``python -m spark_rapids_jni_tpu_torch.bridge.server --ranks W --backend B
--devices d0,...`` runs rank 0 in the server's own process.  It starts
ranks 1 .. W-1 (``parallel/ranks.py::launch``), joins the group with them,
and only then binds its socket.  Rank 0 serves every op as the one-rank
server does, the small ops on its own device.  A ``PLAN_EXECUTE`` that
passes verification, the result cache and admission on rank 0 goes to the
group (``RankGroup.run``):

1. rank 0 sends one record on the group's control channel: the plan's
   bytes, the trace id, the seconds left to the query's deadline and the
   plan cache's decision (rank 0's ``PlanCache.holds``);
2. every rank runs ``PlanCache.get(plan, ranks=, hit=)`` (on a miss
   ``optimize(ranks=)``, where rank 0 plans) and ``execute(ranks=)`` with
   its own cancel token, which the ranks vote on at every chunk boundary
   and gather (engine/recovery.py), so a cancel or a deadline stops every
   rank at the same boundary;
3. every rank reports on the control channel: ok or the error's type, its
   kernel launches, row groups read and plan cache counts.  Rank 0 keeps
   the answer; the others drop theirs.

The control channel is a gloo group of the same ranks whose timeout is
years: an idle worker waits on it for the next record, and a rank that
dies closes its connections, so the others' waits raise at once.  The
data collectives keep the group's own timeout.

Kept deviations from the JAX server, which runs plans concurrently on one
process:

- **One plan at a time over the group**, in the order plans reach the
  group after admission on rank 0 (``RankGroup.turn``): two plans whose
  collectives interleave would deadlock or mix rows.  The scheduler still
  admits, queues and sheds on rank 0; the other ops, ``OP_CANCEL``,
  ``OP_QUERY_STATUS`` and ``OP_METRICS`` are answered while a plan runs.
- **The group's decisions.**  Rank 0 decides plan-cache hit or miss, and
  every rank follows it; the ranks' caches see the same calls in the same
  order, so they agree.  Cancellation and deadlines are voted on; the
  session's budget is the group's least.
- **A lost group stays lost.**  A rank whose process has ended, or a
  collective that failed (a peer gone, or the group's timeout passed,
  after which gloo's pairs are closed), loses the group: rank 0 aborts
  the group's NCCL communicators, stops the other ranks, that plan and
  every later ``PLAN_EXECUTE`` get ``RankGroupLostError`` (kind
  ``ranks_lost``) at once, and the small ops and the result cache keep
  serving.  Errors every rank sees together (rank 0's planning or
  verification error, a cancel, a deadline) leave the group serving.
- **Shared files.**  Only rank 0 writes the profile store; the other ranks
  name their post-mortem bundles with their rank.

How rank 0 learns that a rank died, and why it survives it: a watcher
thread on rank 0 looks at the other ranks' exit codes every ``WATCH_S``
seconds, plan or no plan, and loses the group the moment one has ended.
Under gloo a collective waiting on the dead rank raises at once anyway
(its connections close).  Under NCCL it would not: a collective's kernel
waits on the card for its peer, and rank 0 waits in a host sync behind
it until the group's timeout.  The watcher's abort (``ranks.abort``) ends
that kernel, and the plan's next collective raises; a plan that returns
after the group was lost is refused all the same, since its rows came
through an aborted communicator.  The NCCL group is made so that its
watchdog aborts on an error or a timeout instead of ending the process
(``ranks.init_ranks``): nothing that happens to the group ends rank 0,
which is the server.  A lost group is never re-formed, nor swapped for
gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
import threading
import time

import torch.distributed as dist

from .. import device as _device
from ..parallel import ranks as _ranks
from ..utils.errors import RankGroupLostError

#: the control channel's timeout: an idle server's workers wait on it
CONTROL_TIMEOUT = datetime.timedelta(days=3650)
#: seconds a data collective of the group may wait: a rank that fails
#: alone loses the group after this long
RANK_TIMEOUT_S = 120.0
#: seconds rank 0 waits for the other ranks to exit after the stop record
STOP_WAIT_S = 30.0
#: seconds a failed collective waits for a dead rank's exit code
DEATH_WAIT_S = 1.0
#: seconds between the watcher's looks at the ranks' exit codes
WATCH_S = 0.05


def control(ranks: _ranks.Ranks) -> _ranks.Ranks:
    """The group's control channel: a copy of ``ranks`` whose host group is
    a gloo group of the same ranks with ``CONTROL_TIMEOUT`` (every rank
    calls this once, in the same order; a one-rank group is its own)."""
    if not _ranks.active(ranks):
        return ranks
    return dataclasses.replace(ranks, host_group=dist.new_group(
        backend="gloo", timeout=CONTROL_TIMEOUT))


def _gather(obj, ctrl: _ranks.Ranks) -> list:
    """Every rank's ``obj`` in rank order, over the control channel."""
    if not _ranks.active(ctrl):
        return [obj]
    out = [None] * ctrl.world
    dist.all_gather_object(out, obj, group=ctrl.host_group)
    return out


class _OutOfStep(Exception):
    """A collective of the plan, or the report after it, failed."""


def _counters(prefix: str) -> dict:
    from ..utils import tracing
    return tracing.counters_snapshot(prefix)


def run_plan(ranks, ctrl, cache, plan, hit: bool, cancel, session=None,
             stats=None):
    """This rank's part of one plan: get or plan it, execute it, report.
    Returns ``(answer, error, reports)``: the answer (None on error), the
    error every rank saw together (None on success) and every rank's
    report.  Raises ``_OutOfStep`` when the group fell out of step."""
    from ..engine import new_stats
    stats = new_stats() if stats is None else stats
    before = _counters("kernel.")
    cards_before = _counters("kernel_device.")
    out = err = None
    try:
        out = cache.get(plan, ranks=ranks, hit=hit).execute(
            stats=stats, cancel=cancel, device=ranks.device,
            session=session, ranks=ranks)
    except Exception as e:  # noqa: BLE001 -- reported to the group
        if _ranks.is_group_failure(e):
            raise _OutOfStep(f"rank {ranks.rank}: {e}") from e
        err = e
    after = _counters("kernel.")
    cards_after = _counters("kernel_device.")
    report = {"rank": ranks.rank, "device": str(ranks.device),
              "ok": err is None,
              "error": "" if err is None else type(err).__name__,
              "launches": {k[len("kernel."):]: v - before.get(k, 0)
                           for k, v in after.items()},
              # "<kernel>.<device>": the cards this plan's kernels ran on
              "launch_devices": {
                  k[len("kernel_device."):]: v - cards_before.get(k, 0)
                  for k, v in cards_after.items()
                  if v > cards_before.get(k, 0)},
              "cards_with_tensors": _device.cards_with_tensors(),
              "row_groups_read": stats.get("row_groups_read", 0),
              "exchanges": stats.get("exchanges", 0),
              "plan_cache": cache.stats()}
    try:
        reports = _gather(report, ctrl)
    except Exception as e:
        raise _OutOfStep(f"rank {ranks.rank}: the report: {e}") from e
    return out, err, reports


class RankGroup:
    """Rank 0's side of the group: the ranks' process handles, the plan
    cache every rank mirrors, the turn plans take, and whether the group
    is live."""

    def __init__(self, ranks, ctrl, launched, devices):
        from ..engine.cache import PlanCache
        self.ranks = ranks
        self.ctrl = ctrl
        self.launched = launched
        self.devices = [str(d) for d in devices]
        self.cache = PlanCache()
        self.plans = 0
        self.lost = ""           # why the group was lost ("": live)
        self.last: list = []     # every rank's report of the last plan
        self._cv = threading.Condition()
        self._tickets = 0
        self._serving = 0
        self._lost_lock = threading.Lock()
        self._stopping = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name="rank-watcher")
        self._watcher.start()

    @contextlib.contextmanager
    def turn(self):
        """One plan over the group at a time, first come first served."""
        with self._cv:
            me = self._tickets
            self._tickets += 1
            while self._serving != me:
                self._cv.wait()
        try:
            yield
        finally:
            with self._cv:
                self._serving += 1
                self._cv.notify_all()

    def _dead(self, wait_s: float = 0.0) -> str:
        """Which ranks' processes have ended ("" for none), waiting up to
        ``wait_s`` for one: a killed process's threads take a moment to
        exit before its parent can reap it."""
        deadline = time.monotonic() + wait_s
        while True:
            codes = self.launched.exitcodes()
            dead = [f"rank {r} exited ({c})" for r, c in codes.items()
                    if c is not None]
            if dead or time.monotonic() >= deadline:
                return ", ".join(dead)
            time.sleep(0.01)

    def _watch(self) -> None:
        """Lose the group as soon as a rank's process has ended, until the
        group is lost or shut down."""
        while not self._stopping.wait(WATCH_S) and not self.lost:
            dead = self._dead()
            if dead and not self._stopping.is_set():
                self._lose(dead)

    def _lose(self, why: str) -> RankGroupLostError:
        """Mark the group lost (naming a rank that died, if one did), abort
        its NCCL communicators, stop what is left of it, and return the
        error every later plan gets."""
        with self._lost_lock:
            if not self.lost:
                self.lost = self._dead(DEATH_WAIT_S) or why
                _ranks.abort(self.ranks)
                self.launched.close()
        return RankGroupLostError(
            f"the server's group of {self.ranks.world} ranks is lost: "
            f"{self.lost}")

    def _check_live(self) -> None:
        if self.lost or self._dead():
            raise self._lose(self.lost)

    def run(self, blob: bytes, plan, trace_id: str, cancel, session,
            stats: dict):
        """Run one plan on every rank; rank 0's answer."""
        with self.turn():
            self._check_live()
            cancel.check()  # cancelled or expired while it waited
            hit = self.cache.holds(plan)
            rec = {"op": "plan", "blob": bytes(blob), "trace_id": trace_id,
                   "deadline_s": cancel.remaining_s(), "hit": hit}
            try:
                _ranks.broadcast_object(rec, self.ctrl)
            except Exception as e:
                raise self._lose(f"sending the plan failed: {e}") from e
            self.plans += 1
            try:
                out, err, self.last = run_plan(self.ranks, self.ctrl,
                                               self.cache, plan, hit,
                                               cancel, session, stats)
            except _OutOfStep as e:
                raise self._lose(str(e)) from e
            if self.lost:  # the watcher lost the group while it ran
                raise self._lose(self.lost)
        if err is not None:
            raise err
        return out

    def snapshot(self) -> dict:
        """OP_METRICS' ``ranks`` block."""
        return {"world": self.ranks.world, "backend": self.ranks.backend,
                "devices": self.devices,
                "pids": [os.getpid()] + [
                    self.launched.procs[r].pid
                    for r in sorted(self.launched.procs)],
                "plans": self.plans,
                "live": not (self.lost or self._dead()),
                "lost": self.lost,
                "last_plan": list(self.last)}

    def shutdown(self) -> None:
        """Send the stop record (when the group is live), wait for the
        other ranks to exit, reap them, and leave the group.  The watcher
        ends first: a thread still running when the interpreter exits can
        abort it."""
        with self.turn():
            self._stopping.set()
            self._watcher.join(timeout=STOP_WAIT_S)
            if not (self.lost or self._dead()):
                try:
                    _ranks.broadcast_object({"op": "stop"}, self.ctrl)
                    self.launched.wait(STOP_WAIT_S)
                except Exception:  # noqa: BLE001 -- reaped below
                    pass
            self.launched.close()
            _ranks.close_ranks()


def worker(ranks, settings: list) -> None:
    """Ranks 1 .. W-1: apply the server's settings, then run every plan
    record rank 0 sends until the stop record."""
    from ..engine import deserialize
    from ..engine.cache import PlanCache
    from ..utils import blackbox
    from ..utils.config import config, parse_setting
    from ..utils.errors import CancelToken
    for text in settings:
        name, value = parse_setting(text)
        setattr(config, name, value)
    config.profile_dir = ""  # rank 0 writes the profile store
    blackbox.set_rank(ranks.rank)
    ctrl = control(ranks)
    cache = PlanCache()
    while True:
        rec = _ranks.broadcast_object(None, ctrl)
        if rec["op"] == "stop":
            return
        plan = deserialize(rec["blob"])
        tok = CancelToken(rec["deadline_s"])
        with blackbox.query_scope(rec["trace_id"], label="plan_execute"):
            run_plan(ranks, ctrl, cache, plan, rec["hit"], tok)


def start(world: int, backend: str, devices: list,
          settings: list) -> RankGroup:
    """Start ranks 1 .. ``world`` - 1 and join the group as rank 0.  A rank
    that exits before the group has formed ends this process (its
    traceback on stderr), so a caller waiting for the socket sees the
    server die instead of waiting for the group's timeout."""
    launched = _ranks.launch(worker, world, backend, devices,
                             RANK_TIMEOUT_S, args=(list(settings),),
                             first=1)
    formed = threading.Event()

    def watch():
        while not formed.wait(0.1):
            ended = [r for r, c in launched.exitcodes().items()
                     if c is not None]
            if ended:
                print(f"bridge server: a rank exited before the group "
                      f"formed:\n{launched.failure(ended)}",
                      file=sys.stderr, flush=True)
                launched.close()
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    try:
        r0 = launched.join(0, devices[0])
        ctrl = control(r0)
    except BaseException:
        formed.set()
        launched.close()
        raise
    formed.set()
    return RankGroup(r0, ctrl, launched, devices)
