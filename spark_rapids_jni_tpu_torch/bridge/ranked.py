"""The device server over ranks: rank 0 serves, every rank executes.

``python -m spark_rapids_jni_tpu_torch.bridge.server --ranks W --backend B
--devices d0,...`` runs rank 0 in the server's own process.  It starts
ranks 1 .. W-1 (``parallel/ranks.py::launch``), joins the group with them,
and only then binds its socket.  Rank 0 serves every op as the one-rank
server does, the small ops on its own device.  A ``PLAN_EXECUTE`` that
passes verification, the result cache and admission on rank 0 goes to the
group with its session (``RankGroup.run``):

1. rank 0 gives the plan an id and sends one record on the group's
   control channel, under one send lock: the id, the plan's bytes, the
   trace id and the seconds left to the query's deadline.  Each other
   rank's dispatcher thread (``worker``) receives it and starts an
   execution thread for the plan, which binds the rank's card and opens
   its own trace scope and stats;
2. on every rank the plan waits for the group's turn (``TurnTable``).
   Holding it, every rank runs ``PlanCache.get(plan, ranks=, hit=)`` (on a
   miss ``optimize(ranks=)``, where rank 0 plans) and ``execute(ranks=)``
   with its own cancel token, which the ranks vote on at every chunk
   boundary and gather (engine/recovery.py);
3. holding the turn, every rank gathers its report on the host group: ok
   or the error's type, the kernel launches it made while it held the
   turn, row groups read and plan cache counts.  Rank 0 keeps the answer;
   the others drop theirs.

**Concurrent plans share one turn.**  Under NCCL a communicator runs its
collectives in the order they were issued, so two plans whose collectives
interleave differently on two ranks would deadlock or mix rows.  The group
keeps one turn and one order, decided by rank 0: the turn changes hands
only at points every rank already meets, the votes of the holding plan's
chunk boundaries and gathers and its closing report gather.  Rank 0's
row of that collective carries its scheduler's choice
(``Scheduler.pick``: deficit round robin over the sessions in flight,
``gate``'s step), numbered, and every rank applies rank 0's decisions in
rank 0's order (``parallel/ranks.py::Decisions``), so every plan's device
work and collectives reach every communicator in one order.  When the
group is idle the record names its plan itself.  A decision may name a
plan whose record a slow rank has not received yet; that rank waits for
the record (no other plan runs there meanwhile).  The decision that first
names a plan carries rank 0's plan-cache decision (``PlanCache.holds``),
taken then, so the ranks' caches see the same calls in the same order;
one that names a plan whose token tripped while it waited carries the
error, which every rank raises when the plan resumes.  The plans keep the
group's communicators: no communicator is made per plan.

Kept deviations from the JAX server, which runs plans concurrently on one
process:

- **No overlap between boundaries.**  Between two handoffs only the plan
  holding the turn issues device work and collectives on a rank; JAX's
  threads overlap there too.  A plan with no chunk boundary holds the turn
  from start to end, as JAX's gate lets it.  Prefetch producer threads
  read and stage outside the turn: they issue no collectives.  The
  scheduler still admits, queues and sheds on rank 0; ``OP_CANCEL``,
  ``OP_QUERY_STATUS``, ``OP_METRICS`` and the small ops are answered while
  plans run.  A group of one rank has no collective to order: its plans
  overlap as on the one-rank server, under ``gate``, and its reports count
  the launches of every plan that overlapped.
- **The group's decisions.**  Rank 0 decides the turn and plan-cache hit
  or miss, and every rank follows it.  Cancellation and deadlines are
  voted on; the session's budget is the group's least.
- **A lost group stays lost.**  A rank whose process has ended, or a
  collective that failed (a peer gone, or the group's timeout passed,
  after which gloo's pairs are closed), loses the group: rank 0 aborts
  the group's NCCL communicators, stops the other ranks, and every plan
  in flight, the holder and those waiting for the turn, and every later
  ``PLAN_EXECUTE`` get ``RankGroupLostError`` (kind ``ranks_lost``) at
  once, while the small ops and the result cache keep serving.  Errors
  every rank sees together (rank 0's planning or verification error, a
  cancel, a deadline) leave the group serving.  No plan falls back to
  running alone or to another backend.
- **Shared files.**  Only rank 0 writes the profile store; the other ranks
  name their post-mortem bundles with their rank.

How rank 0 learns that a rank died, and why it survives it: a watcher
thread on rank 0 looks at the other ranks' exit codes every ``WATCH_S``
seconds, plan or no plan, and loses the group the moment one has ended.
Under gloo a collective waiting on the dead rank raises at once anyway
(its connections close).  Under NCCL it would not: a collective's kernel
waits on the card for its peer, and rank 0 waits in a host sync behind
it until the group's timeout.  The watcher's abort (``ranks.abort``) ends
every kernel of the group's communicators, whichever plan issued it, and
the holder's next collective raises; the plans waiting for the turn wake
with the error.  A plan that returns after the group was lost is refused
all the same, since its rows came through an aborted communicator.  The
NCCL group is made so that its watchdog aborts on an error or a timeout
instead of ending the process (``ranks.init_ranks``): nothing that
happens to the group ends rank 0, which is the server.  A lost group is
never re-formed, nor swapped for gloo.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import os
import sys
import threading
import time

import torch.distributed as dist

from .. import device as _device
from ..parallel import ranks as _ranks
from ..utils.errors import (QueryCancelledError, QueryTimeoutError,
                            RankGroupLostError)

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
#: plans whose reports OP_METRICS keeps, by trace id, the newest last
RECENT_PLANS = 32


def control(ranks: _ranks.Ranks) -> _ranks.Ranks:
    """The group's control channel: a copy of ``ranks`` whose host group is
    a gloo group of the same ranks with ``CONTROL_TIMEOUT`` (every rank
    calls this once, in the same order; a one-rank group is its own)."""
    if not _ranks.active(ranks):
        return ranks
    return dataclasses.replace(ranks, host_group=dist.new_group(
        backend="gloo", timeout=CONTROL_TIMEOUT))


class _OutOfStep(Exception):
    """A collective of the plan, or the report after it, failed."""


def _counters() -> dict:
    """The process's kernel launch counters (``kernel.*`` and
    ``kernel_device.*``)."""
    from ..utils import tracing
    return tracing.counters_snapshot("kernel")


#: a decision's error codes: the token of the plan it names tripped
_CANCELLED, _EXPIRED = 1, 2


def _error_code(tok) -> int:
    if tok is None:
        return 0
    return _CANCELLED if tok.cancelled else _EXPIRED if tok.expired else 0


class TurnTable:
    """Every rank's table of the group's turn: which plan holds it here
    (``holder``, 0 for none), what the decision that last named each plan
    carried, how often the turn passed from one plan to another, and
    whether the group is lost.  Rank 0's decisions reach it through
    ``decisions`` (``parallel/ranks.py::Decisions``), in rank 0's order."""

    def __init__(self):
        self._cv = threading.Condition()
        self.holder = 0
        self.handoffs = 0
        self.lost = ""
        self._named: dict = {}   # pid -> (error code, plan-cache hit)
        self.decisions = _ranks.Decisions(self._apply)

    def _apply(self, decision) -> None:
        _, pid, err, hit = decision
        with self._cv:
            if self.holder and pid and pid != self.holder:
                self.handoffs += 1
            self.holder = pid
            if pid:
                self._named[pid] = (err, hit)
            self._cv.notify_all()

    def wait(self, pid: int) -> tuple:
        """Block until plan ``pid`` holds the turn; the error code and the
        plan-cache hit (-1: none) of the decision that named it, or
        ``(0, -1)`` when it kept the turn.  Raises when the group is
        lost."""
        with self._cv:
            while self.holder != pid and not self.lost:
                self._cv.wait()
            if self.lost:
                raise RankGroupLostError(f"the group is lost: {self.lost}")
            return self._named.pop(pid, (0, -1))

    def lose(self, why: str) -> None:
        """Wake every plan waiting for the turn with the group's loss."""
        with self._cv:
            self.lost = self.lost or why or "lost"
            self._cv.notify_all()


class Seat:
    """One plan's place at the group's turn on one rank: the ``turn`` of
    the ``Ranks`` its execution runs under.  Its votes (engine/recovery.py)
    and its closing report carry rank 0's decision and hand the turn over;
    it counts the kernels this rank launched while the plan held the turn.
    ``decide`` is rank 0's ``RankGroup._decide`` (None elsewhere)."""

    def __init__(self, table: TurnTable, ranks, pid: int, cancel,
                 decide=None):
        self.table = table
        self.ranks = ranks
        self.pid = pid
        self.cancel = cancel
        self._decide = decide
        self.tally: dict = {}
        self._mark: dict = {}

    def acquire(self):
        """Wait for the turn and start counting; rank 0's plan-cache hit
        when this is the plan's first turn (None otherwise).  Raises the
        error the decision named the plan with."""
        err, hit = self.table.wait(self.pid)
        self._mark = _counters()
        if err:
            tok = self.cancel
            if err == _CANCELLED:
                if tok is not None and tok.cancelled:
                    tok.check()  # this rank's own message
                raise QueryCancelledError(
                    "query cancelled: cancelled on rank 0 while it waited "
                    "for the group's turn")
            raise QueryTimeoutError("query deadline exceeded")
        return None if hit < 0 else bool(hit)

    def tally_launches(self) -> None:
        """Add this rank's launches since the plan took the turn to its
        tally (the turn is about to pass, or the plan reports)."""
        now = _counters()
        for k, v in now.items():
            self.tally[k] = self.tally.get(k, 0) + v - self._mark.get(k, 0)
        self._mark = now

    def vote(self, row: list) -> list:
        """One vote of the plan (``host_gather_ints`` of ``row``) with rank
        0's decision on it; when that hands the turn to another plan,
        returns once the turn is back."""
        mine = self._decide(self.pid, False) if self._decide else None
        votes, got = _ranks.host_gather_decided(row, mine, self.ranks)
        passes = got[0] and got[1] != self.pid
        if passes:
            self.tally_launches()
        self.table.decisions.deliver(got)
        if passes:
            self.acquire()
        return votes

    def report(self, report: dict) -> list:
        """Every rank's report in rank order, gathered on the host group
        with rank 0's last decision for this plan, which passes the turn
        on."""
        mine = self._decide(self.pid, True) if self._decide else None
        out = [None] * self.ranks.world
        dist.all_gather_object(out, {**report, "turn": mine},
                               group=self.ranks.host_group)
        self.table.decisions.deliver(out[0]["turn"])
        for r in out:
            del r["turn"]
        return out


def run_plan(ranks, cache, plan, cancel, seat=None, session=None,
             stats=None):
    """This rank's part of one plan: with a ``seat``, wait for the group's
    turn; get or plan it, execute it, report.  Returns ``(answer, error,
    reports)``: the answer (None on error), the error every rank saw
    together (None on success) and every rank's report.  Raises
    ``_OutOfStep`` when the group fell out of step and
    ``RankGroupLostError`` when it was lost while the plan waited.
    Without a seat (a group of one rank) the plan overlaps others and its
    counts are the process's over the plan's run."""
    from ..engine import new_stats
    stats = new_stats() if stats is None else stats
    before = _counters()
    out = err = None
    try:
        hit, run_ranks = None, ranks
        if seat is not None:
            hit = seat.acquire()
            run_ranks = dataclasses.replace(ranks, turn=seat)
        out = cache.get(plan, ranks=run_ranks, hit=hit).execute(
            stats=stats, cancel=cancel, device=ranks.device,
            session=session, ranks=run_ranks)
    except RankGroupLostError:
        raise
    except Exception as e:  # noqa: BLE001 -- reported to the group
        if _ranks.is_group_failure(e):
            raise _OutOfStep(f"rank {ranks.rank}: {e}") from e
        err = e
    if seat is not None:
        seat.tally_launches()
        counts = seat.tally
    else:
        after = _counters()
        counts = {k: v - before.get(k, 0) for k, v in after.items()}
    report = {"rank": ranks.rank, "device": str(ranks.device),
              "ok": err is None,
              "error": "" if err is None else type(err).__name__,
              "launches": {k[len("kernel."):]: v for k, v in counts.items()
                           if k.startswith("kernel.")},
              # "<kernel>.<device>": the cards this plan's kernels ran on
              "launch_devices": {k[len("kernel_device."):]: v
                                 for k, v in counts.items()
                                 if k.startswith("kernel_device.") and v > 0},
              "cards_with_tensors": _device.cards_with_tensors(),
              "row_groups_read": stats.get("row_groups_read", 0),
              "exchanges": stats.get("exchanges", 0),
              "plan_cache": cache.stats()}
    if seat is None:
        return out, err, [report]
    try:
        reports = seat.report(report)
    except Exception as e:
        raise _OutOfStep(f"rank {ranks.rank}: the report: {e}") from e
    return out, err, reports


class _Flight:
    """Rank 0's record of one plan in flight over the group."""

    __slots__ = ("pid", "plan", "cancel", "session", "named", "stamp")

    def __init__(self, plan, cancel, session):
        self.pid = 0
        self.plan = plan
        self.cancel = cancel
        self.session = session
        self.named = False   # it has been named once (its first turn)
        self.stamp = 0       # when it was last named: rotation order


class RankGroup:
    """Rank 0's side of the group: the ranks' process handles, the plan
    cache every rank mirrors, the plans in flight and the turn they share,
    and whether the group is live."""

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
        #: {"trace_id", "reports"} of the plans that ended last
        self.recent: collections.deque = collections.deque(
            maxlen=RECENT_PLANS)
        self.table = TurnTable()
        self._send = threading.Lock()    # one sender on the control channel
        self._sched = threading.Lock()   # the flights and rank 0's choices
        self._flight: dict = {}          # pid -> _Flight
        self._decided = 0                # the plan the last decision named
        self._pids = itertools.count(1)
        self._stamps = itertools.count()
        self._closing = False
        self._lost_lock = threading.Lock()
        self._stopping = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name="rank-watcher")
        self._watcher.start()

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
        its NCCL communicators, stop what is left of it, wake every plan
        waiting for the turn, and return the error every plan gets."""
        with self._lost_lock:
            if not self.lost:
                self.lost = self._dead(DEATH_WAIT_S) or why
                _ranks.abort(self.ranks)
                self.launched.close()
                self.table.lose(self.lost)
        return RankGroupLostError(
            f"the server's group of {self.ranks.world} ranks is lost: "
            f"{self.lost}")

    def _check_live(self) -> None:
        if self.lost or self._dead():
            raise self._lose(self.lost)

    # -- rank 0's choices (under ``_sched``) ---------------------------------

    def _name(self, f) -> list:
        """The decision that hands the turn to ``f`` (None: nobody)."""
        if f is None:
            self._decided = 0
            return self.table.decisions.issue(0, 0, -1)
        f.stamp = next(self._stamps)
        hit = -1
        if not f.named:
            f.named = True
            hit = int(self.cache.holds(f.plan))
        self._decided = f.pid
        return self.table.decisions.issue(f.pid, _error_code(f.cancel), hit)

    def _decide(self, pid: int, done: bool):
        """Rank 0, at a vote (``done`` False) or the closing report of the
        plan ``pid`` that holds the turn: the decision its collective
        carries, or None when the plan keeps the turn.  A plan whose token
        tripped keeps the turn, or takes it first when it waits, so that
        its error ends it; otherwise the scheduler's ``pick``."""
        from ..engine.scheduler import SCHEDULER
        with self._sched:
            me = self._flight.pop(pid) if done else self._flight[pid]
            waiting = sorted((f for f in self._flight.values()
                              if f.pid != pid), key=lambda f: f.stamp)
            holding = None if done else me
            if holding is not None and _error_code(holding.cancel):
                return None
            nxt = next((f for f in waiting if _error_code(f.cancel)), None)
            if nxt is None:
                s = SCHEDULER.pick(None if holding is None
                                   else holding.session,
                                   [f.session for f in waiting])
                nxt = next((f for f in ([me] if holding else []) + waiting
                            if f.session is s), None)
            if holding is not None and nxt is holding:
                return None  # it keeps the turn
            return self._name(nxt)

    # -- plans ---------------------------------------------------------------

    def run(self, blob: bytes, plan, trace_id: str, cancel, session,
            stats: dict):
        """Run one plan on every rank, beside the plans already in flight;
        rank 0's answer."""
        self._check_live()
        from ..engine.scheduler import SCHEDULER, QuerySession
        f = _Flight(plan, cancel,
                    session if session is not None
                    else QuerySession(0, SCHEDULER))
        seat = None
        with self._send:
            self._check_live()
            if self._closing:
                raise RankGroupLostError("the server's group is shutting "
                                         "down")
            cancel.check()  # cancelled or expired in admission
            first = None
            with self._sched:
                f.pid = next(self._pids)
                f.stamp = next(self._stamps)
                self._flight[f.pid] = f
                self.plans += 1
                if _ranks.active(self.ranks) and not self._decided:
                    first = self._name(f)  # an idle group: its turn now
        try:
            if _ranks.active(self.ranks):
                seat = Seat(self.table, self.ranks, f.pid, cancel,
                            self._decide)
                self._send_record(f.pid, blob, trace_id, cancel, first)
            out, err, reports = run_plan(self.ranks, self.cache, plan,
                                         cancel, seat, session, stats)
        except _OutOfStep as e:
            raise self._lose(str(e)) from e
        except RankGroupLostError as e:
            raise self._lose(str(e)) from e
        finally:
            with self._sched:
                self._flight.pop(f.pid, None)
        if self.lost:  # the watcher lost the group while it ran
            raise self._lose(self.lost)
        self.last = reports
        self.recent.append({"trace_id": trace_id, "reports": reports})
        if err is not None:
            raise err
        return out

    def _send_record(self, pid, blob, trace_id, cancel, first) -> None:
        """Plan ``pid``'s record on the control channel, with the decision
        ``first`` when it takes an idle group's turn; a failed send loses
        the group."""
        rec = {"op": "plan", "pid": pid, "blob": bytes(blob),
               "trace_id": trace_id, "deadline_s": cancel.remaining_s(),
               "turn": first}
        with self._send:
            try:
                _ranks.broadcast_object(rec, self.ctrl)
            except Exception as e:
                raise self._lose(f"sending the plan failed: {e}") from e
        self.table.decisions.deliver(first)

    def snapshot(self) -> dict:
        """OP_METRICS' ``ranks`` block."""
        with self._sched:
            in_flight = len(self._flight)
        return {"world": self.ranks.world, "backend": self.ranks.backend,
                "devices": self.devices,
                "pids": [os.getpid()] + [
                    self.launched.procs[r].pid
                    for r in sorted(self.launched.procs)],
                "plans": self.plans,
                "in_flight": in_flight,
                "handoffs": self.table.handoffs,
                "live": not (self.lost or self._dead()),
                "lost": self.lost,
                "last_plan": list(self.last),
                "recent": list(self.recent)}

    def _drain(self, seconds: float) -> bool:
        """Wait up to ``seconds`` for the plans in flight to end; True
        when none is left."""
        deadline = time.monotonic() + seconds
        while self._flight and time.monotonic() < deadline:
            time.sleep(0.01)
        return not self._flight

    def shutdown(self) -> None:
        """Refuse new plans, let the plans in flight end (or fail them by
        losing the group after ``STOP_WAIT_S``), send the stop record
        (when the group is live), wait for the other ranks to exit, reap
        them, and leave the group.  The watcher ends first: a thread still
        running when the interpreter exits can abort it."""
        with self._send:
            self._closing = True
        if not self._drain(STOP_WAIT_S):
            self._lose(f"shut down with {len(self._flight)} plan(s) in "
                       "flight")
            self._drain(STOP_WAIT_S)
        self._stopping.set()
        self._watcher.join(timeout=STOP_WAIT_S)
        if not (self.lost or self._dead()):
            try:
                with self._send:
                    _ranks.broadcast_object({"op": "stop"}, self.ctrl)
                self.launched.wait(STOP_WAIT_S)
            except Exception:  # noqa: BLE001 -- reaped below
                pass
        self.launched.close()
        _ranks.close_ranks()


def _execute(ranks, table: TurnTable, cache, rec: dict) -> None:
    """A rank's execution thread for one plan record: bind the card, open
    the plan's trace scope, run it under the turn.  A failure here leaves
    the group out of step: the process ends, and rank 0 loses the
    group."""
    import traceback
    from ..engine import deserialize
    from ..utils import blackbox
    from ..utils.errors import CancelToken
    try:
        _device.bind(ranks.device)
        tok = CancelToken(rec["deadline_s"])
        with blackbox.query_scope(rec["trace_id"], label="plan_execute"):
            run_plan(ranks, cache, deserialize(rec["blob"]), tok,
                     Seat(table, ranks, rec["pid"], tok))
    except _OutOfStep as e:  # a peer is gone: one line, not a traceback
        print(f"bridge server: the group fell out of step: {e}",
              file=sys.stderr, flush=True)
        os._exit(1)
    except BaseException:  # noqa: BLE001 -- the group is out of step
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def worker(ranks, settings: list) -> None:
    """Ranks 1 .. W-1: apply the server's settings, then dispatch every
    plan record rank 0 sends to an execution thread of its own, until the
    stop record (rank 0 sends it once no plan is in flight)."""
    from ..engine.cache import PlanCache
    from ..utils import blackbox
    from ..utils.config import config, parse_setting
    for text in settings:
        name, value = parse_setting(text)
        setattr(config, name, value)
    config.profile_dir = ""  # rank 0 writes the profile store
    blackbox.set_rank(ranks.rank)
    ctrl = control(ranks)
    cache = PlanCache()
    table = TurnTable()
    threads: list = []
    while True:
        rec = _ranks.broadcast_object(None, ctrl)
        if rec["op"] == "stop":
            break
        table.decisions.deliver(rec["turn"])
        t = threading.Thread(target=_execute,
                             args=(ranks, table, cache, rec), daemon=True,
                             name=f"plan-{rec['pid']}")
        t.start()
        threads = [x for x in threads if x.is_alive()] + [t]
    for t in threads:
        t.join()


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
