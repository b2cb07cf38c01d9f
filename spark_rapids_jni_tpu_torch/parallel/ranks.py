"""Ranks: the mesh's shards spread over processes, one rank a card.

The JAX package's mesh spans ``jax.devices()`` under one controller
(``spark_rapids_jni_tpu/parallel/mesh.py``); PyTorch runs one process a
card, with ``torch.distributed`` moving the rows between them.  A mesh of
``N`` shards over ``W`` ranks gives rank ``r`` the shards ``[r * N / W,
(r + 1) * N / W)`` on its own device, and the ranks' row blocks put
together in rank order are the one-process table.

- ``init_ranks`` joins a process group.  The backend is the caller's:
  ``"nccl"`` (one rank a card) or ``"gloo"`` (host-staged; it also takes
  CPU tensors, and several ranks may share a card).  NCCL is refused,
  before it can hang, on a CPU device or for two ranks of one device; the
  library never swaps one backend for the other.
- ``spawn`` runs a function on ``world`` fresh processes over a
  ``FileStore`` (no TCP port) and returns each rank's result, raising when
  any rank fails or the whole run outlasts its timeout.
- The collectives the exchange layer needs: row gathers of unequal blocks,
  the equal-split all-to-all, sums and maxima, and ``on_root`` (one rank
  computes, every rank receives, a failure reaches every rank).  Data
  moves on the group's backend; host-known numbers (row counts, widths,
  a plan) move on a gloo group of the same ranks, so no card sync is
  spent on them.

With no group, or a group of one rank, every helper is the identity.  The
group is always an argument (``make_mesh(ranks=)``, ``optimize(ranks=)``,
``execute(ranks=)``), never a process-wide setting: a call that names no
group runs in its process alone and waits on no other rank.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .. import device as _device

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True, eq=False)
class Ranks:
    """This process's place in a process group."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: object = field(repr=False)       # moves the rows
    host_group: object = field(repr=False)  # gloo: host-known numbers


def check_nccl_devices(device: torch.device, ids: list) -> None:
    """Refuse what NCCL would hang on: a CPU device, or two ranks whose
    devices (``ids``, one a rank) are the same card."""
    if device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device a rank, got {device}")
    seen = {}
    for r, d in enumerate(ids):
        if d in seen:
            raise ValueError(
                f"NCCL refuses two ranks on one device: ranks {seen[d]} "
                f"and {r} both hold {d}; run one rank a card, or gloo")
        seen[d] = r


def _store(init_method: str, world: int):
    """The group's rendezvous: a file every rank can reach (no port)."""
    if not init_method.startswith("file://"):
        raise ValueError(f"init_method must be file://<path>, got "
                         f"{init_method!r}")
    return dist.FileStore(init_method[len("file://"):], world)


def init_ranks(backend: str, rank: int, world: int, init_method: str,
               device=_device.DEFAULT, timeout: float = 120.0) -> Ranks:
    """Join the process group of ``world`` ranks as ``rank`` on ``device``
    and return it (the entry points take it as their ``ranks``).
    ``init_method`` is ``file://<path>`` of a file every rank reaches;
    ``timeout`` (seconds) bounds every collective: when a rank dies, the
    others raise."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = _device.resolve(device)
    if backend == "nccl" and dev.type != "cuda":
        check_nccl_devices(dev, [])
    td = datetime.timedelta(seconds=float(timeout))
    store = _store(init_method, world)
    if backend == "nccl":
        torch.cuda.set_device(dev)
        props = torch.cuda.get_device_properties(dev)
        me = str(getattr(props, "uuid", None) or
                 getattr(props, "pci_bus_id", None) or dev.index)
        store.set(f"ranks/device/{rank}", me)
        keys = [f"ranks/device/{r}" for r in range(world)]
        store.wait(keys, td)
        check_nccl_devices(dev, [store.get(k).decode() for k in keys])
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=td,
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    group = dist.group.WORLD
    host = group if backend == "gloo" else \
        dist.new_group(backend="gloo", timeout=td)
    return Ranks(rank, world, backend, dev, group, host)


def close_ranks() -> None:
    """Leave the group this process joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def active(ranks: Ranks | None) -> bool:
    """True when rows cross processes: a group of two ranks or more."""
    return ranks is not None and ranks.world > 1


# -- collectives ------------------------------------------------------------

def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as one flat uint8 tensor (every backend moves
    uint8; gloo takes few other types)."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        return t.view(torch.uint8).reshape(-1)
    return t.reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, rows: int):
    shape = (rows,) + tuple(like.shape[1:])
    if like.dtype == torch.bool:
        return b.view(torch.bool).reshape(shape)
    return b.view(like.dtype).reshape(shape)


def host_gather_ints(values, ranks: Ranks) -> list:
    """Every rank's list of ints (the same length on every rank), in rank
    order: ``[[...] of rank 0, [...] of rank 1, ...]``."""
    vals = [int(v) for v in values]
    if not active(ranks):
        return [vals]
    t = torch.tensor(vals, dtype=torch.int64)
    out = [torch.empty_like(t) for _ in range(ranks.world)]
    dist.all_gather(out, t, group=ranks.host_group)
    return [o.tolist() for o in out]


def host_max(value: int, ranks: Ranks) -> int:
    return max(v[0] for v in host_gather_ints([value], ranks))


def host_sum(value: int, ranks: Ranks) -> int:
    return sum(v[0] for v in host_gather_ints([value], ranks))


def broadcast_object(obj, ranks: Ranks, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled over the host group)."""
    if not active(ranks):
        return obj
    box = [obj if ranks.rank == src else None]
    dist.broadcast_object_list(box, src=src, group=ranks.host_group)
    return box[0]


class _Failed:
    """What ``on_root`` sends in place of a result when ``fn`` raised."""

    def __init__(self, error: BaseException):
        self.error = error


def _portable(e: Exception) -> Exception:
    """``e`` itself when it survives pickling, else a RuntimeError naming
    it."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def on_root(fn, ranks: Ranks, src: int = 0):
    """``fn()`` run on rank ``src`` alone, its result sent to every rank.
    When ``fn`` raises there (or its result does not pickle), every other
    rank raises the same error at once instead of waiting for a result
    until the group's timeout."""
    if not active(ranks):
        return fn()
    if ranks.rank != src:
        got = pickle.loads(broadcast_object(None, ranks, src))
        if isinstance(got, _Failed):
            got.error.add_note(f"raised on rank {src}")
            raise got.error
        return got
    try:
        blob = pickle.dumps(fn())
    except Exception as e:
        broadcast_object(pickle.dumps(_Failed(_portable(e))), ranks, src)
        raise
    broadcast_object(blob, ranks, src)
    return pickle.loads(blob)


def all_reduce(t: torch.Tensor, ranks: Ranks, op: str = "sum"):
    """The sum (or ``"max"``) of a device tensor over the ranks, without a
    host sync on NCCL."""
    if not active(ranks):
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=ranks.group)
    return out


def all_gather_rows(t: torch.Tensor, ranks: Ranks, lens=None):
    """The ranks' tensors concatenated along dim 0 in rank order; blocks
    may differ in length (``lens``: every rank's length when the caller
    knows them, else one host gather finds them)."""
    if not active(ranks):
        return t
    if lens is None:
        lens = [v[0] for v in host_gather_ints([t.shape[0]], ranks)]
    m = max(lens)
    if m == 0:
        return t[:0]
    if t.shape[0] < m:
        t = torch.cat([t, t.new_zeros((m - t.shape[0],) + tuple(t.shape[1:]))])
    b = _bytes(t)
    out = [torch.empty_like(b) for _ in range(ranks.world)]
    dist.all_gather(out, b, group=ranks.group)
    return torch.cat([_from_bytes(o, t, m)[:n] for o, n in zip(out, lens)])


def all_to_all(send: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """Equal-split all-to-all: ``send`` is ``(world, ...)``, block ``d``
    goes to rank ``d``; returns ``(world, ...)``, block ``s`` from rank
    ``s``."""
    if not active(ranks):
        return send
    b = _bytes(send)
    out = torch.empty_like(b)
    dist.all_to_all_single(out, b, group=ranks.group)
    return _from_bytes(out, send, send.shape[0])


# -- the launcher -----------------------------------------------------------

def _child(fn, rank, world, backend, device, store, timeout, args, out):
    """One rank: join, run ``fn(ranks, *args)``, leave its result (host
    objects: tensors come back on the CPU) or its traceback in ``out``."""
    code = 0
    try:
        ranks = init_ranks(backend, rank, world, f"file://{store}", device,
                           timeout)
        res = _to_host(fn(ranks, *args))
        with open(os.path.join(out, f"result-{rank}.tmp"), "wb") as f:
            pickle.dump(res, f)
        os.replace(os.path.join(out, f"result-{rank}.tmp"),
                   os.path.join(out, f"result-{rank}.pkl"))
    except BaseException:
        code = 1
        with open(os.path.join(out, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
    finally:
        try:
            close_ranks()
        except Exception:
            pass
    os._exit(code)


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def spawn(fn, world: int, backend: str, devices, timeout: float = 120.0,
          args: tuple = ()) -> list:
    """Run ``fn(ranks, *args)`` on ``world`` new processes, rank ``r`` on
    ``devices[r]``, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function of a module
    that a fresh interpreter can import).  The group's collectives time
    out after ``timeout`` seconds; the launcher waits that long plus the
    processes' start, and raises when a rank fails (its traceback in the
    message) or the run outlasts that, after stopping every rank."""
    import torch.multiprocessing as mp
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    work = tempfile.mkdtemp(prefix="ranks-")
    store = os.path.join(work, "store")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, backend, str(devices[r]),
                               store, timeout, args, work))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + float(timeout) + 60.0
        while any(p.exitcode is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(work, failed, procs))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks still running after {timeout:.0f} s + start: "
                    + _failure(work, range(world), procs))
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(work, failed, procs))
        out = []
        for r in range(world):
            with open(os.path.join(work, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.exitcode is None:
                p.kill()
        for p in started:
            p.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)


def _failure(work, ranks_, procs) -> str:
    parts = []
    for r in ranks_:
        path = os.path.join(work, f"error-{r}.txt")
        text = open(path).read() if os.path.exists(path) else ""
        parts.append(f"rank {r} (exit {procs[r].exitcode}): {text}".strip())
    return "\n".join(parts)
