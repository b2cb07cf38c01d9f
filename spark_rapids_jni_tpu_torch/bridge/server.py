"""The device server: handle-table owner and op dispatcher on the card.

The port of ``spark_rapids_jni_tpu/bridge/server.py``.  Where the
reference's ``RowConversionJni.cpp`` unwraps a jlong into a
``cudf::table_view*`` in the same address space, this server owns a
``HandleTable`` mapping opaque u64 ids to the port's ``Table`` / ``Column``
objects, whose tensors live on the server's device, and executes ops named
by opcode.  Per-op traffic is handles only; bulk host columns stage through
shared memory at import and export (``shm.py``), so the JAX package's
``BridgeClient``, the C ABI (``src/main/cpp/src/tpubridge.cpp``) and the
Java classes reach this server unchanged.

Error discipline mirrors ``CATCH_STD`` + ``JNI_NULL_CHECK``: every dispatch
is wrapped, and a failure returns ``STATUS_ERROR`` with the taxonomy
document (``utils/errors.to_wire``) or the structured plan-verification
document; an unknown handle is a ``KeyError`` reply, never a crash.  An op
that fails on the card comes back as that error: nothing retries it on the
CPU.

Threads and streams: one thread per connection.  Each connection thread
binds the server's card before it serves (``device.bind``: a new thread
starts on card 0, and a rank's card may be another), and every thread
uses that device's current (default) CUDA stream, so tensors crossing
between connections through the handle table need no stream bookkeeping.

Run: ``python -m spark_rapids_jni_tpu_torch.bridge.server --socket S
[--device cpu] [--set field=value ...]`` (``--device`` defaults to
``cuda``; ``--set`` assigns a field of ``utils.config.config``).  With
``--ranks W --backend {nccl,gloo} --devices d0,d1,...`` the server spreads
over a group of ``W`` processes, one rank a device: rank 0 serves the
socket and every rank executes each ``PLAN_EXECUTE`` (``ranked.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import struct
import threading
import time

import torch

from .. import device as _device
from ..columnar import Column, Table
from ..dtypes import DType, TypeId
from . import protocol as P
from . import shm as shmlib

_log = logging.getLogger(__name__)


def _error_body(e: Exception, trace_id: str = "", bundle: str = "") -> bytes:
    """STATUS_ERROR payload for one failed op.

    Plan-verification failures ship as a JSON document carrying the check
    code and node path (the client reconstructs a
    ``PlanVerificationError``); everything else ships the error-taxonomy
    JSON (kind, retryable bit, type, message: ``utils.errors.to_wire``), so
    the client can rebuild a typed error.  Both carry the trace id and the
    post-mortem bundle path when known."""
    from ..engine.verify import PlanVerificationError
    if isinstance(e, PlanVerificationError):
        doc = {"error": "plan_verification", **e.to_dict()}
    else:
        from ..utils import errors
        doc = errors.to_wire(e)
    if trace_id and not doc.get("trace_id"):
        doc["trace_id"] = trace_id
    if bundle and not doc.get("bundle"):
        doc["bundle"] = bundle
    return json.dumps(doc).encode()


class HandleTable:
    """u64 id -> device object; the process-local analog of JNI jlong
    handles.  Locked: concurrent ``PLAN_EXECUTE`` bodies write it from
    many connection threads, and ``put``'s allocate-then-store must be
    atomic."""

    def __init__(self):
        self._next = 1
        self._objs: dict[int, object] = {}
        self._lock = threading.Lock()

    def put(self, obj) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._objs[h] = obj
        return h

    def get(self, h: int):
        with self._lock:
            obj = self._objs.get(h)
        if obj is None:
            raise KeyError(f"invalid or released handle {h}")
        return obj

    def release(self, h: int) -> None:
        with self._lock:
            gone = self._objs.pop(h, None) is None
        if gone:
            raise KeyError(f"invalid or released handle {h}")

    def live_count(self) -> int:
        with self._lock:
            return len(self._objs)


class BridgeServer:
    """Serves many clients concurrently (a thread per connection).

    ``_dispatch_lock`` serializes the small ops (handle plumbing, imports
    and exports, the per-op engine calls).  ``PLAN_EXECUTE`` runs outside
    it: whole plans run for seconds, the engine below is
    concurrency-safe (locked caches, per-query metrics contexts), and the
    scheduler (``engine/scheduler.py``) provides admission control and
    chunk interleaving.  ``OP_CANCEL``, ``OP_QUERY_STATUS`` and
    ``OP_SHUTDOWN`` never take the lock, so they reach a running plan.
    The shared state a concurrent plan touches (handle table, export map,
    op counters, cancel registry) is individually locked."""

    def __init__(self, sock_path: str, device=_device.DEFAULT, group=None):
        self.sock_path = sock_path
        self.device = _device.resolve(device)
        # the ranks every PLAN_EXECUTE runs on (ranked.RankGroup; None:
        # this process alone)
        self.group = group
        self.handles = HandleTable()
        self._exports_lock = threading.Lock()
        self._exports: dict[str, object] = {}  # shm name -> mmap
        self._exp_counter = 0
        self._dispatch_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._conns_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        # live CancelTokens of in-flight PLAN_EXECUTEs -> their trace id
        self._tokens_lock = threading.Lock()
        self._active_tokens: dict[object, str] = {}
        self._metrics_lock = threading.Lock()
        self._metrics = {"ops": {}, "errors": 0, "busy_s": 0.0}
        self._plan_cache = None  # built on the first PLAN_EXECUTE
        self._last_plan_stats: dict = {}
        self._last_plan_summary: dict = {}

    # -- handle plumbing ---------------------------------------------------
    def _get_table(self, h: int) -> Table:
        t = self.handles.get(h)
        if not isinstance(t, Table):
            raise TypeError(f"handle {h} is not a table")
        return t

    def _get_col(self, h: int) -> Column:
        c = self.handles.get(h)
        if isinstance(c, Table):
            if c.num_columns != 1:
                raise TypeError(f"handle {h} is a {c.num_columns}-column "
                                "table, not a column")
            return c.columns[0]
        if not isinstance(c, Column):
            raise TypeError(f"handle {h} is not a column")
        return c

    def _put(self, obj) -> bytes:
        return struct.pack("<Q", self.handles.put(obj))

    def _new_export(self) -> shmlib.SegmentWriter:
        with self._exports_lock:
            self._exp_counter += 1
            n = self._exp_counter
        return shmlib.SegmentWriter(f"tpub-exp-{os.getpid()}-{n}")

    def _publish(self, exp: shmlib.SegmentWriter) -> bytes:
        """Write the export segment; keep it mapped until OP_FREE_SHM."""
        m = exp.finish()
        with self._exports_lock:
            self._exports[exp.name] = m
        nameb = exp.name.encode()
        return struct.pack("<I", len(nameb)) + nameb

    # -- row conversion and transfer ---------------------------------------
    def _op_import_table(self, payload: bytes) -> bytes:
        (nlen,) = struct.unpack_from("<I", payload, 0)
        name = payload[4:4 + nlen].decode()
        (ncols,) = struct.unpack_from("<I", payload, 4 + nlen)
        buf = shmlib.attach(name)
        try:
            cols, _ = shmlib.read_columns(payload, 8 + nlen, ncols, buf,
                                          self.device)
        finally:
            buf.close()
        return self._put(Table(cols))

    def _op_to_rows(self, payload: bytes) -> bytes:
        (h,) = struct.unpack_from("<Q", payload)
        table = self._get_table(h)
        from ..ops.row_conversion import convert_to_rows
        blobs = convert_to_rows(table, device=self.device)
        out = [self.handles.put(b) for b in blobs]
        return struct.pack("<I", len(out)) + b"".join(
            struct.pack("<Q", x) for x in out)

    def _op_from_rows(self, payload: bytes) -> bytes:
        h, ncols = struct.unpack_from("<QI", payload)
        col = self.handles.get(h)
        if not isinstance(col, Column):
            raise TypeError(f"handle {h} is not a column")
        schema = [DType(TypeId(tid), scale) for tid, scale in
                  struct.iter_unpack("<ii", payload[12:12 + 8 * ncols])]
        from ..ops.row_conversion import convert_from_rows
        return self._put(convert_from_rows(col, schema, device=self.device))

    def _op_export_table(self, payload: bytes) -> bytes:
        (h,) = struct.unpack_from("<Q", payload)
        table = self._get_table(h)
        exp = self._new_export()
        descs = [shmlib.write_column(exp, c) for c in table.columns]
        head = self._publish(exp)
        return (head + struct.pack("<QI", exp.size, table.num_columns) +
                b"".join(descs))

    def _op_export_column(self, payload: bytes) -> bytes:
        """Export one LIST<INT8> row-blob column (offsets + child bytes)."""
        (h,) = struct.unpack_from("<Q", payload)
        col = self.handles.get(h)
        if not isinstance(col, Column) or col.dtype.id != TypeId.LIST:
            raise TypeError(f"handle {h} is not a LIST column")
        exp = self._new_export()
        ooff, olen = exp.add(col.offsets.to(torch.int32))
        doff, dlen = exp.add(col.children[0].data)
        head = self._publish(exp)
        return head + struct.pack("<QqQQQQ", exp.size, col.size,
                                  ooff, olen, doff, dlen)

    def _op_free_shm(self, payload: bytes) -> bytes:
        (nlen,) = struct.unpack_from("<I", payload, 0)
        name = payload[4:4 + nlen].decode()
        with self._exports_lock:
            m = self._exports.pop(name, None)
        if m is not None:
            m.close()
        shmlib.unlink(name)
        return b""

    def _op_table_meta(self, payload: bytes) -> bytes:
        (h,) = struct.unpack_from("<Q", payload)
        table = self._get_table(h)
        out = struct.pack("<Iq", table.num_columns, table.num_rows)
        for c in table.columns:
            out += struct.pack("<ii", int(c.dtype.id), c.dtype.scale)
        return out

    # -- engine ops ----------------------------------------------------------
    def _op_get_column(self, payload: bytes) -> bytes:
        h, idx = struct.unpack_from("<QI", payload)
        table = self._get_table(h)
        if idx >= table.num_columns:
            raise IndexError(f"column {idx} out of range "
                             f"({table.num_columns} columns)")
        return self._put(table.columns[idx])

    def _op_make_table(self, payload: bytes) -> bytes:
        (n,) = struct.unpack_from("<I", payload)
        cols = [self._get_col(h) for (h,) in
                struct.iter_unpack("<Q", payload[4:4 + 8 * n])]
        return self._put(Table(cols))

    def _op_hash(self, payload: bytes) -> bytes:
        h, kind, seed = struct.unpack_from("<QBi", payload)
        table = self._get_table(h)
        from ..ops.hash import murmur3_hash, xxhash64
        if kind == 0:
            out = murmur3_hash(table, seed, device=self.device)
        elif kind == 1:
            out = xxhash64(table, seed, device=self.device)
        else:
            raise ValueError(f"unknown hash kind {kind}")
        return self._put(out)

    def _op_cast_strings(self, payload: bytes) -> bytes:
        h, tid, scale, ansi, strip = struct.unpack_from("<QiiBB", payload)
        col = self._get_col(h)
        if strip:
            from ..ops.strings import trim
            col = trim(col)
        from ..ops.cast import cast
        return self._put(cast(col, DType(TypeId(tid), scale),
                              ansi=bool(ansi)))

    def _op_groupby(self, payload: bytes) -> bytes:
        h, nk = struct.unpack_from("<QI", payload)
        off = 12
        kidx = list(struct.unpack_from(f"<{nk}I", payload, off)) if nk else []
        off += 4 * nk
        (na,) = struct.unpack_from("<I", payload, off)
        off += 4
        aggs = []
        for _ in range(na):
            ci, ac = struct.unpack_from("<IB", payload, off)
            off += 5
            if ac not in P.AGG_NAMES:
                raise ValueError(f"unknown aggregation code {ac}")
            aggs.append((int(ci), P.AGG_NAMES[ac]))
        table = self._get_table(h)
        names = [f"c{i}" for i in range(table.num_columns)]
        named = Table(list(table.columns), names)
        from ..ops.aggregate import groupby
        return self._put(groupby(
            named, [names[i] for i in kidx],
            [(names[ci] if op != "count_all" else None, op)
             for ci, op in aggs], device=self.device))

    def _op_join(self, payload: bytes) -> bytes:
        lh, rh, how = struct.unpack_from("<QQB", payload)
        (nk,) = struct.unpack_from("<I", payload, 17)
        lidx = struct.unpack_from(f"<{nk}I", payload, 21) if nk else ()
        ridx = struct.unpack_from(f"<{nk}I", payload, 21 + 4 * nk) \
            if nk else ()
        if how not in P.JOIN_NAMES:
            raise ValueError(f"unknown join type {how}")
        left = self._get_table(lh)
        right = self._get_table(rh)
        lnames = [f"l{i}" for i in range(left.num_columns)]
        rnames = [f"r{i}" for i in range(right.num_columns)]
        from ..ops.join import sort_merge_join
        return self._put(sort_merge_join(
            Table(list(left.columns), lnames),
            Table(list(right.columns), rnames),
            [lnames[i] for i in lidx], [rnames[i] for i in ridx],
            how=P.JOIN_NAMES[how], device=self.device))

    def _op_read_parquet(self, payload: bytes) -> bytes:
        (plen,) = struct.unpack_from("<I", payload)
        path = payload[4:4 + plen].decode()
        off = 4 + plen
        (nc,) = struct.unpack_from("<I", payload, off)
        off += 4
        cols = []
        for _ in range(nc):
            (ln,) = struct.unpack_from("<I", payload, off)
            off += 4
            cols.append(payload[off:off + ln].decode())
            off += ln
        from ..io import read_parquet
        return self._put(read_parquet(path, columns=cols or None,
                                      device=self.device))

    def _op_sort(self, payload: bytes) -> bytes:
        h, nk = struct.unpack_from("<QI", payload)
        keys = [(int(ci), bool(asc), None if nf == 2 else bool(nf))
                for ci, asc, nf in
                struct.iter_unpack("<IBB", payload[12:12 + 6 * nk])]
        table = self._get_table(h)
        from ..ops.order import SortKey
        from ..ops.selection import sort_table
        return self._put(sort_table(table, [
            SortKey(table.columns[ci], ascending=asc, nulls_first=nf)
            for ci, asc, nf in keys]))

    def _op_filter(self, payload: bytes) -> bytes:
        h, mh = struct.unpack_from("<QQ", payload)
        table = self._get_table(h)
        mask = self._get_col(mh)
        if mask.dtype.id != TypeId.BOOL8:
            raise TypeError("filter mask must be a BOOL8 column")
        if mask.size != table.num_rows:
            raise ValueError(f"mask has {mask.size} rows, table "
                             f"{table.num_rows}")
        from ..ops.selection import apply_boolean_mask
        return self._put(apply_boolean_mask(table, mask))  # nulls drop

    def _op_concat(self, payload: bytes) -> bytes:
        (nt,) = struct.unpack_from("<I", payload)
        tabs = [self._get_table(h) for (h,) in
                struct.iter_unpack("<Q", payload[4:4 + 8 * nt])]
        from ..ops.selection import concat_tables
        return self._put(concat_tables(tabs))

    def _op_plan_execute(self, payload: bytes, trace_id: str = "") -> bytes:
        """Whole-plan dispatch: one message runs a multi-op plan DAG.

        The client ships one serialized logical plan; ``PlanCache``
        optimizes it once a fingerprint and the executor runs it on the
        server's device.  The run executes under the client's trace scope
        (the v2 frame's trace id, or a minted one for a v1 client), so
        server spans, the flight recorder and any post-mortem bundle join
        on the client's id.  In order: build-time verification (a bad plan
        is a structured ``PlanVerificationError`` reply), the result-set
        cache (a hit skips admission and execution), admission through
        ``SCHEDULER.admit`` (queue or shed), then execution with the
        admitted session under a registered ``CancelToken``.  With a group
        of ranks the execution is the group's (``ranked.RankGroup.run``):
        every rank runs the plan, and the plans in flight pass the group's
        turn at their chunk boundaries by the session's fair share."""
        (plen,) = struct.unpack_from("<I", payload)
        blob = payload[4:4 + plen]
        from ..engine import deserialize
        from ..engine.cache import RESULT_CACHE, PlanCache, data_version
        from ..utils import blackbox, metrics
        from ..utils.config import config
        from ..utils.errors import CancelToken
        qm = None
        with blackbox.query_scope(trace_id, label="plan_execute") as scope:
            plan = deserialize(blob)
            if config.verify:
                from ..engine import verify
                verify(plan)
            if self._plan_cache is None:
                self._plan_cache = PlanCache() if self.group is None \
                    else self.group.cache
            stats: dict = {}
            tok = CancelToken(config.query_timeout_s or None)
            with self._tokens_lock:
                self._active_tokens[tok] = scope.trace_id
            fp = plan.fingerprint()
            try:
                with metrics.query(f"plan:{fp[:12]}") as qm:
                    if qm is not None:
                        qm.trace_id = scope.trace_id
                        # the submitted plan's fingerprint keys the SLO
                        # burn that admission sheds by
                        qm.fingerprint = fp
                        qm.source_fingerprint = fp
                    out, version = None, None
                    if RESULT_CACHE.enabled:
                        # before admission: a hit costs no device work, so
                        # it serves even when the scheduler would queue
                        version = data_version(plan)
                        out = RESULT_CACHE.get(fp, version)
                        if out is not None:
                            stats["served_from_cache"] = True
                    if out is None:
                        session = None
                        if config.sched:
                            from ..engine.scheduler import SCHEDULER
                            session = SCHEDULER.admit(
                                fingerprint=fp, trace_id=scope.trace_id)
                        try:
                            if self.group is not None:
                                out = self.group.run(blob, plan,
                                                     scope.trace_id, tok,
                                                     session, stats)
                            else:
                                compiled = self._plan_cache.get(plan)
                                out = compiled.execute(
                                    stats=stats, cancel=tok,
                                    session=session, device=self.device)
                        finally:
                            if session is not None:
                                session.release()
                        if RESULT_CACHE.enabled and version is not None:
                            RESULT_CACHE.put(fp, version, out)
                    if qm is not None:
                        qm.note_stats(stats)
            finally:
                with self._tokens_lock:
                    self._active_tokens.pop(tok, None)
        self._last_plan_stats = stats
        if qm is not None:
            self._last_plan_summary = qm.summary()
        return struct.pack("<I", 1) + self._put(out)

    def _cancel_active(self, trace_id: str = "") -> int:
        """Flip in-flight PLAN_EXECUTE tokens (every one for an empty
        ``trace_id``, else that trace's); returns how many."""
        with self._tokens_lock:
            toks = [t for t, tid in self._active_tokens.items()
                    if not trace_id or tid == trace_id]
        for t in toks:
            t.cancel("cancelled via bridge OP_CANCEL")
        return len(toks)

    # -- dispatch ------------------------------------------------------------
    _OPS = {
        P.OP_IMPORT_TABLE: _op_import_table,
        P.OP_TO_ROWS: _op_to_rows,
        P.OP_FROM_ROWS: _op_from_rows,
        P.OP_EXPORT_TABLE: _op_export_table,
        P.OP_EXPORT_COLUMN: _op_export_column,
        P.OP_FREE_SHM: _op_free_shm,
        P.OP_TABLE_META: _op_table_meta,
        P.OP_GET_COLUMN: _op_get_column,
        P.OP_MAKE_TABLE: _op_make_table,
        P.OP_HASH: _op_hash,
        P.OP_CAST_STRINGS: _op_cast_strings,
        P.OP_GROUPBY: _op_groupby,
        P.OP_JOIN: _op_join,
        P.OP_READ_PARQUET: _op_read_parquet,
        P.OP_SORT: _op_sort,
        P.OP_FILTER: _op_filter,
        P.OP_CONCAT: _op_concat,
    }

    def _dispatch(self, opcode: int, payload: bytes,
                  trace_id: str = "") -> bytes:
        from ..utils import faults
        faults.check("bridge.op")
        if opcode == P.OP_PING:
            return b"pong"
        if opcode == P.OP_RELEASE:
            (h,) = struct.unpack_from("<Q", payload)
            self.handles.release(h)
            return b""
        if opcode == P.OP_LIVE_COUNT:
            return struct.pack("<I", self.handles.live_count())
        if opcode == P.OP_METRICS:
            return self._op_metrics(payload)
        if opcode == P.OP_PLAN_EXECUTE:
            return self._op_plan_execute(payload, trace_id)
        op = self._OPS.get(opcode)
        if op is None:
            raise ValueError(f"unknown opcode {opcode}")
        return op(self, payload)

    def _op_metrics(self, payload: bytes = b"") -> bytes:
        """The observability snapshot: op counts, errors, busy time, live
        handles, open exports; after the first PLAN_EXECUTE the plan cache,
        the last plan's stats, the scheduler and the result cache; the
        counter/histogram/gauge registry (narrowed by an optional UTF-8
        name prefix in ``payload``), recent query summaries, per-shard
        exchange gauges, the profile store, the timeline, the flight
        recorder's health and the SLO burn; with a group of ranks, its
        ``ranks`` block (``ranked.RankGroup.snapshot``: the plans in
        flight and how often the turn passed between plans among it)."""
        prefix = payload.decode("utf-8") if payload else ""
        with self._metrics_lock:
            snap = {"ops": dict(self._metrics["ops"]),
                    "errors": self._metrics["errors"],
                    "busy_s": round(self._metrics["busy_s"], 6)}
        snap["live_handles"] = self.handles.live_count()
        with self._exports_lock:
            snap["open_exports"] = len(self._exports)
        snap["device"] = str(self.device)
        if self.group is not None:
            snap["ranks"] = self.group.snapshot()
        if self._plan_cache is not None:
            snap["plan_cache"] = self._plan_cache.stats()
            snap["last_plan"] = dict(self._last_plan_stats)
            if self._last_plan_summary:
                snap["last_plan_summary"] = dict(self._last_plan_summary)
            from ..engine.cache import RESULT_CACHE
            from ..engine.scheduler import SCHEDULER
            snap["scheduler"] = SCHEDULER.stats()
            snap["result_cache"] = RESULT_CACHE.stats()
        from ..utils import blackbox, metrics, profile, timeline, tracing
        snap["counters"] = tracing.counters_snapshot(prefix)
        snap["histograms"] = metrics.histograms_snapshot(prefix)
        snap["gauges"] = metrics.gauges_snapshot(prefix)
        snap["queries"] = metrics.recent_summaries()
        dev_gauges = metrics.gauges_snapshot("engine.exchange.dev")
        if dev_gauges:
            snap["devices"] = {
                "exchange_rows": {k.split(".")[2][3:]: v
                                  for k, v in dev_gauges.items()
                                  if k.endswith(".rows")},
                "skew": metrics.gauges_snapshot("engine.exchange.skew")
                .get("engine.exchange.skew"),
                "straggler_share":
                    metrics.gauges_snapshot("engine.exchange.straggler")
                    .get("engine.exchange.straggler_share")}
        if profile.enabled():
            snap["profile_store"] = profile.store_summary()
        if timeline.enabled():
            snap["timeline"] = timeline.export()
        snap["blackbox"] = blackbox.ring_stats()
        if blackbox.slo_enabled():
            snap["slo"] = blackbox.slo_report()
        return json.dumps(snap).encode()

    # -- connections ---------------------------------------------------------
    def serve_forever(self, ready: threading.Event | None = None) -> None:
        """Accept connections until ``OP_SHUTDOWN``; ``ready`` (optional)
        is set once the socket listens."""
        try:
            os.unlink(self.sock_path)
        except FileNotFoundError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.sock_path)
        srv.listen(16)
        if ready is not None:
            ready.set()
        workers: list[threading.Thread] = []
        try:
            while not self._shutdown.is_set():
                try:
                    conn, _ = srv.accept()
                except OSError:
                    break
                t = threading.Thread(target=self._serve_client, args=(conn,),
                                     daemon=True)
                t.start()
                workers = [w for w in workers if w.is_alive()]
                workers.append(t)
        finally:
            srv.close()
            # unblock workers parked in recv on idle connections, then wait
            with self._conns_lock:
                for c in list(self._conns):
                    try:
                        c.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
            for t in workers:
                t.join(timeout=5)
            try:
                os.unlink(self.sock_path)
            except FileNotFoundError:
                pass
            with self._exports_lock:
                leftover = list(self._exports.items())
                self._exports.clear()
            for name, m in leftover:
                try:
                    m.close()
                except (BufferError, OSError) as e:
                    # a straggler still maps it; best effort, but counted,
                    # and unlinked all the same (the mapping outlives its
                    # name)
                    from ..utils import metrics
                    metrics.count("bridge.straggler_remaps")
                    _log.debug("straggler remap of %s: %s", name, e)
                shmlib.unlink(name)

    def _serve_client(self, conn: socket.socket) -> None:
        _device.bind(self.device)
        with self._conns_lock:
            self._conns.add(conn)
        try:
            self._client_loop(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _reply(self, conn, status: int, body: bytes, trace) -> bool:
        """Send one reply; False when the peer is gone (or too slow for
        the send deadline): drop that connection, keep serving others."""
        try:
            P.send_msg(conn, status, body, trace=trace)
            return True
        except OSError:
            return False

    def _client_loop(self, conn: socket.socket) -> None:
        from ..utils.config import config
        # per-op socket deadline: an idle timeout between requests is not
        # an error, so the loop waits again
        conn.settimeout(config.bridge_timeout_s or None)
        with conn:
            while not self._shutdown.is_set():
                try:
                    opcode, payload, tid, span = P.recv_frame(conn)
                except socket.timeout:
                    continue
                except ConnectionError:
                    return
                # replies mirror the request's protocol version
                trace = (tid, span) if tid else None
                if opcode == P.OP_CANCEL:
                    n = self._cancel_active(
                        payload.decode("utf-8", "replace").strip())
                    _log.info("OP_CANCEL flipped %d token(s)", n)
                    if not self._reply(conn, P.STATUS_OK,
                                       struct.pack("<I", n), trace):
                        return
                    continue
                if opcode == P.OP_QUERY_STATUS:
                    from ..utils import metrics
                    queries = metrics.progress_snapshot()
                    want = payload.decode("utf-8", "replace").strip()
                    if want:
                        queries = [q for q in queries
                                   if q.get("trace_id") == want]
                    if not self._reply(conn, P.STATUS_OK, json.dumps(
                            {"queries": queries}).encode(), trace):
                        return
                    continue
                if opcode == P.OP_SHUTDOWN:
                    self._reply(conn, P.STATUS_OK, b"", trace)
                    self._shutdown.set()
                    try:  # unblock the accept() loop
                        poke = socket.socket(socket.AF_UNIX,
                                             socket.SOCK_STREAM)
                        poke.connect(self.sock_path)
                        poke.close()
                    except OSError:
                        pass
                    return
                try:
                    t0 = time.perf_counter()
                    if opcode == P.OP_PLAN_EXECUTE:
                        out = self._dispatch(opcode, payload, tid)
                    else:
                        with self._dispatch_lock:
                            out = self._dispatch(opcode, payload, tid)
                    with self._metrics_lock:
                        ops = self._metrics["ops"]
                        ops[opcode] = ops.get(opcode, 0) + 1
                        self._metrics["busy_s"] += time.perf_counter() - t0
                except Exception as e:  # noqa: BLE001 -- CATCH_STD analog
                    with self._metrics_lock:
                        self._metrics["errors"] += 1
                    _log.warning("op %d failed: %s: %s", opcode,
                                 type(e).__name__, e)
                    # the executor's own bundle wins (e.bundle_path); else
                    # one for a failure before the executor (bad plan, bad
                    # handle) under the client's trace
                    from ..utils import blackbox
                    bundle = getattr(e, "bundle_path", "") or \
                        blackbox.post_mortem(f"bridge.op:{opcode}", exc=e,
                                             trace_id=tid) or ""
                    status, resp = P.STATUS_ERROR, _error_body(
                        e, trace_id=getattr(e, "trace_id", "") or tid,
                        bundle=bundle)
                else:
                    status, resp = P.STATUS_OK, out
                if not self._reply(conn, status, resp, trace):
                    return


def serve(sock_path: str, device=_device.DEFAULT,
          ready: threading.Event | None = None, group=None) -> None:
    """Run a server on ``sock_path`` until a client sends OP_SHUTDOWN."""
    BridgeServer(sock_path, device, group).serve_forever(ready)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="device server of the port")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--device", default=_device.DEFAULT,
                    help="torch device of every table (default cuda)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="set a field of utils.config.config (repeatable)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes of the server's group, one rank a "
                         "device (default 1: this process alone)")
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help="the group's torch.distributed backend (forms a "
                         "group even of one rank)")
    ap.add_argument("--devices",
                    help="each rank's torch device, comma-separated")
    args = ap.parse_args(argv)
    from ..utils.config import config, parse_setting
    for text in args.set:
        name, value = parse_setting(text)
        setattr(config, name, value)
    if args.backend is None and args.devices is None and args.ranks == 1:
        serve(args.socket, args.device)
        return
    if args.backend is None or args.devices is None:
        ap.error("--ranks, --backend and --devices go together")
    devices = [d.strip() for d in args.devices.split(",")]
    if len(devices) != args.ranks:
        ap.error(f"{len(devices)} devices for {args.ranks} ranks")
    from . import ranked
    group = ranked.start(args.ranks, args.backend, devices, args.set)
    try:
        serve(args.socket, devices[0], group=group)
    finally:
        group.shutdown()


if __name__ == "__main__":
    main()
