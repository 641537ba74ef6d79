"""Pluggable invocation transports for the serverless runtime (§3.3/§4).

The port of the JAX package's ``repro.serverless.transport`` (copied as is,
but for one guard: a process pool whose workers hold CUDA devices must be
spawned, since a forked child of a process that has initialised CUDA cannot
use the card). The third transport, over TCP sockets, is
``serverless.socket_transport``.

The choreography in ``runtime.py`` decides *what* to invoke (the Alg. 2
tree, payload chunks, QP fan-out); a :class:`Transport` decides *where and
when the function bodies run*:

* :class:`LocalTransport` — the in-process backend behind the virtual-time
  scheduler (``events.EventLoop``): handler bodies run inline at collection
  time, warm/cold and S3-fetch economics are simulated by the
  ``core.dre.ContainerPool`` leases the runtime holds. This is the modeled
  execution PRs 2–4 built.
* :class:`ProcessTransport` — a real worker-pool backend: one long-lived
  ``multiprocessing`` process per QueryProcessor partition plus a pool for
  the shared allocator function. Payloads cross the process boundary
  codec-encoded; submissions are **eager** so one QA wave's processors
  genuinely execute concurrently (the sequential Fig. 7 strawman instead
  defers each send to collection, serializing the fleet for an honest
  measured comparison); warm starts and data retention are *real* — keyed
  to the worker's OS pid and observed from the worker's own report — and a
  crashed worker is detected (pipe EOF / process sentinel), respawned cold,
  and its in-flight invocations re-sent under a bounded retry budget.

Both transports expose the same contract::

    inv = transport.submit(fn, payload=wire_bytes, extra={...})
    response_dict, info = inv.result()      # InvokeInfo: pid/warm/fetch/…
    transport.invoke(fn, ...)               # submit + result shorthand

so the runtime's traces can report the modeled §3.5 timeline and the
measured wall-clock one side by side from a single choreography.
"""

from __future__ import annotations

import dataclasses
import itertools
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import DEFAULT_BYTES_BUCKETS
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.serverless import payload as pl
from repro_torch.serverless import workers as wk

__all__ = ["TransportError", "InvokeInfo", "Transport", "LocalTransport",
           "ProcessTransport", "TRANSPORTS"]

# Backend registry: "socket" is implemented by
# serverless.socket_transport.SocketTransport (imported lazily by the
# runtime so the TCP machinery never loads for in-process runs).
TRANSPORTS = ("local", "process", "socket")


class TransportError(RuntimeError):
    """An invocation could not be completed (worker crash budget exhausted,
    handler exception crossing the wire, or a response timeout)."""


@dataclasses.dataclass
class InvokeInfo:
    """Measured facts about one completed invocation.

    ``warm``/``state_hit`` are *real* under ProcessTransport (reported by
    the worker that served the request); LocalTransport leaves them False —
    its warm/cold economics are simulated by the runtime's container pools.
    Wall times are absolute ``perf_counter`` values.
    """

    os_pid: int
    warm: bool
    state_hit: bool
    fetch_s: float
    compute_s: float
    retries: int
    wall_submit: float
    wall_sent: float
    wall_done: float
    host: str = ""       # "host:port" that served it (SocketTransport only)
    # Worker-side sub-spans for distributed tracing: the ``info["obs"]``
    # dict the worker shipped back ({"run", "parent", "spans": [[name, t0,
    # t1], ...]} with offsets relative to handler entry), or None when the
    # request carried no span context. The runtime stitches these into the
    # RunTrace's span tree; nothing else reads them.
    spans: Optional[Dict] = None


class Transport:
    """Interface both backends implement (duck-typed; no ABC machinery)."""

    kind: str = "?"

    def submit(self, fn: str, *, request: Optional[Dict] = None,
               payload: Optional[bytes] = None,
               extra: Optional[Dict] = None):
        raise NotImplementedError

    def invoke(self, fn: str, **kw) -> Tuple[Dict, InvokeInfo]:
        return self.submit(fn, **kw).result()

    def collect_metrics(self) -> Dict[str, Dict]:
        """Pull remote registries into the local one (fleet telemetry).

        Backends whose workers cannot push telemetry on their responses
        override this (SocketTransport's STATS pull); LocalTransport has no
        remote processes and ProcessTransport's pipe workers echo registry
        deltas on every response instead, so the default is a no-op.
        """
        return {}

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


# ------------------------------------------------------------------- local

class _LocalInvocation:
    def __init__(self, transport: "LocalTransport", fn: str,
                 request: Optional[Dict], payload: Optional[bytes],
                 extra: Optional[Dict]):
        self._transport = transport
        self.fn = fn
        self._request = request
        self._payload = payload
        self.extra = extra or {}
        self.predicted_warm = False
        self.t_submit = time.perf_counter()

    def result(self):
        t0 = time.perf_counter()
        req = (self._request if self._request is not None
               else pl.decode_message(self._payload))
        role = self.fn.split(":", 1)[0]
        resp = self._transport.handlers[role](self.fn, req, self.extra)
        t1 = time.perf_counter()
        spans = None
        ctx = pl.extract_span_context(self.extra)
        if ctx is not None:
            # Inline execution has no worker boundary; synthesize the one
            # sub-span that exists (the handler body) so traces from all
            # three transports stitch through the same code path.
            spans = {"run": ctx["run"], "parent": ctx["span"],
                     "spans": [["compute", 0.0, t1 - t0]]}
        _METRICS.counter("transport.local.submits").inc()
        _METRICS.histogram("transport.local.invoke_s").observe(
            t1 - self.t_submit)
        info = InvokeInfo(
            os_pid=os.getpid(), warm=False, state_hit=False,
            fetch_s=0.0, compute_s=t1 - t0, retries=0,
            wall_submit=self.t_submit, wall_sent=t0, wall_done=t1,
            spans=spans)
        return resp, info


class LocalTransport(Transport):
    """Inline execution: the handler body runs in the caller's interpreter.

    Laziness is the point — nothing runs at ``submit``; the body executes
    when the virtual-time scheduler collects the result, so the modeled
    timeline drives host execution order exactly as in PRs 2–4.
    """

    kind = "local"

    def __init__(self, handlers: Dict[str, Callable[[str, Dict, Dict], Dict]]):
        self.handlers = handlers

    def submit(self, fn, *, request=None, payload=None, extra=None):
        return _LocalInvocation(self, fn, request, payload, extra)


# ------------------------------------------------------------------ process

class _Worker:
    """One live worker process + its two simplex pipes."""

    def __init__(self, ctx, init: wk.WorkerInit):
        req_r, req_w = ctx.Pipe(duplex=False)
        resp_r, resp_w = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(
            target=wk.worker_main, args=(init, req_r, resp_w), daemon=True,
            name=f"squash-{init.fn.replace(':', '-')}")
        self.proc.start()
        req_r.close()
        resp_w.close()
        self.req_conn = req_w        # parent → worker requests
        self.resp_conn = resp_r      # worker → parent responses
        self.init = init
        self.fn = init.fn
        self.assigned = 0            # guarded-by: _lock -- routed (sent or queued)
        self.done = 0                # guarded-by: _lock -- responses received
        self.dead = False            # guarded-by: _lock
        self.send_lock = threading.Lock()

    @property
    def inflight(self) -> int:  # squash: holds[_lock]
        return self.assigned - self.done


class _Pending:
    def __init__(self, rid: int, fn: str, payload: bytes, extra: Dict):
        self.rid = rid
        self.fn = fn
        self.payload = payload
        self.extra = extra
        self.worker: Optional[_Worker] = None  # guarded-by: _lock
        self.retries = 0
        self.sent = False                      # guarded-by: _lock
        self.event = threading.Event()
        self.value = None
        self.error: Optional[Exception] = None
        self.t_submit = time.perf_counter()
        self.t_sent = 0.0
        self.t_done = 0.0

    @property
    def resolved(self) -> bool:
        return self.event.is_set()

    def resolve(self, data, winfo) -> None:
        self.value = (data, winfo)
        self.t_done = time.perf_counter()
        self.event.set()

    def fail(self, exc: Exception) -> None:
        self.error = exc
        self.t_done = time.perf_counter()
        self.event.set()


class _ProcessInvocation:
    def __init__(self, transport: "ProcessTransport", pending: _Pending,
                 predicted_warm: bool):
        self._transport = transport
        self._pending = pending
        self.fn = pending.fn
        self.extra = pending.extra
        self.predicted_warm = predicted_warm

    def result(self):
        t = self._transport
        p = self._pending  # squash: ignore[lock-guarded-access] -- name collision: the invocation's own _Pending object (bound once at construction), not the transport's guarded dict
        if not p.sent and not p.resolved:  # squash: ignore[lock-guarded-access] -- lock-free fast path: a stale False only makes _send re-check (it exits on sent/resolved); a stale True means the send already happened
            t._send(p)                       # lazy (sequential) mode
        if not p.event.wait(t.invoke_timeout_s):
            timed_out = False
            with t._lock:
                # Re-check under the lock: the response may have landed
                # between the wait expiring and us acquiring the lock.
                if not p.resolved:
                    # Forget it AND rebalance its worker: dropping only the
                    # pending left ``assigned`` permanently inflated, so the
                    # least-loaded routing shunned a hung worker forever
                    # (even after it recovered) — and a late response was
                    # double-booked into ``done`` for a request nobody
                    # awaits, skewing inflight negative.
                    t._pending.pop(p.rid, None)
                    if p.worker is not None:
                        p.worker.assigned -= 1
                    if p.sent:
                        t._timed_out[p.rid] = p.worker
                    timed_out = True
            if timed_out:
                _METRICS.counter(f"transport.{t.kind}.timeouts").inc()
                raise TransportError(
                    f"invocation of {p.fn!r} timed out after "
                    f"{t.invoke_timeout_s:.0f}s (worker pool hung?)")
        if p.error is not None:
            raise p.error
        data, winfo = p.value
        resp = pl.decode_message(data)
        _METRICS.histogram(f"transport.{t.kind}.invoke_s").observe(
            p.t_done - p.t_submit)
        # Fleet telemetry: a pipe worker serving an obs-enabled request
        # echoes its registry delta since the previous echo; absorb it
        # under the worker's pid so fleet_snapshot() can label the source.
        wmetrics = winfo.get("metrics")
        if wmetrics:
            _METRICS.absorb_snapshot(
                wmetrics, source=f"pid:{int(winfo['os_pid'])}")
        info = InvokeInfo(
            os_pid=int(winfo["os_pid"]),
            warm=int(winfo["served_before"]) > 0,
            state_hit=bool(winfo["state_hit"]),
            fetch_s=float(winfo["fetch_s"]),
            compute_s=float(winfo["compute_s"]),
            retries=p.retries,
            wall_submit=p.t_submit,
            wall_sent=p.t_sent or p.t_submit,
            wall_done=p.t_done,
            spans=winfo.get("obs"))
        return resp, info


class ProcessTransport(Transport):
    """Real multi-process worker-pool backend (see module docstring)."""

    kind = "process"

    def __init__(
        self,
        inits: Dict[str, Tuple[wk.WorkerInit, int]],
        *,
        eager: bool = True,
        start_method: str = "spawn",
        invoke_timeout_s: float = 180.0,
        max_retries: int = 2,
    ):
        if start_method == "fork" and any(
                init.device.startswith("cuda") for init, _ in inits.values()):
            raise ValueError(
                "worker_start_method='fork' cannot serve CUDA workers (a "
                "forked child cannot use the card); use 'spawn'")
        self._ctx = mp.get_context(start_method)
        self.eager = eager
        self.invoke_timeout_s = invoke_timeout_s
        self.max_retries = max_retries
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}   # guarded-by: _lock
        self._timed_out: Dict[int, _Worker] = {}  # guarded-by: _lock -- dropped
                                                  # on timeout; a late response
                                                  # must not re-book
        self._dead_births: Dict[str, int] = {}   # guarded-by: _lock
        self._respawning: Dict[str, int] = {}    # guarded-by: _lock
        self._closed = False                     # guarded-by: _lock
        self._workers: Dict[str, List[_Worker]] = {  # guarded-by: _lock
            fn: [_Worker(self._ctx, init) for _ in range(count)]
            for fn, (init, count) in inits.items()
        }
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name="squash-transport-collector")
        self._collector.start()

    # ------------------------------------------------------------ submission

    def submit(self, fn, *, request=None, payload=None, extra=None):
        if payload is None:
            payload = pl.encode_message(request)
        _METRICS.counter(f"transport.{self.kind}.submits").inc()
        _METRICS.histogram(f"transport.{self.kind}.request_bytes",
                           buckets=DEFAULT_BYTES_BUCKETS).observe(len(payload))
        pending = _Pending(next(self._rid), fn, payload, dict(extra or {}))
        deadline = time.perf_counter() + min(self.invoke_timeout_s, 30.0)
        while True:
            with self._lock:
                # Checked under the same lock that registers the pending: a
                # submit racing close() used to insert into _pending *after*
                # close had failed-and-cleared it, leaving an invocation
                # whose result() blocked the full invoke_timeout_s.
                if self._closed:
                    raise TransportError("transport is closed")
                worker = self._pick(fn)
                if worker is not None:
                    predicted_warm = worker.assigned > 0 or worker.done > 0
                    pending.worker = worker
                    worker.assigned += 1
                    self._pending[pending.rid] = pending
                    break
            # The pool's only worker died and its replacement is still being
            # spawned (outside the lock) — wait for it rather than erroring.
            if time.perf_counter() > deadline:
                raise TransportError(
                    f"no live worker for {fn!r} (respawn stuck?)")
            time.sleep(0.01)
        if self.eager:
            self._send(pending)
        return _ProcessInvocation(self, pending, predicted_warm)

    def _pick(self, fn: str) -> Optional[_Worker]:  # squash: holds[_lock]
        """Least-loaded live worker; None while a respawn is in flight."""
        if fn not in self._workers:
            raise TransportError(f"no worker pool for function {fn!r}")
        pool = [w for w in self._workers[fn] if not w.dead]
        if not pool:
            if self._respawning.get(fn, 0) > 0:
                return None
            raise TransportError(
                f"no live worker for {fn!r} (pool exceeded its respawn "
                f"budget)")
        return min(pool, key=lambda w: (w.inflight, w.assigned))

    def _send(self, pending: _Pending) -> None:
        """Deliver a pending request, following it across worker respawns.

        A send that hits a dead pipe triggers the failure path (which
        re-routes this pending to the freshly-spawned replacement — or
        fails it once budgets are exhausted) and then retries; the loop
        terminates because every failure either resolves the pending or
        installs a live worker to send to.
        """
        while not pending.resolved and not pending.sent:  # squash: ignore[lock-guarded-access] -- lock-free loop condition; the locked re-check below is what commits the sent flag
            worker = pending.worker  # squash: ignore[lock-guarded-access] -- routing snapshot; if the failure path re-routes concurrently, the locked re-check below refuses to mark sent and the loop retries on the replacement
            try:
                with worker.send_lock:
                    worker.req_conn.send(
                        (pending.rid, pending.payload, pending.extra))
                # Commit the sent flag under the transport lock, re-checking
                # the routing: the worker can die between the pipe write and
                # here, in which case _on_worker_failure has already
                # re-routed this pending to the replacement (it saw
                # sent=False, so it expects *this* loop to deliver) —
                # blindly marking it sent stranded the invocation until its
                # timeout, with nobody ever writing it to the new pipe.
                with self._lock:
                    if pending.worker is worker:
                        pending.sent = True
                        pending.t_sent = time.perf_counter()
            except (BrokenPipeError, OSError):
                self._on_worker_failure(worker)

    # ------------------------------------------------------------ collection

    def _collect_loop(self) -> None:
        while not self._closed:  # squash: ignore[lock-guarded-access] -- lock-free shutdown poll; a stale read costs one 0.25s wait tick, never correctness
            with self._lock:
                live = [w for ws in self._workers.values()
                        for w in ws if not w.dead]
                conns = {w.resp_conn: w for w in live}
                sentinels = {w.proc.sentinel: w for w in live}
            if not conns:
                time.sleep(0.02)
                continue
            try:
                ready = mpc.wait(list(conns) + list(sentinels), timeout=0.25)
            except OSError:      # a pipe vanished mid-wait; re-scan
                continue
            for r in ready:
                if self._closed:  # squash: ignore[lock-guarded-access] -- lock-free shutdown poll; close() owns failing the stragglers
                    return
                # The collector must survive anything a single worker's
                # failure path throws — a dead collector silently turns
                # every outstanding result() into a timeout.
                try:
                    if r in conns:
                        self._drain(conns[r])
                    else:
                        self._on_worker_failure(sentinels[r])
                except Exception:                        # noqa: BLE001
                    _METRICS.counter(
                        f"transport.{self.kind}.swallowed_errors").inc()
                    continue

    def _drain(self, worker: _Worker) -> None:
        try:
            msg = worker.resp_conn.recv()  # squash: ignore[wire-raw-socket] -- mp pipe Connection.recv, not a TCP socket; the payload inside was budget-checked at submit
        except (EOFError, OSError):
            self._on_worker_failure(worker)
            return
        rid, ok, data, winfo = msg
        if ok:
            _METRICS.histogram(
                f"transport.{self.kind}.response_bytes",
                buckets=DEFAULT_BYTES_BUCKETS).observe(len(data))
        with self._lock:
            pending = self._pending.pop(rid, None)
            if pending is not None:
                worker.done += 1
            else:
                # Late response for a request result() already timed out and
                # dropped: its assignment was rebalanced at drop time, so
                # booking ``done`` here would drive inflight negative and
                # make the worker look under-loaded. Other unknown rids
                # (close() cleared the table) are ignored the same way.
                self._timed_out.pop(rid, None)
        if pending is None or pending.resolved:
            return
        if ok:
            pending.resolve(data, winfo)
        else:
            pending.fail(TransportError(
                f"worker {worker.fn!r} (pid {winfo.get('os_pid')}) handler "
                f"raised:\n{data}"))

    # ----------------------------------------------------- crash / retry path

    def _on_worker_failure(self, worker: _Worker) -> None:
        """Respawn a dead worker and re-route its in-flight invocations.

        Respawns are budgeted per function (``max_retries + 1`` consecutive
        dead births): a function whose workers die on arrival — e.g. an
        environment where workers cannot start at all — fails its pending
        invocations fast instead of spinning up processes forever. A worker
        that served at least one request resets the budget. The replacement
        is spawned *outside* the lock (pickling a QP bundle is not cheap),
        so concurrent submits and drains of other workers proceed during
        recovery; ``submit`` waits on the ``_respawning`` count if the pool
        is momentarily empty.
        """
        with self._lock:
            if worker.dead or self._closed:
                return
            worker.dead = True
            pool = self._workers.get(worker.fn, [])
            if worker in pool:
                pool.remove(worker)
            affected = [p for p in self._pending.values()
                        if p.worker is worker and not p.resolved]
            # Timed-out requests in flight on this worker can never arrive.
            for rid in [r for r, w in self._timed_out.items() if w is worker]:
                del self._timed_out[rid]
            if worker.done > 0:
                self._dead_births[worker.fn] = 0
            births = self._dead_births.get(worker.fn, 0) + 1
            self._dead_births[worker.fn] = births
            if births > self.max_retries + 1:
                self._fail_locked(affected, TransportError(
                    f"workers for {worker.fn!r} keep dying at startup "
                    f"({births} consecutive failed births); giving up"))
                self._reap(worker)
                return
            self._respawning[worker.fn] = \
                self._respawning.get(worker.fn, 0) + 1
        _METRICS.counter(f"transport.{self.kind}.respawns").inc()
        try:
            replacement = _Worker(self._ctx, worker.init)
        except Exception as exc:                     # spawn itself failed
            with self._lock:
                self._respawning[worker.fn] -= 1
                self._fail_locked(affected, TransportError(
                    f"could not respawn worker for {worker.fn!r}: {exc}"))
            self._reap(worker)
            return
        resend: List[_Pending] = []
        with self._lock:
            self._respawning[worker.fn] -= 1
            if self._closed:
                replacement.proc.terminate()
                self._fail_locked(affected,
                                  TransportError("transport closed"))
            else:
                self._workers[worker.fn].append(replacement)
                for p in affected:
                    if p.resolved:
                        continue
                    if not p.sent:
                        # Unsent (lazy mode): re-route only — the _send loop
                        # that owns this pending retries against the
                        # replacement itself.
                        p.worker = replacement
                        replacement.assigned += 1
                        continue
                    p.retries += 1
                    if p.retries > self.max_retries:
                        self._fail_locked([p], TransportError(
                            f"invocation of {p.fn!r} failed after "
                            f"{p.retries - 1} retries (worker kept dying)"))
                        continue
                    p.worker = replacement
                    p.sent = False
                    replacement.assigned += 1
                    resend.append(p)
        if resend:
            _METRICS.counter(
                f"transport.{self.kind}.retries").inc(len(resend))
        for p in resend:
            self._send(p)
        self._reap(worker)

    def _fail_locked(self, pendings: List[_Pending],
                     exc: Exception) -> None:  # squash: holds[_lock]
        """Fail + forget pendings (caller holds the lock) — failed entries
        must not linger in ``_pending`` or they accumulate for the
        transport's lifetime and get re-scanned on every later failure."""
        for p in pendings:
            if not p.resolved:
                p.fail(exc)
            self._pending.pop(p.rid, None)

    @staticmethod
    def _reap(worker: _Worker) -> None:
        try:
            worker.proc.join(timeout=0.1)
            for conn in (worker.req_conn, worker.resp_conn):
                conn.close()
        except (OSError, ValueError):
            _METRICS.counter("transport.process.swallowed_errors").inc()

    # --------------------------------------------------------------- lifecycle

    def worker_pids(self, fn: str) -> List[int]:
        """Live OS pids serving ``fn`` (tests kill these to exercise retry)."""
        with self._lock:
            return [w.proc.pid for w in self._workers.get(fn, ())
                    if not w.dead]

    def close(self) -> None:
        # Check-and-set under the lock: two racing close() calls (user +
        # __del__, or two fixtures sharing a transport) both used to pass
        # the unlocked `if self._closed` test, double-sending SHUTDOWN and
        # double-closing every pipe.
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = [w for ws in self._workers.values() for w in ws]
            for p in self._pending.values():
                if not p.resolved:
                    p.fail(TransportError("transport closed"))
            self._pending.clear()
            self._timed_out.clear()
        for w in workers:
            try:
                with w.send_lock:
                    w.req_conn.send(wk.SHUTDOWN)
            except (BrokenPipeError, OSError, ValueError):
                _METRICS.counter(
                    f"transport.{self.kind}.swallowed_errors").inc()
        for w in workers:
            w.proc.join(timeout=2.0)
        for w in workers:
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=0.5)
            for conn in (w.req_conn, w.resp_conn):
                try:
                    conn.close()
                except (OSError, ValueError):
                    _METRICS.counter(
                        f"transport.{self.kind}.swallowed_errors").inc()
        if self._collector.is_alive():
            self._collector.join(timeout=1.0)

    def __del__(self):  # pragma: no cover - best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
