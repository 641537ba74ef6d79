"""TCP-backed invocation transport: the QA/QP fleet off one box (§4).

``SocketTransport`` is the third :class:`~repro_torch.serverless.transport.Transport`
backend. The choreography in ``runtime.py`` is untouched by construction —
it speaks the same ``submit(fn, payload, extra) → Invocation`` contract —
but every function worker now lives behind a TCP connection to a
``repro_torch.serverless.host`` process, possibly on another machine:

* **Deployment**: one connection per worker slot. Connecting sends an INIT
  frame carrying the pickled :class:`~repro_torch.serverless.workers.WorkerInit`
  (the S3-code-package analogue, budget-exempt); the host's PONG ack means
  the function is live. Worker slots round-robin across the host list, so
  ``hosts=("10.0.0.5:7070", "10.0.0.6:7070")`` genuinely spreads the fleet.
  With no ``hosts`` given, loopback host processes are auto-spawned — the
  zero-config default that still exercises the full wire path.
* **Budget**: request payloads are capped at the 6 MB synchronous-invocation
  budget at ``submit`` *and* per frame at the socket layer
  (:func:`~repro_torch.serverless.payload.write_frame`); oversized responses
  paginate host-side into budget-sized RESP pages reassembled here.
* **Crash/retry**: connection loss is the socket-era worker crash. The read
  loop detects EOF/reset; a monitor thread PINGs every link and declares a
  link dead only when it has in-flight work *and* has gone silent past the
  heartbeat window — a busy worker keeps answering PONG from its receiver
  thread, so long compute never masquerades as a dead link. A failed link
  reconnects with exponential backoff (respawning its host process first if
  this transport owns it and it died), and in-flight invocations are re-sent
  under the same ``max_retries`` budget ProcessTransport applies — ids and
  ``SearchStats`` stay bitwise-identical across the retry.

Counter discipline matches the repaired ProcessTransport exactly: a
timed-out invocation rebalances its link's ``assigned`` and parks its rid in
``_timed_out`` so a late page cannot re-book ``done``.

The port of the JAX package's ``repro.serverless.socket_transport``. Two
changes: a fleet whose links hold CUDA devices refuses the ``fork`` start
method (a forked child of a process that has initialised CUDA cannot use the
card), and the auto-spawned hosts are all started before their ports are
collected, so their torch imports overlap. ``spawn_s`` and ``deploy_s``
report the start-up seconds.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import DEFAULT_BYTES_BUCKETS
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.serverless import payload as pl
from repro_torch.serverless import transport as tr
from repro_torch.serverless import workers as wk

__all__ = ["SocketTransport"]


def _parse_host(spec: str) -> Tuple[str, int]:
    hostname, _, port = spec.rpartition(":")
    if not hostname or not port:
        raise ValueError(f"host spec {spec!r} is not 'host:port'")
    return hostname, int(port)


class _LocalHostHandle:
    """One auto-spawned loopback host process (respawnable at its port)."""

    def __init__(self, ctx):
        self._ctx = ctx
        self._lock = threading.Lock()
        self.proc = None
        self._port_conn = None
        self.address: Optional[Tuple[str, int]] = None

    def spawn(self) -> Tuple[str, int]:
        self.start()
        return self.wait_port()

    def start(self) -> None:
        """Start the host process; :meth:`wait_port` collects its port."""
        # Imported here (not at module load) so `python -m
        # repro_torch.serverless.host` doesn't see the module pre-imported by
        # the package and warn about double execution.
        from repro_torch.serverless import host as host_mod

        parent, child = self._ctx.Pipe(duplex=False)
        port = 0 if self.address is None else self.address[1]
        self.proc = self._ctx.Process(
            target=host_mod._spawned_main, args=(child, port),
            daemon=True, name="squash-host")
        self.proc.start()
        child.close()
        self._port_conn = parent

    def wait_port(self) -> Tuple[str, int]:
        """Wait (up to 60 s) for the started host to report its bound port."""
        parent = self._port_conn
        deadline = time.monotonic() + 60.0
        while not parent.poll(0.1):
            if not self.proc.is_alive():
                raise ConnectionError(
                    "spawned host died before reporting its port")
            if time.monotonic() > deadline:
                raise ConnectionError("spawned host never reported its port")
        port = parent.recv()  # squash: ignore[wire-raw-socket] -- mp pipe Connection.recv (the spawned host's port report), not a TCP socket; no payload bytes travel here
        parent.close()
        self.address = ("127.0.0.1", port)
        return self.address

    def ensure_alive(self) -> None:
        """Respawn (at the same port) if the host process died."""
        with self._lock:
            if self.proc is None or not self.proc.is_alive():
                self.spawn()

    def terminate(self) -> None:
        if self.proc is not None and self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=1.0)


class _Link:
    """One worker slot: a function deployed over one TCP connection.

    Unlike a ``_Worker`` (whose identity dies with its process), a link
    survives reconnects — ``generation`` counts them, so stale read loops
    and racing failure detectors cannot double-handle one loss. The
    retained singleton does *not* survive: a fresh connection is a fresh
    ``RequestServer``, i.e. a cold container, exactly as a crash should be.
    """

    def __init__(self, fn: str, init: wk.WorkerInit,
                 address: Tuple[str, int],
                 owner: Optional[_LocalHostHandle] = None):
        self.fn = fn
        self.init = init
        self.address = address
        self.owner = owner
        self.sock: Optional[socket.socket] = None
        self.generation = 0          # guarded-by: _lock
        self.assigned = 0            # guarded-by: _lock -- routed (sent or queued)
        self.done = 0                # guarded-by: _lock -- responses received
        self.dead = False            # guarded-by: _lock
        self.send_lock = threading.Lock()
        self.up = threading.Event()  # connection established + deploy-acked
        self.last_seen = time.perf_counter()   # last frame received
        self.pages: Dict[int, List[Optional[bytes]]] = {}  # guarded-by: _lock
        self.stats_event = threading.Event()   # a STATS reply landed
        self.stats_reply: Optional[Dict] = None  # last decoded STATS body

    @property
    def inflight(self) -> int:  # squash: holds[_lock]
        return self.assigned - self.done

    @property
    def host(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"


class _SocketInvocation(tr._ProcessInvocation):
    """Same await/timeout/rebalance semantics; adds the serving host."""

    def result(self):
        resp, info = super().result()
        link = self._pending.worker  # squash: ignore[lock-guarded-access] -- name collision: this _pending is the invocation's own _Pending object (bound once at construction), not the transport's guarded dict; worker is read post-resolution
        if link is not None:
            info.host = link.host
        return resp, info


class SocketTransport(tr.Transport):
    """TCP worker-fleet backend (see module docstring)."""

    kind = "socket"

    def __init__(
        self,
        inits: Dict[str, Tuple[wk.WorkerInit, int]],
        *,
        hosts: Optional[Tuple[str, ...]] = None,
        auto_hosts: int = 2,
        eager: bool = True,
        start_method: str = "spawn",
        invoke_timeout_s: float = 180.0,
        max_retries: int = 2,
        max_payload_bytes: int = pl.MAX_SYNC_PAYLOAD_BYTES,
        heartbeat_s: float = 0.25,
        heartbeat_misses: int = 8,
        connect_timeout_s: float = 60.0,
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
        self.max_payload_bytes = max_payload_bytes
        self.heartbeat_s = heartbeat_s
        self.heartbeat_misses = heartbeat_misses
        self.connect_timeout_s = connect_timeout_s
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._pending: Dict[int, tr._Pending] = {}  # guarded-by: _lock
        self._timed_out: Dict[int, _Link] = {}      # guarded-by: _lock
        self._closed = False                        # guarded-by: _lock
        self._owned_hosts: List[_LocalHostHandle] = []
        # Start-up seconds on the host clock: spawning the owned hosts (0
        # with ``hosts``) and deploying every link (connect + INIT + ack).
        self.spawn_s = self.deploy_s = 0.0
        t0 = time.perf_counter()
        if hosts:
            addresses = [_parse_host(h) for h in hosts]
            owners: List[Optional[_LocalHostHandle]] = [None] * len(addresses)
        else:
            self._owned_hosts = [_LocalHostHandle(self._ctx)
                                 for _ in range(max(1, int(auto_hosts)))]
            try:
                for h in self._owned_hosts:  # all start, then all report
                    h.start()
                addresses = [h.wait_port() for h in self._owned_hosts]
            except BaseException:
                for h in self._owned_hosts:
                    h.terminate()
                raise
            owners = list(self._owned_hosts)
            self.spawn_s = time.perf_counter() - t0
        slot = itertools.count()
        self._links: Dict[str, List[_Link]] = {}
        for fn, (init, count) in inits.items():
            self._links[fn] = []
            for _ in range(count):
                i = next(slot) % len(addresses)
                self._links[fn].append(
                    _Link(fn, init, addresses[i], owner=owners[i]))
        t0 = time.perf_counter()
        self._deploy_all()
        self.deploy_s = time.perf_counter() - t0
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="squash-socket-monitor")
        self._monitor.start()

    # ------------------------------------------------------------ deployment

    def _deploy_all(self) -> None:
        """Connect + INIT every link concurrently (one deploy per slot)."""
        errors: List[Exception] = []

        def go(link: _Link) -> None:
            try:
                self._connect(link)
            except Exception as exc:             # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=go, args=(link,), daemon=True)
                   for links in self._links.values() for link in links]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self.close()
            raise tr.TransportError(
                f"socket transport failed to deploy: {errors[0]}")

    def _connect(self, link: _Link) -> None:
        """Dial, deploy (INIT → PONG ack), install the socket, start reading."""
        sock = socket.create_connection(link.address,
                                        timeout=self.connect_timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            pl.write_frame(sock, pl.FRAME_INIT,
                           pl.encode_init(link.init, self.max_payload_bytes))
            kind, _ = pl.read_frame(sock)        # honors the connect timeout
            if kind != pl.FRAME_PONG:
                raise ConnectionError(
                    f"host {link.host} sent {kind!r} instead of a deploy ack")
            sock.settimeout(None)
        except BaseException:
            sock.close()
            raise
        with self._lock:
            if self._closed:
                sock.close()
                raise ConnectionError("transport closed during connect")
            link.sock = sock
            link.last_seen = time.perf_counter()
            gen = link.generation
            link.up.set()
        threading.Thread(
            target=self._read_loop, args=(link, gen, sock), daemon=True,
            name=f"squash-sock-read-{link.fn.replace(':', '-')}").start()

    # ------------------------------------------------------------ submission

    def submit(self, fn, *, request=None, payload=None, extra=None):
        if payload is None:
            payload = pl.encode_message(request)
        if len(payload) > self.max_payload_bytes:
            raise pl.PayloadOverflowError(
                f"invocation payload of {len(payload)} B exceeds the "
                f"{self.max_payload_bytes} B budget")
        _METRICS.counter("transport.socket.submits").inc()
        _METRICS.histogram("transport.socket.request_bytes",
                           buckets=DEFAULT_BYTES_BUCKETS).observe(len(payload))
        pending = tr._Pending(next(self._rid), fn, payload, dict(extra or {}))
        with self._lock:
            if self._closed:
                raise tr.TransportError("transport is closed")
            link = self._pick(fn)
            predicted_warm = link.assigned > 0 or link.done > 0
            pending.worker = link
            link.assigned += 1
            self._pending[pending.rid] = pending
        if self.eager:
            self._send(pending)
        return _SocketInvocation(self, pending, predicted_warm)

    def _pick(self, fn: str) -> _Link:  # squash: holds[_lock]
        if fn not in self._links:
            raise tr.TransportError(f"no worker links for function {fn!r}")
        pool = [link for link in self._links[fn] if not link.dead]
        if not pool:
            raise tr.TransportError(
                f"no live link for {fn!r} (reconnect budget exhausted)")
        return min(pool, key=lambda link: (link.inflight, link.assigned))

    def _send(self, pending: tr._Pending) -> None:
        """Deliver a pending request, waiting out reconnects of its link."""
        while not pending.resolved and not pending.sent:
            link = pending.worker
            if link.dead:  # squash: ignore[lock-guarded-access] -- lock-free fast-path read; the locked failure path already failed/parked this pending, so a stale False only costs one extra loop
                return
            if not link.up.wait(0.1):
                continue             # reconnect in progress
            sock = link.sock
            if sock is None:
                continue
            body = pl.encode_message({
                "rid": pending.rid, "extra": pending.extra,
                "payload": np.frombuffer(pending.payload, dtype=np.uint8),
            })
            try:
                with link.send_lock:
                    pl.write_frame(sock, pl.FRAME_REQ, body,
                                   max_bytes=self.max_payload_bytes
                                   + pl.FRAME_SLACK)
                _METRICS.histogram(
                    "transport.socket.frame_bytes",
                    buckets=DEFAULT_BYTES_BUCKETS).observe(len(body))
                # Mark sent under the transport lock, re-checking that the
                # connection we wrote to is still current: if the link
                # failed between write_frame and here, the failure handler
                # has already decided this pending's fate (resend with
                # sent=False) and marking it sent now would strand it —
                # the reconnect path only re-sends what it saw as sent.
                with self._lock:
                    if link.sock is sock and not link.dead:
                        pending.sent = True
                        pending.t_sent = time.perf_counter()
            except (OSError, ConnectionError):
                self._on_link_failure(link, link.generation)  # squash: ignore[lock-guarded-access] -- generation snapshot read: a stale value makes _on_link_failure a no-op by design (another thread already handled this loss)

    # ------------------------------------------------------------ collection

    def _read_loop(self, link: _Link, gen: int, sock: socket.socket) -> None:
        try:
            while True:
                kind, body = pl.read_frame(sock)
                link.last_seen = time.perf_counter()
                if kind == pl.FRAME_RESP:
                    _METRICS.histogram(
                        "transport.socket.frame_bytes",
                        buckets=DEFAULT_BYTES_BUCKETS).observe(len(body))
                    self._on_response(link, body)
                elif kind == pl.FRAME_STATS:
                    # Fleet-telemetry reply: stash for collect_metrics().
                    link.stats_reply = pl.decode_message(body)
                    link.stats_event.set()
                # PONG (and anything else) only refreshes liveness
        except (OSError, ConnectionError, ValueError):
            self._on_link_failure(link, gen)

    def _on_response(self, link: _Link, body: bytes) -> None:
        msg = pl.decode_message(body)
        rid = int(msg["rid"])
        nseq = int(msg["nseq"])
        data = msg["data"].tobytes()
        ok = bool(msg["ok"])
        winfo = msg["info"]
        with self._lock:
            if nseq > 1:                      # paginated response: reassemble
                # Under _lock: _on_link_failure clears link.pages (also
                # under _lock) when the connection drops, and unlocked
                # reassembly raced it — a clear between setdefault and the
                # final del left a KeyError that killed the read thread.
                pages = link.pages.setdefault(rid, [None] * nseq)
                pages[int(msg["seq"])] = data
                if any(p is None for p in pages):
                    return
                link.pages.pop(rid, None)
                data = b"".join(pages)
            pending = self._pending.pop(rid, None)
            if pending is not None:
                link.done += 1
            else:
                # Late page for a timed-out (or cleared) request — its
                # assignment was rebalanced at drop time; see transport.py.
                self._timed_out.pop(rid, None)
        if pending is None or pending.resolved:
            return
        if ok:
            pending.resolve(data, winfo)
        else:
            pending.fail(tr.TransportError(
                f"worker {link.fn!r} on {link.host} (pid "
                f"{winfo.get('os_pid')}) handler raised:\n"
                f"{data.decode('utf-8', 'replace')}"))

    # ----------------------------------------------------- crash / retry path

    def _monitor_loop(self) -> None:
        """Heartbeat every link; silence + in-flight work ⇒ link is dead."""
        while not self._closed:  # squash: ignore[lock-guarded-access] -- lock-free shutdown poll; a stale read costs one extra heartbeat tick, never correctness
            time.sleep(self.heartbeat_s / 2.0)
            with self._lock:
                links = [link for links in self._links.values()
                         for link in links
                         if not link.dead and link.up.is_set()]
                inflight = {id(link): link.inflight for link in links}
            now = time.perf_counter()
            for link in links:
                if (inflight[id(link)] > 0 and now - link.last_seen
                        > self.heartbeat_s * self.heartbeat_misses):
                    self._on_link_failure(link, link.generation)  # squash: ignore[lock-guarded-access] -- generation snapshot read: a stale value makes _on_link_failure a no-op by design
                    continue
                sock = link.sock
                if sock is None:
                    continue
                try:
                    with link.send_lock:
                        pl.write_frame(sock, pl.FRAME_PING)
                    _METRICS.counter("transport.socket.heartbeats").inc()
                except (OSError, ConnectionError):
                    self._on_link_failure(link, link.generation)  # squash: ignore[lock-guarded-access] -- generation snapshot read: a stale value makes _on_link_failure a no-op by design

    def _on_link_failure(self, link: _Link, gen: int) -> None:
        """Reconnect a lost link and re-send its in-flight invocations.

        ``gen`` is the generation the caller observed the failure on; a
        stale generation means another thread already handled this loss
        (bumping the counter), so the call is a no-op. Re-sent invocations
        stay on the *same* link — the link is the function's slot, the
        connection is merely its current container — and burn one retry
        each under the shared ``max_retries`` budget.
        """
        with self._lock:
            if link.dead or self._closed or gen != link.generation:
                return
            link.generation += 1
            link.up.clear()
            old = link.sock
            link.sock = None
            link.pages.clear()
            for rid in [r for r, l in self._timed_out.items() if l is link]:
                del self._timed_out[rid]
            resend: List[tr._Pending] = []
            for p in list(self._pending.values()):
                if p.worker is not link or p.resolved or not p.sent:
                    continue
                p.retries += 1
                if p.retries > self.max_retries:
                    self._fail_locked([p], tr.TransportError(
                        f"invocation of {p.fn!r} failed after "
                        f"{p.retries - 1} retries (link to {link.host} "
                        f"kept dropping)"))
                    continue
                p.sent = False
                resend.append(p)
        _METRICS.counter("transport.socket.reconnects").inc()
        if resend:
            _METRICS.counter("transport.socket.retries").inc(len(resend))
        if old is not None:
            try:
                old.close()
            except OSError:
                _METRICS.counter("transport.socket.swallowed_errors").inc()
        delay = 0.05
        deadline = time.perf_counter() + self.connect_timeout_s
        while True:
            if self._closed:  # squash: ignore[lock-guarded-access] -- lock-free shutdown poll during reconnect backoff; close() fails the stragglers itself
                return
            try:
                if link.owner is not None:
                    link.owner.ensure_alive()
                self._connect(link)
                break
            except (OSError, ConnectionError):
                if time.perf_counter() > deadline:
                    with self._lock:
                        link.dead = True
                        stuck = [p for p in self._pending.values()
                                 if p.worker is link and not p.resolved]
                        self._fail_locked(stuck, tr.TransportError(
                            f"could not reconnect to {link.host} for "
                            f"{link.fn!r} within {self.connect_timeout_s:.0f}s"))
                    return
                time.sleep(delay)
                delay = min(delay * 2.0, 1.0)
        for p in resend:
            if not p.resolved:
                self._send(p)

    def _fail_locked(self, pendings: List[tr._Pending],
                     exc: Exception) -> None:  # squash: holds[_lock]
        """Fail + forget pendings, rebalancing their link (lock held).

        Links outlive failures (unlike workers), so a failed invocation must
        hand back its ``assigned`` slot or the least-loaded routing shuns
        the link forever.
        """
        for p in pendings:
            if not p.resolved:
                p.fail(exc)
                if p.worker is not None:
                    p.worker.assigned -= 1
            self._pending.pop(p.rid, None)

    # ---------------------------------------------------------- fleet telemetry

    def collect_metrics(self, timeout_s: float = 5.0) -> Dict[str, Dict]:
        """Pull every host process's metrics registry into the local one.

        Sends one STATS frame per distinct host address (every link to one
        ``host:port`` is served by the same host process, whose registry is
        process-global — one pull covers them all), waits for the receiver
        thread's reply, and absorbs each snapshot into
        ``REGISTRY`` under a ``"host:port/pid:N"`` source label with
        ``replace=True`` — host snapshots are cumulative, so repeated pulls
        supersede rather than double-count. Returns ``{source: snapshot}``
        for the hosts that answered in time; an empty dict when the
        registry is disabled (telemetry stays zero-cost when obs is off —
        no frame ever hits the wire).
        """
        if not _METRICS.enabled:
            return {}
        with self._lock:
            links = [link for links in self._links.values() for link in links
                     if not link.dead and link.up.is_set()]
        by_host: Dict[str, _Link] = {}
        for link in links:
            by_host.setdefault(link.host, link)
        out: Dict[str, Dict] = {}
        for link in by_host.values():
            sock = link.sock
            if sock is None:
                continue
            link.stats_event.clear()
            try:
                with link.send_lock:
                    pl.write_frame(sock, pl.FRAME_STATS)
            except (OSError, ConnectionError):
                _METRICS.counter("transport.socket.stats_failures").inc()
                continue
            if not link.stats_event.wait(timeout_s):
                _METRICS.counter("transport.socket.stats_failures").inc()
                continue
            reply = link.stats_reply
            if not reply:
                continue
            source = f"{link.host}/pid:{int(reply['os_pid'])}"
            _METRICS.absorb_snapshot(reply["snapshot"], source=source,
                                     replace=True)
            out[source] = reply["snapshot"]
        return out

    # --------------------------------------------------------------- lifecycle

    def worker_hosts(self, fn: str) -> List[str]:
        """Host:port serving each live link of ``fn`` (in slot order)."""
        with self._lock:
            return [link.host for link in self._links.get(fn, ())
                    if not link.dead]

    def drop_connection(self, fn: str, index: int = 0) -> None:
        """Sever one link's TCP connection (tests exercise reconnect+retry)."""
        with self._lock:
            link = self._links[fn][index]
            sock = link.sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                _METRICS.counter("transport.socket.swallowed_errors").inc()

    def close(self) -> None:
        # Check-and-set under the lock: two racing close() calls (user +
        # __del__, or two fixtures) both used to pass the unlocked
        # `if self._closed` test and double-send SHUTDOWN frames.
        with self._lock:
            if self._closed:
                return
            self._closed = True
            links = [link for ls in self._links.values() for link in ls]
            for p in self._pending.values():
                if not p.resolved:
                    p.fail(tr.TransportError("transport closed"))
            self._pending.clear()
            self._timed_out.clear()
        for link in links:
            sock = link.sock
            if sock is None:
                continue
            try:
                with link.send_lock:
                    pl.write_frame(sock, pl.FRAME_SHUTDOWN)
            except (OSError, ConnectionError):
                _METRICS.counter("transport.socket.swallowed_errors").inc()
            try:
                sock.close()
            except OSError:
                _METRICS.counter("transport.socket.swallowed_errors").inc()
        for h in self._owned_hosts:
            h.terminate()
        monitor = getattr(self, "_monitor", None)  # deploy may fail earlier
        if monitor is not None and monitor.is_alive():
            monitor.join(timeout=1.0)

    def __del__(self):  # pragma: no cover - best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
