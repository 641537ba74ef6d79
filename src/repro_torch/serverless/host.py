"""TCP worker host for the socket transport (``python -m repro_torch.serverless.host``).

One host process serves any number of tree-node *functions*: each accepted
connection is one long-lived worker — the client's
:class:`~repro_torch.serverless.socket_transport.SocketTransport` opens one
connection per worker slot and deploys it with an INIT frame (the pickled
:class:`~repro_torch.serverless.workers.WorkerInit`, the analogue of the S3 code
package). After the deploy-ack every request is served by the *same*
:class:`~repro_torch.serverless.workers.RequestServer` the pipe-backed
ProcessTransport workers run, so warm starts, fetch timing and derived-state
retention are reported identically whether the worker lives behind a pipe or
a TCP link — and a dropped connection loses the retained singleton exactly
like a reclaimed container.

Per connection, two threads split the work so the hang guard stays honest:

* the **receiver** thread owns the socket's read side. It answers PING
  frames with PONG *immediately* — even while a request is executing — so
  the client can tell "worker busy computing" (PONGs keep flowing) from
  "link dead" (silence); it answers STATS frames the same way, with the
  host process's cumulative metrics-registry snapshot (fleet telemetry);
* the **compute** thread drains a local queue of decoded requests, runs
  :meth:`RequestServer.handle`, and writes RESP frames back. Oversized
  responses paginate into budget-sized pages (``seq``/``nseq``) rather than
  violating the per-frame cap.

The CLI prints ``LISTENING <port>`` once bound (port 0 picks a free one),
so a remote launcher — or a test spawning a genuinely separate server
process — can scrape the port and pass ``host:port`` to the client.

The port of the JAX package's ``repro.serverless.host``. Every link's
deployment replicates the client's torch configuration
(:func:`~repro_torch.serverless.workers.configure_torch`); a QP link bound to
a CUDA device raises in a host without CUDA (its connection closes, so the
client's deploy fails) and is never served from the CPU. The links of one
host share its CUDA context; each runs on its own compute thread and launches
on that thread's current stream, the default stream, so a handler's copy of
its answer to the host waits for its own kernels. A STATS reply of a host that
holds the card carries the gauge ``host.cuda_memory_allocated_bytes``.
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.serverless import payload as pl
from repro_torch.serverless import workers as wk

__all__ = ["serve", "main"]


def _compute_loop(conn, send_lock: threading.Lock, jobs: "queue.Queue",
                  server: wk.RequestServer, max_bytes: int) -> None:
    """Serve queued requests; one RESP frame per response page."""
    while True:
        job = jobs.get()
        if job is None:
            return
        rid, payload, extra = job
        ok, data, info = server.handle(payload, extra)
        if not ok:
            data = data.encode("utf-8")       # formatted traceback
        pages = [data[i:i + max_bytes]
                 for i in range(0, len(data), max_bytes)] or [b""]
        try:
            for seq, page in enumerate(pages):
                body = pl.encode_message({
                    "rid": rid, "ok": ok, "seq": seq, "nseq": len(pages),
                    "info": info,
                    "data": np.frombuffer(page, dtype=np.uint8),
                })
                with send_lock:
                    pl.write_frame(conn, pl.FRAME_RESP, body,
                                   max_bytes=max_bytes + pl.FRAME_SLACK)
        except (OSError, ConnectionError):
            # Client went away; this worker dies with the connection (the
            # transport's reconnect path deploys a fresh one). Counted so a
            # fleet silently shedding workers shows up in the metrics dump.
            _METRICS.counter("transport.host.swallowed_errors").inc()
            return


def _serve_connection(conn: socket.socket) -> None:
    """Receiver loop for one worker connection (see module docstring)."""
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    send_lock = threading.Lock()
    jobs: "queue.Queue" = queue.Queue()
    try:
        while True:
            try:
                kind, body = pl.read_frame(conn)
            except (ConnectionError, OSError):
                break
            if kind == pl.FRAME_INIT:
                init, max_bytes = pl.decode_init(body)
                wk.configure_torch(init)
                server = wk.RequestServer(init)
                threading.Thread(
                    target=_compute_loop,
                    args=(conn, send_lock, jobs, server, max_bytes),
                    daemon=True,
                    name=f"squash-host-compute-{init.fn.replace(':', '-')}",
                ).start()
                with send_lock:               # deploy ack: function is live
                    pl.write_frame(conn, pl.FRAME_PONG)
            elif kind == pl.FRAME_PING:
                with send_lock:
                    pl.write_frame(conn, pl.FRAME_PONG)
            elif kind == pl.FRAME_STATS:
                # Fleet-telemetry pull: dump this process's cumulative
                # registry (every RequestServer in this host shares it).
                # Answered from the receiver thread like PONG, so a busy
                # compute thread never delays the fleet snapshot. A host
                # that holds the card also reports the device memory its
                # links' tensors hold (a reconnect must free the old slab).
                if torch.cuda.is_initialized():
                    _METRICS.gauge("host.cuda_memory_allocated_bytes").set(
                        torch.cuda.memory_allocated())
                body = pl.encode_message({
                    "os_pid": os.getpid(),
                    "snapshot": _METRICS.snapshot(),
                })
                with send_lock:
                    pl.write_frame(conn, pl.FRAME_STATS, body)
            elif kind == pl.FRAME_REQ:
                msg = pl.decode_message(body)
                jobs.put((int(msg["rid"]), msg["payload"].tobytes(),
                          msg.get("extra") or {}))
            elif kind == pl.FRAME_SHUTDOWN:
                break
    finally:
        jobs.put(None)                        # stop the compute thread
        try:
            conn.close()
        except OSError:
            pass


def serve(address: Tuple[str, int], *,
          ready: Optional[Callable[[int], None]] = None) -> None:
    """Listen on ``address`` and serve worker connections forever.

    ``ready(port)`` fires once the socket is bound (with the *actual* port —
    callers may bind port 0), before the first ``accept``.
    """
    srv = socket.create_server(address)
    if ready is not None:
        ready(srv.getsockname()[1])
    while True:
        try:
            conn, _ = srv.accept()
        except OSError:                       # listening socket closed
            break
        threading.Thread(target=_serve_connection, args=(conn,),
                         daemon=True, name="squash-host-conn").start()


def _spawned_main(port_conn, port: int = 0) -> None:
    """Entry for auto-spawned loopback hosts: report the bound port, serve."""

    def ready(bound: int) -> None:
        port_conn.send(bound)
        port_conn.close()

    serve(("127.0.0.1", port), ready=ready)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serverless.host",
        description="Serve SQUASH tree-node workers over TCP.")
    ap.add_argument("--listen", default="127.0.0.1:0", metavar="HOST:PORT",
                    help="bind address (port 0 picks a free port; the bound "
                         "port is printed as 'LISTENING <port>')")
    args = ap.parse_args(argv)
    hostname, _, port = args.listen.rpartition(":")

    def ready(bound: int) -> None:
        print(f"LISTENING {bound}", flush=True)

    serve((hostname or "127.0.0.1", int(port)), ready=ready)


if __name__ == "__main__":
    main()
