"""Serverless runtime subsystem — the paper's system layer (§3), executable.

The port of the JAX package's ``repro.serverless``: event-driven Coordinator
→ QueryAllocator → QueryProcessor execution of the real SQUASH data plane,
with the QPs on the card (``RuntimeConfig(device=None)``, the default) or
the CPU (``device="cpu"``):

* ``events``    — the discrete-event loop (virtual clock) actors run on.
* ``payload``   — request/response codec + Lambda-style byte budgets with an
  explicit overflow policy (error vs chunked re-invocation; oversized
  single-query QP requests chunk on the candidate-row axis).
* ``nodes``     — the three actor roles: Coordinator fan-out/merge, QA
  attribute filtering + Alg. 1 selection with the §2.5 filter-count
  guarantee, QP Stages 3–5 on its partition shard (``core.dataplane``).
* ``workers``   — the function *bodies* (QA plan / QP stages) plus the
  shared ``RequestServer`` container loop the process and socket workers
  both run.
* ``transport`` — the pluggable execution substrate: ``LocalTransport``
  (inline, virtual-time modeled) and ``ProcessTransport`` (real
  multiprocessing worker pool: codec-encoded payloads over process
  boundaries, truly concurrent QP waves, real warm starts, crash retry).
* ``socket_transport`` / ``host`` — the third substrate: workers behind TCP
  connections to ``python -m repro_torch.serverless.host`` processes
  (loopback by default, other machines via ``RuntimeConfig(hosts=...)``),
  with length-prefixed budgeted frames, heartbeat liveness and
  reconnect-with-retry on connection loss.
* ``traces``    — per-node latency/payload/DRE/cache records, the measured
  wall-clock twin fields, and the §3.5 cost assembly (``core.cost_model``).
* ``runtime``   — the façade tying it together: ``ServerlessRuntime.search``
  returns ids bitwise-identical to ``SquashIndex.search(backend="torch")``
  plus a full run trace, under any transport
  (``RuntimeConfig(transport="local" | "process" | "socket")``). With
  ``RuntimeConfig(cache_enabled=True)`` the Coordinator consults the §5.6
  result cache and only cache-miss queries traverse the Alg. 2 tree.
"""

from repro_torch.core.dre import ResultCache
from repro_torch.serverless.events import EventLoop
from repro_torch.serverless.payload import (MAX_SYNC_PAYLOAD_BYTES,
                                            PayloadOverflowError,
                                            decode_message, encode_message)
from repro_torch.serverless.runtime import (RuntimeConfig, SearchResult,
                                            ServerlessRuntime)
from repro_torch.serverless.socket_transport import SocketTransport
from repro_torch.serverless.traces import NodeTrace, RunTrace
from repro_torch.serverless.transport import (LocalTransport,
                                              ProcessTransport, Transport,
                                              TransportError)

__all__ = [
    "EventLoop", "MAX_SYNC_PAYLOAD_BYTES", "PayloadOverflowError",
    "decode_message", "encode_message", "ResultCache", "RuntimeConfig",
    "SearchResult", "ServerlessRuntime", "NodeTrace", "RunTrace",
    "Transport", "LocalTransport", "ProcessTransport", "SocketTransport",
    "TransportError",
]
