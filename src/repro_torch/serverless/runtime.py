"""ServerlessRuntime — event-driven execution of the SQUASH system layer.

The port of the JAX package's ``repro.serverless.runtime``. Its QPs run the
port's torch plane on ``RuntimeConfig.device`` (the card unless the caller
names ``"cpu"``), in the default torch float dtype; the choreography, the
traces and the cost model are the reference's, copied as is.

One ``search()`` call replays the paper's §3.3 choreography: the client
invokes the Coordinator; the Coordinator fans out over the Algorithm 2
ID-jump tree (or the sequential strawman); every QueryAllocator runs
Stage 1 + Algorithm 1 on its own query slice and invokes one QueryProcessor
per visited partition; QPs execute Stages 3–5 of the real batched data
plane on their partition shard; results merge back up the tree via the
MPI-style top-k combine. Along the way the runtime models what the old
simulators only sketched:

* payload byte budgets — every hop is encoded through the codec and checked
  against the Lambda-style 6 MB cap with an explicit overflow policy
  (oversized requests chunk on the query axis, and a single query whose
  candidate rows alone bust the budget chunks on the partition-row axis);
* DRE — warm-container reuse through ``core.dre.ContainerPool`` leases, one
  pool per function (``squash-allocator``, ``squash-processor-<pid>``),
  extended from "dataset fetched" to *derived-state retention*;
* the §5.6 result cache — with ``cache_enabled`` the Coordinator splits
  every incoming batch into hit/miss query slices before fan-out;
* per-node latency traces and the §3.5 dollar breakdown via
  ``core.cost_model``.

The *execution substrate* is pluggable (``RuntimeConfig(transport=...)``,
see ``serverless.transport``):

* ``"local"`` — handler bodies run inline under the virtual-time scheduler
  (``events.EventLoop``); concurrency, warm starts and fetches are modeled.
  This is bit- and trace-compatible with PRs 2–4.
* ``"process"`` — handler bodies run in long-lived worker *processes* (one
  per QP partition + a pool for the allocator function): payloads cross
  real process boundaries codec-encoded under the same byte budget, QP
  waves execute genuinely concurrently (eager submission; the
  ``sequential=True`` strawman defers sends so the measured comparison is
  honest), warm starts / data retention are real (keyed to worker OS pids)
  and crashed workers are respawned with bounded re-invocation. The
  *modeled* §3.5 timeline is still assembled — with measured handler/fetch
  times folded in — and ``RunTrace.measured_makespan_s`` plus the per-node
  ``wall_*`` fields report the real clock next to it.
* ``"socket"`` — same worker bodies, but each one lives behind a TCP
  connection to a ``repro_torch.serverless.host`` process
  (``serverless.socket_transport``): pass ``hosts=("10.0.0.5:7070", ...)``
  to spread the QA/QP fleet across machines, or let the runtime auto-spawn
  loopback hosts. Connection loss is handled like a worker crash —
  heartbeat-guarded detection, reconnect with backoff, bounded
  re-invocation — and ``NodeTrace.worker_host`` records who served what.

Parity contract: for the same index/queries/predicates/k, the returned ids
are **bitwise identical** across ``transport="local"``,
``transport="process"``, ``transport="socket"`` and
``SquashIndex.search(backend="torch")`` (and the
reference runtime, in float64) — every
substrate runs the same plane over the same partition slices, and
the ascending-partition stable merge reproduces the reference tie-breaking.
The aggregate :class:`~repro_torch.core.pipeline.SearchStats` match exactly too,
*except* that on a cache-enabled run the stage counters cover only the miss
slice, and under row-axis payload chunking the keep/take counters reflect
the per-chunk budgets (documented in ``nodes.split_processor_rows``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dataplane, invocation
from repro_torch.core.attributes import Predicate
from repro_torch.core.cost_model import PricingConstants
from repro_torch.core.dre import ContainerPool, DreStats, Lease, ResultCache
from repro_torch.core.pipeline import SearchStats, SquashIndex, resolve_device
from repro_torch.obs.export import InMemoryExporter, JsonlExporter, run_record
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.spans import Recorder
from repro_torch.serverless import nodes as nd
from repro_torch.serverless import payload as pl
from repro_torch.serverless import transport as tp
from repro_torch.serverless import workers as wk
from repro_torch.serverless.events import EventLoop
from repro_torch.serverless.traces import NodeTrace, RunTrace, assemble_run_trace

__all__ = ["RuntimeConfig", "SearchResult", "ServerlessRuntime"]


def _unwrap_live(index):
    """Accept either a ``SquashIndex`` or its ``LiveIndex`` wrapper."""
    base = getattr(index, "base", None)
    if base is not None and getattr(base, "live_owner", None) is index:
        return base
    return index


@dataclasses.dataclass
class RuntimeConfig:
    """Topology, latency model, payload budget and pricing of one deployment."""

    branching: int = 4                 # F — Alg. 2 fan-out
    max_level: int = 2                 # l_max — tree depth below the CO
    sequential: bool = False           # CO-invokes-everything strawman (Fig. 7)

    # Execution substrate (serverless.transport).
    transport: str = "local"           # "local" | "process" | "socket"
    qa_workers: int = 2                # allocator-function pool size (real)
    worker_start_method: str = "spawn"  # multiprocessing start method
    invoke_timeout_s: float = 180.0    # per-invocation hang guard (real)
    max_worker_retries: int = 2        # re-invocations after a worker crash
    hosts: Optional[Tuple[str, ...]] = None  # socket: "host:port" fleet; None
                                             # auto-spawns loopback hosts
    auto_hosts: int = 2                # loopback hosts when hosts is None
    heartbeat_s: float = 0.25          # socket link liveness probe interval
    # Where the QPs hold their partition slices and run the plane: None
    # means the CUDA card (raises without CUDA), "cpu" the CPU.
    device: Optional[str] = None
    worker_sleep_s: float = 0.0        # injected QueryProcessor busy-sleep —
                                       # emulates heavyweight Stage 3–5 work
                                       # so concurrency benches/tests measure
                                       # the transport, not the tiny index

    # Payload budget (§3.3): Lambda's synchronous request/response cap.
    max_payload_bytes: int = pl.MAX_SYNC_PAYLOAD_BYTES
    overflow: str = "chunk"            # "chunk" | "error"

    # DRE / container model (§3.2).
    use_dre: bool = True
    warm_prob: float = 1.0
    fetch_bandwidth_bps: float = 85e6
    fetch_rtt_s: float = 0.02
    qp_setup_s: float = 0.002          # derived-state build on first use of a
                                       # container (skipped on a retained hit)

    # §5.6 result cache (CO-level hit/miss split; off by default).
    cache_enabled: bool = False
    result_cache_bytes: int = 64 * 1024 * 1024
    result_cache_entries: int = 100_000

    # Invocation latency model (Alg. 2 / Fig. 7).
    invoke_latency_warm_s: float = 0.015
    invoke_latency_cold_s: float = 0.400
    invoke_stagger_s: float = 0.002    # thread-spawn serialization per child
    payload_bandwidth_bps: float = 300e6

    # Node busy times: None → measured wall time of the real handler (host
    # wall under LocalTransport, the worker's own report under
    # ProcessTransport); a float pins the virtual compute time.
    co_compute_s: Optional[float] = None
    qa_compute_s: Optional[float] = None
    qp_compute_s: Optional[float] = None

    # §3.5 cost model inputs.
    mem_co_mb: int = 512
    mem_qa_mb: int = 1770
    mem_qp_mb: int = 1770
    prices: PricingConstants = dataclasses.field(default_factory=PricingConstants)

    # Observability (repro_torch.obs). Off by default and zero-cost when off; ids,
    # SearchStats and all traces are bitwise-identical with it on or off
    # (the span context rides the transport envelope, never the budgeted
    # payload). ``obs_enabled=True`` also enables the process-global metrics
    # REGISTRY for the process lifetime (enabling is one-way here — tests
    # that need isolation call ``REGISTRY.disable()``/``reset()`` directly).
    obs_enabled: bool = False
    obs_trace_path: Optional[str] = None  # JSONL trace file; None → in-memory

    dataset_tag: str = "dataset"       # DRE singleton key prefix
    seed: int = 0

    def __post_init__(self):
        if self.overflow not in pl.OVERFLOW_POLICIES:
            raise ValueError(f"unknown overflow policy {self.overflow!r}; "
                             f"expected {pl.OVERFLOW_POLICIES}")
        if self.transport not in tp.TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}; "
                             f"expected {tp.TRANSPORTS}")
        if self.branching < 1 or self.max_level < 1:
            raise ValueError("branching and max_level must be >= 1")


@dataclasses.dataclass
class SearchResult:
    """Final merged top-k plus the run's full accounting."""

    ids: np.ndarray        # (Q, k) int64, -1 padding
    dists: np.ndarray      # (Q, k) float64, +inf padding
    stats: SearchStats
    trace: RunTrace


class _Gather:
    """Scatter-accumulator for (possibly chunked) responses, by query index."""

    def __init__(self, qidx: np.ndarray, k: int):
        self.pos = {int(q): i for i, q in enumerate(qidx)}
        self.ids = np.full((qidx.shape[0], k), -1, dtype=np.int64)
        self.dists = np.full((qidx.shape[0], k), np.inf, dtype=np.float64)

    def rows_of(self, qidx: np.ndarray) -> np.ndarray:
        return np.fromiter((self.pos[int(q)] for q in qidx),
                           dtype=np.int64, count=qidx.shape[0])

    def scatter(self, resp: Dict) -> None:
        if resp["qidx"].shape[0] == 0:
            return
        rows = self.rows_of(resp["qidx"])
        self.ids[rows] = resp["ids"]
        self.dists[rows] = resp["dists"]


class _ChunkGather(_Gather):
    """Chunk-ordered top-k merge accumulator for QueryProcessor responses.

    Query-axis chunks carry disjoint query sets, for which the merge
    degenerates to the plain scatter; *row-axis* chunks (one query's
    candidate rows split across invocations) share a query index, and their
    per-chunk top-k streams merge by (distance, chunk order) — chunk order
    is ascending row order, reproducing the unsplit stream's tie-breaking.
    Responses are merged in ascending chunk index regardless of arrival
    order, so ProcessTransport completion races cannot reorder ties.
    """

    def __init__(self, qidx: np.ndarray, k: int):
        super().__init__(qidx, k)
        self.k = k
        self._parts: Dict[int, Dict] = {}

    def add(self, ci: int, resp: Dict) -> None:
        self._parts[ci] = resp

    def merged(self):
        for ci in sorted(self._parts):
            resp = self._parts[ci]
            if resp["qidx"].shape[0] == 0:
                continue
            rows = self.rows_of(resp["qidx"])
            cat_i = np.concatenate([self.ids[rows], resp["ids"]], axis=1)
            cat_d = np.concatenate([self.dists[rows], resp["dists"]], axis=1)
            order = np.argsort(cat_d, axis=1, kind="stable")[:, :self.k]
            self.ids[rows] = np.take_along_axis(cat_i, order, axis=1)
            self.dists[rows] = np.take_along_axis(cat_d, order, axis=1)
        return self.ids, self.dists


class ServerlessRuntime:
    """The serverless system façade bound to one resident :class:`SquashIndex`."""

    def __init__(self, index: SquashIndex, config: Optional[RuntimeConfig] = None):
        self.index = _unwrap_live(index)
        index = self.index
        self.cfg = config or RuntimeConfig()
        self.device = resolve_device(self.cfg.device)
        self.n_qp = len(index.parts)
        self.n_qa = invocation.tree_size(self.cfg.branching, self.cfg.max_level)
        self.topology = self._build_topology()
        pool_kw = dict(warm_prob=self.cfg.warm_prob,
                       fetch_bandwidth_bps=self.cfg.fetch_bandwidth_bps,
                       fetch_rtt_s=self.cfg.fetch_rtt_s)
        # One pool per Lambda *function*: the shared allocator function and
        # one processor function per partition (squash-processor-<pid>), so a
        # warm QP container always matches its partition's singleton. Under
        # ProcessTransport these virtual pools are bypassed — warm/retention
        # economics come from the real workers.
        self.qa_pool = ContainerPool(seed=self.cfg.seed + 1, **pool_kw)
        self.qp_pools = {
            pid: ContainerPool(seed=self.cfg.seed + 2 + pid, **pool_kw)
            for pid in range(self.n_qp)
        }
        self.allocator = nd.QueryAllocator(index)
        self.result_cache = (
            ResultCache(capacity=self.cfg.result_cache_entries,
                        max_bytes=self.cfg.result_cache_bytes)
            if self.cfg.cache_enabled else None)
        self.index_version = 0
        # Mutation-log cursor into the index's LiveIndex owner (if any):
        # `search` drains events past it lazily (pull model), so the runtime
        # stays consistent with streaming inserts/deletes/compactions
        # without the index ever holding a runtime reference.
        live = getattr(index, "live_owner", None)
        self._live_cursor = live.version if live is not None else 0
        self._dtype = torch.get_default_dtype()
        self._processors: Dict[int, nd.QueryProcessor] = {}
        self._planes: Dict = {}
        self._transport: Optional[tp.Transport] = None
        self._obs_exporter = None
        self._slo_tracker = None
        if self.cfg.obs_enabled:
            _METRICS.enable()

    @property
    def obs_exporter(self):
        """Trace sink for obs-enabled runs: a JSONL file when
        ``obs_trace_path`` is set, else an in-memory exporter whose
        ``records`` tests inspect. None when observability is off."""
        if not self.cfg.obs_enabled:
            return None
        if self._obs_exporter is None:
            self._obs_exporter = (
                JsonlExporter(self.cfg.obs_trace_path)
                if self.cfg.obs_trace_path else InMemoryExporter())
        return self._obs_exporter

    @property
    def slo_tracker(self):
        """Rolling SLO monitors fed by every obs-enabled search (one
        tracker per runtime, so it watches one transport's latency
        profile). None when observability is off; gate it with any
        :class:`repro_torch.obs.slo.SloPolicy`."""
        if not self.cfg.obs_enabled:
            return None
        if self._slo_tracker is None:
            from repro_torch.obs.slo import SloTracker
            self._slo_tracker = SloTracker()
        return self._slo_tracker

    # ------------------------------------------------------------- transport

    @property
    def is_process(self) -> bool:
        return self.cfg.transport == "process"

    @property
    def is_socket(self) -> bool:
        return self.cfg.transport == "socket"

    @property
    def is_real(self) -> bool:
        """Real workers behind a boundary (process pipes or TCP links), as
        opposed to the modeled inline LocalTransport."""
        return self.cfg.transport != "local"

    @property
    def transport(self) -> tp.Transport:
        """The execution substrate, built lazily (real workers are
        long-lived across searches — that is what makes DRE warm hits real)."""
        if self._transport is None:
            if self.is_process:
                self._transport = self._build_process_transport()
            elif self.is_socket:
                self._transport = self._build_socket_transport()
            else:
                self._transport = tp.LocalTransport(self._local_handlers())
        return self._transport

    def _local_handlers(self) -> Dict[str, Callable]:
        def qa(fn: str, req: Dict, extra: Dict):
            return wk.qa_compute(self.allocator, req,
                                 int(extra["olo"]), int(extra["ohi"]))

        def qp(fn: str, req: Dict, extra: Dict):
            pid = int(fn.split(":", 1)[1])
            return wk.qp_compute(self.processor(pid), req)

        return {"qa": qa, "qp": qp}

    def _worker_inits(self) -> Dict:
        """Function → (WorkerInit, pool size): the fleet's deployment map,
        shared by the process and socket substrates.

        QP workers hold their slices on the runtime's device; QA workers run
        NumPy only and stay on the CPU.
        """
        cfg = self.cfg
        dtype = str(self._dtype).removeprefix("torch.")
        inits = {
            "qa": (wk.WorkerInit(role="qa", fn="qa", pid=None, dtype=dtype,
                                 device="cpu",
                                 bundle=wk.build_qa_bundle(self.index)),
                   max(1, cfg.qa_workers)),
        }
        for pid in range(self.n_qp):
            inits[f"qp:{pid}"] = (
                wk.WorkerInit(role="qp", fn=f"qp:{pid}", pid=pid, dtype=dtype,
                              device=str(self.device),
                              bundle=wk.build_qp_bundle(self.index, pid,
                                                        self._dtype)),
                1)
        return inits

    def _build_kernels_for_workers(self) -> None:
        """Build the search kernels here, before any worker starts, so that
        QP workers (or host threads) only load the libraries instead of each
        running nvcc."""
        if self.device.type == "cuda":
            from repro_torch.kernels import build

            build.build_all(["hamming", "adc_lookup"])

    def _build_process_transport(self) -> tp.ProcessTransport:
        cfg = self.cfg
        inits = self._worker_inits()
        self._build_kernels_for_workers()
        return tp.ProcessTransport(
            inits,
            eager=not cfg.sequential,
            start_method=cfg.worker_start_method,
            invoke_timeout_s=cfg.invoke_timeout_s,
            max_retries=cfg.max_worker_retries)

    def _build_socket_transport(self):
        # Imported lazily so the TCP machinery never loads for in-process
        # runs (and LocalTransport stays importable with no socket support).
        from repro_torch.serverless.socket_transport import SocketTransport

        cfg = self.cfg
        inits = self._worker_inits()
        self._build_kernels_for_workers()
        return SocketTransport(
            inits,
            hosts=cfg.hosts,
            auto_hosts=cfg.auto_hosts,
            eager=not cfg.sequential,
            start_method=cfg.worker_start_method,
            invoke_timeout_s=cfg.invoke_timeout_s,
            max_retries=cfg.max_worker_retries,
            max_payload_bytes=cfg.max_payload_bytes,
            heartbeat_s=cfg.heartbeat_s)

    def close(self) -> None:
        """Shut down the transport (terminates process workers)."""
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    def __enter__(self) -> "ServerlessRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- resources

    def _build_topology(self) -> Dict[int, invocation.NodeSpec]:
        if self.cfg.sequential:
            nodes = {-1: invocation.NodeSpec(node_id=-1, level=0,
                                             children=tuple(range(self.n_qa)),
                                             subtree=self.n_qa)}
            for x in range(self.n_qa):
                nodes[x] = invocation.NodeSpec(node_id=x, level=1,
                                               children=(), subtree=0)
            return nodes
        return invocation.tree_nodes(self.cfg.branching, self.cfg.max_level)

    @property
    def stacked(self) -> dataplane.StackedIndex:
        """The index's stacked payload on the runtime's device: the one the
        torch backend searches, built once by the index (not a second
        copy)."""
        return self.index.stacked(self._dtype, self.device)

    def processor(self, pid: int) -> nd.QueryProcessor:
        if pid not in self._processors:
            # The QP's DRE singleton: this partition's slice of the stacked
            # payload, as views (same tensors the torch backend searches, so
            # bit-parity).
            sl = self.stacked.part(pid)
            self._processors[pid] = nd.QueryProcessor(
                pid, sl, self._plane_for, self.index.config, self._dtype)
        return self._processors[pid]

    def _plane_for(self, k: int):
        cfg = self.index.config
        keep_s, take_s = dataplane.static_counts(
            self.stacked.n_max, cfg, k, getattr(self.index, "profile", None))
        key = (k, keep_s, take_s, cfg.enable_refine)
        plane = self._planes.get(key)
        if plane is None:
            plane = dataplane.make_plane(
                k=k, keep_s=keep_s, take_s=take_s, refine=cfg.enable_refine)
            self._planes[key] = plane
        return plane

    def invalidate_cache(self, pids: Optional[Sequence[int]] = None) -> None:
        """Drop cached results and retained DRE state, whole or per-segment.

        With ``pids=None`` (whole-index): bumping ``index_version`` makes
        every container's retained state stale — *both* the fetch-level
        singletons and the derived state embed the version in their keys, so
        a warm container acquired afterwards pays the S3 fetch and the setup
        again. Clearing the pools' retained sets keeps permanently-stale
        keys from accumulating, and bumps the pools' epoch so an in-flight
        lease cannot resurrect the cleared state on release.

        With ``pids`` (segment-granular, the live-index path): only the
        named partitions' result-cache entries are evicted (dependency-set
        intersection) and only their pools — plus the allocator's, whose
        bundle always covers every partition — drop retained state; fetch
        keys go stale through the per-partition *generation* they embed, so
        untouched partitions keep their warm retention.

        Neither form rebinds the runtime to new index *data* — ``rebind``
        (or the live-index event sync in ``search``) does that.
        """
        if pids is None:
            self.index_version += 1
            if self.result_cache is not None:
                self.result_cache.invalidate()
            for pool in (self.qa_pool, *self.qp_pools.values()):
                pool.clear_derived()
            return
        if self.result_cache is not None:
            self.result_cache.invalidate_partitions(pids)
        self.qa_pool.clear_derived()
        for pid in pids:
            if pid in self.qp_pools:
                self.qp_pools[pid].clear_derived()

    # ------------------------------------------------------ live-index state

    def _generation(self, pid: int) -> int:
        """The partition's live-index generation (0 for a frozen index)."""
        live = getattr(self.index, "live_owner", None)
        return live.generations[pid] if live is not None else 0

    def _qa_generation(self) -> int:
        """Generation of the QA-visible state (partitioning + attributes +
        tombstones): any mutation changes it, so the mutation counter is
        the natural key component."""
        live = getattr(self.index, "live_owner", None)
        return live.version if live is not None else 0

    def _sync_index(self) -> None:
        """Drain the LiveIndex mutation log and rebind derived state.

        Pull model: mutations only record events; the next ``search`` pays
        the rebinding — every processor drops (the mutation cleared the
        index's stacked payload, so their views are stale; they rebind to the
        restacked payload on next use), real-transport workers
        restart with fresh bundles, touched pools' derived state clears
        (their keys embed the new generations anyway — the clear stops stale
        keys accumulating and epoch-fences in-flight leases), and the result
        cache invalidates at segment granularity per event kind.
        """
        live = getattr(self.index, "live_owner", None)
        if live is None:
            return
        cursor, events = live.events_since(self._live_cursor)
        if not events:
            return
        self._live_cursor = cursor
        touched = sorted({pid for ev in events for pid in ev.pids})
        self._processors.clear()
        if self.is_real:
            # Live workers hold bundles of the pre-mutation index; closing
            # the transport respawns them lazily with fresh bundles. The
            # modeled pools survive — the virtual warm/fetch economics are
            # what the local transport reports.
            self.close()
        self.qa_pool.clear_derived()
        for pid in touched:
            if pid in self.qp_pools:
                self.qp_pools[pid].clear_derived()
        if self.result_cache is not None:
            for ev in events:
                self._invalidate_cache_for_event(ev)

    def _invalidate_cache_for_event(self, ev) -> None:
        """Segment-granular §5.6 invalidation for one mutation event.

        * delete — evict entries whose partition dependency set intersects
          the touched partitions, plus underfilled entries (fewer than k
          results means every candidate was returned, so candidate-count
          changes can reshape them).
        * insert — evict entries the new vectors could displace: the
          nearest new vector reaches the entry's kth distance (underfilled
          entries have an infinite kth and always evict). Over-eviction
          only — if the new vector's partition wouldn't even be visited,
          the fresh search returns the same ids the entry held.
        * compact — drop-only compaction is bitwise-invisible (same codes,
          same order), nothing evicts; requantization changes the
          partition's quantized geometry, so entries depending on it, in
          its threshold radius, or underfilled evict.

        Residual (documented in DESIGN.md §Live index): entries whose query
        reached k candidates only through §2.5 escalations may survive a
        delete/requantize that would now escalate differently — the
        dependency sets cover returned ids, not the visit set.
        """
        cache = self.result_cache
        pid_set = frozenset(ev.pids)

        def underfilled(value) -> bool:
            ids, _ = value
            return bool((np.asarray(ids) < 0).any())

        if ev.kind == "delete":
            cache.invalidate_where(lambda key, value: (
                underfilled(value)
                or cache.deps(key) is None
                or bool(cache.deps(key) & pid_set)))
        elif ev.kind == "insert":
            vecs = ev.vectors

            def displaced(key, value) -> bool:
                if underfilled(value):
                    return True
                _, dists = value
                q = np.frombuffer(key[0], dtype=np.float64)
                dmin = float(np.sqrt(
                    ((vecs - q[None, :]) ** 2).sum(axis=1)).min())
                return dmin <= float(np.asarray(dists)[-1])

            cache.invalidate_where(displaced)
        elif ev.kind == "compact" and ev.requantize:
            cent = self.index.partitioning.centroids
            thr = self.index.partitioning.threshold

            def touches(key, value) -> bool:
                if underfilled(value):
                    return True
                deps = cache.deps(key)
                if deps is None or (deps & pid_set):
                    return True
                q = np.frombuffer(key[0], dtype=np.float64)
                d = np.sqrt(((cent - q[None, :]) ** 2).sum(axis=1))
                return any(d[p] <= thr * max(float(d.min()), 1e-12)
                           for p in pid_set)

            cache.invalidate_where(touches)

    def rebind(self, index) -> None:
        """Swap this runtime onto a (re)built index without dropping warm
        container state.

        The container pools survive the swap: their free lists keep the
        warm containers, while ``invalidate_cache()`` bumps the index
        version (staling every fetch/derived key) and the pools' epoch — so
        in-flight leases *drain* through the existing epoch machinery
        (their releases still return containers to the pool; their derived
        retains are dropped) instead of the old behavior of discarding the
        runtime wholesale. Partition-count changes keep the overlapping
        processor pools' warmth and add/remove the rest.
        """
        index = _unwrap_live(index)
        self.index = index
        n_new = len(index.parts)
        if n_new != self.n_qp:
            pool_kw = dict(warm_prob=self.cfg.warm_prob,
                           fetch_bandwidth_bps=self.cfg.fetch_bandwidth_bps,
                           fetch_rtt_s=self.cfg.fetch_rtt_s)
            for pid in range(self.n_qp, n_new):
                self.qp_pools[pid] = ContainerPool(
                    seed=self.cfg.seed + 2 + pid, **pool_kw)
            for pid in range(n_new, self.n_qp):
                del self.qp_pools[pid]
            self.n_qp = n_new
        self.allocator = nd.QueryAllocator(index)
        live = getattr(index, "live_owner", None)
        self._live_cursor = live.version if live is not None else 0
        self._processors.clear()
        self.close()     # real workers hold the old index's bundles
        self.invalidate_cache()

    def qa_data_bytes(self) -> int:
        """QA singleton: attribute Q-index + centroids + P-V map."""
        idx = self.index
        return int(idx.attr_index.codes.nbytes
                   + idx.partitioning.centroids.nbytes
                   + idx.partitioning.assign.nbytes)

    def qp_data_bytes(self, pid: int) -> int:
        """QP singleton: the partition's OSQ indexes (the S3 object)."""
        part = self.index.parts[pid]
        return int(part.packed.nbytes + part.low.packed.nbytes
                   + part.codes.nbytes + part.quant.boundaries.nbytes)

    # ----------------------------------------------------------------- search

    def search(
        self,
        queries: np.ndarray,
        predicates: Sequence[Predicate] = (),
        k: int = 10,
    ) -> SearchResult:
        """Run one query batch through the full CO → QA → QP choreography."""
        self._sync_index()      # drain any live-index mutations first
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        qn = queries.shape[0]
        if qn == 0:
            empty = assemble_run_trace(
                [], makespan_s=0.0, escalations=0, dre=DreStats(),
                efs_reads=0, efs_read_bytes=0, stats=SearchStats(),
                mem_qa_mb=self.cfg.mem_qa_mb, mem_qp_mb=self.cfg.mem_qp_mb,
                mem_co_mb=self.cfg.mem_co_mb, prices=self.cfg.prices,
                transport=self.cfg.transport)
            return SearchResult(ids=np.full((0, k), -1, np.int64),
                                dists=np.full((0, k), np.inf),
                                stats=SearchStats(), trace=empty)
        return _Execution(self, qn, k).run(queries, list(predicates))


class _Execution:
    """One search run: the event choreography plus its accumulators.

    The choreography is transport-agnostic: every function body executes
    through ``transport.submit(...).result()``. Under LocalTransport the
    submit is lazy and the body runs inline at collection, reproducing the
    reference's virtual-time behavior exactly; under ProcessTransport submits
    are eager at *issue* time, so one wave's workers run concurrently while
    the virtual scheduler collects their results in deterministic order.
    """

    def __init__(self, rt: ServerlessRuntime, qn: int, k: int):
        self.rt = rt
        self.cfg = rt.cfg
        self.transport = rt.transport
        self.real = rt.is_real        # process or socket workers (not inline)
        self.loop = EventLoop()
        self.qn = qn
        self.k = k
        self.qpq = -(-qn // rt.n_qa)          # queries per QA (ceil)
        self.nodes: List[NodeTrace] = []
        self.dre = DreStats()
        self.stats = SearchStats(queries=qn)
        self.escalations = 0
        self.efs_reads = 0
        self.efs_read_bytes = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.out_ids = np.full((qn, k), -1, dtype=np.int64)
        self.out_dists = np.full((qn, k), np.inf, dtype=np.float64)
        self.rec = Recorder() if rt.cfg.obs_enabled else None
        self.wall0 = time.perf_counter()  # squash: ignore[wallclock] -- measured wall-clock feeds the measured timeline/trace only; ids and SearchStats never depend on it

    # ------------------------------------------------------------- utilities

    def _tx(self, nbytes: int) -> float:
        return nbytes / self.cfg.payload_bandwidth_bps

    def _qrange(self, idlo: int, idhi: int):
        return idlo * self.qpq, min(idhi * self.qpq, self.qn)

    def _own_range(self, spec: invocation.NodeSpec):
        if spec.node_id == -1:
            return 0, 0
        return self._qrange(spec.node_id, spec.node_id + 1)

    def _acquire(self, pool: ContainerPool, key, nbytes: int,
                 merge: bool = True) -> Lease:
        """Lease a container; with ``merge=False`` the caller folds the
        lease's per-call stats delta into ``self.dre`` itself — used by the
        QP path so the delta can first absorb the derived-hit outcome and
        be merged exactly once (the old flow merged here and then bumped
        ``derived_hits`` by hand, double-counting against the pool)."""
        lease = pool.acquire(key, nbytes, use_dre=self.cfg.use_dre)
        if merge:
            self.dre.merge(lease.stats)
        return lease

    def _invoke_overhead(self, warm: bool) -> float:
        return (self.cfg.invoke_latency_warm_s if warm
                else self.cfg.invoke_latency_cold_s)

    def _merge_real_dre(self, info: tp.InvokeInfo, data_bytes: int,
                        derived: bool = False) -> None:
        """Fold a worker's real container report into the run's DreStats."""
        self.dre.merge(DreStats(
            invocations=1,
            warm_starts=int(info.warm),
            dre_hits=int(info.state_hit),
            derived_hits=int(derived and info.state_hit),
            s3_gets=int(not info.state_hit),
            bytes_fetched=0 if info.state_hit else data_bytes,
            fetch_seconds=info.fetch_s,
        ))

    def _wall_kw(self, info: Optional[tp.InvokeInfo],
                 t0: float, t1: float) -> Dict:
        """NodeTrace measured-wall fields, relative to the run submit."""
        if info is not None and self.real:
            return dict(wall_issue_s=info.wall_submit - self.wall0,
                        wall_start_s=info.wall_sent - self.wall0,
                        wall_end_s=info.wall_done - self.wall0,
                        wall_compute_s=info.compute_s,
                        worker_pid=info.os_pid,
                        worker_host=info.host,
                        retries=info.retries)
        return dict(wall_issue_s=t0 - self.wall0,
                    wall_start_s=t0 - self.wall0,
                    wall_end_s=t1 - self.wall0,
                    wall_compute_s=t1 - t0,
                    worker_pid=os.getpid(),
                    worker_host="",
                    retries=0)

    # -------------------------------------------------------------- tracing

    def _ctx(self, sid: Optional[str]) -> Optional[Dict]:
        """Wire span context for one invocation, or None when obs is off."""
        if self.rec is None or sid is None:
            return None
        return {"run": self.rec.run_id, "span": sid}

    def _record_node_span(self, sid, parent_sid, name, kind, ci, t_issue,
                          t_start, t_avail, t_end, inv, fetch_s, compute_s,
                          warm, wallkw, winfo) -> None:
        """Stitch one node invocation into the run's span tree.

        Records the node span on the modeled clock with its derived phase
        children (issue → wire → fetch → compute → respond), then grafts the
        worker-reported wall-clock sub-spans beneath it — but only when the
        worker echoed back *this* run and parent span id, so a stale or
        foreign report can never stitch into the wrong tree.
        """
        rec = self.rec
        if rec is None or sid is None:
            return
        rec.record(name, t_issue, t_end, span_id=sid, parent_id=parent_sid,
                   kind=kind, chunk=ci, warm=bool(warm),
                   retries=int(wallkw.get("retries", 0)),
                   worker_pid=int(wallkw.get("worker_pid", 0)),
                   worker_host=wallkw.get("worker_host", ""))
        rec.record("issue", t_issue, t_issue + inv, parent_id=sid, phase=True)
        rec.record("wire", t_issue + inv, t_start, parent_id=sid, phase=True)
        if fetch_s > 0:
            rec.record("fetch", t_start, t_start + fetch_s, parent_id=sid,
                       phase=True)
        rec.record("compute", t_avail, t_avail + compute_s, parent_id=sid,
                   phase=True)
        rec.record("respond", t_avail + compute_s, t_end, parent_id=sid,
                   phase=True)
        wspans = winfo.spans if winfo is not None else None
        if (wspans and wspans.get("run") == rec.run_id
                and wspans.get("parent") == sid):
            base = float(wallkw.get("wall_start_s", 0.0))
            for mname, m0, m1 in wspans.get("spans", ()):
                rec.record(f"worker.{mname}", base + float(m0),
                           base + float(m1), parent_id=sid, clock="wall")

    # ------------------------------------------------------------------ run

    def run(self, queries: np.ndarray, predicates: List[Predicate]
            ) -> SearchResult:
        root_req = {
            "qidx": np.arange(self.qn, dtype=np.int32),
            "queries": queries,
            "preds": pl.predicates_to_json(predicates),
            "k": int(self.k),
        }

        def root_respond(resp: Dict) -> None:
            rows = resp["qidx"].astype(np.int64)
            self.out_ids[rows] = resp["ids"]
            self.out_dists[rows] = resp["dists"]

        root_sid = self.rec.new_span_id() if self.rec is not None else None
        self._invoke_allocator(self.rt.topology[-1], root_req,
                               t_issue=0.0, parent="client",
                               respond=root_respond, parent_sid=root_sid)
        makespan = self.loop.run()
        measured = time.perf_counter() - self.wall0  # squash: ignore[wallclock] -- measured wall-clock feeds the measured timeline/trace only; ids and SearchStats never depend on it
        trace = assemble_run_trace(
            self.nodes, makespan_s=makespan, escalations=self.escalations,
            dre=self.dre, efs_reads=self.efs_reads,
            efs_read_bytes=self.efs_read_bytes, stats=self.stats,
            mem_qa_mb=self.cfg.mem_qa_mb, mem_qp_mb=self.cfg.mem_qp_mb,
            mem_co_mb=self.cfg.mem_co_mb, prices=self.cfg.prices,
            cache_hits=self.cache_hits, cache_misses=self.cache_misses,
            transport=self.cfg.transport, measured_makespan_s=measured)
        if self.rec is not None:
            self.rec.record("search", 0.0, makespan, span_id=root_sid,
                            transport=self.cfg.transport, queries=self.qn,
                            k=self.k)
            # Fleet telemetry: pull remote registries (socket hosts answer
            # STATS; pipe-worker deltas were absorbed per response) so the
            # exported record carries the merged, source-labelled view, and
            # feed the rolling SLO monitors with this run.
            fleet_metrics = None
            if _METRICS.enabled:
                self.transport.collect_metrics()
                fleet_metrics = _METRICS.fleet_snapshot()
            tracker = self.rt.slo_tracker
            if tracker is not None:
                tracker.observe_run(trace)
            exporter = self.rt.obs_exporter
            if exporter is not None:
                exporter.export(run_record(
                    self.rec, run_trace=trace,
                    meta={"transport": self.cfg.transport,
                          "queries": self.qn, "k": self.k,
                          "makespan_s": makespan,
                          "measured_makespan_s": measured},
                    metrics=fleet_metrics,
                    slo=None if tracker is None else tracker.snapshot()))
        return SearchResult(ids=self.out_ids, dists=self.out_dists,
                            stats=self.stats, trace=trace)

    # ------------------------------------------------------- allocator nodes

    def _invoke_allocator(
        self,
        spec: invocation.NodeSpec,
        req: Dict,
        t_issue: float,
        parent: str,
        respond: Callable[[Dict], None],
        parent_sid: Optional[str] = None,
    ) -> float:
        """Issue one logical CO/QA invocation (possibly chunked).

        Returns the launch occupancy (Σ stagger + invoke overhead over the
        chunks) the issuing thread pays — the sequential strawman serializes
        on exactly this.
        """
        kind = "co" if spec.node_id == -1 else "qa"
        name = "co" if kind == "co" else f"qa:{spec.node_id}"
        chunks = pl.chunk_request(
            req, max_bytes=self.cfg.max_payload_bytes,
            policy=self.cfg.overflow, split=nd.split_search_request,
            num_items=lambda r: r["qidx"].shape[0])
        gather = _Gather(req["qidx"], self.k)
        state = {"left": len(chunks)}
        olo, ohi = self._own_range(spec)

        def chunk_done(resp: Dict) -> None:
            gather.scatter(resp)
            state["left"] -= 1
            if state["left"] == 0:
                respond({"qidx": req["qidx"], "ids": gather.ids,
                         "dists": gather.dists})

        launch_s = 0.0
        for ci, (creq, buf) in enumerate(chunks):
            sid = self.rec.new_span_id() if self.rec is not None else None
            pinv, lease = None, None
            if kind == "co":
                # The Coordinator runs where the runtime lives (it fronts
                # the client); its empty own-slice plan is computed inline.
                warm, hit, fetch_s = True, False, 0.0
            elif self.real:
                pinv = self.transport.submit(
                    "qa", payload=buf,
                    extra=pl.inject_span_context(
                        {"olo": olo, "ohi": ohi}, self._ctx(sid)))
                warm = pinv.predicted_warm
                hit, fetch_s = warm, 0.0       # refined from the worker report
            else:
                # Local: the lease models warm/fetch now; the body itself is
                # submitted at collection, on the handler's *decoded* wire
                # request, so the codec stays on the hop's real path.
                # The fetch-level singleton key embeds the index version and
                # the QA-state generation: after invalidate_cache()/rebind
                # (or any live-index mutation) a warm container's retained
                # bytes are stale and the S3 fetch is paid again.
                lease = self._acquire(
                    self.rt.qa_pool,
                    (self.cfg.dataset_tag, "qa-index",
                     self.rt.index_version, self.rt._qa_generation()),
                    self.rt.qa_data_bytes())
                warm, hit, fetch_s = lease.warm, lease.dre_hit, lease.fetch_s
            inv = self._invoke_overhead(warm)
            t_i = t_issue + launch_s
            launch_s += self.cfg.invoke_stagger_s + inv
            t_start = t_i + inv + self._tx(len(buf))
            # The handler decodes the wire bytes — the codec is on the real
            # path of every hop, not just in the byte accounting.
            self.loop.at(t_start, lambda buf=buf, lease=lease, pinv=pinv,
                         warm=warm, hit=hit, fetch_s=fetch_s, inv=inv,
                         ci=ci, t_i=t_i, t_start=t_start, sid=sid:
                         self._allocator_handler(
                             spec, kind, name, parent, ci,
                             pl.decode_message(buf), len(buf),
                             lease, pinv, warm, hit, fetch_s, inv, t_i,
                             t_start, chunk_done,
                             sid=sid, parent_sid=parent_sid))
        return launch_s

    def _allocator_handler(
        self, spec, kind, name, parent, ci, creq, req_bytes, lease, pinv,
        warm, hit, fetch_s, inv, t_issue, t_start, respond_chunk,
        sid=None, parent_sid=None,
    ) -> None:
        cfg = self.cfg
        t0 = time.perf_counter()  # squash: ignore[wallclock] -- measured wall-clock feeds the measured timeline/trace only; ids and SearchStats never depend on it
        predicates = pl.predicates_from_json(creq["preds"])
        k = int(creq["k"])
        full_qidx = creq["qidx"]
        qidx, queries = full_qidx, creq["queries"]

        # §5.6 result-cache split (CO only): hits never enter the fan-out —
        # the tree below sees only the miss slice. Lookup runs inside the
        # measured window: the Coordinator pays for its own cache probes.
        cache = self.rt.result_cache if kind == "co" else None
        hit_entries: List[tuple] = []        # (global qidx, (ids, dists))
        miss_keys: Dict[int, object] = {}    # global qidx → cache key
        if cache is not None:
            miss_rows = []
            pp = cache.canonical_predicates(predicates)
            for i in range(qidx.shape[0]):
                ckey = (cache.query_key(queries[i]), pp, k)
                entry = cache.get(ckey)
                if entry is not None:
                    hit_entries.append((int(qidx[i]), entry))
                else:
                    miss_rows.append(i)
                    miss_keys[int(qidx[i])] = ckey
            if hit_entries:
                rows = np.asarray(miss_rows, dtype=np.int64)
                qidx, queries = qidx[rows], queries[rows]
            self.cache_hits += len(hit_entries)
            self.cache_misses += len(miss_keys)

        olo, ohi = self._own_range(spec)
        own_mask = (qidx >= olo) & (qidx < ohi)
        own_qidx = qidx[own_mask]

        # Collect the node's plan from the transport. The CO plans inline
        # (its own slice is empty by construction); QA plans were submitted
        # at issue — under ProcessTransport they may already have finished
        # in a worker while sibling handlers ran.
        winfo = None
        if kind == "co":
            presp = wk.qa_compute(self.rt.allocator, creq, olo, ohi)
        elif self.real:
            raw, winfo = pinv.result()
            presp = wk.unpack_plan_response(raw)
            warm, hit, fetch_s = winfo.warm, winfo.state_hit, winfo.fetch_s
            self._merge_real_dre(winfo, self.rt.qa_data_bytes())
        else:
            pinv = self.transport.submit(
                "qa", request=creq,
                extra=pl.inject_span_context(
                    {"olo": olo, "ohi": ohi}, self._ctx(sid)))
            presp, winfo = pinv.result()
        t1 = time.perf_counter()  # squash: ignore[wallclock] -- measured wall-clock feeds the measured timeline/trace only; ids and SearchStats never depend on it
        measured = (winfo.compute_s if (self.real and winfo is not None)
                    else t1 - t0)
        fixed = cfg.co_compute_s if kind == "co" else cfg.qa_compute_s
        compute_s = measured if fixed is None else fixed
        t_avail = t_start + fetch_s
        t_ready = t_avail + compute_s
        wallkw = self._wall_kw(winfo, t0, t1)

        qp_requests = presp["plans"]
        self.stats.filter_pass += presp["filter_pass"]
        self.stats.partitions_visited += presp["partitions_visited"]
        self.escalations += presp["escalations"]

        gather = _Gather(full_qidx, k)
        m_own = own_qidx.shape[0]
        own_streams: Dict[int, tuple] = {}
        own_gather = _Gather(own_qidx, k) if m_own else None
        pending = {"n": 0}

        def finalize() -> None:
            if m_own:
                streams = [own_streams[pid] for pid in sorted(own_streams)]
                ids, dists = nd.merge_partition_topk(m_own, k, streams)
                gather.scatter({"qidx": own_qidx, "ids": ids, "dists": dists})
            if hit_entries:
                gather.scatter({
                    "qidx": np.asarray([q for q, _ in hit_entries], np.int32),
                    "ids": np.stack([e[0] for _, e in hit_entries]),
                    "dists": np.stack([e[1] for _, e in hit_entries])})
            if miss_keys:
                # Dependency sets for segment-granular invalidation: the
                # home partitions of the returned ids (a result can only
                # change if one of them — or, for underfilled entries, the
                # candidate supply — changes; see invalidate_cache).
                assign = self.rt.index.partitioning.assign
                n_parts = len(self.rt.index.parts)
                for gq, ckey in miss_keys.items():
                    row = gather.pos[gq]
                    ids_row = gather.ids[row]
                    deps = np.unique(assign[ids_row[ids_row >= 0]])
                    cache.put(ckey, (ids_row.copy(),
                                     gather.dists[row].copy()),
                              parts=deps[deps < n_parts])
            resp = {"qidx": full_qidx, "ids": gather.ids,
                    "dists": gather.dists}
            rbuf = pl.encode_message(resp)
            # Responses are budgeted too: under the chunk policy an
            # oversized response paginates — each extra page is a warm
            # round-trip back to this (still-leased) container.
            n_pages = pl.response_chunks(
                len(rbuf), max_bytes=cfg.max_payload_bytes,
                policy=cfg.overflow)
            t_end = max(self.loop.now, t_ready)
            t_end += (n_pages - 1) * cfg.invoke_latency_warm_s
            self.nodes.append(NodeTrace(
                node=name, kind=kind, parent=parent, chunk=ci,
                t_issue=t_issue, t_start=t_start, t_end=t_end,
                invoke_s=inv, fetch_s=fetch_s, compute_s=compute_s,
                request_bytes=req_bytes, response_bytes=len(rbuf),
                warm=warm, dre_hit=hit, queries=int(full_qidx.shape[0]),
                own_queries=m_own, response_chunks=n_pages,
                cache_hits=len(hit_entries), **wallkw))
            self._record_node_span(
                sid, parent_sid, name, kind, ci, t_issue, t_start,
                t_avail, t_end, inv, fetch_s, compute_s, warm, wallkw,
                winfo)
            if lease is not None:
                self.loop.at(t_end, lambda: self.rt.qa_pool.release(lease))
            self.loop.at(t_end + self._tx(len(rbuf)),
                         lambda: respond_chunk(resp))

        def done() -> None:
            pending["n"] -= 1
            if pending["n"] == 0:
                finalize()

        # Children launch first (keep the tree expanding), then the node's
        # own QP fan-out once Alg. 1 has produced the request payloads.
        # The primary chunk (ci == 0) launches every child — the whole-fleet
        # tree launch is the Fig. 7 artifact — but overflow chunks forward
        # only to subtrees that actually hold some of their queries, and a
        # Coordinator whose batch was thinned by cache *hits* forwards only
        # to subtrees that still hold misses (a fully-hit batch launches no
        # tree at all). A cold cache (no hits) must reproduce the cache-off
        # fleet exactly, so the skip is gated on hits, not on cache_enabled.
        seq_t = t_avail
        for i, ch_id in enumerate(spec.children):
            ch = self.rt.topology[ch_id]
            clo, chi = self._qrange(*ch.id_range(self.rt.n_qa))
            mask = (qidx >= clo) & (qidx < chi)
            if (ci > 0 or hit_entries) and not mask.any():
                continue
            subreq = {"qidx": qidx[mask], "queries": queries[mask],
                      "preds": creq["preds"], "k": k}
            pending["n"] += 1

            def child_done(resp: Dict) -> None:
                gather.scatter(resp)
                done()

            if cfg.sequential and kind == "co":
                seq_t += self._invoke_allocator(ch, subreq, seq_t, name,
                                                child_done, parent_sid=sid)
            else:
                self._invoke_allocator(
                    ch, subreq, t_avail + i * cfg.invoke_stagger_s, name,
                    child_done, parent_sid=sid)

        for j, pid in enumerate(sorted(qp_requests)):
            qreq = qp_requests[pid]
            pending["n"] += 1

            def qp_done(resp: Dict, pid: int = pid) -> None:
                rows = own_gather.rows_of(resp["qidx"])
                own_streams[pid] = (rows, resp["ids"], resp["dists"])
                done()

            self._invoke_processor(pid, qreq,
                                   t_ready + j * cfg.invoke_stagger_s,
                                   name, qp_done, parent_sid=sid)

        if pending["n"] == 0:
            self.loop.at(t_ready, finalize)

    # ------------------------------------------------------- processor nodes

    def _invoke_processor(
        self,
        pid: int,
        req: Dict,
        t_issue: float,
        parent: str,
        respond: Callable[[Dict], None],
        parent_sid: Optional[str] = None,
    ) -> None:
        cfg = self.cfg
        chunks = pl.chunk_request(
            req, max_bytes=cfg.max_payload_bytes, policy=cfg.overflow,
            split=nd.split_processor_request,
            num_items=lambda r: r["qidx"].shape[0],
            fallback_split=nd.split_processor_rows,
            fallback_num=lambda r: int(r["rows"].shape[0]))
        gather = _ChunkGather(req["qidx"], self.k)
        state = {"left": len(chunks)}

        def chunk_done(ci: int, resp: Dict) -> None:
            gather.add(ci, resp)
            state["left"] -= 1
            if state["left"] == 0:
                ids, dists = gather.merged()
                respond({"qidx": req["qidx"], "ids": ids, "dists": dists})

        for ci, (creq, buf) in enumerate(chunks):
            sid = self.rec.new_span_id() if self.rec is not None else None
            pinv, lease = None, None
            if self.real:
                pinv = self.transport.submit(
                    f"qp:{pid}", payload=buf,
                    extra=pl.inject_span_context(
                        {"sleep_s": cfg.worker_sleep_s}, self._ctx(sid)))
                warm = pinv.predicted_warm
            else:
                # Versioned fetch key: index version + per-partition
                # generation, so invalidation and live mutations stale the
                # *fetch* retention too (not just derived state — the old
                # unversioned key let a warm container score a free DRE hit
                # on stale partition bytes after invalidate_cache()). The
                # stats delta merges in the handler, after the derived-hit
                # outcome lands on it.
                lease = self._acquire(
                    self.rt.qp_pools[pid],
                    (cfg.dataset_tag, f"part{pid}",
                     self.rt.index_version, self.rt._generation(pid)),
                    self.rt.qp_data_bytes(pid), merge=False)
                warm = lease.warm
            inv = self._invoke_overhead(warm)
            t_i = t_issue + ci * cfg.invoke_stagger_s
            t_start = t_i + inv + self._tx(len(buf))
            # Local handlers decode the wire bytes at collection (codec on
            # the hop's real path); process workers decode in-process.
            self.loop.at(t_start, lambda lease=lease, pinv=pinv,
                         buf=buf, inv=inv, ci=ci, t_i=t_i, t_start=t_start,
                         sid=sid:
                         self._processor_handler(
                             pid, parent, ci,
                             None if pinv else pl.decode_message(buf),
                             len(buf), lease, pinv,
                             inv, t_i, t_start, chunk_done,
                             sid=sid, parent_sid=parent_sid))

    def _processor_handler(
        self, pid, parent, ci, creq, req_bytes, lease, pinv, inv, t_issue,
        t_start, respond_chunk, sid=None, parent_sid=None,
    ) -> None:
        cfg = self.cfg
        t0 = time.perf_counter()  # squash: ignore[wallclock] -- measured wall-clock feeds the measured timeline/trace only; ids and SearchStats never depend on it
        if self.real:
            raw, winfo = pinv.result()
            resp, counters = wk.unpack_qp_response(raw)
            warm, hit, fetch_s = winfo.warm, winfo.state_hit, winfo.fetch_s
            # In a real worker, retained derived state (the device-resident
            # slice + traced plane) lives and dies with the process — a
            # state hit *is* a derived hit.
            self._merge_real_dre(winfo, self.rt.qp_data_bytes(pid),
                                 derived=True)
            setup_s = 0.0
            measured = winfo.compute_s
            t1 = time.perf_counter()  # squash: ignore[wallclock] -- measured wall-clock feeds the measured timeline/trace only; ids and SearchStats never depend on it
        else:
            # Derived-state retention (DRE beyond the fetch): a container
            # that already materialized this partition's device-resident
            # slice skips the setup step; DRE-off pays it on every
            # invocation. Keys embed the index version so invalidation
            # makes retained state stale.
            winfo = None
            warm, hit, fetch_s = lease.warm, lease.dre_hit, lease.fetch_s
            pool = self.rt.qp_pools[pid]
            setup_s = cfg.qp_setup_s
            if cfg.use_dre:
                dkey = ("stacked", pid, self.rt.index_version,
                        self.rt._generation(pid))
                if pool.derived_hit(lease, dkey):
                    setup_s = 0.0
                else:
                    pool.retain_derived(lease, dkey)
            # One merge of the per-call delta (Lease.stats), which now
            # carries the derived-hit outcome — pool.stats and the run's
            # DreStats stay consistent by construction.
            self.dre.merge(lease.stats)
            raw, linfo = self.transport.submit(
                f"qp:{pid}", request=creq,
                extra=pl.inject_span_context({}, self._ctx(sid))).result()
            resp, counters = raw
            winfo = linfo
            measured = linfo.compute_s
            t1 = time.perf_counter()  # squash: ignore[wallclock] -- measured wall-clock feeds the measured timeline/trace only; ids and SearchStats never depend on it
        t_avail = t_start + fetch_s + setup_s
        compute_s = measured if cfg.qp_compute_s is None else cfg.qp_compute_s
        t_end = t_avail + compute_s

        self.stats.hamming_in += counters["hamming_in"]
        self.stats.hamming_kept += counters["hamming_kept"]
        self.stats.adc_evals += counters["adc_evals"]
        self.stats.refined += counters["refined"]
        # Stage 5 reads full-precision rows from shared storage ('EFS').
        self.efs_reads += counters["refined"]
        self.efs_read_bytes += (counters["refined"] * self.rt.index.dim
                                * np.dtype(np.float32).itemsize)

        rbuf = pl.encode_message(resp)
        n_pages = pl.response_chunks(len(rbuf),
                                     max_bytes=cfg.max_payload_bytes,
                                     policy=cfg.overflow)
        t_end += (n_pages - 1) * cfg.invoke_latency_warm_s
        nq = int(resp["qidx"].shape[0])
        wallkw = self._wall_kw(winfo if self.real else None, t0, t1)
        self.nodes.append(NodeTrace(
            node=f"qp:{pid}", kind="qp", parent=parent, chunk=ci,
            t_issue=t_issue, t_start=t_start, t_end=t_end,
            invoke_s=inv, fetch_s=fetch_s, compute_s=compute_s,
            request_bytes=req_bytes, response_bytes=len(rbuf),
            warm=warm, dre_hit=hit,
            queries=nq, own_queries=nq,
            response_chunks=n_pages, setup_s=setup_s,
            hamming_in=counters["hamming_in"],
            hamming_kept=counters["hamming_kept"],
            adc_evals=counters["adc_evals"],
            refined=counters["refined"],
            **wallkw))
        self._record_node_span(
            sid, parent_sid, f"qp:{pid}", "qp", ci, t_issue, t_start,
            t_avail, t_end, inv, fetch_s, compute_s, warm, wallkw, winfo)
        if lease is not None:
            self.loop.at(t_end, lambda: self.rt.qp_pools[pid].release(lease))
        self.loop.at(t_end + self._tx(len(rbuf)),
                     lambda: respond_chunk(ci, resp))
