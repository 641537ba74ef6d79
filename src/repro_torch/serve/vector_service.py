"""Vector-search serving facade: QA-style request routing over SquashIndex.

The port of the JAX package's ``repro.serve.vector_service``. Callers talk to
the index through this service rather than calling ``SquashIndex.search``
directly, so the data plane becomes a routing decision:

* ``backend="numpy"``  — per-query reference loop (debug / tiny batches).
* ``backend="torch"``  — the batched plane on ``ServiceConfig.device``
  (default: the CUDA card; raises without CUDA unless ``device="cpu"``).
* ``backend="serverless"`` — the full event-driven Coordinator → QA → QP
  runtime (``repro_torch.serverless``): same ids as the torch plane, plus
  per-node latency / payload / DRE / cost traces (kept on ``last_trace``),
  its QPs on ``ServiceConfig.device``. With ``cache_enabled=True`` the
  runtime's §5.6 result cache serves repeated queries at the Coordinator;
  ``swap_index`` drains the runtime onto the new index.
* ``backend="auto"``   — route by batch size: single-query lookups take the
  loop, real batches the batched torch plane.

The service also plays the QueryAllocator's accounting role: it accumulates
:class:`~repro_torch.core.pipeline.SearchStats` across requests and counts
served queries per backend. A request's time is read from a profiler: the
``squash.search`` range that ``SquashIndex.search`` opens (numpy and torch
backends), or the serverless run's trace (``last_trace``). With
``ServiceConfig(recall_target=…)`` it runs the recall-targeted Hamming
autotune against the bound index at bind time and on every ``swap_index``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import attributes as attr_mod
from repro_torch.core.pipeline import SearchStats, SquashIndex

__all__ = ["ServiceConfig", "VectorSearchService"]

_AUTO_BATCH_THRESHOLD = 4  # ≥ this many queries → batched torch plane

# Backends a request may name explicitly ("auto" resolves before dispatch).
_CALL_BACKENDS = ("numpy", "torch", "serverless")


@dataclasses.dataclass
class ServiceConfig:
    backend: str = "auto"              # numpy | torch | serverless | auto
    default_k: int = 10
    device: Optional[str] = None       # torch / serverless device (None: cuda)
    serverless: Optional[object] = None  # repro_torch.serverless.RuntimeConfig
    # §5.6 result-cache knobs for the serverless backend. They overlay onto
    # the RuntimeConfig (an explicit ``serverless`` config that already
    # enables the cache wins).
    cache_enabled: bool = False
    result_cache_bytes: int = 64 * 1024 * 1024
    # Execution substrate of the serverless backend: None keeps the
    # RuntimeConfig's choice; "local", "process" or "socket" pins it.
    transport: Optional[str] = None
    # Socket-transport host fleet ("host:port", ...). None keeps the
    # RuntimeConfig's choice (auto-spawned loopback hosts by default).
    hosts: Optional[Tuple[str, ...]] = None
    recall_target: Optional[float] = None
    calibration_sample: int = 64
    calibration_seed: int = 0


class VectorSearchService:
    """One QueryAllocator front-end bound to a resident SquashIndex."""

    def __init__(self, index: SquashIndex,
                 config: Optional[ServiceConfig] = None):
        base = getattr(index, "base", None)     # accept a LiveIndex wrapper
        self.index = base if isinstance(base, SquashIndex) else index
        self.config = config or ServiceConfig()
        if self.config.backend not in _CALL_BACKENDS + ("auto",):
            raise ValueError(f"unknown backend {self.config.backend!r}")
        self.stats = SearchStats()
        self.requests = 0
        self.queries_served: Dict[str, int] = {b: 0 for b in _CALL_BACKENDS}
        self._runtime = None
        self.last_trace = None         # RunTrace of the last serverless call
        self._calibrate()

    def _calibrate(self) -> None:
        """(Re)derive the autotune profile for the currently-bound index."""
        if self.config.recall_target is None:
            return
        self.index.autotune(
            recall_target=self.config.recall_target,
            k=self.config.default_k,
            sample=self.config.calibration_sample,
            seed=self.config.calibration_seed)

    @property
    def profile(self):
        """The bound index's active CalibrationProfile (None if untuned)."""
        return self.index.profile

    def resolve_backend(self, num_queries: int) -> str:
        if self.config.backend != "auto":
            return self.config.backend
        return "torch" if num_queries >= _AUTO_BATCH_THRESHOLD else "numpy"

    def runtime(self):
        """The lazily-built serverless runtime bound to this index."""
        if self._runtime is None:
            from repro_torch.serverless import RuntimeConfig, ServerlessRuntime

            cfg = self.config.serverless or RuntimeConfig(
                device=self.config.device)
            if self.config.cache_enabled and not cfg.cache_enabled:
                cfg = dataclasses.replace(
                    cfg, cache_enabled=True,
                    result_cache_bytes=self.config.result_cache_bytes)
            if (self.config.transport is not None
                    and cfg.transport != self.config.transport):
                cfg = dataclasses.replace(cfg,
                                          transport=self.config.transport)
            if (self.config.hosts is not None
                    and cfg.hosts != self.config.hosts):
                cfg = dataclasses.replace(cfg, hosts=self.config.hosts)
            self._runtime = ServerlessRuntime(self.index, cfg)
        return self._runtime

    @property
    def result_cache(self):
        """The serverless backend's §5.6 ResultCache (None if unbuilt/off)."""
        return self._runtime.result_cache if self._runtime else None

    def swap_index(self, index: SquashIndex) -> None:
        """Rebind the service to a rebuilt (or live-wrapped) index.

        The serverless runtime survives the swap via
        ``ServerlessRuntime.rebind``: its container pools keep their warm
        containers while the version bump stales every retained key, and
        process workers holding old shards shut down and respawn with fresh
        bundles on the next call. Re-calibrates if tuned.
        """
        base = getattr(index, "base", None)     # accept a LiveIndex wrapper
        self.index = base if isinstance(base, SquashIndex) else index
        if self._runtime is not None:
            self._runtime.rebind(self.index)
        self._calibrate()

    def close(self) -> None:
        """Release backend resources (process-transport worker pools)."""
        if self._runtime is not None:
            self._runtime.close()
            self._runtime = None

    def warmup(self, num_queries: int, k: Optional[int] = None) -> None:
        """Run one search of ``num_queries`` zero queries through the
        batched torch plane on the service's device before the first
        request (the reference's DRE-style warm start): on the card this
        uploads the stacked index and loads the kernel libraries, so the
        first real batch pays neither. Counts as no request and adds
        nothing to the service's stats."""
        k = k or self.config.default_k
        q = np.zeros((num_queries, self.index.dim))
        self.index.search(q, [], k=k, backend="torch",
                          device=self.config.device)

    def query(
        self,
        queries: np.ndarray,
        predicates: Sequence[attr_mod.Predicate] = (),
        k: Optional[int] = None,
        backend: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Serve one request batch; returns (ids, dists, per-request stats).

        ``backend`` must be one of ``_CALL_BACKENDS`` or ``"auto"``/None; an
        unknown string fails here, before any index state is touched.
        """
        if backend not in (None, "auto") + _CALL_BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of "
                f"{('auto',) + _CALL_BACKENDS}")
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        k = k or self.config.default_k
        chosen = (self.resolve_backend(queries.shape[0])
                  if backend in (None, "auto") else backend)
        if chosen == "serverless":
            result = self.runtime().search(queries, list(predicates), k=k)
            ids, dists, stats = result.ids, result.dists, result.stats
            self.last_trace = result.trace
        else:
            ids, dists, stats = self.index.search(
                queries, list(predicates), k=k, backend=chosen,
                device=self.config.device)
        self.requests += 1
        self.stats.merge(stats)
        self.queries_served[chosen] += queries.shape[0]
        return ids, dists, stats
