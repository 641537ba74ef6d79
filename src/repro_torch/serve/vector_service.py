"""Vector-search serving facade: QA-style request routing over SquashIndex.

The port of the JAX package's ``repro.serve.vector_service``. Callers talk to
the index through this service rather than calling ``SquashIndex.search``
directly, so the data plane becomes a routing decision:

* ``backend="numpy"``  — per-query reference loop (debug / tiny batches).
* ``backend="torch"``  — the batched plane on ``ServiceConfig.device``
  (default: the CUDA card; raises without CUDA unless ``device="cpu"``).
* ``backend="auto"``   — route by batch size: single-query lookups take the
  loop, real batches the batched torch plane.
* ``backend="serverless"`` — not ported yet; raises ``NotImplementedError``.

The service also plays the QueryAllocator's accounting role: it accumulates
:class:`~repro_torch.core.pipeline.SearchStats` across requests and tracks
wall time and served queries per backend. With
``ServiceConfig(recall_target=…)`` it runs the recall-targeted Hamming
autotune against the bound index at bind time and on every ``swap_index``.
"""

from __future__ import annotations

import dataclasses
import time
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
    device: Optional[str] = None       # torch backend's device (None: cuda)
    recall_target: Optional[float] = None
    calibration_sample: int = 64
    calibration_seed: int = 0


class VectorSearchService:
    """One QueryAllocator front-end bound to a resident SquashIndex."""

    def __init__(self, index: SquashIndex,
                 config: Optional[ServiceConfig] = None):
        self.index = index
        self.config = config or ServiceConfig()
        if self.config.backend not in _CALL_BACKENDS + ("auto",):
            raise ValueError(f"unknown backend {self.config.backend!r}")
        self.stats = SearchStats()
        self.requests = 0
        self.wall_s: Dict[str, float] = {b: 0.0 for b in _CALL_BACKENDS}
        self.queries_served: Dict[str, int] = {b: 0 for b in _CALL_BACKENDS}
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

    def swap_index(self, index: SquashIndex) -> None:
        """Rebind the service to a rebuilt index (re-calibrating if tuned)."""
        self.index = index
        self._calibrate()

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
            raise NotImplementedError("serverless backend not ported yet")
        t0 = time.perf_counter()
        ids, dists, stats = self.index.search(
            queries, list(predicates), k=k, backend=chosen,
            device=self.config.device)
        dt = time.perf_counter() - t0
        self.requests += 1
        self.stats.merge(stats)
        self.wall_s[chosen] += dt
        self.queries_served[chosen] += queries.shape[0]
        return ids, dists, stats

    def qps(self, backend: str) -> float:
        """Served-queries-per-second for one backend (0 if unused)."""
        t = self.wall_s.get(backend, 0.0)
        return self.queries_served.get(backend, 0) / t if t > 0 else 0.0
