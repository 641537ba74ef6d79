"""HNSW baseline (Malkov & Yashunin) — the index family the paper argues
against for serverless deployment (§2.1, Table 1; Vexless uses it).

A faithful, compact implementation: multi-layer navigable small-world graph,
greedy beam search (ef), heuristic neighbor selection, post-filtering for
hybrid queries. Exists so the paper's comparisons (recall/latency/memory vs
OSQ, and the post-filter recall cliff under selective predicates) are
reproducible in this repo rather than cited.

NumPy-only on purpose: the point of the baseline is the *algorithm*, and the
paper's argument is precisely that its pointer-chasing structure doesn't map
onto FaaS/TPU-style workers the way scan-based OSQ does.

The port of the JAX package's ``repro.core.hnsw``, copied as is over the
port's :class:`~repro_torch.core.attributes.Predicate`.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.attributes import Predicate

__all__ = ["HNSWConfig", "HNSWIndex"]


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    m: int = 16                   # max neighbors per node (layer > 0)
    ef_construction: int = 100
    ef_search: int = 64
    seed: int = 0


class HNSWIndex:
    """Hierarchical navigable small-world graph over (N, d) float vectors."""

    def __init__(self, vectors: np.ndarray, config: HNSWConfig = HNSWConfig(),
                 attributes: Optional[np.ndarray] = None):
        self.vectors = np.asarray(vectors, dtype=np.float32)
        self.attributes = attributes
        self.config = config
        self._m0 = 2 * config.m
        self._ml = 1.0 / math.log(config.m)
        self._rng = np.random.default_rng(config.seed)
        n = self.vectors.shape[0]
        self._levels = np.minimum(
            (-np.log(self._rng.uniform(1e-12, 1.0, n)) * self._ml)
            .astype(np.int32), 32)
        self._max_level = int(self._levels.max(initial=0))
        # adjacency: per level, list of neighbor arrays
        self._adj: List[Dict[int, List[int]]] = [
            {} for _ in range(self._max_level + 1)]
        self._entry = int(np.argmax(self._levels))
        for i in range(n):
            self._insert(i)

    # ------------------------------------------------------------- internals

    def _dist(self, q: np.ndarray, ids) -> np.ndarray:
        sub = self.vectors[ids]
        return np.sqrt(((sub - q[None, :]) ** 2).sum(axis=1))

    def _search_layer(self, q: np.ndarray, entry: int, ef: int, level: int,
                      allow: Optional[np.ndarray] = None) -> List[Tuple[float, int]]:
        """Beam search on one layer. Returns up to ef (dist, id) ascending."""
        d0 = float(self._dist(q, [entry])[0])
        visited = {entry}
        cand = [(d0, entry)]                   # min-heap by distance
        best: List[Tuple[float, int]] = [(-d0, entry)]  # max-heap (neg)
        while cand:
            d, u = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            for v in self._adj[level].get(u, []):
                if v in visited:
                    continue
                visited.add(v)
                dv = float(self._dist(q, [v])[0])
                if len(best) < ef or dv < -best[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(best, (-dv, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        out = sorted((-nd, i) for nd, i in best)
        if allow is not None:
            out = [(d, i) for d, i in out if allow[i]]
        return out

    def _select_heuristic(self, q: np.ndarray, cands: List[Tuple[float, int]],
                          m: int) -> List[int]:
        """Heuristic neighbor selection (alg. 4): keep diverse neighbors."""
        selected: List[int] = []
        for d, c in sorted(cands):
            if len(selected) >= m:
                break
            ok = True
            for s in selected:
                if float(self._dist(self.vectors[c], [s])[0]) < d:
                    ok = False
                    break
            if ok:
                selected.append(c)
        if len(selected) < m:                      # backfill closest
            seen = set(selected)
            for d, c in sorted(cands):
                if c not in seen:
                    selected.append(c)
                    seen.add(c)
                if len(selected) >= m:
                    break
        return selected

    def _insert(self, i: int):
        level = int(self._levels[i])
        q = self.vectors[i]
        if i == self._entry:
            for l in range(level + 1):
                self._adj[l][i] = []
            return
        ep = self._entry
        for l in range(self._max_level, level, -1):
            res = self._search_layer(q, ep, 1, l)
            if res:
                ep = res[0][1]
        for l in range(min(level, self._max_level), -1, -1):
            ef = self.config.ef_construction
            res = self._search_layer(q, ep, ef, l)
            m = self._m0 if l == 0 else self.config.m
            nbrs = self._select_heuristic(q, res, m)
            self._adj[l][i] = list(nbrs)
            for v in nbrs:
                lst = self._adj[l].setdefault(v, [])
                lst.append(i)
                if len(lst) > m:
                    # Overflow pruning MUST use the diversity heuristic
                    # (alg. 4), not keep-closest: keep-closest severs every
                    # long-range/cross-cluster edge and fragments the graph.
                    ds = self._dist(self.vectors[v], lst)
                    cands = list(zip(ds.tolist(), lst))
                    self._adj[l][v] = self._select_heuristic(
                        self.vectors[v], cands, m)
            if res:
                ep = res[0][1]

    # ----------------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int = 10,
               ef: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Unfiltered ANN search. Returns (ids (Q,k), dists (Q,k))."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        ef = ef or max(self.config.ef_search, k)
        out_i = np.full((len(queries), k), -1, np.int64)
        out_d = np.full((len(queries), k), np.inf)
        for qi, q in enumerate(queries):
            ep = self._entry
            for l in range(self._max_level, 0, -1):
                res = self._search_layer(q, ep, 1, l)
                if res:
                    ep = res[0][1]
            res = self._search_layer(q, ep, ef, 0)[:k]
            for r, (d, i) in enumerate(res):
                out_i[qi, r] = i
                out_d[qi, r] = d
        return out_i, out_d

    def search_filtered(self, queries: np.ndarray,
                        predicates: Sequence[Predicate], k: int = 10,
                        ef: Optional[int] = None,
                        expansion: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Post-filtered hybrid search (the decomposition the paper critiques):
        run ANN with an ef widened by ``expansion``, then drop vectors that
        fail the predicate. Under selective filters recall collapses unless
        ef grows ~1/selectivity — the effect bench_baselines measures."""
        assert self.attributes is not None
        mask = np.ones(self.vectors.shape[0], dtype=bool)
        for p in predicates:
            mask &= p.eval(self.attributes[:, p.attr])
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        ef = (ef or max(self.config.ef_search, k)) * expansion
        out_i = np.full((len(queries), k), -1, np.int64)
        out_d = np.full((len(queries), k), np.inf)
        for qi, q in enumerate(queries):
            ep = self._entry
            for l in range(self._max_level, 0, -1):
                res = self._search_layer(q, ep, 1, l)
                if res:
                    ep = res[0][1]
            res = self._search_layer(q, ep, ef, 0, allow=mask)[:k]
            for r, (d, i) in enumerate(res):
                out_i[qi, r] = i
                out_d[qi, r] = d
        return out_i, out_d

    def graph_bytes(self) -> int:
        """In-memory footprint: full-precision vectors + adjacency."""
        edges = sum(len(v) for lvl in self._adj for v in lvl.values())
        return int(self.vectors.nbytes + edges * 8)
