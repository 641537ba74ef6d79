"""Coarse partitioning + filtered partition ranking/selection (paper §2.4.1–2.4.2).

Balanced (capacity-constrained) k-means yields computationally balanced
partitions for the resource-constrained workers; Eq. 1 derives the centroid
distance-ratio threshold T; Algorithm 1 selects, per query, the minimal
partition set that (a) covers every centroid within factor T of the nearest
and (b) contains ≥ k predicate-passing vectors — guaranteeing a single
distributed pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "balanced_kmeans",
    "compute_threshold",
    "select_partitions",
    "Partitioning",
]


@dataclasses.dataclass
class Partitioning:
    centroids: np.ndarray   # (P, d)
    assign: np.ndarray      # (N,) partition id per vector
    threshold: float        # T from Eq. 1

    @property
    def num_partitions(self) -> int:
        return int(self.centroids.shape[0])

    def residency_bitmap(self) -> np.ndarray:
        """Compact P_V map: (P, N) bool — vector residency per partition.

        Rows with out-of-range assignment (the ``assign == P`` sentinel a
        live-index compaction leaves on physically removed vectors) reside
        nowhere.
        """
        p = self.num_partitions
        n = self.assign.shape[0]
        pv = np.zeros((p, n), dtype=bool)
        resident = self.assign < p
        pv[self.assign[resident], np.arange(n)[resident]] = True
        return pv


def balanced_kmeans(
    x: np.ndarray,
    num_partitions: int,
    iters: int = 15,
    seed: int = 0,
    slack: float = 1.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Capacity-constrained Lloyd iterations (paper's 'constrained clustering').

    Each iteration assigns vectors greedily in order of *assignment margin*
    (gap between best and second-best centroid), respecting a per-partition
    capacity of ``slack * ceil(N/P)``. Returns (centroids, assign).
    """
    x = np.asarray(x, dtype=np.float64)
    n, d = x.shape
    p = num_partitions
    rng = np.random.default_rng(seed)
    cent = x[rng.choice(n, size=p, replace=False)].copy()
    cap = int(np.ceil(slack * n / p))
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1) if n * p * d < 5e7 \
            else _chunked_sqdist(x, cent)
        order = np.argsort(np.partition(d2, 1, axis=1)[:, 0] - np.partition(d2, 1, axis=1)[:, 1])
        counts = np.zeros(p, dtype=np.int64)
        pref = np.argsort(d2, axis=1)
        for i in order:
            for c in pref[i]:
                if counts[c] < cap:
                    assign[i] = c
                    counts[c] += 1
                    break
        for c in range(p):
            members = x[assign == c]
            if members.shape[0]:
                cent[c] = members.mean(axis=0)
    return cent, assign


def _chunked_sqdist(x: np.ndarray, cent: np.ndarray, chunk: int = 8192) -> np.ndarray:
    n = x.shape[0]
    out = np.empty((n, cent.shape[0]), dtype=np.float64)
    c2 = (cent ** 2).sum(-1)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        xx = x[lo:hi]
        out[lo:hi] = (xx ** 2).sum(-1)[:, None] - 2 * xx @ cent.T + c2[None, :]
    return np.maximum(out, 0.0)


def compute_threshold(
    x: np.ndarray,
    centroids: np.ndarray,
    assign: np.ndarray,
    beta: float = 0.001,
    sample: Optional[int] = 20000,
    seed: int = 0,
) -> float:
    """Centroid distance-ratio threshold T (Eq. 1).

    Builds the vector↔centroid distance-ratio matrix R (each row divided by
    the home-centroid distance), takes row-wise means/stds, then
    T = 1 + σ_µ/µ_µ + β·√d over *their* means.
    """
    x = np.asarray(x, dtype=np.float64)
    n, d = x.shape
    if sample is not None and n > sample:
        idx = np.random.default_rng(seed).choice(n, size=sample, replace=False)
        x, assign = x[idx], assign[idx]
        n = sample
    dist = np.sqrt(_chunked_sqdist(x, centroids))
    home = dist[np.arange(n), assign]
    ratio = dist / np.maximum(home[:, None], 1e-12)
    mu_r = ratio.mean(axis=1)
    sigma_r = ratio.std(axis=1)
    mu_mu = float(mu_r.mean())
    sigma_mu = float(sigma_r.mean())
    return 1.0 + sigma_mu / max(mu_mu, 1e-12) + beta * np.sqrt(d)


def select_partitions(
    queries: np.ndarray,
    centroids: np.ndarray,
    filter_masks: np.ndarray,
    assign: np.ndarray,
    threshold: float,
    k: int,
    balance: bool = False,
    escalations: Optional[list] = None,
    scanned: Optional[list] = None,
    shared_scans: Optional[list] = None,
) -> Tuple[np.ndarray, List[Dict[int, np.ndarray]]]:
    """Algorithm 1 — Filtered Partition Ranking and Selection.

    Args:
      queries: (Q, d).
      centroids: (P, d).
      filter_masks: (Q, N) bool — attribute satisfaction mask F per query.
        A row shared by every query (a broadcast view, row stride 0, or
        Q = 1) is scanned once per partition for the whole batch.
      assign: (N,) home partition of each vector (the P_V map). Rows with
        the out-of-range sentinel ``assign == P`` belong to no partition.
      threshold: T (multiplicative factor over the nearest centroid distance).
      k: top-k target.
      balance: optional batch load-balancing step (assign extra queries to
        under-visited partitions, narrowest-miss first).
      escalations: optional one-element list; incremented by the number of
        (query, partition) visits *past* the Eq. 1 threshold cut — the §2.5
        filter-count guarantee at work (counted here, where the cut decision
        is made, so callers can't drift from it).
      scanned: optional one-element list; incremented by the rows of the
        filter mask the scans read — a partition's n_p rows per scan, or
        once per partition for a shared row (main and balance loops).
      shared_scans: optional one-element list; incremented by the
        (query, partition) scans answered from a shared row's per-partition
        row sets (every scan when the row is shared, else none).

    Returns:
      visit: (Q, P) bool — partitions each query must be issued to.
      cands: per-query dict partition → local candidate row indices (into the
        partition's local vector order), int64 ascending. Every visited
        partition carries a non-empty candidate bitmap, so per-partition
        processors prune all non-passing vectors (single-pass guarantee).
        Under a shared row, queries visiting one partition share one
        read-only array.
    """
    queries = np.asarray(queries, dtype=np.float64)
    qn, d = queries.shape
    p = centroids.shape[0]
    # A partition's local rows are its members in ascending global id (the
    # order a live index keeps), so local row j is global id members[pid][j].
    members: List[Optional[np.ndarray]] = [None] * p
    one_row = qn == 1 or filter_masks.strides[0] == 0
    shared: List[Optional[np.ndarray]] = [None] * p
    mask_reads = 0
    n_shared = 0

    def local_rows(qi: int, pid: int) -> np.ndarray:
        nonlocal mask_reads, n_shared
        if one_row:
            n_shared += 1
            if shared[pid] is not None:
                return shared[pid]
        if members[pid] is None:
            members[pid] = np.flatnonzero(assign == pid)
        mask_reads += members[pid].size
        rows = np.flatnonzero(filter_masks[qi][members[pid]])
        if one_row:
            rows.flags.writeable = False
            shared[pid] = rows
        return rows

    dists = np.sqrt(_chunked_sqdist(queries, centroids))
    visit = np.zeros((qn, p), dtype=bool)
    cands: List[Dict[int, np.ndarray]] = []
    near_miss: List[Tuple[float, int, int]] = []  # (margin, q, partition)
    escalated = 0
    for qi in range(qn):
        cand_total = 0
        per_part: Dict[int, np.ndarray] = {}
        ranked = np.argsort(dists[qi])
        dmin = dists[qi, ranked[0]]
        for rank, pid in enumerate(ranked):
            past_cut = dists[qi, pid] > threshold * max(dmin, 1e-12)
            if past_cut and cand_total >= k:
                near_miss.append((dists[qi, pid] / max(dmin, 1e-12), qi, pid))
                break
            rows = local_rows(qi, pid)
            if rows.size:
                visit[qi, pid] = True
                per_part[pid] = rows
                cand_total += rows.size
                if past_cut:
                    escalated += 1
        cands.append(per_part)
    if escalations is not None:
        escalations[0] += escalated
    if balance:
        visits_per_part = visit.sum(axis=0)
        target = max(1, int(np.ceil(visit.sum() / p)))
        near_miss.sort()
        for margin, qi, pid in near_miss:
            if visits_per_part[pid] < target and not visit[qi, pid]:
                rows = local_rows(qi, pid)
                if rows.size:
                    visit[qi, pid] = True
                    cands[qi][pid] = rows
                    visits_per_part[pid] += 1
    if scanned is not None:
        scanned[0] += mask_reads
    if shared_scans is not None:
        shared_scans[0] += n_shared
    return visit, cands
