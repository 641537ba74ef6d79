"""Recall-targeted Hamming threshold autotune (paper §2.4 / Fig. 5, Eq. 1).

SQUASH prunes most vectors at the low-bit Hamming lower-bound stage; the
static ``SquashConfig.hamming_perc`` applies one keep fraction to every
partition, but how well Hamming LB ranks predict exact ranks varies per
partition (KLT quality, local intrinsic dimensionality, cluster shape).
This module derives **per-partition** keep fractions from a seeded
calibration pass so search hits a recall target with strictly fewer ADC
evaluations than the one-knob configuration:

1. Sample calibration queries (held-out draws from the indexed vectors by
   default, or a caller-provided query set).
2. Replay Algorithm 1 unfiltered, so each sampled query visits the same
   partitions production queries would.
3. Per visited (query, partition): rank all resident rows by Hamming LB and
   by exact distance; record (a) the Spearman rank correlation between the
   two orders and (b) the minimal keep count such that the partition's exact
   top-k rows all survive the Hamming cut.
4. Per partition: the keep fraction is a high quantile (the recall target)
   of the sampled required fractions, inflated by a safety margin that grows
   as the LB/exact rank correlation degrades, and floored globally.

The result is a :class:`CalibrationProfile` — a serializable dict-of-arrays
artifact, deterministic given (index, sample, seed) — consumed by every
data plane through :func:`keep_fracs` / :func:`keep_floor`:
``core.pipeline`` (NumPy reference) and ``core.dataplane`` (batched torch
plane, via ``stage_counts``/``static_counts``). All backends must return
bitwise-identical ids under the same profile. This module is a copy of the
JAX package's ``repro.core.autotune`` over the port's own pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "CalibrationProfile", "calibrate", "keep_count", "keep_counts",
    "keep_fracs", "keep_floor", "spearman",
]


# ------------------------------------------------------------ keep-count math

def keep_count(n: int, frac: float, floor: int) -> int:
    """Hamming survivors for ``n`` candidates at keep fraction ``frac`` (%).

    The single reference formula every data plane derives from:
    ``max(min(floor, n), ceil(n · frac / 100))`` clamped to ``n``. The floor
    keeps tiny candidate sets alive (paper default 64); zero candidates keep
    zero rows.
    """
    n = int(n)
    if n <= 0:
        return 0
    keep = max(min(int(floor), n), int(np.ceil(n * float(frac) / 100.0)))
    return min(keep, n)


def keep_counts(n: np.ndarray, frac, floor: int) -> np.ndarray:
    """Vectorized :func:`keep_count` — ``frac`` scalar or broadcastable."""
    n = np.asarray(n, dtype=np.int64)
    keep = np.maximum(
        np.minimum(int(floor), n),
        np.ceil(n * np.asarray(frac, dtype=np.float64) / 100.0).astype(
            np.int64),
    )
    return np.minimum(keep, n)


def keep_fracs(config, profile: Optional["CalibrationProfile"],
               p: int) -> np.ndarray:
    """(p,) per-partition keep percentages for one index.

    ``profile=None`` broadcasts the static ``config.hamming_perc``; a profile
    supplies its calibrated vector, edge-padded when the consumer stacked
    extra (empty) partition slots (``stack_index(pad_to_multiple=...)``).
    """
    if profile is None:
        return np.full(p, float(config.hamming_perc))
    frac = np.asarray(profile.keep_frac, dtype=np.float64)
    if frac.shape[0] < p:
        frac = np.pad(frac, (0, p - frac.shape[0]), mode="edge")
    return frac[:p]


def keep_floor(config, profile: Optional["CalibrationProfile"]) -> int:
    """The global keep floor: profile's calibrated floor, else the config's."""
    return int(config.min_hamming_keep if profile is None
               else profile.min_keep)


# ------------------------------------------------------------------ profile

@dataclasses.dataclass
class CalibrationProfile:
    """Serializable per-partition keep-budget artifact.

    ``keep_frac[p]`` is the percentage of partition ``p``'s post-filter
    candidates kept past the Hamming stage; ``min_keep`` is the global floor
    replacing ``SquashConfig.min_hamming_keep``. ``rank_corr``/``required``
    are calibration diagnostics (mean Spearman LB/exact correlation and the
    raw per-partition quantile before the safety margin).
    """

    keep_frac: np.ndarray          # (P,) float64 percent, in (0, 100]
    min_keep: int                  # global floor on kept rows
    recall_target: float
    seed: int
    sample_queries: int
    rank_corr: np.ndarray          # (P,) mean Spearman corr (diagnostic)
    required: np.ndarray           # (P,) pre-margin quantile (diagnostic)

    def __post_init__(self):
        self.keep_frac = np.asarray(self.keep_frac, dtype=np.float64)
        self.rank_corr = np.asarray(self.rank_corr, dtype=np.float64)
        self.required = np.asarray(self.required, dtype=np.float64)
        if self.keep_frac.ndim != 1 or self.keep_frac.shape[0] == 0:
            raise ValueError("keep_frac must be a non-empty 1-D vector")
        if not ((self.keep_frac > 0) & (self.keep_frac <= 100.0)).all():
            raise ValueError("keep_frac entries must be in (0, 100]")
        if self.min_keep < 1:
            raise ValueError("min_keep must be >= 1")

    @property
    def num_partitions(self) -> int:
        return int(self.keep_frac.shape[0])

    def to_dict(self) -> Dict:
        """Plain-types artifact (JSON-safe); :meth:`from_dict` round-trips."""
        return {
            "keep_frac": [float(x) for x in self.keep_frac],
            "min_keep": int(self.min_keep),
            "recall_target": float(self.recall_target),
            "seed": int(self.seed),
            "sample_queries": int(self.sample_queries),
            "rank_corr": [float(x) for x in self.rank_corr],
            "required": [float(x) for x in self.required],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "CalibrationProfile":
        return cls(
            keep_frac=np.asarray(d["keep_frac"], dtype=np.float64),
            min_keep=int(d["min_keep"]),
            recall_target=float(d["recall_target"]),
            seed=int(d["seed"]),
            sample_queries=int(d["sample_queries"]),
            rank_corr=np.asarray(d["rank_corr"], dtype=np.float64),
            required=np.asarray(d["required"], dtype=np.float64),
        )


# -------------------------------------------------------------- measurement

def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation with average-rank tie handling."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.size < 2:
        return 1.0
    ra = _avg_ranks(a)
    rb = _avg_ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    if denom == 0.0:
        return 1.0
    return float((ra * rb).sum() / denom)


def _avg_ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share their mean rank), 0-based."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(x.size, dtype=np.float64)
    ranks[order] = np.arange(x.size, dtype=np.float64)
    # Average tied groups: sort values, find runs, assign mean rank.
    sx = x[order]
    i = 0
    while i < sx.size:
        j = i
        while j + 1 < sx.size and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def _partition_hamming(part, query: np.ndarray) -> np.ndarray:
    """Low-bit Hamming LB of ``query`` against every row of one partition."""
    from repro_torch.core.pipeline import _popcount_u32

    qbits = part.low.encode_queries((query - part.mean)[None, :])[0]
    x = np.bitwise_xor(part.low.packed, qbits[None, :])
    return _popcount_u32(x).sum(axis=1)


# -------------------------------------------------------------- calibration

def calibrate(
    index,
    queries: Optional[np.ndarray] = None,
    *,
    recall_target: float = 0.95,
    k: int = 10,
    sample: int = 64,
    seed: int = 0,
    min_keep: Optional[int] = None,
    margin: float = 0.5,
    quantile: Optional[float] = None,
) -> CalibrationProfile:
    """Measure LB/exact rank agreement and derive per-partition keep budgets.

    Args:
      index: a built ``SquashIndex``.
      queries: optional (S, d) calibration query set. Default: ``sample``
        seeded draws from the indexed vectors themselves, jittered by a small
        fraction of the dataset scale so calibration queries are near — not
        exactly on — database points (the paper's query distribution).
      recall_target: target recall@k the profile is tuned for; also the
        quantile of the per-partition required-keep distribution (unless
        ``quantile`` overrides it).
      k: the top-k the target refers to (also Stage 5's refinement k).
      sample: number of auto-drawn calibration queries when ``queries=None``.
      seed: RNG seed — calibration is fully deterministic given it.
      min_keep: global floor; default ``2 · ceil(refine_ratio · k)`` so the
        Stage 4 → Stage 5 take (R·k) never consumes the whole Hamming set.
      margin: safety inflation per unit of *missing* rank correlation:
        ``frac *= 1 + margin · (1 − corr_p)``.
      quantile: override for the required-keep quantile.
    Returns:
      a :class:`CalibrationProfile` (see module docstring).
    """
    from repro_torch.core import partitions as part_mod

    cfg = index.config
    p = len(index.parts)
    rng = np.random.default_rng(seed)
    if queries is None:
        # Sample (partition, row) pairs through the per-partition sizes —
        # no transient copy of the whole dataset on the serving path.
        sizes = np.array([pt.size for pt in index.parts], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        pick = np.sort(rng.choice(int(offsets[-1]),
                                  size=min(sample, int(offsets[-1])),
                                  replace=False))
        pids = np.searchsorted(offsets, pick, side="right") - 1
        queries = np.stack([
            index.parts[pid].vectors[g - offsets[pid]]
            for pid, g in zip(pids, pick)
        ]).astype(np.float64)
        jitter = 0.01 * float(np.std(queries))
        queries = queries + rng.normal(0.0, jitter, size=queries.shape)
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
    s = queries.shape[0]

    # Replay Algorithm 1 unfiltered: calibration sees the partitions (and
    # candidate populations) production queries see before predicates thin
    # them — keep *fractions* transfer across selectivities.
    n_total = sum(pt.size for pt in index.parts)
    f = np.ones((s, n_total), dtype=bool)
    _, cands = part_mod.select_partitions(
        queries, index.partitioning.centroids, f,
        index.partitioning.assign, index.partitioning.threshold, k)

    req_fracs = [[] for _ in range(p)]       # required keep fraction samples
    corrs = [[] for _ in range(p)]           # Spearman samples
    for qi in range(s):
        per_part = {}
        pool = []                            # (exact, pid, local_row) stream
        for pid in sorted(cands[qi]):
            part = index.parts[pid]
            n = part.size
            if n < 2:
                continue
            ham = _partition_hamming(part, queries[qi])
            exact = np.sqrt(
                ((part.vectors - queries[qi][None, :]) ** 2).sum(axis=1))
            corrs[pid].append(spearman(ham, exact))
            # Hamming rank of every row under the plane's (ham, row) total
            # order — the order Stage 3's cut walks.
            comp = ham.astype(np.int64) * n + np.arange(n)
            ham_rank = np.empty(n, dtype=np.int64)
            ham_rank[np.argsort(comp, kind="stable")] = np.arange(n)
            per_part[pid] = (ham_rank, n)
            kk = min(k, n)
            local_top = np.argsort(exact, kind="stable")[:kk]
            pool.extend(
                (float(exact[r]), pid, int(r)) for r in local_top)
        if not pool:
            continue
        # Recall@k is a *global* property: only the rows in the query's
        # global top-k must survive their home partition's Hamming cut, so
        # the required keep count is the worst Hamming rank among a
        # partition's global-top-k residents — zero for partitions that
        # contribute nothing (they only ever need the floor).
        pool.sort()
        winners: Dict[int, list] = {}
        for exact_d, pid, row in pool[:k]:
            winners.setdefault(pid, []).append(row)
        for pid, (ham_rank, n) in per_part.items():
            rows = winners.get(pid)
            need = int(ham_rank[rows].max()) + 1 if rows else 0
            req_fracs[pid].append(need / n)

    if min_keep is None:
        take_cap = int(np.ceil(cfg.refine_ratio * k)) if cfg.enable_refine \
            else k
        min_keep = max(2 * take_cap, 16)
    q = recall_target if quantile is None else quantile
    keep_frac = np.empty(p, dtype=np.float64)
    rank_corr = np.empty(p, dtype=np.float64)
    required = np.empty(p, dtype=np.float64)
    fallback = float(cfg.hamming_perc)
    for pid in range(p):
        if not req_fracs[pid]:
            # Partition never visited by the sample: keep the static knob.
            required[pid] = fallback / 100.0
            rank_corr[pid] = 0.0
            keep_frac[pid] = fallback
            continue
        base = float(np.quantile(np.asarray(req_fracs[pid]), q))
        corr = float(np.mean(corrs[pid]))
        rank_corr[pid] = corr
        required[pid] = base
        inflated = base * (1.0 + margin * max(0.0, 1.0 - corr))
        keep_frac[pid] = float(np.clip(inflated * 100.0, 1e-3, 100.0))
    return CalibrationProfile(
        keep_frac=keep_frac,
        min_keep=int(min_keep),
        recall_target=float(recall_target),
        seed=int(seed),
        sample_queries=int(s),
        rank_corr=rank_corr,
        required=required,
    )
