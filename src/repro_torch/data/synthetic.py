"""Synthetic datasets: attributed vectors (SQUASH benchmarks) + token streams.

A copy of the JAX package's ``repro.data.synthetic`` (same values from the
same seed), computing the mixture in row chunks so a 1M-row preset fits in
memory. No network is assumed, so SIFT1M/GIST1M/DEEP10M are stood in for by
clustered Gaussians with matching dimensionality and N scaled to the test
budget; attributes follow §5.1 (A = 4 uniform attributes, predicates tuned to
~8 % joint selectivity). Ground truth is exact brute force under the filter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.attributes import Predicate

__all__ = [
    "VectorDataset",
    "make_vector_dataset",
    "default_predicates",
    "ground_truth",
    "DATASET_PRESETS",
    "token_batch",
]

# Paper Table 2 shapes (N scaled down by `scale` at generation time).
# ``lid`` mimics the paper's Local Intrinsic Dimensionality column: points are
# generated on a low-dimensional manifold within each cluster plus small
# ambient noise, so neighborhood structure matches the real benchmarks.
_ROW_CHUNK = 65536

DATASET_PRESETS = {
    "sift1m": dict(n=1_000_000, d=128, clusters=64, lid=13),
    "gist1m": dict(n=1_000_000, d=960, clusters=64, lid=29),
    "sift10m": dict(n=10_000_000, d=128, clusters=128, lid=13),
    "deep10m": dict(n=10_000_000, d=96, clusters=128, lid=10),
}


@dataclasses.dataclass
class VectorDataset:
    name: str
    vectors: np.ndarray     # (N, d) float32
    attributes: np.ndarray  # (N, A) float64 (integer-valued uniform)
    queries: np.ndarray     # (Q, d) float32
    attr_cardinality: int

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def d(self) -> int:
        return int(self.vectors.shape[1])


def make_vector_dataset(
    preset: str = "sift1m",
    scale: float = 0.02,
    num_queries: int = 100,
    num_attributes: int = 4,
    attr_cardinality: int = 16,
    seed: int = 0,
) -> VectorDataset:
    """Clustered-Gaussian stand-in for a paper dataset.

    ``scale`` shrinks N (default 2 % ⇒ 20 000 rows for the 1M presets) while
    keeping d faithful. Vectors are drawn from ``clusters`` anisotropic
    Gaussians — realistic local intrinsic dimensionality for partition/KLT
    behaviour. Queries are held-out draws from the same mixture.
    """
    spec = DATASET_PRESETS[preset]
    n = max(int(spec["n"] * scale), 1024)
    d = spec["d"]
    lid = spec["lid"]
    c = min(spec["clusters"], max(4, n // 256))
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, size=(c, d))
    # Low intrinsic dimensionality: each cluster lives on a ``lid``-dim
    # affine manifold (random basis, decaying energy) + small ambient noise,
    # matching the LID figures of Table 2 and giving real neighbor structure.
    bases = rng.normal(size=(c, lid, d)) / np.sqrt(d)
    energies = np.geomspace(4.0, 0.5, lid)
    which = rng.integers(0, c, size=n + num_queries)
    latent = rng.normal(size=(n + num_queries, lid)) * energies[None, :]
    ambient = rng.normal(size=(n + num_queries, d)) * 0.05
    # The reference's einsum over the whole (N, lid, d) gather would hold
    # N·lid·d float64 at once (13 GB at N = 1M); row chunks give the same
    # values, each output element summed over l in the same order.
    pts = np.empty_like(ambient)
    for lo in range(0, pts.shape[0], _ROW_CHUNK):
        hi = min(lo + _ROW_CHUNK, pts.shape[0])
        w = which[lo:hi]
        pts[lo:hi] = (centers[w]
                      + np.einsum("nl,nld->nd", latent[lo:hi], bases[w])
                      + ambient[lo:hi])
    attrs = rng.integers(0, attr_cardinality, size=(n, num_attributes)).astype(
        np.float64
    )
    return VectorDataset(
        name=preset,
        vectors=pts[:n].astype(np.float32),
        attributes=attrs,
        queries=pts[n:].astype(np.float32),
        attr_cardinality=attr_cardinality,
    )


def default_predicates(
    attr_cardinality: int = 16,
    num_attributes: int = 4,
    target_selectivity: float = 0.08,
) -> List[Predicate]:
    """Conjunctive predicates with ≈8 % joint selectivity (paper §5.1).

    Per-attribute selectivity s = target^(1/A); each attribute gets a range
    predicate covering ⌈s·cardinality⌉ integer values.
    """
    s = target_selectivity ** (1.0 / num_attributes)
    width = max(1, int(round(s * attr_cardinality)))
    preds = []
    for a in range(num_attributes):
        lo = (a * 3) % max(attr_cardinality - width, 1)
        preds.append(Predicate(attr=a, op="B", lo=float(lo), hi=float(lo + width - 1)))
    return preds


def ground_truth(
    ds: VectorDataset, predicates: Sequence[Predicate], k: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact filtered top-k by brute force. Returns (ids (Q,k), dists (Q,k))."""
    from repro_torch.core.attributes import ground_truth_mask

    mask = ground_truth_mask(ds.attributes, predicates)
    idx = np.where(mask)[0]
    sub = ds.vectors[idx].astype(np.float64)
    out_ids = np.full((ds.queries.shape[0], k), -1, dtype=np.int64)
    out_d = np.full((ds.queries.shape[0], k), np.inf)
    for qi, q in enumerate(ds.queries.astype(np.float64)):
        dist = np.sqrt(((sub - q[None, :]) ** 2).sum(axis=1))
        kk = min(k, idx.size)
        best = np.argpartition(dist, kk - 1)[:kk]
        best = best[np.argsort(dist[best])]
        out_ids[qi, :kk] = idx[best]
        out_d[qi, :kk] = dist[best]
    return out_ids, out_d


def token_batch(
    batch: int, seq_len: int, vocab: int, seed: int = 0, shard: int = 0
) -> np.ndarray:
    """Deterministic per-shard token stream for LM training/smoke tests."""
    rng = np.random.default_rng(seed * 1_000_003 + shard)
    return rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int32)
