"""Inputs made from the seed: the attributed-vector corpus and the batches.

``make_vector_dataset`` is a frozen copy of the port's
``repro_torch.data.synthetic.make_vector_dataset`` (same values from the
same seed), kept here so that a change to the program cannot move the
benchmark's data. ``batch_inputs`` is the traffic generator: one batch's
queries and conjunctive range predicate, a function of (seed, batch index)
and the traffic file alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

_ROW_CHUNK = 65536


@dataclasses.dataclass
class Corpus:
    vectors: np.ndarray     # (N, d) float32
    attributes: np.ndarray  # (N, A) float64, integer-valued
    queries: np.ndarray     # (pool, d) float32, held-out draws


def make_vector_dataset(rows: int, d: int, clusters: int, lid: int,
                        num_queries: int, num_attributes: int,
                        attr_cardinality: int, seed: int) -> Corpus:
    """Clustered Gaussians on ``lid``-dimensional manifolds (§5.1 stand-in).

    The program's ``make_vector_dataset(preset, scale=rows / n, ...)``
    draws the same values for a preset of the same d, clusters and lid.
    """
    n = max(int(rows), 1024)
    c = min(clusters, max(4, n // 256))
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, size=(c, d))
    bases = rng.normal(size=(c, lid, d)) / np.sqrt(d)
    energies = np.geomspace(4.0, 0.5, lid)
    which = rng.integers(0, c, size=n + num_queries)
    latent = rng.normal(size=(n + num_queries, lid)) * energies[None, :]
    ambient = rng.normal(size=(n + num_queries, d)) * 0.05
    pts = np.empty_like(ambient)
    for lo in range(0, pts.shape[0], _ROW_CHUNK):
        hi = min(lo + _ROW_CHUNK, pts.shape[0])
        w = which[lo:hi]
        pts[lo:hi] = (centers[w]
                      + np.einsum("nl,nld->nd", latent[lo:hi], bases[w])
                      + ambient[lo:hi])
    attrs = rng.integers(0, attr_cardinality, size=(n, num_attributes)
                         ).astype(np.float64)
    return Corpus(vectors=pts[:n].astype(np.float32), attributes=attrs,
                  queries=pts[n:].astype(np.float32))


def corpus(config: dict, traffic: dict, seed: int) -> Corpus:
    """The cell's corpus: the configuration's data, the traffic's pool."""
    data = config["data"]
    return make_vector_dataset(
        data["rows"], data["dim"], data["clusters"], data["lid"],
        traffic["query_pool"], data["attributes"], data["attr_cardinality"],
        seed)


Predicate = Tuple[int, float, float]   # (attribute, lo, hi), inclusive


def batch_inputs(traffic: dict, cardinality: int, pool: np.ndarray,
                 seed: int, b: int) -> Tuple[np.ndarray, List[Predicate]]:
    """Batch ``b``: Q queries in pool order, one conjunctive predicate.

    Each attribute gets a range of ``width`` values at an offset drawn from
    (seed, b); the widths fix the joint selectivity, so every batch does
    the same amount of filtering whatever its offsets. Warm-up batches use
    negative ``b`` and draw from a stream of their own.
    """
    q = traffic["batch"]
    rows = (b * q + np.arange(q)) % pool.shape[0]
    rng = np.random.default_rng([int(seed), 1 if b < 0 else 0, abs(int(b))])
    preds = []
    for a, width in enumerate(traffic["predicate_widths"]):
        lo = int(rng.integers(0, cardinality - width + 1))
        preds.append((a, float(lo), float(lo + width - 1)))
    return pool[rows].astype(np.float64), preds


def filter_mask(attributes: np.ndarray, preds: List[Predicate]) -> np.ndarray:
    """Raw-value semantics of a conjunction of inclusive ranges: (N,) bool."""
    mask = np.ones(attributes.shape[0], dtype=bool)
    for a, lo, hi in preds:
        mask &= (attributes[:, a] >= lo) & (attributes[:, a] <= hi)
    return mask
