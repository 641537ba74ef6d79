"""SQUASH's index build (paper §2.2–2.4), written for the reference.

Balanced k-means, the Eq. 1 threshold, bit allocation, encoding and the
1-bit index follow the paper's algorithms step for step, in the order the
SQUASH reference implementation takes them, so that the same corpus gives
the same partitions, the same quantizer cells and the same codes. The
Lloyd-Max design accumulates each cell's sum with ``np.bincount``, one
column at a time, which is the same arithmetic as a masked sum in row
order.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Part:
    ids: np.ndarray          # (n_p,) global ids, ascending
    mean: np.ndarray         # (d,)
    klt: np.ndarray          # (d, d), columns in descending variance
    boundaries: np.ndarray   # (M+1, d), +inf past a dim's cells
    cells: np.ndarray        # (d,) int64
    codes: np.ndarray        # (n_p, d) int64
    low_words: np.ndarray    # (n_p, G) uint32, MSB-first bits
    low_mean: np.ndarray     # (d,)
    low_std: np.ndarray      # (d,) floored at 1e-12
    vectors: np.ndarray      # (n_p, d) float64


@dataclasses.dataclass
class Index:
    centroids: np.ndarray    # (P, d)
    assign: np.ndarray       # (N,) home partition
    threshold: float         # Eq. 1 T
    parts: List[Part]


def sqdist(x: np.ndarray, cent: np.ndarray, chunk: int = 8192) -> np.ndarray:
    """Squared distances by the norm expansion, in row chunks, floored at 0."""
    out = np.empty((x.shape[0], cent.shape[0]), dtype=np.float64)
    c2 = (cent ** 2).sum(-1)
    for lo in range(0, x.shape[0], chunk):
        xx = x[lo:lo + chunk]
        out[lo:lo + chunk] = ((xx ** 2).sum(-1)[:, None] - 2 * xx @ cent.T
                              + c2[None, :])
    return np.maximum(out, 0.0)


def balanced_kmeans(x: np.ndarray, p: int, iters: int, seed: int,
                    slack: float = 1.05):
    """Capacity-constrained Lloyd: rows placed greedily by assignment margin
    (best minus second-best distance, most decided first), each into its
    nearest centroid with room under ``slack * ceil(N / P)``."""
    n, d = x.shape
    rng = np.random.default_rng(seed)
    cent = x[rng.choice(n, size=p, replace=False)].copy()
    cap = int(np.ceil(slack * n / p))
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = (((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
              if n * p * d < 5e7 else sqdist(x, cent))
        two = np.partition(d2, 1, axis=1)
        order = np.argsort(two[:, 0] - two[:, 1])
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


def eq1_threshold(x, centroids, assign, beta: float, sample: int = 20000,
                  seed: int = 0) -> float:
    """T = 1 + σ_µ/µ_µ + β·√d over a seeded sample of the distance-ratio
    matrix (each row over its home-centroid distance)."""
    n, d = x.shape
    if n > sample:
        idx = np.random.default_rng(seed).choice(n, size=sample,
                                                 replace=False)
        x, assign, n = x[idx], assign[idx], sample
    dist = np.sqrt(sqdist(x, centroids))
    ratio = dist / np.maximum(dist[np.arange(n), assign][:, None], 1e-12)
    mu_mu = float(ratio.mean(axis=1).mean())
    sigma_mu = float(ratio.std(axis=1).mean())
    return 1.0 + sigma_mu / max(mu_mu, 1e-12) + beta * np.sqrt(d)


def allocate_bits(var: np.ndarray, budget: int, max_bits: int) -> np.ndarray:
    """Greedy allocation: each bit to the dim of highest remaining variance,
    which it quarters; a dim at ``max_bits`` takes no more."""
    var = np.asarray(var, dtype=np.float64).copy() + 1e-30
    bits = np.zeros(var.shape[0], dtype=np.int64)
    for _ in range(budget):
        j = int(np.argmax(var))
        bits[j] += 1
        var[j] /= 4.0
        if bits[j] >= max_bits:
            var[j] = -np.inf
    return bits


def lloyd_max(x: np.ndarray, k: int, iters: int) -> np.ndarray:
    """1-D Lloyd-Max over the columns of ``x`` that all get ``k`` cells:
    centroids start at the (c + ½)/k quantiles; the group stops when no
    centroid moved by more than 1e-12. Returns (k+1, D) boundaries."""
    n, dd = x.shape
    cent = np.quantile(x, (np.arange(k, dtype=np.float64) + 0.5) / k, axis=0)
    for _ in range(iters):
        bounds = (cent[:-1] + cent[1:]) / 2.0
        new = cent.copy()
        for j in range(dd):
            code = np.searchsorted(bounds[:, j], x[:, j], side="right")
            cnt = np.bincount(code, minlength=k)
            sums = np.bincount(code, weights=x[:, j], minlength=k)
            nz = cnt > 0
            new[nz, j] = sums[nz] / cnt[nz]
        new = np.sort(new, axis=0)
        done = np.allclose(new, cent, rtol=0, atol=1e-12)
        cent = new
        if done:
            break
    out = np.empty((k + 1, dd), dtype=np.float64)
    out[0], out[-1] = -np.inf, np.inf
    out[1:-1] = (cent[:-1] + cent[1:]) / 2.0
    return out


def quantizers(xt: np.ndarray, bits: np.ndarray, iters: int):
    """Per-dim boundaries (M+1, d) and cell counts under ``bits``."""
    cells = (1 << bits.astype(np.int64)).astype(np.int64)
    m = int(cells.max())
    bnd = np.full((m + 1, xt.shape[1]), np.inf)
    for k in np.unique(cells):
        cols = np.where(cells == k)[0]
        if k == 1:
            bnd[0, cols] = -np.inf
            continue
        bnd[:k + 1, cols] = lloyd_max(xt[:, cols], int(k), iters)
    return bnd, cells


def encode(bnd: np.ndarray, cells: np.ndarray, xt: np.ndarray) -> np.ndarray:
    codes = np.zeros(xt.shape, dtype=np.int64)
    for j in range(xt.shape[1]):
        if cells[j] > 1:
            codes[:, j] = np.searchsorted(bnd[1:cells[j], j], xt[:, j],
                                          side="right")
    return codes


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, d) {0, 1} → (N, ceil(d / 32)) uint32, first dim in the top bit."""
    n, d = bits.shape
    g = -(-d // 32)
    padded = np.zeros((n, g * 32), dtype=np.uint64)
    padded[:, :d] = bits
    weights = np.uint64(1) << np.arange(31, -1, -1, dtype=np.uint64)
    return (padded.reshape(n, g, 32) * weights).sum(-1).astype(np.uint32)


def build_part(x: np.ndarray, ids: np.ndarray, cfg: dict) -> Part:
    d = x.shape[1]
    mean = x.mean(axis=0)
    xc = x - mean
    if x.shape[0] > d:
        cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
        klt = np.linalg.eigh(cov)[1][:, ::-1]
    else:
        klt = np.eye(d)
    xt = xc @ klt
    bits = allocate_bits(xt.var(axis=0), int(round(cfg["bits_per_dim"] * d)),
                         cfg["max_bits_per_dim"])
    bnd, cells = quantizers(xt, bits, cfg["lloyd_iters"])
    low_mean, low_std = xc.mean(axis=0), xc.std(axis=0)
    z = (xc - low_mean) / np.maximum(low_std, 1e-12)
    return Part(ids=ids, mean=mean, klt=np.ascontiguousarray(klt),
                boundaries=bnd, cells=cells, codes=encode(bnd, cells, xt),
                low_words=pack_bits((z > 0).astype(np.uint8)),
                low_mean=low_mean, low_std=np.maximum(low_std, 1e-12),
                vectors=x)


def build(vectors: np.ndarray, cfg: dict) -> Index:
    """The whole index from the corpus' vectors and the configuration's
    ``index`` block."""
    x = np.asarray(vectors, dtype=np.float64)
    cent, assign = balanced_kmeans(x, cfg["num_partitions"],
                                   cfg["kmeans_iters"], cfg["build_seed"])
    t = eq1_threshold(x, cent, assign, cfg["beta"])
    parts = []
    for pid in range(cfg["num_partitions"]):
        ids = np.where(assign == pid)[0]
        parts.append(build_part(x[ids], ids, cfg))
    return Index(centroids=cent, assign=assign, threshold=t, parts=parts)
