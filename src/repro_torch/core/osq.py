"""Optimized Scalar Quantization (OSQ) — paper §2.2.

Non-uniform per-dimension bit allocation (variance-greedy, VA+-file lineage),
per-dimension Lloyd-Max scalar quantizers, and encode/decode between float
vectors and per-dimension cell codes.

Build-time code is NumPy (offline indexing), a bit-for-bit copy of the JAX
package's ``repro.core.osq``; the query-time hot path lives in ``adc.py`` /
``lowbit.py`` / ``segments.py`` and ``core/dataplane.py`` as torch code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "allocate_bits",
    "lloyd_max_1d",
    "design_quantizers",
    "encode",
    "decode_cell_centers",
    "OSQQuantizer",
]


def allocate_bits(variances: np.ndarray, budget: int, max_bits: int = 12) -> np.ndarray:
    """Greedy non-uniform bit allocation (paper §2.2.1).

    Bits are iteratively assigned to the dimension with the highest remaining
    variance; each assignment divides that dimension's variance by 4 (one bit
    halves quantization step ⇒ quarters the expected squared error) [22].

    Args:
      variances: (d,) per-dimension variances (post-transform).
      budget: total bit budget ``b`` (paper uses b = 4·d).
      max_bits: cap per dimension. The paper allows >S bits for a single hot
        dimension (e.g. 9 with S=8); segments make that free.

    Returns:
      (d,) int array of per-dimension bit counts, summing to ``budget``.
    """
    var = np.asarray(variances, dtype=np.float64).copy()
    if np.any(var < 0):
        raise ValueError("variances must be non-negative")
    d = var.shape[0]
    if budget > d * max_bits:
        raise ValueError(f"budget {budget} exceeds d*max_bits {d * max_bits}")
    bits = np.zeros(d, dtype=np.int32)
    # Tiny epsilon so zero-variance dims still get bits if budget is huge.
    var = var + 1e-30
    for _ in range(budget):
        j = int(np.argmax(var))
        bits[j] += 1
        var[j] /= 4.0
        if bits[j] >= max_bits:
            var[j] = -np.inf
    return bits


def lloyd_max_1d(
    x: np.ndarray, k: int, iters: int = 25, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Vectorized 1-D Lloyd-Max quantizer design over a batch of dimensions.

    Paper §2.4.1: "efficient one-dimensional K-means clustering to design
    optimal scalar quantizers based on the data distribution" [33].

    Args:
      x: (N, D) samples for D dimensions that all want ``k`` cells.
      k: number of quantization cells.
      iters: Lloyd iterations.

    Returns:
      (k+1, D) cell *boundaries* per dimension: b[0] = -inf, b[k] = +inf,
      interior boundaries are midpoints between sorted centroids.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, dd = x.shape
    # Initialize centroids at quantiles — near-optimal for 1-D, deterministic.
    qs = (np.arange(k, dtype=np.float64) + 0.5) / k
    cent = np.quantile(x, qs, axis=0)  # (k, D)
    for _ in range(iters):
        bounds = (cent[:-1] + cent[1:]) / 2.0  # (k-1, D)
        # Assign: searchsorted per column.
        codes = np.empty((n, dd), dtype=np.int64)
        for j in range(dd):
            codes[:, j] = np.searchsorted(bounds[:, j], x[:, j], side="right")
        # Update: mean of members (keep old centroid when a cell is empty).
        new_cent = cent.copy()
        for c in range(k):
            mask = codes == c
            cnt = mask.sum(axis=0)
            sums = np.where(mask, x, 0.0).sum(axis=0)
            nz = cnt > 0
            new_cent[c, nz] = sums[nz] / cnt[nz]
        new_cent = np.sort(new_cent, axis=0)
        if np.allclose(new_cent, cent, rtol=0, atol=1e-12):
            cent = new_cent
            break
        cent = new_cent
    inner = (cent[:-1] + cent[1:]) / 2.0
    out = np.empty((k + 1, dd), dtype=np.float64)
    out[0] = -np.inf
    out[-1] = np.inf
    out[1:-1] = inner
    return out


@dataclasses.dataclass
class OSQQuantizer:
    """Per-dimension scalar quantizer bundle.

    Attributes:
      bits: (d,) per-dimension bit allocation B.
      boundaries: (M+1, d) padded boundary matrix V. M = max cells. For a
        dimension with C[j] cells only rows 0..C[j] are meaningful; the rest
        are +inf padding (searchsorted then never selects them). Row 0 is the
        *finite* data minimum proxy (used for ADC edge distances); we store
        finite sentinels for ADC and treat the outermost cells as unbounded
        during encode.
      centers: (M, d) cell centroids (padding = +inf).
    """

    bits: np.ndarray
    boundaries: np.ndarray
    centers: np.ndarray

    @property
    def d(self) -> int:
        return int(self.bits.shape[0])

    @property
    def cells(self) -> np.ndarray:
        return (1 << self.bits.astype(np.int64)).astype(np.int64)

    @property
    def max_cells(self) -> int:
        return int(self.cells.max())

    @property
    def total_bits(self) -> int:
        return int(self.bits.sum())


def design_quantizers(
    x: np.ndarray, bits: np.ndarray, iters: int = 25
) -> OSQQuantizer:
    """Design per-dimension Lloyd-Max quantizers under allocation ``bits``."""
    x = np.asarray(x, dtype=np.float64)
    n, d = x.shape
    bits = np.asarray(bits, dtype=np.int32)
    cells = (1 << bits.astype(np.int64)).astype(np.int64)
    m = int(cells.max())
    boundaries = np.full((m + 1, d), np.inf, dtype=np.float64)
    centers = np.full((m, d), np.inf, dtype=np.float64)
    for k in np.unique(cells):
        cols = np.where(cells == k)[0]
        if k == 1:
            # 0 bits: single cell covering everything; center = mean.
            boundaries[0, cols] = -np.inf
            boundaries[1, cols] = np.inf
            centers[0, cols] = x[:, cols].mean(axis=0)
            continue
        b = lloyd_max_1d(x[:, cols], int(k), iters=iters)
        boundaries[: k + 1, cols] = b
        # Centers = member means approximated by midpoint of boundaries,
        # with data min/max standing in for the infinite edges.
        lo = np.minimum(x[:, cols].min(axis=0), b[1])
        hi = np.maximum(x[:, cols].max(axis=0), b[-2])
        bb = b.copy()
        bb[0] = lo
        bb[-1] = hi
        centers[:k, cols] = (bb[:-1] + bb[1:]) / 2.0
    return OSQQuantizer(bits=bits, boundaries=boundaries, centers=centers)


def encode(q: OSQQuantizer, x: np.ndarray) -> np.ndarray:
    """Quantize vectors to per-dimension cell codes. Returns (N, d) int32."""
    x = np.asarray(x, dtype=np.float64)
    n, d = x.shape
    if d != q.d:
        raise ValueError(f"dim mismatch {d} != {q.d}")
    codes = np.empty((n, d), dtype=np.int32)
    cells = q.cells
    for j in range(d):
        k = int(cells[j])
        if k == 1:
            codes[:, j] = 0
        else:
            inner = q.boundaries[1:k, j]
            codes[:, j] = np.searchsorted(inner, x[:, j], side="right")
    return codes


def decode_cell_centers(q: OSQQuantizer, codes: np.ndarray) -> np.ndarray:
    """Reconstruct vectors as their cell centers (for error measurement)."""
    codes = np.asarray(codes)
    n, d = codes.shape
    out = np.empty((n, d), dtype=np.float64)
    for j in range(d):
        out[:, j] = q.centers[codes[:, j], j]
    return out
