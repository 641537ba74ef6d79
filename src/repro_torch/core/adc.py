"""Asymmetric lower-bound distances via per-query lookup tables (paper §2.4.4).

For query q and dimension j, ``L[c, j]`` holds the squared distance from
``q[j]`` to the *nearest edge* of cell ``c``: 0 if c is q's own cell, distance
to the right boundary if c < cell(q[j]), to the left boundary if c > cell(q[j]).
LB(vec) = sqrt(Σ_j L[code_j, j]) — a VA-file-style lower bound on Euclidean
distance [68], asymmetric because the query stays un-quantized [31].

Building L costs (Σ_j C[j]) − 1 subtractions; evaluating candidates is a
gather + row-sum ("advanced indexing"). On the card the gather reads the table
from shared memory in a hand-written CUDA kernel — see
``repro_torch.kernels.adc_lookup``; ``build_adc_table`` is a NumPy copy of the
JAX package's ``repro.core.adc``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_adc_table", "lb_distances", "lb_distances_onehot"]


def build_adc_table(
    query: np.ndarray, boundaries: np.ndarray, cells: np.ndarray
) -> np.ndarray:
    """Construct L of shape (M+1, d) for one query (vectorized, NumPy).

    Args:
      query: (d,) un-quantized query (same transform space as the index).
      boundaries: (M+1, d) padded boundary matrix V (±inf edges, +inf padding).
        Row c is the left boundary of cell c; row c+1 its right boundary.
      cells: (d,) per-dimension cell counts C.
    Returns:
      (M+1, d) float32 squared edge distances; rows ≥ C[j] are +inf padding
      (valid codes never index them).

    For any valid cell c with c < cell(q[j]) the right boundary (row c+1 ≤
    C[j]−1) is an interior, finite boundary; symmetrically for c > cell(q[j]).
    The query's own cell contributes 0. Hence every reachable entry is finite.
    """
    q = np.asarray(query, dtype=np.float64)
    boundaries = np.asarray(boundaries, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int64)
    m1, d = boundaries.shape
    qcell = np.empty(d, dtype=np.int64)
    for j in range(d):
        k = int(cells[j])
        qcell[j] = 0 if k == 1 else np.searchsorted(
            boundaries[1:k, j], q[j], side="right"
        )
    cell_idx = np.arange(m1)[:, None]                  # (M+1, 1)
    right = np.vstack([boundaries[1:], np.full((1, d), np.inf)])
    left = boundaries
    diff = np.where(
        cell_idx < qcell[None, :],
        q[None, :] - right,
        np.where(cell_idx > qcell[None, :], left - q[None, :], 0.0),
    )
    out = np.square(diff)
    out[~np.isfinite(diff)] = np.inf
    out = np.where(cell_idx >= cells[None, :], np.inf, out)
    return out.astype(np.float32)


def lb_distances(table, codes):
    """Gather formulation: (M+1, d) table, (N, d) codes → (N,) LB distances."""
    t = torch.as_tensor(table)
    c = torch.as_tensor(codes, device=t.device).to(torch.int64)
    picked = t[c, torch.arange(c.shape[1], device=t.device)[None, :]]  # (N, d)
    return torch.sqrt(torch.sum(picked, dim=-1))


def lb_distances_onehot(table, codes):
    """One-hot formulation: one-hot(codes) contracted against the table.

    Mathematically identical to :func:`lb_distances` (the TPU formulation,
    kept as a second oracle). Padding rows of ``table`` are +inf, but one-hot
    rows never select them, so we zero the padding before the contraction.
    """
    t = torch.as_tensor(table)
    c = torch.as_tensor(codes, device=t.device).to(torch.int64)
    m1 = t.shape[0]
    t_safe = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    onehot = torch.nn.functional.one_hot(c, m1).to(t.dtype)   # (N, d, M+1)
    picked = torch.einsum("ndm,md->n", onehot, t_safe)
    return torch.sqrt(picked)
