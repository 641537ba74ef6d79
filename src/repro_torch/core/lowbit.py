"""Low-bit (binary) OSQ index for fast Hamming pruning (paper §2.4.3).

One bit per dimension: standardize, threshold at 0, pack 32 dims per uint32
lane via the OSQ segment scheme. Query→candidate Hamming distances are
XOR + popcount over packed words; the best ``H_perc`` % of candidates (ascending
Hamming order) survive to the fine-grained ADC stage.

Build-time code is a NumPy copy of the JAX package's ``repro.core.lowbit``.
The query-side distances go through ``repro_torch.kernels.ops``: the CUDA
Hamming kernel for tensors on the card, its plain PyTorch twin on the CPU.
Packed words travel as int32 tensors holding the uint32 bit patterns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["LowBitIndex", "build_lowbit_index", "binarize", "pack_bits_u32",
           "as_words", "hamming_distances", "hamming_prune"]


def binarize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Standardize then threshold around 0 (paper §2.4.3). Returns {0,1} int8."""
    z = (np.asarray(x, dtype=np.float64) - mean) / np.maximum(std, 1e-12)
    return (z > 0).astype(np.int8)


def pack_bits_u32(bits: np.ndarray) -> np.ndarray:
    """Pack (N, d) {0,1} into (N, ceil(d/32)) uint32, MSB-first per word."""
    bits = np.asarray(bits)
    n, d = bits.shape
    g = -(-d // 32)
    padded = np.zeros((n, g * 32), dtype=np.uint64)
    padded[:, :d] = bits
    weights = 1 << np.arange(31, -1, -1, dtype=np.uint64)
    return (padded.reshape(n, g, 32) @ weights).astype(np.uint32)


@dataclasses.dataclass
class LowBitIndex:
    """Packed binary codes + standardization stats."""

    packed: np.ndarray  # (N, G32) uint32
    mean: np.ndarray    # (d,)
    std: np.ndarray     # (d,)
    d: int

    def encode_queries(self, q: np.ndarray) -> np.ndarray:
        return pack_bits_u32(binarize(q, self.mean, self.std))


def build_lowbit_index(x: np.ndarray) -> LowBitIndex:
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    packed = pack_bits_u32(binarize(x, mean, std))
    return LowBitIndex(packed=packed, mean=mean, std=std, d=x.shape[1])


def as_words(packed, device=None) -> torch.Tensor:
    """Packed uint32 words as their int32 bit pattern (the port's layout).

    Accepts a numpy uint32 array or an int32 tensor; the bits are unchanged.
    """
    if isinstance(packed, torch.Tensor):
        if packed.dtype != torch.int32:
            raise TypeError(f"packed words must be int32, got {packed.dtype}")
        return packed.to(device)
    arr = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def hamming_distances(q_packed, db_packed):
    """Hamming distance between one packed query and all packed rows.

    Args:
      q_packed: (G,) packed words (numpy uint32 or int32 tensor).
      db_packed: (N, G) packed words.
    Returns:
      (N,) int32 on ``q_packed``'s device (the CPU for numpy input) —
      Eq. 2, computed 32 dims per popcount lane.
    """
    from repro_torch.kernels import ops

    q = as_words(q_packed)
    db = as_words(db_packed, q.device)
    return ops.hamming_distances(q, db)


def hamming_prune(q_packed, db_packed, candidate_mask, keep: int):
    """Retain the ``keep`` best candidates by ascending Hamming distance.

    Non-candidates (mask 0) are pushed to +inf so they never survive. Ties
    resolve by ascending row (a stable sort). Returns (indices, distances) of
    the kept set, both length ``keep``.
    """
    dist = hamming_distances(q_packed, db_packed)
    mask = torch.as_tensor(candidate_mask, device=dist.device).to(torch.bool)
    big = torch.iinfo(torch.int32).max
    dist = torch.where(mask, dist, torch.full_like(dist, big))
    order = torch.sort(dist, stable=True).indices[:keep]
    return order, dist[order]
