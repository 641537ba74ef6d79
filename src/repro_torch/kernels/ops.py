"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The counterpart of the JAX package's ``repro.kernels.ops``, with one rule:
the tensor's device alone decides. A CUDA tensor goes to the hand-written
kernel (which raises if it cannot launch), a CPU tensor to the plain
version in :mod:`repro_torch.kernels.ref`. There is no fallback and no
override.
"""

from __future__ import annotations

from typing import Dict

from torch.distributed.tensor import DTensor

from repro_torch.core.segments import SegmentLayout
from repro_torch.kernels import adc_lookup, bitpack, hamming, ref, ssd

__all__ = ["hamming_distances", "hamming_stacked", "adc_distances",
           "adc_batch", "adc_table", "adc_direct", "extract_codes",
           "ssd_intra", "launch_counts", "reset_launch_counts"]


def hamming_distances(q_packed, db_packed):
    """(G,) query words vs (N, G) rows → (N,) int32 Hamming."""
    if q_packed.is_cuda:
        return hamming.packed_hamming(q_packed, db_packed)
    return ref.hamming_ref(q_packed, db_packed)


def hamming_stacked(q_packed, db_packed):
    """(Q, P, G) query words vs (P, N, G) stacked rows → (Q, P, N) int32."""
    if q_packed.is_cuda:
        return hamming.hamming_stacked(q_packed, db_packed)
    return ref.hamming_stacked_ref(q_packed, db_packed)


def adc_distances(table, codes, *, sqrt: bool = True):
    """(M+1, d) f32 table + (N, d) codes → (N,) f32 LB distances."""
    if table.is_cuda:
        return adc_lookup.adc_lb_distances(table, codes, sqrt=sqrt)
    return ref.adc_lb_ref(table, codes, sqrt=sqrt)


def adc_batch(tables, codes, *, sqrt: bool = True):
    """(B, M+1, d) f32 tables + (B, N, d) codes → (B, N) f32 LB distances."""
    if tables.is_cuda:
        return adc_lookup.adc_batch(tables, codes, sqrt=sqrt)
    return ref.adc_lb_batch_ref(tables, codes, sqrt=sqrt)


def adc_table(tables, codes, sel, keep, *, sqrt: bool = True):
    """Table Stage 4: (Q, P, M+1, d) f32 per-pair tables, survivors ``sel``
    (Q, P, S) of stacked ``codes`` (P, n_max, d) → (Q, P, S) f32 LB
    distances, +inf at slots s ≥ ``keep`` (Q, P)."""
    if tables.is_cuda:
        return adc_lookup.adc_table(tables, codes, sel, keep, sqrt=sqrt)
    return ref.adc_table_ref(tables, codes, sel, keep, sqrt=sqrt)


def adc_direct(qt, qcell, boundaries, codes, sel, keep):
    """Direct Stage 4: survivors ``sel`` (Q, P, S) of stacked ``codes``
    (P, n_max, d) → (Q, P, S) f32 squared LB sums, +inf at slots
    s ≥ ``keep`` (Q, P)."""
    if qt.is_cuda:
        return adc_lookup.adc_direct(qt, qcell, boundaries, codes, sel, keep)
    return ref.adc_direct_ref(qt, qcell, boundaries, codes, sel, keep)


def extract_codes(segments, layout: SegmentLayout):
    """(N, G) packed S-bit segments → (N, d) int32 codes (S = 32 as int32
    bit patterns)."""
    if segments.is_cuda:
        return bitpack.extract_codes(segments, layout)
    return ref.extract_ref(segments, layout)


def ssd_intra(c_mat, b_mat, da, x):
    """(G,lc,N)/(G,lc,N)/(G,H,lc)/(G,H,lc,P) f32 → (G,H,lc,P) SSD intra-chunk.
    On the card, the kernel with its gradient (``ssd.ssd_intra_autograd``);
    on DTensors, each rank's own block of it (``ssd.ssd_intra_sharded``)."""
    if isinstance(c_mat, DTensor):
        return ssd.ssd_intra_sharded(c_mat, b_mat, da, x)
    if c_mat.is_cuda:
        return ssd.ssd_intra_autograd(c_mat, b_mat, da, x)
    return ref.ssd_intra_ref(c_mat, b_mat, da, x)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {
        "hamming_stacked": hamming.launches,
        "adc_batch": adc_lookup.batch_launches,   # kernel 2, either contract
        "adc_direct": adc_lookup.direct_launches,
        "extract_codes": bitpack.launches,
        "ssd_intra": ssd.launches,
    }


def reset_launch_counts() -> None:
    hamming.launches = 0
    adc_lookup.batch_launches = 0
    adc_lookup.direct_launches = 0
    bitpack.launches = 0
    ssd.launches = 0
