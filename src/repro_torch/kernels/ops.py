"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The counterpart of the JAX package's ``repro.kernels.ops``, with one rule:
a CUDA tensor goes to the hand-written kernel (which raises if it cannot
launch), a CPU tensor to the plain version in :mod:`repro_torch.kernels.ref`.
There is no fallback. The search-plane ops keep a ``use_kernel`` override
for tests only: ``True`` on a CPU tensor raises in the kernel wrapper,
``False`` on a CUDA tensor runs the plain version there. ``extract_codes``
and ``ssd_intra`` have none: the tensor's device alone decides.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.segments import SegmentLayout
from repro_torch.kernels import adc_lookup, bitpack, hamming, ref, ssd

__all__ = ["hamming_distances", "hamming_stacked", "adc_distances",
           "adc_batch", "adc_direct", "extract_codes", "ssd_intra",
           "launch_counts", "reset_launch_counts"]


def _kernel(t: torch.Tensor, override: Optional[bool]) -> bool:
    return t.is_cuda if override is None else override


def hamming_distances(q_packed, db_packed, *, use_kernel: Optional[bool] = None):
    """(G,) query words vs (N, G) rows → (N,) int32 Hamming."""
    if _kernel(q_packed, use_kernel):
        return hamming.packed_hamming(q_packed, db_packed)
    return ref.hamming_ref(q_packed, db_packed)


def hamming_stacked(q_packed, db_packed, *, use_kernel: Optional[bool] = None):
    """(Q, P, G) query words vs (P, N, G) stacked rows → (Q, P, N) int32."""
    if _kernel(q_packed, use_kernel):
        return hamming.hamming_stacked(q_packed, db_packed)
    return ref.hamming_stacked_ref(q_packed, db_packed)


def adc_distances(table, codes, *, sqrt: bool = True,
                  use_kernel: Optional[bool] = None):
    """(M+1, d) f32 table + (N, d) codes → (N,) f32 LB distances."""
    if _kernel(table, use_kernel):
        return adc_lookup.adc_lb_distances(table, codes, sqrt=sqrt)
    return ref.adc_lb_ref(table, codes, sqrt=sqrt)


def adc_batch(tables, codes, *, sqrt: bool = True,
              use_kernel: Optional[bool] = None):
    """(B, M+1, d) f32 tables + (B, N, d) codes → (B, N) f32 LB distances."""
    if _kernel(tables, use_kernel):
        return adc_lookup.adc_batch(tables, codes, sqrt=sqrt)
    return ref.adc_lb_batch_ref(tables, codes, sqrt=sqrt)


def adc_direct(qt, qcell, boundaries, codes, sel, *,
               use_kernel: Optional[bool] = None):
    """Direct Stage 4: survivors ``sel`` (Q, P, S) of stacked ``codes``
    (P, n_max, d) → (Q, P, S) f32 squared LB sums."""
    if _kernel(qt, use_kernel):
        return adc_lookup.adc_direct(qt, qcell, boundaries, codes, sel)
    return ref.adc_direct_ref(qt, qcell, boundaries, codes, sel)


def extract_codes(segments, layout: SegmentLayout):
    """(N, G) packed S-bit segments → (N, d) int32 codes (S = 32 as int32
    bit patterns)."""
    if segments.is_cuda:
        return bitpack.extract_codes(segments, layout)
    return ref.extract_ref(segments, layout)


def ssd_intra(c_mat, b_mat, da, x):
    """(G,lc,N)/(G,lc,N)/(G,H,lc)/(G,H,lc,P) f32 → (G,H,lc,P) SSD intra-chunk."""
    if c_mat.is_cuda:
        return ssd.ssd_intra(c_mat, b_mat, da, x)
    return ref.ssd_intra_ref(c_mat, b_mat, da, x)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {
        "hamming_stacked": hamming.launches,
        "adc_batch": adc_lookup.batch_launches,
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
