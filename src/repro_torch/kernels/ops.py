"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The counterpart of the JAX package's ``repro.kernels.ops``, with one rule:
a CUDA tensor goes to the hand-written kernel (which raises if it cannot
launch), a CPU tensor to the plain version in :mod:`repro_torch.kernels.ref`.
There is no fallback. ``use_kernel`` overrides the choice for tests only:
``True`` on a CPU tensor raises in the kernel wrapper, ``False`` on a CUDA
tensor runs the plain version there.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import adc_lookup, hamming, ref

__all__ = ["hamming_distances", "hamming_stacked", "adc_distances",
           "adc_batch", "adc_direct", "launch_counts", "reset_launch_counts"]


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


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {
        "hamming_stacked": hamming.launches,
        "adc_batch": adc_lookup.batch_launches,
        "adc_direct": adc_lookup.direct_launches,
    }


def reset_launch_counts() -> None:
    hamming.launches = 0
    adc_lookup.batch_launches = 0
    adc_lookup.direct_launches = 0
