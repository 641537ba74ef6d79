"""Batched torch query data plane — Stages 3–5 of §2.4 with fixed shapes.

The port of the JAX package's ``repro.core.dataplane``: the paper's
per-partition hot path (low-bit Hamming prune → ADC lookup-table lower
bounds → full-precision refinement → single-pass top-k merge), batched over
queries *and* partitions. ``SquashIndex.search(backend="torch")``
(``repro_torch.core.pipeline``) drives it with the whole
:class:`StackedIndex` resident on one device.

Layout: all partitions are stacked to a fixed row budget ``n_max`` with
validity masks (:func:`stack_index`), so every stage is a dense fixed-shape
tensor op — ``(Q, P, G)`` packed query words × ``(P, n_max, G)`` stacked
codes for the Hamming kernel, then for either ADC kernel the stacked codes
read in place through the survivors' rows ``sel`` (Q, P, keep_s), with
``(Q, P, M+1, d)`` per-pair tables for the table kernel or the partitions'
boundaries for the direct kernel. The kernels dispatch through
``repro_torch.kernels.ops``: hand-written CUDA kernels for tensors on the
card, plain PyTorch versions for tensors on the CPU. There is no jit: the
plane runs eagerly, and the kernels' launch counters (``ops.launch_counts``)
show which kernels a search went through.

Parity contract: the returned ids are **bitwise identical** to the NumPy
reference path in ``pipeline.py`` (and to the JAX package). Data-dependent
per-(query, partition) keep/take counts come from Algorithm 1 on the host as
dense integer arrays and are applied as masks over statically-shaped
selections. Ties break as in the reference — ascending (score, row) within
a stage, ascending (distance, partition, rank) at the merge — which
``torch.topk`` does not promise, so Stage 3 selects on the unique int64 key
``ham · n_max + row`` and Stages 4, 5 and the merge use stable sorts.

Known residual (as in the reference): ADC table *entries* are identical
float32 values on every backend, but row sums reduce in backend-specific
order (NumPy pairwise, torch.sum, the CUDA kernels' ascending d), so two
survivors whose LB sums differ only at f32-ULP scale could straddle the
refine-take cut differently.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.obs.spans import profiler_range as _span

__all__ = [
    "StackedIndex", "stack_index", "part_stack_arrays", "stack_single_part",
    "pack_query_bits", "adc_table_batch",
    "query_cells", "adc_lb_direct", "build_cand_arrays", "stage_counts",
    "static_counts", "batched_stage345", "make_plane", "ADC_TABLE_MAX_M1",
]

_BIG_HAMMING = 1 << 30

# Stage 4 formulation switch (as in the reference): dense per-(query,
# partition) tables feed the table kernel, but their (M+1) axis scales with
# the *hottest* dimension's cell count (2^12 at the default
# max_bits_per_dim). Above this M+1 the plane switches to the direct
# boundary-gather kernel (two gathers per (survivor, dim)).
ADC_TABLE_MAX_M1 = 129

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class StackedIndex:
    """All partitions stacked to a fixed row budget (leading axis = partition),
    as tensors on one device.

    Padding rows have ``valid=False`` and never reach the results.
    """

    low_packed: torch.Tensor  # (P, n_max, G32) int32 (uint32 bit patterns)
    codes: torch.Tensor       # (P, n_max, d) int32
    vectors: torch.Tensor     # (P, n_max, d) float
    valid: torch.Tensor       # (P, n_max) bool
    vector_ids: torch.Tensor  # (P, n_max) int32
    part_mean: torch.Tensor   # (P, d)
    klt: torch.Tensor         # (P, d, d)
    low_mean: torch.Tensor    # (P, d)
    low_std: torch.Tensor     # (P, d)
    boundaries: torch.Tensor  # (P, M+1, d) float (+inf padding)
    cells: torch.Tensor       # (P, d) int32

    @property
    def num_partitions(self) -> int:
        return int(self.low_packed.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.low_packed.shape[1])

    @property
    def device(self) -> torch.device:
        return self.low_packed.device

    def part(self, pid: int) -> "StackedIndex":
        """Partition ``pid`` as a one-partition stack of views (no copy)."""
        return StackedIndex(**{f.name: getattr(self, f.name)[pid:pid + 1]
                               for f in dataclasses.fields(self)})


def part_stack_arrays(pt, *, n_max: int, m1: int, d: int,
                      dtype=np.float32,
                      live_rows: Optional[np.ndarray] = None
                      ) -> Dict[str, np.ndarray]:
    """One partition's numpy slab of the stacked payload (no leading P axis).

    The field values are exactly what :func:`stack_index` writes at that
    partition's row (the reference's slab format, bit for bit). ``live_rows``
    (optional, (n,) bool) folds a tombstone bitmap into ``valid``.
    """
    n = pt.size
    g32 = pt.low.packed.shape[1]
    out = {
        "low_packed": np.zeros((n_max, g32), np.uint32),
        "codes": np.zeros((n_max, d), np.int32),
        "vectors": np.zeros((n_max, d), dtype),
        "valid": np.zeros((n_max,), bool),
        "vector_ids": np.full((n_max,), -1, np.int32),
        "part_mean": np.asarray(pt.mean, dtype),
        "klt": (pt.klt.astype(dtype) if pt.klt is not None
                else np.eye(d, dtype=dtype)),
        "low_mean": np.asarray(pt.low.mean, dtype),
        "low_std": np.maximum(pt.low.std, 1e-12).astype(dtype),
        "boundaries": np.full((m1, d), np.inf, dtype),
        "cells": np.asarray(pt.quant.cells, np.int32),
    }
    out["low_packed"][:n] = pt.low.packed
    out["codes"][:n] = pt.codes
    out["vectors"][:n] = pt.vectors
    out["valid"][:n] = True if live_rows is None else np.asarray(
        live_rows, dtype=bool)
    out["vector_ids"][:n] = pt.vector_ids
    mb = pt.quant.boundaries.shape[0]
    out["boundaries"][:mb] = pt.quant.boundaries.astype(dtype)
    return out


def _tensor(name: str, arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if name == "low_packed":
        arr = arr.view(np.int32)        # uint32 bits, seen as int32
    return torch.from_numpy(arr).to(device)  # squash: ignore[device-sync] -- the stacked index's one upload to the card, made when the index is stacked (cached per dtype and device)


def stack_single_part(arrays: Dict[str, np.ndarray],
                      device=None) -> StackedIndex:
    """Build a 1-partition :class:`StackedIndex` from a part's slab arrays."""
    return StackedIndex(**{k: _tensor(k, v[None], device)
                           for k, v in arrays.items()})


def stack_index(index, pad_to_multiple: int = 1,
                dtype: torch.dtype = torch.float32,
                device=None) -> StackedIndex:
    """Stack a built ``SquashIndex`` into fixed-shape tensors on ``device``.

    ``dtype`` sets the float width of the stacked payload: float64 is the
    parity configuration (bit-for-bit with the NumPy reference), float32 the
    deployment one.
    """
    np_dtype = _NP_FLOAT[dtype]
    parts = index.parts
    p = len(parts)
    pad_p = -(-p // pad_to_multiple) * pad_to_multiple
    n_max = max(pt.size for pt in parts)
    d = index.dim
    g32 = parts[0].low.packed.shape[1]
    m1 = max(pt.quant.boundaries.shape[0] for pt in parts)

    stacked = {
        "low_packed": np.zeros((pad_p, n_max, g32), np.uint32),
        "codes": np.zeros((pad_p, n_max, d), np.int32),
        "vectors": np.zeros((pad_p, n_max, d), np_dtype),
        "valid": np.zeros((pad_p, n_max), bool),
        "vector_ids": np.full((pad_p, n_max), -1, np.int32),
        "part_mean": np.zeros((pad_p, d), np_dtype),
        "klt": np.tile(np.eye(d, dtype=np_dtype), (pad_p, 1, 1)),
        "low_mean": np.zeros((pad_p, d), np_dtype),
        "low_std": np.ones((pad_p, d), np_dtype),
        "boundaries": np.full((pad_p, m1, d), np.inf, np_dtype),
        "cells": np.ones((pad_p, d), np.int32),
    }
    live_mask = getattr(index, "live_mask", None)
    for i, pt in enumerate(parts):
        live_rows = None if live_mask is None else live_mask[pt.vector_ids]
        pa = part_stack_arrays(pt, n_max=n_max, m1=m1, d=d, dtype=np_dtype,
                               live_rows=live_rows)
        for name, arr in pa.items():
            stacked[name][i] = arr
    return StackedIndex(**{k: _tensor(k, v, device)
                           for k, v in stacked.items()})


def pack_query_bits(z: torch.Tensor) -> torch.Tensor:
    """Binarize standardized values and pack into 32-bit words, MSB-first.

    Works over arbitrary leading batch axes: (..., d) → (..., ceil(d/32))
    int32 holding the uint32 bit patterns of ``lowbit.pack_bits_u32``.
    """
    d = z.shape[-1]
    g = -(-d // 32)
    bits = torch.nn.functional.pad((z > 0).to(torch.int64), (0, g * 32 - d))
    bits = bits.reshape(*z.shape[:-1], g, 32)
    weights = torch.ones(32, dtype=torch.int64, device=z.device) << torch.arange(
        31, -1, -1, dtype=torch.int64, device=z.device)
    words = torch.sum(bits * weights, dim=-1)           # [0, 2^32)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def adc_table_batch(qt: torch.Tensor, boundaries: torch.Tensor,
                    cells: torch.Tensor) -> torch.Tensor:
    """Batched torch twin of ``adc.build_adc_table``.

    qt: (..., d) transformed queries; boundaries: (..., M+1, d) with +inf
    padding; cells: (..., d). Returns (..., M+1, d) squared edge distances in
    qt's dtype with padding cells set to 0 (the gather never selects them for
    valid codes, and zeros keep the kernels' accumulators finite).
    """
    m1 = boundaries.shape[-2]
    inner = boundaries[..., 1:, :]                          # (..., M, d)
    qcell = torch.sum(
        (inner <= qt[..., None, :]) & torch.isfinite(inner), dim=-2
    )                                                       # (..., d)
    cell_idx = torch.arange(m1, device=qt.device)[:, None]  # (M+1, 1)
    pad_inf = torch.full(boundaries.shape[:-2] + (1, boundaries.shape[-1]),
                         float("inf"), dtype=boundaries.dtype,
                         device=boundaries.device)
    right = torch.cat([inner, pad_inf], dim=-2)
    left = boundaries
    zero = torch.zeros((), dtype=qt.dtype, device=qt.device)
    diff = torch.where(
        cell_idx < qcell[..., None, :],
        qt[..., None, :] - right,
        torch.where(cell_idx > qcell[..., None, :],
                    left - qt[..., None, :], zero),
    )
    sq = torch.where(torch.isfinite(diff), diff * diff, zero)
    return torch.where(cell_idx >= cells[..., None, :], zero, sq)


def query_cells(qt: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Per-dimension home cell of each query: (Q, P, d) int32.

    Batched twin of the ``searchsorted`` loop in ``adc.build_adc_table``:
    counts interior boundaries ≤ qt (the +inf padding never counts), one
    binary search per (query, partition, dim), batched over (P, d).
    """
    inner = boundaries[:, 1:, :].transpose(1, 2).contiguous()   # (P, d, M)
    vals = qt.permute(1, 2, 0).contiguous()                      # (P, d, Q)
    idx = torch.searchsorted(inner, vals, right=True)            # (P, d, Q)
    return idx.permute(2, 0, 1).to(torch.int32).contiguous()


def adc_lb_direct(qt: torch.Tensor, qcell: torch.Tensor,
                  boundaries: torch.Tensor,
                  codes: torch.Tensor) -> torch.Tensor:
    """Squared LB sums via direct boundary gathers (no dense table).

    qt/qcell: (Q, P, d); boundaries: (P, M+1, d); codes: (Q, P, S, d) →
    (Q, P, S) f32 — the reference's signature. The plane itself calls
    ``ops.adc_direct``, which reads the survivors' codes through their rows
    instead of taking them gathered.
    """
    return ref.adc_lb_direct_ref(qt, qcell, boundaries, codes)


# ------------------------------------------------------------ host helpers

def build_cand_arrays(
    cands: List[Dict[int, np.ndarray]], qn: int, p: int, n_max: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Densify Algorithm 1's per-query candidate dicts.

    Returns ``cand_mask`` (Q, P, n_max) bool — filter ∧ residency ∧ visit —
    and ``n_cand`` (Q, P) int32 candidate counts.
    """
    cand_mask = np.zeros((qn, p, n_max), dtype=bool)
    n_cand = np.zeros((qn, p), dtype=np.int32)
    for qi in range(qn):
        for pid, rows in cands[qi].items():
            cand_mask[qi, pid, rows] = True
            n_cand[qi, pid] = rows.size
    return cand_mask, n_cand


def stage_counts(n_cand: np.ndarray, config, k: int, profile=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(query, partition) Hamming-keep and refine-take counts.

    Elementwise twin of the NumPy reference's data-dependent formulas in
    ``SquashIndex._search_partition`` (zero where no candidates), under the
    static config knobs or a calibration profile.
    """
    from repro_torch.core import autotune

    frac = autotune.keep_fracs(config, profile, n_cand.shape[1])
    floor = autotune.keep_floor(config, profile)
    keep = autotune.keep_counts(n_cand, frac[None, :], floor)
    cap = int(np.ceil(config.refine_ratio * k)) if config.enable_refine else k
    take = np.minimum(cap, keep)
    return keep.astype(np.int32), take.astype(np.int32)


def static_counts(n_max: int, config, k: int, profile=None
                  ) -> Tuple[int, int]:
    """Static upper bounds for keep/take (the fixed selection sizes).

    Both per-pair formulas are monotone in the candidate count, so their
    value at ``n_max`` — under the *largest* per-partition keep fraction —
    bounds every (query, partition) pair.
    """
    from repro_torch.core import autotune

    n = max(int(n_max), 1)
    if profile is None:
        frac = float(config.hamming_perc)
        floor = int(config.min_hamming_keep)
    else:
        frac = float(np.max(profile.keep_frac))
        floor = int(profile.min_keep)
    keep_s = max(int(autotune.keep_count(n, frac, floor)), 1)
    cap = int(np.ceil(config.refine_ratio * k)) if config.enable_refine else k
    take_s = max(min(cap, keep_s), 1)
    return keep_s, take_s


# ------------------------------------------------------------------- plane

def batched_stage345(
    queries: torch.Tensor,
    stacked: StackedIndex,
    cand_mask: torch.Tensor,
    keep: torch.Tensor,
    take: torch.Tensor,
    *,
    k: int,
    keep_s: int,
    take_s: int,
    refine: bool = True,
    mark: Optional[Callable[[str], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 3–5 for a query batch against a partition stack.

    Args:
      queries: (Q, d) float, on the stack's device.
      stacked: the resident partition stack (P partitions, n_max row budget).
      cand_mask: (Q, P, n_max) bool — filter ∧ residency ∧ Alg.-1 visit.
      keep: (Q, P) int — per-pair Hamming survivors (≤ ``keep_s``).
      take: (Q, P) int — per-pair refinement candidates (≤ ``take_s``).
      k / keep_s / take_s: static shape parameters (see
        :func:`static_counts`).
      refine: include Stage 5 full-precision re-ranking.
      mark: called with ``"start"`` on entry and with ``"hamming"``,
        ``"adc"`` and ``"refine_merge"`` as each stage's work has been
        issued (per-stage timing hook).
    Returns:
      ids (Q, k) int32 (-1 padding), dists (Q, k) float (+inf padding) —
      merged across all P partitions in one pass.
    """
    qn = queries.shape[0]
    p, n_max = stacked.valid.shape
    dev = queries.device
    p_idx = torch.arange(p, device=dev)[None, :, None]
    inf = float("inf")
    if mark is not None:
        mark("start")

    # --- Stage 3: low-bit Hamming prune (raw centered space) -------------
    with _span("squash.stage3"):
        qc = queries[:, None, :] - stacked.part_mean[None]      # (Q, P, d)
        zq = (qc - stacked.low_mean[None]) / stacked.low_std[None]
        qbits = pack_query_bits(zq)                             # (Q, P, G)
        ham = ops.hamming_stacked(qbits, stacked.low_packed)
        alive0 = cand_mask & stacked.valid[None]
        ham = torch.where(alive0, ham, _BIG_HAMMING).to(torch.int64)
        # Unique key (ham, row): the smallest keep_s keys are the
        # reference's lax.top_k(-ham) selection, ties by ascending row, in
        # that order.
        key = ham * n_max + torch.arange(n_max, device=dev)
        sel = torch.topk(key, keep_s, dim=-1, largest=False,
                         sorted=True).indices
    if mark is not None:
        mark("hamming")

    # --- Stage 4: ADC lookup-table lower bounds on survivors -------------
    # Slots s ≥ keep[q, p] are dead: their bound is +inf.
    with _span("squash.stage4"):
        qt = torch.einsum("qpd,pde->qpe", qc, stacked.klt)      # (Q, P, d)
        d = queries.shape[-1]
        m1 = stacked.boundaries.shape[1]
        if m1 <= ADC_TABLE_MAX_M1:
            # Dense per-pair tables (query dtype, cast f32) → table kernel,
            # which reads the live survivors' codes through sel; dead slots
            # come back +inf.
            tables = adc_table_batch(qt, stacked.boundaries[None],
                                     stacked.cells[None])
            lb = ops.adc_table(
                tables.reshape(qn, p, m1, d).to(torch.float32).contiguous(),
                stacked.codes, sel, keep)
        else:
            # Tall tables (hot dims of up to 2^max_bits cells): direct
            # gathers of the live survivors' codes, read through sel; dead
            # slots come back +inf from the kernel.
            qt = qt.contiguous()
            qcell = query_cells(qt, stacked.boundaries)
            lb = torch.sqrt(ops.adc_direct(qt, qcell, stacked.boundaries,
                                           stacked.codes, sel, keep))
        lb_sorted, sel2 = torch.sort(lb, dim=-1, stable=True)
        lb_sorted, sel2 = lb_sorted[..., :take_s], sel2[..., :take_s]
        slot2 = torch.arange(take_s, device=dev)
        alive2 = slot2[None, None, :] < take[:, :, None]
        rows = torch.gather(sel, -1, sel2)                  # (Q, P, take_s)
    if mark is not None:
        mark("adc")

    kk = min(k, take_s)
    with _span("squash.stage5"):
        if refine:
            # --- Stage 5: full-precision refinement ('EFS' rows) ---------
            full = stacked.vectors[p_idx, rows]             # (Q,P,take_s,d)
            diff = full - queries[:, None, None, :]
            exact = torch.sqrt(torch.sum(diff * diff, dim=-1))
            exact = torch.where(alive2, exact, inf)
            part_d, sel3 = torch.sort(exact, dim=-1, stable=True)
            part_d = part_d[..., :kk]
            final_rows = torch.gather(rows, -1, sel3[..., :kk])
        else:
            part_d = torch.where(alive2, lb_sorted, inf)[..., :kk]
            final_rows = rows[..., :kk]
        part_ids = stacked.vector_ids[p_idx, final_rows]
        part_ids = torch.where(torch.isfinite(part_d), part_ids, -1)
        if kk < k:
            part_ids = torch.nn.functional.pad(part_ids, (0, k - kk),
                                               value=-1)
            part_d = torch.nn.functional.pad(part_d, (0, k - kk), value=inf)

        # --- single-pass MPI-style merge over partitions (§2.4.5) --------
        flat_d = part_d.reshape(qn, p * k)
        flat_i = part_ids.reshape(qn, p * k)
        dists, msel = torch.sort(flat_d, dim=1, stable=True)
        ids = torch.gather(flat_i, 1, msel[:, :k])
    if mark is not None:
        mark("refine_merge")
    return ids, dists[:, :k]


def make_plane(
    *,
    k: int,
    keep_s: int,
    take_s: int,
    refine: bool = True,
):
    """The batched search callable for one index/config shape.

    Signature ``(queries, stacked, cand_mask, keep, take, mark=None) ->
    (ids, dists)``. PyTorch runs eagerly, so there is nothing to compile:
    the callable fixes the static shape parameters, as the reference's
    jitted plane does.
    """

    def plane(queries, stacked, cand_mask, keep, take, mark=None):
        return batched_stage345(
            queries, stacked, cand_mask, keep, take,
            k=k, keep_s=keep_s, take_s=take_s, refine=refine, mark=mark,
        )

    return plane
