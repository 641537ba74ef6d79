"""Plain PyTorch versions of every kernel of the port (oracles + CPU path).

Torch twins of the JAX package's ``repro.kernels.ref``, plus the plain
versions of the two Stage 4 kernels that read survivors through ``sel``: the
table kernel (``adc_lb_batch_ref`` on the gathered codes, dead slots +inf)
and the direct-gather kernel (the port of
``repro.core.dataplane.adc_lb_direct``). ``kernels.ops`` runs these for CPU
tensors; the tests hold them against the JAX package and ``chip_smoke.py``
holds the CUDA kernels against them on the card.

Packed words are int32 tensors carrying the uint32 bit patterns: torch has
no popcount and cannot shift ``torch.uint32`` on every backend, so
:func:`popcount32` widens to int64, masks to 32 bits and counts by SWAR.
"""

from __future__ import annotations

import torch

from repro_torch.core.segments import SegmentLayout, extract_all

__all__ = ["popcount32", "hamming_ref", "hamming_stacked_ref", "adc_lb_ref",
           "adc_lb_batch_ref", "adc_table_ref", "adc_lb_direct_ref",
           "adc_direct_ref", "extract_ref", "ssd_intra_ref", "ssd_intra_vjp"]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit pattern) → int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_ref(q_packed: torch.Tensor, db_packed: torch.Tensor) -> torch.Tensor:
    """(G,) query words vs (N, G) rows → (N,) int32 Hamming distances."""
    x = torch.bitwise_xor(db_packed, q_packed[None, :])
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


def hamming_stacked_ref(q_packed: torch.Tensor,
                        db_packed: torch.Tensor) -> torch.Tensor:
    """(Q, P, G) query words vs (P, N, G) rows → (Q, P, N) int32."""
    x = torch.bitwise_xor(db_packed[None], q_packed[:, :, None, :])
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


def adc_lb_ref(table: torch.Tensor, codes: torch.Tensor,
               sqrt: bool = True) -> torch.Tensor:
    """(M+1, d) table + (N, d) codes → (N,) f32 LB (gather formulation)."""
    return adc_lb_batch_ref(table[None], codes[None], sqrt=sqrt)[0]


def adc_lb_batch_ref(tables: torch.Tensor, codes: torch.Tensor,
                     sqrt: bool = True) -> torch.Tensor:
    """(B, M+1, d) f32 tables + (B, N, d) int32 codes → (B, N) f32."""
    t = tables.to(torch.float32)
    picked = torch.gather(t, 1, codes.to(torch.int64))       # (B, N, d)
    s = torch.sum(picked, dim=-1)
    return torch.sqrt(s) if sqrt else s


def _survivors(codes: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """(P, n_max, d) stacked codes at (Q, P, S) rows ``sel`` → (Q, P, S, d)."""
    p_idx = torch.arange(codes.shape[0], device=codes.device)[None, :, None]
    return codes[p_idx, sel]


def _dead_inf(lb: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(Q, P, S) ``lb`` with +inf at slots s ≥ keep[q, p]."""
    slot = torch.arange(lb.shape[-1], device=lb.device)
    return torch.where(slot < keep[:, :, None], lb, float("inf"))


def adc_table_ref(tables: torch.Tensor, codes: torch.Tensor,
                  sel: torch.Tensor, keep: torch.Tensor,
                  sqrt: bool = True) -> torch.Tensor:
    """Plain version of the table Stage 4 kernel (kernel 2).

    tables: (Q, P, M+1, d) f32 per-pair tables; codes: (P, n_max, d) int32
    stacked codes; sel: (Q, P, S) rows of each pair's survivors; keep:
    (Q, P) live counts → (Q, P, S) f32, +inf at slots s ≥ keep[q, p].
    Gathers the survivors' codes, then :func:`adc_lb_batch_ref`.
    """
    qn, p, m1, d = tables.shape
    s = sel.shape[-1]
    lb = adc_lb_batch_ref(tables.reshape(qn * p, m1, d),
                          _survivors(codes, sel).reshape(qn * p, s, d),
                          sqrt=sqrt).reshape(qn, p, s)
    return _dead_inf(lb, keep)


def adc_lb_direct_ref(qt: torch.Tensor, qcell: torch.Tensor,
                      boundaries: torch.Tensor,
                      codes: torch.Tensor) -> torch.Tensor:
    """Squared LB sums via direct boundary gathers (no dense table).

    qt/qcell: (Q, P, d); boundaries: (P, M+1, d); codes: (Q, P, S, d) →
    (Q, P, S) f32. Per (survivor, dim): 0 in the query's own cell, squared
    distance to the facing cell edge otherwise — computed in qt's dtype,
    zeroed where not finite and cast to f32 before the row sum, as the JAX
    package's ``dataplane.adc_lb_direct``.
    """
    qn, p = codes.shape[:2]
    m1 = boundaries.shape[-2]
    c = codes.to(torch.int64)
    cc = qcell[:, :, None, :]                                 # (Q, P, 1, d)
    b = boundaries[None].expand(qn, p, m1, boundaries.shape[-1])
    right = torch.gather(b, 2, torch.clamp(c + 1, 0, m1 - 1))
    left = torch.gather(b, 2, torch.clamp(c, 0, m1 - 1))
    qtb = qt[:, :, None, :]
    zero = torch.zeros((), dtype=qt.dtype, device=qt.device)
    diff = torch.where(c < cc, qtb - right,
                       torch.where(c > cc, left - qtb, zero))
    sq = torch.where(torch.isfinite(diff), diff * diff, zero)
    return torch.sum(sq.to(torch.float32), dim=-1)


def adc_direct_ref(qt: torch.Tensor, qcell: torch.Tensor,
                   boundaries: torch.Tensor, codes: torch.Tensor,
                   sel: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Plain version of the direct Stage 4 kernel (kernel 2b).

    codes: (P, n_max, d) int32 stacked codes; sel: (Q, P, S) rows of each
    (query, partition) pair's survivors; keep: (Q, P) live counts →
    (Q, P, S) f32 squared LB, +inf at slots s ≥ keep[q, p]. Gathers the
    survivors' codes, then :func:`adc_lb_direct_ref`.
    """
    lb = adc_lb_direct_ref(qt, qcell, boundaries, _survivors(codes, sel))
    return _dead_inf(lb, keep)


def extract_ref(segments: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """(N, G) packed segments → (N, d) int32 codes (``segments.extract_all``)."""
    return extract_all(segments, layout)


def _ssd_decay(da: torch.Tensor) -> torch.Tensor:
    """(G, H, lc) da → (G, H, lc, lc) ``tril(exp(cs_l - cs_s))``, cs the
    cumulative sum of da. ``exp`` sees only the lower triangle's
    differences: the upper ones are positive and would overflow, and
    ``inf · 0`` is NaN."""
    cs = torch.cumsum(da, dim=-1)                          # (G, H, lc)
    diff = cs[..., :, None] - cs[..., None, :]             # (G, H, lc, lc)
    ii = torch.arange(da.shape[-1], device=da.device)
    tri = ii[:, None] >= ii[None, :]
    zero = torch.zeros((), dtype=da.dtype, device=da.device)
    return torch.where(tri, torch.exp(torch.where(tri, diff, zero)), zero)


def ssd_intra_ref(c_mat: torch.Tensor, b_mat: torch.Tensor, da: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """SSD intra-chunk term of every (batch·chunk, head) block.

    c_mat/b_mat: (G, lc, N); da: (G, H, lc); x: (G, H, lc, P) →
    (G, H, lc, P): ``y = (tril(exp(segsum(da))) ∘ C Bᵀ) · x``.
    """
    decay = _ssd_decay(da)
    scores = torch.einsum("gln,gsn->gls", c_mat, b_mat)    # (G, lc, lc)
    return torch.einsum("gls,ghls,ghsp->ghlp", scores, decay, x)


def ssd_intra_vjp(c_mat: torch.Tensor, b_mat: torch.Tensor, da: torch.Tensor,
                  x: torch.Tensor, dy: torch.Tensor):
    """The vector-Jacobian product of :func:`ssd_intra_ref`: the gradients
    (dC, dB, d(da), dx) of ``Σ dy · y`` at (c_mat, b_mat, da, x).

    With D = tril(exp(cs_l - cs_s)), S = C Bᵀ and M = S ∘ D (y = M x):
    dM = dy xᵀ, dx = Mᵀ dy, dS = Σ_h dM ∘ D, dC = dS B, dB = dSᵀ C; the
    decay's exponent cs_l - cs_s takes E = dM ∘ M, so d(cs) is E's row sums
    less its column sums, and d(da) the reverse cumulative sum of d(cs).
    """
    decay = _ssd_decay(da)                                 # (G, H, lc, lc)
    scores = torch.einsum("gln,gsn->gls", c_mat, b_mat)    # (G, lc, lc)
    m = scores[:, None] * decay                            # (G, H, lc, lc)
    d_m = dy @ x.transpose(-1, -2)                         # (G, H, lc, lc)
    dx = m.transpose(-1, -2) @ dy
    d_s = torch.einsum("ghls,ghls->gls", d_m, decay)
    dc = d_s @ b_mat
    db = d_s.transpose(-1, -2) @ c_mat
    del decay
    e = d_m.mul_(m)                                        # zero above
    d_cs = e.sum(dim=-1) - e.sum(dim=-2)                   # (G, H, lc)
    dda = torch.flip(torch.cumsum(torch.flip(d_cs, (-1,)), dim=-1), (-1,))
    return dc, db, dda, dx
