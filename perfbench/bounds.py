"""The yardstick's arithmetic: the card's published peaks and the least
bytes each search stage has to move.

A stage's bytes are worked out from the batch's own shapes and counts, so
the same work is read whatever kernels a later program uses for it. Each
input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, HBM3 at the 700 W limit. The stages read
# here move bytes and do little arithmetic, so memory bounds them.
HBM_BYTES_PER_S = 3.35e12


def keep_count(n: int, perc: float, floor: int) -> int:
    """Hamming survivors of ``n`` candidates: ``perc`` % of them, at least
    ``floor`` (or all, when fewer), none of none (paper §2.4.3)."""
    n = int(n)
    if n <= 0:
        return 0
    return min(n, max(min(int(floor), n), math.ceil(n * float(perc) / 100.0)))


def static_slots(n_max: int, index_cfg: dict, k: int):
    """(keep_s, take_s): the survivor slots a (query, partition) pair has at
    most, at the largest partition's row count ``n_max``."""
    keep_s = max(keep_count(n_max, index_cfg["hamming_perc"],
                            index_cfg["min_hamming_keep"]), 1)
    take_s = max(min(math.ceil(index_cfg["refine_ratio"] * k), keep_s), 1)
    return keep_s, take_s


def stage3_bytes(q: int, p: int, n_max: int, g: int, keep_s: int) -> int:
    """Hamming prune: the stack's 1-bit codes (P, n_max, G) u32 and the
    candidate mask (Q, P, n_max) bool read once, the (Q, P, keep_s) int64
    survivors written once."""
    return p * n_max * g * 4 + q * p * n_max + q * p * keep_s * 8


def stage4_bytes(q: int, p: int, m1: int, d: int, live_slots: int,
                 take_s: int) -> int:
    """ADC lower bounds: the live survivors' codes (live slots × d int32)
    and the boundaries (P, M+1, d) f32 read once, the (Q, P, take_s) int64
    rows written once."""
    return live_slots * d * 4 + p * m1 * d * 4 + q * p * take_s * 8


def roofline_pct(nbytes: float, device_s: float):
    """Share (%) of the memory roofline: least time at the HBM rate over
    the time the device took. None when no time was read."""
    if device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
