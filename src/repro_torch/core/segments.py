"""Shared segment-based storage + dimensional extraction (paper §2.2.1–2.2.2).

Variable-length per-dimension bit codes are concatenated MSB-first into shared
S-bit segments: ``G_OSQ = ceil(b / S)`` segments per vector versus ``G_SQ = d``
fixed slots under standard SQ. Extraction recovers dimension ``j`` of *all*
rows simultaneously via static shift/mask/OR plans (paper Fig. 3).
``build_layout`` / ``pack_codes`` are NumPy copies of the JAX package's
``repro.core.segments``; the extraction here runs as torch ops and is the
plain version of the CUDA kernel ``kernels.bitpack.extract_codes`` (the port
of the TPU kernel ``repro.kernels.bitpack.extract_codes``).

Bit-order convention: global bit position ``p`` (0-based from the start of the
vector's code stream) lives in segment ``p // S`` at MSB-based offset ``p % S``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "SegmentLayout",
    "build_layout",
    "pack_codes",
    "extract_dim",
    "extract_all",
    "sq_wastage",
]

_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.uint32}


@dataclasses.dataclass(frozen=True)
class Piece:
    """One contiguous chunk of a dimension's code inside a single segment."""

    seg: int      # segment index
    rshift: int   # right shift to land the piece at the LSB of the segment word
    nbits: int    # piece width
    lshift: int   # left shift to place the piece inside the dim code


@dataclasses.dataclass(frozen=True)
class SegmentLayout:
    """Static packing metadata shared by pack/extract."""

    bits: Tuple[int, ...]          # per-dim bit widths B
    seg_bits: int                  # S
    total_bits: int                # b = sum(B)
    num_segments: int              # G = ceil(b / S)
    offsets: Tuple[int, ...]       # per-dim global start bit
    plans: Tuple[Tuple[Piece, ...], ...]  # per-dim extraction plan

    @property
    def dtype(self):
        return _DTYPES[self.seg_bits]

    @property
    def d(self) -> int:
        return len(self.bits)


def build_layout(bits: Sequence[int], seg_bits: int = 8) -> SegmentLayout:
    if seg_bits not in _DTYPES:
        raise ValueError(f"seg_bits must be one of {sorted(_DTYPES)}")
    bits = tuple(int(b) for b in bits)
    offsets = []
    plans: List[Tuple[Piece, ...]] = []
    pos = 0
    for bj in bits:
        offsets.append(pos)
        pieces: List[Piece] = []
        covered = 0
        while covered < bj:
            p = pos + covered
            seg = p // seg_bits
            in_seg = p % seg_bits            # MSB-based offset inside segment
            take = min(bj - covered, seg_bits - in_seg)
            # piece occupies segment bits [in_seg, in_seg+take) (MSB-based)
            rshift = seg_bits - in_seg - take
            lshift = bj - covered - take     # placement inside the dim code
            pieces.append(Piece(seg=seg, rshift=rshift, nbits=take, lshift=lshift))
            covered += take
        plans.append(tuple(pieces))
        pos += bj
    total = pos
    g = -(-total // seg_bits) if total else 0
    return SegmentLayout(
        bits=bits,
        seg_bits=seg_bits,
        total_bits=total,
        num_segments=g,
        offsets=tuple(offsets),
        plans=tuple(plans),
    )


def pack_codes(
    layout: SegmentLayout, codes: np.ndarray, chunk: int = 65536
) -> np.ndarray:
    """Pack (N, d) integer codes into (N, G) segments of ``layout.dtype``."""
    codes = np.asarray(codes)
    n, d = codes.shape
    if d != layout.d:
        raise ValueError(f"dim mismatch {d} != {layout.d}")
    s = layout.seg_bits
    g = layout.num_segments
    out = np.zeros((n, g), dtype=np.uint64)
    weights = (1 << np.arange(s - 1, -1, -1, dtype=np.uint64))  # MSB-first
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        cols = []
        for j, bj in enumerate(layout.bits):
            if bj == 0:
                continue
            shifts = np.arange(bj - 1, -1, -1, dtype=np.uint64)
            cols.append(
                (codes[lo:hi, j].astype(np.uint64)[:, None] >> shifts[None, :]) & 1
            )
        if cols:
            bitmat = np.concatenate(cols, axis=1)
        else:
            bitmat = np.zeros((hi - lo, 0), dtype=np.uint64)
        pad = g * s - layout.total_bits
        if pad:
            bitmat = np.pad(bitmat, ((0, 0), (0, pad)))
        out[lo:hi] = bitmat.reshape(hi - lo, g, s) @ weights
    return out.astype(layout.dtype)


def _wide(segments) -> torch.Tensor:
    """Segments (numpy uint8/16/32 or a tensor) as int64 words, on the
    tensor's device (numpy arrays land on the CPU).

    A uint32 word may arrive as its int32 bit pattern (the port's convention,
    since torch cannot shift ``torch.uint32``); the mask restores its value.
    """
    if isinstance(segments, torch.Tensor):
        wide = segments.to(torch.int64)
        if segments.dtype == torch.int32:
            wide = wide & 0xFFFFFFFF
        return wide
    return torch.from_numpy(np.asarray(segments).astype(np.int64))


def extract_dim(segments, layout: SegmentLayout, j: int):
    """Extract dimension ``j`` for all rows (paper Fig. 3) as a torch tensor.

    Left/right-shift semantics from the paper are realized as a single
    combined right shift + mask per overlapped segment, followed by a left
    shift into the residue position and a bitwise OR across segments.
    """
    wide = _wide(segments)
    out = torch.zeros(wide.shape[:-1], dtype=torch.int64, device=wide.device)
    for piece in layout.plans[j]:
        chunk = (wide[..., piece.seg] >> piece.rshift) & ((1 << piece.nbits) - 1)
        out = out | (chunk << piece.lshift)
    return out.to(torch.int32)


def extract_all(segments, layout: SegmentLayout):
    """Extract every dimension: (N, G) segments -> (N, d) int32 codes."""
    wide = _wide(segments)
    cols = [extract_dim(wide, layout, j) for j in range(layout.d)]
    return torch.stack(cols, dim=-1)


def sq_wastage(bits: Sequence[int], seg_bits: int = 8) -> dict:
    """Paper Fig. 2 quantities: bit wastage of standard SQ vs OSQ."""
    bits = np.asarray(list(bits), dtype=np.int64)
    b = int(bits.sum())
    g_osq = -(-b // seg_bits)
    g_sq = int(bits.shape[0])  # one S-bit slot per dim
    waste_sq = int(np.maximum(seg_bits - bits, 0).sum())
    waste_osq = g_osq * seg_bits - b
    return {
        "total_bits": b,
        "segments_osq": g_osq,
        "segments_sq": g_sq,
        "bits_sq": g_sq * seg_bits,
        "bits_osq": g_osq * seg_bits,
        "waste_sq": waste_sq,
        "waste_osq": waste_osq,
        "saving_ratio": (g_sq * seg_bits) / max(g_osq * seg_bits, 1),
    }
