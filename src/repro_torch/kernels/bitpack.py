"""Wrapper of the CUDA segment-extraction kernel (``csrc/bitpack.cu``), kernel 5.

Replaces the TPU kernel ``repro/kernels/bitpack.py::extract_codes``: (N, G)
packed S-bit segments → (N, d) int32 per-dimension codes (paper §2.2.2).
Segments of S = 8 and 16 bits come as ``torch.uint8`` / ``torch.uint16``,
S = 32 as the int32 bit pattern of the uint32 words (the port's convention).
The layout's plan is uploaded once per (bit widths, S, device) as a small
table; each thread of the kernel loads its dims' pieces into registers (or,
past three pieces a dim, reads the table from shared memory). The wrapper
takes CUDA tensors only — ``kernels.ops`` routes CPU tensors to
``kernels.ref.extract_ref``.

``launches`` counts the kernel launches of this process (reset it to 0 to
count a window).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segments import SegmentLayout, build_layout
from repro_torch.kernels import build

__all__ = ["extract_codes", "extract_codes_with", "bind", "launches",
           "SEG_DTYPES"]

launches = 0

# Segment width S → the tensor dtype carrying its words.
SEG_DTYPES = {8: torch.uint8, 16: torch.uint16, 32: torch.int32}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def bind(lib: ctypes.CDLL):
    """The launch function of a library built from ``csrc/bitpack.cu`` (or
    from an edited copy of it, as ``tools/kernel_variants.py`` builds), with
    its C interface declared."""
    fn = lib.extract_launch
    fn.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _launcher():
    return bind(build.library("bitpack"))


@functools.lru_cache(maxsize=None)
def _plan(bits: Tuple[int, ...], seg_bits: int, device: torch.device):
    """The plan of ``build_layout(bits, seg_bits)`` as an (n, 4) int32 table
    of (seg, rshift, nbits, lshift) pieces and each dim's first piece (d + 1
    offsets), on ``device``. Keyed by the bit widths, which fix the plan and
    hash as one tuple of ints (a ``SegmentLayout``'s hash walks each of its
    ``Piece`` objects)."""
    plans = build_layout(bits, seg_bits).plans
    pieces = [(pc.seg, pc.rshift, pc.nbits, pc.lshift)
              for plan in plans for pc in plan]
    starts = np.cumsum([0] + [len(plan) for plan in plans])
    table = np.asarray(pieces, dtype=np.int32).reshape(-1, 4)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(starts.astype(np.int32)).to(device))


def extract_codes(segments: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """(N, G) packed segments on the card → (N, d) int32 codes."""
    return extract_codes_with(None, segments, layout)


def extract_codes_with(launch, segments: torch.Tensor,
                       layout: SegmentLayout) -> torch.Tensor:
    """:func:`extract_codes` through ``launch``, the function :func:`bind`
    returns (None: the port's own)."""
    global launches
    device = segments.device
    if device.type != "cuda":
        raise ValueError(f"segments must be a CUDA tensor, got {device}")
    want = SEG_DTYPES[layout.seg_bits]
    if segments.dtype != want:
        raise TypeError(f"S={layout.seg_bits}-bit segments must be {want}, "
                        f"got {segments.dtype}")
    if segments.ndim != 2 or not segments.is_contiguous():
        raise ValueError("segments must be a contiguous 2-D tensor, got shape "
                         f"{tuple(segments.shape)}")
    n, g = segments.shape
    if g != layout.num_segments:
        raise ValueError(f"{g} segments per row, the layout has "
                         f"{layout.num_segments}")
    d = layout.d
    out = torch.empty((n, d), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    pieces, starts = _plan(layout.bits, layout.seg_bits, device)
    max_pieces = max((len(plan) for plan in layout.plans), default=0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if launch is None:
            launch = _launcher()
        err = launch(segments.data_ptr(), pieces.data_ptr(),
                     starts.data_ptr(), out.data_ptr(), n, g, d,
                     pieces.shape[0], max_pieces, layout.seg_bits // 8, stream)
    if err == -2:
        raise ValueError(f"layout of d={d}, G={g} exceeds the kernel's "
                         "shared memory")
    if err != 0:
        raise RuntimeError(f"extract_codes launch failed: cudaError {err}")
    launches += 1
    return out
