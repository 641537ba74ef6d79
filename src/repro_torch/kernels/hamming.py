"""Wrapper of the CUDA Hamming kernel (``csrc/hamming.cu``), kernel 1.

Replaces the TPU kernel ``repro/kernels/hamming.py::packed_hamming_stacked``;
:func:`packed_hamming` is its single-query view (the TPU's
``packed_hamming``), served by the same kernel at Q = P = 1. The wrappers
take CUDA tensors only — ``kernels.ops`` routes CPU tensors to the plain
versions in ``kernels.ref``.

``launches`` counts the kernel launches of this process (reset it to 0 to
count a window).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["hamming_stacked", "packed_hamming", "launches"]

launches = 0

_BQ = 16  # queries per block, as in csrc/hamming.cu


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("hamming").hamming_stacked_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bit patterns), got "
                        f"{t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def hamming_stacked(q_packed: torch.Tensor,
                    db_packed: torch.Tensor) -> torch.Tensor:
    """(Q, P, G) query words vs (P, N, G) rows → (Q, P, N) int32 on the card."""
    global launches
    device = q_packed.device
    _check("q_packed", q_packed, 3, device)
    _check("db_packed", db_packed, 3, device)
    qn, p, g = q_packed.shape
    if db_packed.shape[0] != p or db_packed.shape[2] != g:
        raise ValueError(f"shape mismatch: q {tuple(q_packed.shape)} vs db "
                         f"{tuple(db_packed.shape)}")
    n = db_packed.shape[1]
    if _BQ * g * 4 > 48 * 1024:
        raise ValueError(f"G={g} words per row exceed the kernel's shared "
                         "memory for one query tile")
    out = torch.empty((qn, p, n), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher()(q_packed.data_ptr(), db_packed.data_ptr(),
                          out.data_ptr(), qn, p, n, g, stream)
    if err != 0:
        raise RuntimeError(f"hamming_stacked launch failed: cudaError {err}")
    launches += 1
    return out


def packed_hamming(q_packed: torch.Tensor,
                   db_packed: torch.Tensor) -> torch.Tensor:
    """(G,) query words vs (N, G) rows → (N,) int32 (kernel 1 at Q=P=1)."""
    return hamming_stacked(q_packed[None, None].contiguous(),
                           db_packed[None].contiguous())[0, 0]
