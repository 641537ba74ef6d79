"""Wrapper of the CUDA SSD intra-chunk kernel (``csrc/ssd.cu``), kernel 6.

Replaces the TPU kernel ``repro/kernels/ssd.py::ssd_intra_block``: the
Mamba2 intra-chunk term ``(tril(exp(segsum(da))) ∘ C Bᵀ) · x`` of every
(batch·chunk, head) block. The wrapper takes CUDA tensors only —
``kernels.ops`` routes CPU tensors to ``kernels.ref.ssd_intra_ref``.

``launches`` counts the kernel launches of this process (reset it to 0 to
count a window).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["ssd_intra", "launches"]

launches = 0

_SMEM_LIMIT = 227 * 1024    # dynamic shared memory one H100 block can use


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("ssd")
    lib.ssd_intra_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.ssd_intra_launch.restype = ctypes.c_int
    lib.ssd_intra_smem_bytes.argtypes = [ctypes.c_int]
    lib.ssd_intra_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def ssd_intra(c_mat: torch.Tensor, b_mat: torch.Tensor, da: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """(G, lc, N) C and B, (G, H, lc) da, (G, H, lc, P) x → (G, H, lc, P)."""
    global launches
    device = c_mat.device
    _check("c_mat", c_mat, 3, device)
    _check("b_mat", b_mat, 3, device)
    _check("da", da, 3, device)
    _check("x", x, 4, device)
    g, lc, n = c_mat.shape
    h, p = da.shape[1], x.shape[-1]
    if (b_mat.shape != c_mat.shape or da.shape != (g, h, lc)
            or x.shape != (g, h, lc, p)):
        raise ValueError(
            f"shape mismatch: c_mat {tuple(c_mat.shape)}, b_mat "
            f"{tuple(b_mat.shape)}, da {tuple(da.shape)}, x {tuple(x.shape)}")
    out = torch.empty((g, h, lc, p), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()          # an empty score sum is 0
    lib = _lib()
    if lib.ssd_intra_smem_bytes(lc) > _SMEM_LIMIT:
        raise ValueError(f"chunk length {lc} exceeds the kernel's shared "
                         "memory for the prefix sums")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ssd_intra_launch(c_mat.data_ptr(), b_mat.data_ptr(),
                                   da.data_ptr(), x.data_ptr(), out.data_ptr(),
                                   g, h, lc, n, p, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra launch failed: cudaError {err}")
    launches += 1
    return out
