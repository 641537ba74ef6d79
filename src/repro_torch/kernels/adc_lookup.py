"""Wrappers of the two CUDA ADC kernels (``csrc/adc_lookup.cu``).

* :func:`adc_batch` — kernel 2, replaces the TPU kernel
  ``repro/kernels/adc_lookup.py::adc_lb_distances_batch`` (Stage 4 when
  M+1 ≤ 129); :func:`adc_lb_distances` is its single-table view (the TPU's
  ``adc_lb_distances``), the same kernel at B = 1.
* :func:`adc_direct` — kernel 2b, the port of
  ``repro/core/dataplane.py::adc_lb_direct`` (Stage 4 for tall tables),
  reading each live survivor's codes through ``sel``; slots at or past a
  pair's ``keep`` are +inf and cost no work.

The wrappers take CUDA tensors only — ``kernels.ops`` routes CPU tensors to
the plain versions in ``kernels.ref``. ``batch_launches`` and
``direct_launches`` count each kernel's launches in this process.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["adc_batch", "adc_lb_distances", "adc_direct", "adc_direct_with",
           "bind", "batch_launches", "direct_launches", "TABLE_SMEM_BYTES"]

batch_launches = 0
direct_launches = 0

# Shared memory one adc_batch block stages its table tile in: two blocks fit
# an H100 SM (227 KB), and (M+1) = 129 x d = 128 f32 (66 KB) fits whole.
TABLE_SMEM_BYTES = 100 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def bind(lib: ctypes.CDLL):
    """The (adc_batch, adc_direct) launch functions of a library built from
    ``csrc/adc_lookup.cu`` (or from an edited copy of it, as
    ``tools/kernel_variants.py`` builds), with their C interface declared."""
    batch = lib.adc_batch_launch
    batch.argtypes = [_P, _P, _P, _L, _I, _L, _I, _I, _I, _P]
    batch.restype = _I
    direct = lib.adc_direct_launch
    direct.argtypes = [_P] * 8 + [_I, _I, _I, _L, _I, _L, _I, _P]
    direct.restype = _I
    return batch, direct


@functools.lru_cache(maxsize=None)
def _launchers():
    return bind(build.library("adc_lookup"))


def _check(name: str, t: torch.Tensor, ndim: int, dtypes, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def _dim_tile(m1: int, d: int) -> int:
    """Widest dim tile whose (M+1, DT) f32 table slice fits the budget."""
    dt = min(d, TABLE_SMEM_BYTES // (4 * m1))
    if dt >= 4:
        dt -= dt % 4
    if dt < 1:
        raise ValueError(f"M+1={m1} table rows exceed the kernel's shared "
                         "memory budget")
    return dt


def adc_batch(tables: torch.Tensor, codes: torch.Tensor,
              sqrt: bool = True) -> torch.Tensor:
    """(B, M+1, d) f32 tables + (B, N, d) int32 codes → (B, N) f32 LB."""
    global batch_launches
    device = tables.device
    _check("tables", tables, 3, (torch.float32,), device)
    _check("codes", codes, 3, (torch.int32,), device)
    b, m1, d = tables.shape
    if codes.shape[0] != b or codes.shape[2] != d:
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)} vs "
                         f"codes {tuple(codes.shape)}")
    n = codes.shape[1]
    out = torch.empty((b, n), dtype=torch.float32, device=device)
    if out.numel() == 0 or d == 0:
        return out.zero_()      # an empty sum is 0, and so is its sqrt
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launchers()[0](tables.data_ptr(), codes.data_ptr(),
                              out.data_ptr(), b, m1, n, d, _dim_tile(m1, d),
                              int(sqrt), stream)
    if err != 0:
        raise RuntimeError(f"adc_batch launch failed: cudaError {err}")
    batch_launches += 1
    return out


def adc_lb_distances(table: torch.Tensor, codes: torch.Tensor,
                     sqrt: bool = True) -> torch.Tensor:
    """(M+1, d) table + (N, d) codes → (N,) f32 LB (kernel 2 at B=1)."""
    return adc_batch(table[None].contiguous(), codes[None].contiguous(),
                     sqrt=sqrt)[0]


def adc_direct(qt: torch.Tensor, qcell: torch.Tensor, boundaries: torch.Tensor,
               codes: torch.Tensor, sel: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """Squared LB sums of each pair's live survivors, read through ``sel``.

    qt (Q, P, d) f32/f64; qcell (Q, P, d) int32; boundaries (P, M+1, d) in
    qt's dtype; codes (P, n_max, d) int32; sel (Q, P, S) int64 row indices
    in [0, n_max); keep (Q, P) int32 live counts → (Q, P, S) f32,
    +inf at slots s ≥ keep[q, p].
    """
    return adc_direct_with(None, qt, qcell, boundaries, codes, sel, keep)


def adc_direct_with(launch, qt: torch.Tensor, qcell: torch.Tensor,
                    boundaries: torch.Tensor, codes: torch.Tensor,
                    sel: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """:func:`adc_direct` through ``launch``, the second function
    :func:`bind` returns (None: the port's own)."""
    global direct_launches
    device = qt.device
    floats = (torch.float32, torch.float64)
    _check("qt", qt, 3, floats, device)
    _check("qcell", qcell, 3, (torch.int32,), device)
    _check("boundaries", boundaries, 3, (qt.dtype,), device)
    _check("codes", codes, 3, (torch.int32,), device)
    _check("sel", sel, 3, (torch.int64,), device)
    _check("keep", keep, 2, (torch.int32,), device)
    qn, p, d = qt.shape
    m1 = boundaries.shape[1]
    n_max = codes.shape[1]
    s = sel.shape[2]
    if (qcell.shape != qt.shape or boundaries.shape[0] != p
            or boundaries.shape[2] != d or codes.shape[0] != p
            or codes.shape[2] != d or sel.shape[:2] != (qn, p)
            or keep.shape != (qn, p)):
        raise ValueError(
            f"shape mismatch: qt {tuple(qt.shape)}, qcell "
            f"{tuple(qcell.shape)}, boundaries {tuple(boundaries.shape)}, "
            f"codes {tuple(codes.shape)}, sel {tuple(sel.shape)}, keep "
            f"{tuple(keep.shape)}")
    out = torch.empty((qn, p, s), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    off = torch.empty(p * qn + 1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if launch is None:
            launch = _launchers()[1]
        err = launch(qt.data_ptr(), qcell.data_ptr(), boundaries.data_ptr(),
                     codes.data_ptr(), sel.data_ptr(), keep.data_ptr(),
                     off.data_ptr(), out.data_ptr(), qn, p, m1, n_max, d, s,
                     int(qt.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"adc_direct launch failed: cudaError {err}")
    direct_launches += 1
    return out
