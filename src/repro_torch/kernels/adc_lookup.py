"""Wrappers of the two CUDA ADC kernels (``csrc/adc_lookup.cu``).

* :func:`adc_table` — kernel 2, replaces the TPU kernel
  ``repro/kernels/adc_lookup.py::adc_lb_distances_batch`` (Stage 4 when
  M+1 ≤ 129) with the plane's survivor gather and dead-slot mask around it:
  each pair's live survivors are read through ``sel`` from the stacked codes
  in place, and slots at or past a pair's ``keep`` are +inf. :func:`adc_batch`
  is the TPU kernel's own (B, N, d) contract and :func:`adc_lb_distances` its
  single-table view: the same kernel at Q = 1, P = B with every slot live.
* :func:`adc_direct` — kernel 2b, the port of
  ``repro/core/dataplane.py::adc_lb_direct`` (Stage 4 for tall tables),
  reading each live survivor's codes through ``sel`` likewise. Its shared
  memory does not grow with d (the query rows are staged a chunk of dims
  at a time); :func:`check_direct_smem` refuses, before the launch, a
  size that would not fit a block.

The wrappers take CUDA tensors only — ``kernels.ops`` routes CPU tensors to
the plain versions in ``kernels.ref``. ``batch_launches`` and
``direct_launches`` count each kernel's launches in this process.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["adc_table", "adc_table_with", "adc_batch", "adc_lb_distances",
           "adc_direct", "adc_direct_with", "bind", "direct_smem_bytes",
           "check_direct_smem", "batch_launches", "direct_launches"]

batch_launches = 0
direct_launches = 0

SMEM_LIMIT = 227 * 1024     # dynamic shared memory one H100 block can use

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def bind(lib: ctypes.CDLL):
    """The (adc_table, adc_direct) launch functions of a library built from
    ``csrc/adc_lookup.cu`` (or from an edited copy of it, as
    ``tools/kernel_variants.py`` builds), with their C interface declared."""
    table = lib.adc_table_launch
    table.argtypes = [_P] * 6 + [_I, _I, _I, _L, _I, _L, _I, _P]
    table.restype = _I
    direct = lib.adc_direct_launch
    direct.argtypes = [_P] * 8 + [_I, _I, _I, _L, _I, _L, _I, _P]
    direct.restype = _I
    lib.adc_direct_smem_bytes.argtypes = [_I, _I, _I]
    lib.adc_direct_smem_bytes.restype = _L
    return table, direct


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library("adc_lookup")
    bind(lib)
    return lib


def _launchers():
    lib = _library()
    return lib.adc_table_launch, lib.adc_direct_launch


def direct_smem_bytes(m1: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of kernel 2b asks for at M+1 = ``m1``
    and ``d`` dims in ``dtype`` (the card's library)."""
    return int(_library().adc_direct_smem_bytes(
        m1, d, int(dtype == torch.float64)))


def check_direct_smem(need: int, m1: int, d: int) -> None:
    """Raise before the launch when a block of kernel 2b would need more
    shared memory than an H100 block has, naming the sizes."""
    if need > SMEM_LIMIT:
        raise ValueError(
            f"adc_direct at d={d}, M+1={m1} needs {need} bytes of shared "
            f"memory a block, over the limit of {SMEM_LIMIT} bytes")


def _check(name: str, t: torch.Tensor, ndim: int, dtypes, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def adc_table(tables: torch.Tensor, codes: torch.Tensor, sel: torch.Tensor,
              keep: torch.Tensor, sqrt: bool = True) -> torch.Tensor:
    """LB sums of each pair's live survivors, read through ``sel``.

    tables (Q, P, M+1, d) f32; codes (P, n_max, d) int32; sel (Q, P, S)
    int64 row indices in [0, n_max); keep (Q, P) int32 live counts →
    (Q, P, S) f32 Σ_j T[q, p, code[sel[q, p, s], j], j] (square-rooted
    when ``sqrt``), +inf at slots s ≥ keep[q, p].
    """
    return adc_table_with(None, tables, codes, sel, keep, sqrt=sqrt)


def adc_table_with(launch, tables: torch.Tensor, codes: torch.Tensor,
                   sel: Optional[torch.Tensor], keep: Optional[torch.Tensor],
                   sqrt: bool = True) -> torch.Tensor:
    """:func:`adc_table` through ``launch``, the first function :func:`bind`
    returns (None: the port's own). ``sel`` None reads row s for slot s and
    ``keep`` None makes every slot live (the (B, N, d) contract)."""
    global batch_launches
    device = tables.device
    _check("tables", tables, 4, (torch.float32,), device)
    _check("codes", codes, 3, (torch.int32,), device)
    qn, p, m1, d = tables.shape
    n_max = codes.shape[1]
    if m1 < 1:
        raise ValueError("tables need at least one code row (M+1 >= 1)")
    if sel is not None:
        _check("sel", sel, 3, (torch.int64,), device)
    if keep is not None:
        _check("keep", keep, 2, (torch.int32,), device)
    s = n_max if sel is None else sel.shape[2]
    if (codes.shape[0] != p or codes.shape[2] != d
            or (sel is not None and sel.shape[:2] != (qn, p))
            or (keep is not None and keep.shape != (qn, p))):
        raise ValueError(
            f"shape mismatch: tables {tuple(tables.shape)}, codes "
            f"{tuple(codes.shape)}, sel "
            f"{None if sel is None else tuple(sel.shape)}, keep "
            f"{None if keep is None else tuple(keep.shape)}")
    out = torch.empty((qn, p, s), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    off = torch.empty(p * qn + 1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if launch is None:
            launch = _launchers()[0]
        err = launch(tables.data_ptr(), codes.data_ptr(),
                     None if sel is None else sel.data_ptr(),
                     None if keep is None else keep.data_ptr(),
                     off.data_ptr(), out.data_ptr(), qn, p, m1, n_max, d, s,
                     int(sqrt), stream)
    if err != 0:
        raise RuntimeError(f"adc_table launch failed: cudaError {err}")
    batch_launches += 1
    return out


def adc_batch(tables: torch.Tensor, codes: torch.Tensor,
              sqrt: bool = True) -> torch.Tensor:
    """(B, M+1, d) f32 tables + (B, N, d) int32 codes → (B, N) f32 LB:
    kernel 2 at Q = 1, P = B, every row of each batch live."""
    device = tables.device
    _check("tables", tables, 3, (torch.float32,), device)
    _check("codes", codes, 3, (torch.int32,), device)
    if codes.shape[0] != tables.shape[0] or codes.shape[2] != tables.shape[2]:
        raise ValueError(f"shape mismatch: tables {tuple(tables.shape)} vs "
                         f"codes {tuple(codes.shape)}")
    return adc_table_with(None, tables[None], codes, None, None,
                          sqrt=sqrt)[0]


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
    check_direct_smem(direct_smem_bytes(m1, d, qt.dtype), m1, d)
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
