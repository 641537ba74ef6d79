"""OSQ applied to the KV cache — the paper's technique as a serving feature
(the port of ``repro.serve.kv_quant``).

SQUASH's core move is scalar quantization with segment packing so sub-word
codes realize their theoretical compression (DESIGN.md §5.ii). A KV cache is
dimension-structured exactly like the paper's vectors: per-(head, channel)
value ranges are narrow and stable, so ``bits``-bit codes per channel with
``32 // bits`` codes packed per 32-bit word give a 4–8× memory reduction.

Packing is along the *sequence* axis of each buffer, keeping channel
extraction a pure shift/mask (paper §2.2.2). Per-channel ``lo``/``hi`` are
taken over the whole buffer axis, the zero slots past the prompt included,
as in the reference. Cache leaves are identified by name
(k/v/latent/k_rope) with the buffer axis located relative to the trailing
dims, so layer-stacked caches of any depth work.

The reference packs in ``uint32``; torch's ``uint32`` has few operators, so
codes are packed in ``int64`` and wrapped to ``int32``: the words equal the
reference's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

__all__ = ["quantize_leaf", "dequantize_leaf", "quantize_caches",
           "dequantize_caches", "cache_bytes",
           "quantize_leaf_nonuniform", "dequantize_leaf_nonuniform"]

# name → buffer-axis position counted from the END of the shape
#   k/v     : (..., B, buf, kv, hd) → -3
#   latent  : (..., B, buf, r)      → -2
#   k_rope  : (..., B, buf, r)      → -2
_BUF_AXIS_FROM_END = {"k": 3, "v": 3, "latent": 2, "k_rope": 2}


def _shifts(per: int, bits: int, ndim: int, axis: int,
            device) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = per
    return (torch.arange(per, dtype=torch.int64, device=device)
            * bits).reshape(shape)


def quantize_leaf(x: torch.Tensor, bits: int, axis: int):
    """Pack ``bits``-bit codes along ``axis`` (per-channel lo/scale).

    Returns (packed int32 words, meta) with the buffer axis shortened to
    ``ceil(S / (32 // bits))`` words.
    """
    if bits <= 0 or 32 % bits:
        raise ValueError(f"bits must divide 32, got {bits}")
    axis = axis % x.ndim
    per = 32 // bits
    levels = (1 << bits) - 1
    lo = x.amin(dim=axis, keepdim=True)
    hi = x.amax(dim=axis, keepdim=True)
    scale = (hi - lo) / levels
    scale = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round((x - lo) / scale), 0, levels).to(
        torch.int64)
    s = x.shape[axis]
    pad = (-s) % per
    if pad:
        widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
        codes = torch.nn.functional.pad(codes, widths)
    g = codes.shape[axis] // per
    codes = codes.reshape(*x.shape[:axis], g, per, *x.shape[axis + 1:])
    words = torch.sum(codes << _shifts(per, bits, codes.ndim, axis + 1,
                                       x.device), dim=axis + 1)
    packed = torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)
    return packed, (lo, scale, s, x.dtype, bits, axis)


def dequantize_leaf(packed: torch.Tensor, meta) -> torch.Tensor:
    lo, scale, s, dtype, bits, axis = meta
    per = 32 // bits
    mask = (1 << bits) - 1
    words = packed.to(torch.int64).unsqueeze(axis + 1) & 0xFFFFFFFF
    codes = (words >> _shifts(per, bits, words.ndim, axis + 1,
                              packed.device)) & mask
    flat = codes.reshape(*packed.shape[:axis], packed.shape[axis] * per,
                         *packed.shape[axis + 1:])
    flat = flat.narrow(axis, 0, s)
    return (flat.to(torch.float32) * scale + lo).to(dtype)


def _buf_axis(name: str, leaf: torch.Tensor) -> int:
    off = _BUF_AXIS_FROM_END.get(name, 0)
    if not off:
        return -1
    axis = leaf.ndim - off
    # buffer must be long enough to be worth packing
    if axis < 0 or leaf.shape[axis] < 16:
        return -1
    if not leaf.dtype.is_floating_point:
        return -1
    return axis


def quantize_caches(caches: Mapping[str, Any], bits: int):
    """Quantize every KV-like float leaf of a nested cache dict.

    Returns (the dict with those leaves packed, meta): ``meta`` mirrors the
    dict, holding each packed leaf's :func:`quantize_leaf` meta and None
    for a leaf left as it was.
    """
    out: Dict[str, Any] = {}
    metas: Dict[str, Any] = {}
    for key, val in caches.items():
        if isinstance(val, Mapping):
            out[key], metas[key] = quantize_caches(val, bits)
            continue
        axis = _buf_axis(key, val)
        if axis >= 0:
            out[key], metas[key] = quantize_leaf(val, bits, axis)
        else:
            out[key], metas[key] = val, None
    return out, metas


def dequantize_caches(qcaches: Mapping[str, Any], meta) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in qcaches.items():
        m = meta[key]
        if isinstance(val, Mapping):
            out[key] = dequantize_caches(val, m)
        else:
            out[key] = val if m is None else dequantize_leaf(val, m)
    return out


def cache_bytes(caches: Mapping[str, Any]) -> int:
    return sum(cache_bytes(v) if isinstance(v, Mapping)
               else v.numel() * v.element_size() for v in caches.values())


# ---------------------------------------------------------------------------
# Non-uniform OSQ-KV: variance-based per-channel bit allocation (paper §2.2).
# Channels are ranked by their value variance over the buffer; the top
# ``hi_frac`` get ``hi_bits`` codes, the rest ``lo_bits`` — the serving-side
# analogue of OSQ's variance-greedy allocation, stored as two packed tensors
# (each internally uniform, so extraction stays a shift/mask).
# ---------------------------------------------------------------------------

def quantize_leaf_nonuniform(x: torch.Tensor, axis: int, *, hi_bits: int = 8,
                             lo_bits: int = 4, hi_frac: float = 0.5):
    """Returns ((packed_hi, packed_lo), meta). Channels = trailing dims
    flattened; variance measured along ``axis`` (the buffer) and the axes
    before it."""
    axis = axis % x.ndim
    nch = 1
    for s in x.shape[axis + 1:]:
        nch *= s
    lead = x.shape[:axis]
    xr = x.reshape(*lead, x.shape[axis], nch)           # (..., S, C)
    var = xr.to(torch.float32).var(dim=tuple(range(xr.ndim - 1)),
                                   correction=0)
    n_hi = max(int(nch * hi_frac), 1)
    order = torch.argsort(-var, stable=True)            # high-variance first
    hi_idx, lo_idx = order[:n_hi], order[n_hi:]
    q_hi, m_hi = quantize_leaf(xr[..., hi_idx], hi_bits, axis)
    if lo_idx.shape[0]:
        q_lo, m_lo = quantize_leaf(xr[..., lo_idx], lo_bits, axis)
    else:
        q_lo, m_lo = None, None
    return (q_hi, q_lo), (m_hi, m_lo, hi_idx, lo_idx, tuple(x.shape), axis)


def dequantize_leaf_nonuniform(packed: Tuple[torch.Tensor, Any],
                               meta) -> torch.Tensor:
    q_hi, q_lo = packed
    m_hi, m_lo, hi_idx, lo_idx, shape, _ = meta
    x_hi = dequantize_leaf(q_hi, m_hi)
    nch = hi_idx.shape[0] + lo_idx.shape[0]
    out = torch.zeros((*x_hi.shape[:-1], nch), dtype=x_hi.dtype,
                      device=x_hi.device)
    out[..., hi_idx] = x_hi
    if q_lo is not None:
        out[..., lo_idx] = dequantize_leaf(q_lo, m_lo)
    return out.reshape(shape)
