"""Mamba2 (SSD — state-space duality) mixer: chunked scan + O(1) decode.

The port of ``repro.models.ssm``. The selective SSM is computed chunk-wise —
a quadratic *intra-chunk* term (kernel 6, ``kernels.ops.ssd_intra``: the
CUDA kernel for tensors on the card, differentiable through
``kernels.ssd.SsdIntraFunction``; its plain version for CPU tensors) plus
a linear *inter-chunk* recurrence over per-chunk states, here a Python loop
over chunks. Per-token decode keeps the recurrent state ``(B, H, P, N)``.

Conventions (n_groups = 1, B/C shared across heads, as in the 370m config):
  d_inner = expand · d_model,  H = d_inner / headdim,  N = ssm_state.
The input projections are split into z | xBC | dt; a depthwise causal conv
runs over the [x | B | C] channels; gated RMSNorm before out_proj. The
SSD scan (kernel 6 included) and the decode recurrence run in f32 whatever
the weights' dtype, as the reference's ``SSD_COMPUTE_DTYPE``; the
projections, the conv and the norm take the weights' dtype, and ``A_log``,
``D`` and ``dt_bias`` stay f32 (``F32_PARAMS``). Parameters broadcast by
trailing alignment, without leading ``[None]`` axes: on a 1 × 1 mesh
DTensor's backward of such an axis squeezes a size-1 dim it holds as
sharded, which it refuses. The
reference's sharding hints place a sharded model's streams
(``hints.hint``): heads over ``model``, B and C replicated over it, so
that kernel 6 runs on each rank's own heads (``kernels.ops.ssd_intra``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.hints import along, hint, pad_dim, split_heads

__all__ = ["Mamba2Mixer", "ssd_chunked", "init_mamba2_cache"]


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    return d_inner, heads, cfg.ssm_state, cfg.ssm_headdim


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis. xbc: (B, S, C)."""
    kw = conv_w.shape[0]
    pad = pad_dim(xbc, 1, kw - 1, 0)
    out = sum(pad[:, i:i + xbc.shape[1], :] * conv_w[i]
              for i in range(kw))
    return F.silu(out + conv_b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P)  dt: (B, S, H)  a: (H,) (negative)
    b_mat/c_mat: (B, S, N)  (n_groups=1, broadcast over heads)
    Returns (y (B, S, H, P), final_state (B, H, P, N)). S is padded to a
    multiple of ``lc = min(chunk, S)`` with dt = 0, which leaves the states
    unchanged.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    lc = min(chunk, s)
    pad = (-s) % lc
    if pad:
        x, dt, b_mat, c_mat = (pad_dim(t, 1, 0, pad)
                               for t in (x, dt, b_mat, c_mat))
    nc = x.shape[1] // lc

    xc = x.reshape(bsz, nc, lc, h, p)
    dtc = dt.reshape(bsz, nc, lc, h)
    bc = b_mat.reshape(bsz, nc, lc, n)
    cc = c_mat.reshape(bsz, nc, lc, n)

    da = dtc * a                       # (B,nc,lc,H) ≤ 0
    a_cs = along(lambda t: torch.cumsum(t, dim=2), da, 2)   # within-chunk
    xdt = xc * dtc[..., None]

    # Intra-chunk (quadratic in lc — the "attention duality" term), kernel 6.
    # Views, no copies: C and B stay slices of the conv stream, da and x
    # keep the heads innermost, and on the card y comes back in the
    # (B, S, H, P) layout, so the transpose below is a view there too.
    g = bsz * nc
    y_k = ops.ssd_intra(cc.reshape(g, lc, n), bc.reshape(g, lc, n),
                        da.reshape(g, lc, h).transpose(1, 2),
                        xdt.reshape(g, lc, h, p).transpose(1, 2))  # (G,H,lc,P)
    y_diag = y_k.transpose(1, 2).reshape(bsz, nc, lc, h, p)

    # Per-chunk input → state contribution.
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)     # (B,nc,lc,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn",
                          bc, decay_states, xdt)            # (B,nc,H,P,N)

    # Inter-chunk recurrence: each chunk reads the state *prior* to it.
    chunk_decay = torch.exp(a_cs[:, :, -1, :])              # (B,nc,H)
    carry = (torch.zeros((bsz, h, p, n), dtype=states.dtype, device=x.device)
             if init_state is None else init_state)
    prior = []
    for c in range(nc):
        prior.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prior = torch.stack(prior, dim=1)                       # (B,nc,H,P,N)

    # Inter-chunk output: prior state read out through C with in-chunk decay.
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp",
                         cc, prior, torch.exp(a_cs))
    y = (y_diag + y_off).reshape(bsz, nc * lc, h, p)
    return y[:, :s], carry


def init_mamba2_cache(cfg: ArchConfig, batch: int, device=None,
                      dtype=None) -> Dict[str, torch.Tensor]:
    """Zero decode cache of one mixer: the last ``ssm_conv - 1`` pre-conv
    inputs in ``dtype`` (default: torch's) and the recurrent state, at
    least f32 whatever ``dtype`` is, as the reference keeps it."""
    d_inner, h, n, p = _dims(cfg)
    dtype = dtype or torch.get_default_dtype()
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, h, p, n), device=device,
                             dtype=torch.promote_types(dtype, torch.float32)),
    }


class Mamba2Mixer(nn.Module):
    """One Mamba2 mixer; parameter names follow ``init_mamba2``'s tree."""

    # kept in f32 by ``DecoderLM.to_dtype``, as ``init_mamba2`` keeps them
    F32_PARAMS = ("A_log", "D", "dt_bias")

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner, h, n, _ = _dims(cfg)
        conv_ch = d_inner + 2 * n
        self.in_z = L.Linear(d, d_inner)
        self.in_xbc = L.Linear(d, conv_ch)
        self.in_dt = L.Linear(d, h)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv, conv_ch))
        self.conv_b = nn.Parameter(torch.empty(conv_ch))
        self.A_log = nn.Parameter(torch.empty(h))
        self.D = nn.Parameter(torch.empty(h))
        self.dt_bias = nn.Parameter(torch.empty(h))
        self.norm = L.RMSNorm(d_inner)
        self.out_proj = L.Linear(d_inner, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``init_mamba2`` distributions."""
        h = self.A_log.shape[0]
        for lin in (self.in_z, self.in_xbc, self.in_dt):
            lin.reset_parameters(generator)
        with torch.no_grad():
            self.conv_w.normal_(0.0, self.cfg.ssm_conv ** -0.5,
                                generator=generator)
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, h, dtype=torch.float64)))
            self.D.fill_(1.0)
            self.dt_bias.zero_()
        self.norm.reset_parameters(generator)
        self.out_proj.reset_parameters(generator)

    def _project_in(self, x: torch.Tensor):
        """Split input projections z | xBC | dt."""
        return self.in_z(x), self.in_xbc(x), self.in_dt(x)

    def _mix(self, x: torch.Tensor):
        """Full-sequence mixer → (out, final state, pre-conv xBC)."""
        cfg = self.cfg
        d_inner, h, n, p = _dims(cfg)
        z, xbc, dt = self._project_in(x)
        xbc_conv = _causal_conv(xbc, self.conv_w, self.conv_b)
        xs = xbc_conv[..., :d_inner]
        b_mat = xbc_conv[..., d_inner:d_inner + n]
        c_mat = xbc_conv[..., d_inner + n:]
        dt = F.softplus(dt.to(torch.float32) + self.dt_bias)
        a = -torch.exp(self.A_log)
        # The reference's placements on a mesh: heads over `model`; the
        # slim shared B/C streams replicated (every head reads them).
        xs = hint(xs, "data", None, "model")
        b_mat = hint(b_mat, "data", None, None)
        c_mat = hint(c_mat, "data", None, None)
        xh = split_heads(xs, h, p).to(torch.float32)
        xh = hint(xh, "data", None, "model", None)
        y, state = ssd_chunked(xh, dt, a, b_mat.to(torch.float32),
                               c_mat.to(torch.float32), cfg.ssm_chunk)
        y = y + self.D[:, None] * xh
        y = y.reshape(*xs.shape[:2], d_inner).to(x.dtype)
        y = self.norm(y * F.silu(z))
        return self.out_proj(y), state, xbc

    def forward(self, x: torch.Tensor,
                init_state: Optional[torch.Tensor] = None):
        """Full-sequence mixer (the reference's ``mamba2_train``).
        x: (B, S, d_model) → (out (B, S, d_model), final state (B, H, P, N)).

        ``init_state`` is taken and not used, as in the reference (whose
        ``mamba2_train`` never passes it to ``ssd_chunked``): the scan
        starts from zeros."""
        del init_state
        out, state, _ = self._mix(x)
        return out, state

    def prefill(self, x: torch.Tensor):
        """:meth:`forward` plus the decode cache: the *pre-conv* xBC of the
        last ``ssm_conv - 1`` positions and the final state."""
        out, state, xbc = self._mix(x)
        return out, {"conv": xbc[:, -(self.cfg.ssm_conv - 1):, :],
                     "state": state}

    def mamba2_decode(self, x: torch.Tensor, conv: torch.Tensor,
                      state: torch.Tensor) -> torch.Tensor:
        """Single-token recurrent step. x: (B, 1, d_model) → (B, 1, d_model).

        Updates the caller's ``conv`` (B, ssm_conv-1, C) and ``state``
        (B, H, P, N) cache tensors in place.
        """
        d_inner, h, n, p = _dims(self.cfg)
        bsz = x.shape[0]
        z, xbc, dt = self._project_in(x[:, 0, :])
        window = torch.cat([conv, xbc[:, None, :]], dim=1)
        conv_out = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                                self.conv_w.to(torch.float32))
        xbc = F.silu(conv_out + self.conv_b.to(torch.float32))
        xs = xbc[..., :d_inner]
        b_vec = xbc[..., d_inner:d_inner + n]
        c_vec = xbc[..., d_inner + n:]
        dt = F.softplus(dt.to(torch.float32) + self.dt_bias)
        da = torch.exp(dt * -torch.exp(self.A_log))      # (B,H)
        xh = split_heads(xs, h, p)
        state.mul_(da[:, :, None, None]).add_(
            torch.einsum("bhp,bn,bh->bhpn", xh, b_vec, dt))
        y = torch.einsum("bhpn,bn->bhp", state, c_vec)
        y = y + self.D[:, None] * xh
        y = y.reshape(bsz, 1, d_inner).to(x.dtype)
        y = self.norm(y * F.silu(z[:, None, :]))
        conv.copy_(window[:, 1:])
        return self.out_proj(y)
