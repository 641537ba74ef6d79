"""Shared layers of the port's language models: RMSNorm, Linear, SwiGLU MLP,
Embedding, RoPE (+M-RoPE), and the LM loss.

Counterparts of ``repro.models.layers``. Weights keep the JAX package's
layout: a :class:`Linear` stores ``w`` as ``(d_in, d_out)`` and computes
``x @ w``, so a reference parameter tree loads without transposes. Each
module's ``reset_parameters(generator)`` draws the reference's distribution
in place from an explicit :class:`torch.Generator` on the parameter's
device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.hints import hint

__all__ = ["RMSNorm", "Linear", "MLP", "Embedding", "rope_frequencies",
           "apply_rope", "apply_mrope", "cross_entropy_loss"]


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x²) + eps) * scale`` in f32, cast back to x's dtype."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(d))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator                   # ones, as init_rms_norm
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32)).to(x.dtype)


class Linear(nn.Module):
    """Bias-free ``x @ w`` with ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal with std ``d_in ** -0.5``, as init_linear."""
        with torch.no_grad():
            self.w.normal_(0.0, self.w.shape[0] ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w


class Embedding(nn.Module):
    """Rows of a ``(vocab, d_model)`` table."""

    def __init__(self, vocab: int, d_model: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal with std 0.02, as init_embedding."""
        with torch.no_grad():
            self.table.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding, not an index: on a DTensor it is DTensor's
        # vocab-parallel lookup (an index's backward, index_put, has no
        # working sharding strategy in torch 2.11).
        return F.embedding(tokens, self.table)


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``, as init_mlp / mlp."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.gate = Linear(d_model, d_ff)
        self.up = Linear(d_model, d_ff)
        self.down = Linear(d_ff, d_model)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


# ---------------------------------------------------------------------- RoPE

def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs         # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                theta: float = 10_000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): three position streams (t, h, w).

    x: (B, S, H, hd); positions_3d: (3, B, S). The rotary half-dim is split
    into three contiguous sections, each rotated by its own position stream
    (text tokens carry t = h = w, recovering 1-D RoPE exactly).
    """
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_frequencies(hd, theta, x.device)                # (half,)
    s1 = half // 3
    s2 = (half - s1) // 2
    sections = [s1, s2, half - s1 - s2]
    angs = []
    start = 0
    for i, sec in enumerate(sections):
        f = freqs[start:start + sec]
        angs.append(positions_3d[i][..., None].to(torch.float32) * f)
        start += sec
    ang = torch.cat(angs, dim=-1)                                # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


# ---------------------------------------------------------------------- Loss

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -100) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels == ignore_id are masked.
    Sharded logits are gathered over the vocabulary first (batch stays
    over ``data``): the gold logit's gather reads the whole row."""
    logits = hint(logits.to(torch.float32), "data",
                  *([None] * (logits.ndim - 1)))
    mask = labels != ignore_id
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
