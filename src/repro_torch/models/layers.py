"""Shared layers of the port's language models: RMSNorm, Linear, Embedding.

Counterparts of ``repro.models.layers``. Weights keep the JAX package's
layout: a :class:`Linear` stores ``w`` as ``(d_in, d_out)`` and computes
``x @ w``, so a reference parameter tree loads without transposes. Each
module's ``reset_parameters(generator)`` draws the reference's distribution
from an explicit :class:`torch.Generator`. RoPE, the MLP and the loss come
with the attention families (``ROADMAP.md``).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSNorm", "Linear", "Embedding"]


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
            self.w.copy_(torch.randn(self.w.shape, generator=generator)
                         * self.w.shape[0] ** -0.5)

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
            self.table.copy_(torch.randn(self.table.shape, generator=generator)
                             * 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]
