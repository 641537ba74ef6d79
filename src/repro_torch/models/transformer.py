"""Decoder assembly of the port: the ``uniform`` schedule of Mamba2 blocks.

The port of ``repro.models.transformer`` for the attention-free ``ssm``
family (``mamba2-370m``): an embedding, ``num_layers`` pre-norm Mamba2
blocks in an ``nn.ModuleList`` (the reference stacks them on a leading axis
and runs ``lax.scan``; here a loop over the list), a final RMSNorm and the
LM head. Entry points: :meth:`DecoderLM.prefill` (populate caches, last-token
logits) and :meth:`DecoderLM.decode_step` (one token). Attention, MoE and
hybrid blocks, the other layer schedules and ``forward_train`` are not
ported yet (``ROADMAP.md``): their configs raise ``NotImplementedError``.

Caches keep the reference's layout: ``{"blocks": {"conv": (L, B, k-1, C),
"state": (L, B, H, P, N)}}``, stacked over layers.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

__all__ = ["Block", "DecoderLM", "init_params", "from_jax_params"]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.family != "ssm" or cfg.d_ff or cfg.hybrid_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the port runs only attention-free Mamba2 stacks "
            "without an MLP (family 'ssm', d_ff 0, the uniform schedule); "
            "ROADMAP.md lists the attention, MoE and hybrid families still "
            "to port")


class Block(nn.Module):
    """Pre-norm residual Mamba2 block (the reference's mamba ``init_block``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps)
        self.mixer = S.Mamba2Mixer(cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.norm1.reset_parameters(generator)
        self.mixer.reset_parameters(generator)

    def block_prefill(self, x: torch.Tensor):
        """x: (B, S, d) → (x + mixer(norm(x)), {"conv", "state"} cache)."""
        mixed, cache = self.mixer.prefill(self.norm1(x))
        return x + mixed, cache

    def block_decode(self, x: torch.Tensor, conv: torch.Tensor,
                     state: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, d); updates this layer's ``conv``/``state`` in place."""
        return x + self.mixer.mamba2_decode(self.norm1(x), conv, state)


class DecoderLM(nn.Module):
    """Embedding → Mamba2 blocks → final norm → LM head.

    Parameters are allocated uninitialised; :func:`init_params` draws them
    and :func:`from_jax_params` loads a reference tree.
    """

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.lm_head = L.Linear(cfg.d_model, cfg.vocab_size)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``init_params`` distributions, drawn in a fixed
        order from ``generator``."""
        self.embed.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)
        if not self.cfg.tie_embeddings:
            self.lm_head.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids → (B, S, d)."""
        return self.embed(tokens)

    def _lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ self.embed.table.T
        return self.lm_head(x)

    def init_decode_caches(self, batch: int) -> Dict[str, Any]:
        """Zero caches in :meth:`prefill`'s layout, on the model's device."""
        one = S.init_mamba2_cache(self.cfg, batch, self.device)
        n = self.cfg.num_layers
        return {"blocks": {k: v[None].repeat(n, *([1] * v.ndim))
                           for k, v in one.items()}}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """Populate all caches; return (last-token logits (B, 1, V), caches)."""
        x = self._embed_inputs(tokens)
        caches = self.init_decode_caches(x.shape[0])
        stacked = caches["blocks"]
        for i, blk in enumerate(self.blocks):
            x, cache = blk.block_prefill(x)
            stacked["conv"][i].copy_(cache["conv"])
            stacked["state"][i].copy_(cache["state"])
        x = self.final_norm(x[:, -1:])
        return self._lm_logits(x), caches

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: Dict[str, Any]):
        """One decode step. tokens: (B, 1) → (logits (B, 1, V), caches).

        Updates ``caches`` in place and returns the same object.
        """
        x = self._embed_inputs(tokens)
        stacked = caches["blocks"]
        for i, blk in enumerate(self.blocks):
            x = blk.block_decode(x, stacked["conv"][i], stacked["state"][i])
        x = self.final_norm(x)
        return self._lm_logits(x), caches


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> DecoderLM:
    """A model with random weights drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``, then moved to ``device``."""
    model = DecoderLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device) if device is not None else model


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def from_jax_params(tree: Mapping[str, Any], cfg: ArchConfig,
                    device=None) -> DecoderLM:
    """The port's model computing the same function as a reference tree.

    ``tree`` is the reference's ``init_params`` pytree as nested dicts of
    numpy arrays, with ``blocks`` stacked on a leading layer axis. Weights
    keep their layout (``Linear.w`` is ``(d_in, d_out)`` in both packages),
    so loading unstacks the layers and renames nothing.
    """
    state = {}
    for name, arr in _flatten(tree):
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(arr.shape[0]):
                state[f"blocks.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            state[name] = torch.tensor(arr)
    model = DecoderLM(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device) if device is not None else model
