"""Mixture-of-Experts FFN: top-k routing, shared experts, dense residual.

The port of ``repro.models.moe``. Dispatch is **gather-based**, as in the
reference (no GShard one-hot dispatch tensor):

  1. router logits and softmax in f32 (the router's weight stays f32 in
     a bf16 model, as in the reference), then top-k → flat (T·K,) expert
     assignments,
  2. capacity slots via a stable-sort rank (tokens beyond ``capacity``
     drop, as in Switch/GShard capacity-factor semantics); the capacity
     ``max(int(cf · T · k / E), k)`` is recomputed per call, so a decode
     step at T = B drops tokens just as the reference does,
  3. a masked safe-gather of token states into (E, C, d),
  4. one batched product per weight over the E-stacked expert tensors,
  5. a scatter-add combine weighted by the renormalized router
     probabilities.

``jax.lax.top_k`` returns the lower index first on ties; ``torch.topk``
does not promise an order, so the top k come from a stable descending
sort. Load-balance aux loss follows Switch Transformers (top-1 fraction ×
mean router prob per expert, scaled by E).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.hints import hint, on_replicated

__all__ = ["MoE", "ExpertStack", "capacity"]


class ExpertStack(nn.Module):
    """E SwiGLU experts stacked on a leading axis: ``gate``/``up`` (E, d, f),
    ``down`` (E, f, d)."""

    def __init__(self, e: int, d_model: int, d_ff: int):
        super().__init__()
        self.gate = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.up = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.down = nn.Parameter(torch.empty(e, d_ff, d_model))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal with std d_model^-0.5 (gate, up) and d_ff^-0.5 (down)."""
        s_in = self.gate.shape[1] ** -0.5
        s_ff = self.gate.shape[2] ** -0.5
        with torch.no_grad():
            self.gate.normal_(0.0, s_in, generator=generator)
            self.up.normal_(0.0, s_in, generator=generator)
            self.down.normal_(0.0, s_ff, generator=generator)

    def forward(self, dispatched: torch.Tensor) -> torch.Tensor:
        """(E, C, d) → (E, C, d)."""
        g = F.silu(torch.bmm(dispatched, self.gate))
        u = torch.bmm(dispatched, self.up)
        return torch.bmm(g * u, self.down)


def capacity(cfg: ArchConfig, tokens: int) -> int:
    cap = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts)
    return max(cap, cfg.top_k)


class MoE(nn.Module):
    """Router + E-stacked experts (+ DeepSeek's shared experts, + Arctic's
    parallel dense FFN)."""

    # kept in f32 by ``DecoderLM.to_dtype``: the reference's router is f32
    # whatever the experts' dtype
    F32_PARAMS = ("router",)

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.router = L.Linear(cfg.d_model, cfg.num_experts)
        self.experts = ExpertStack(cfg.num_experts, cfg.d_model, cfg.d_ff)
        if cfg.num_shared_experts:
            self.shared = L.MLP(cfg.d_model,
                                cfg.d_ff * cfg.num_shared_experts)
        if cfg.moe_dense_residual:
            self.dense = L.MLP(cfg.d_model, cfg.d_ff)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.router.reset_parameters(generator)
        self.experts.reset_parameters(generator)
        for name in ("shared", "dense"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d) → (y (B, S, d), aux_loss scalar).

        On a sharded model the routing, the dispatch gather and the combine
        run on the whole, replicated tokens on every rank
        (``hints.on_replicated``), and the expert products on the experts'
        shards: dispatched tokens and expert outputs pinned E over
        ``model``, the output tokens over ``data``, as the reference's
        hints pin them."""
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        xt = hint(x.reshape(t, d), "data", None)
        c = capacity(cfg, t)

        # --- routing (f32 for a stable softmax) -----------------------------
        probs = torch.softmax(self.router(xt.to(torch.float32)), dim=-1)
        flat_p, flat_tok, keep, slot, tok_for_slot, aux = on_replicated(
            functools.partial(_route, cfg=cfg, c=c), 6, probs)

        # --- dispatch → grouped expert SwiGLU (E-stacked) → combine --------
        dispatched = on_replicated(_dispatch, 1, xt, tok_for_slot).reshape(
            cfg.num_experts, c, d)
        dispatched = hint(dispatched, "model", None, None)
        out = hint(self.experts(dispatched), "model", None, None)
        y = hint(on_replicated(functools.partial(_combine, t=t,
                                                 dtype=x.dtype),
                               1, out, slot, keep, flat_p, flat_tok),
                 "data", None)

        # --- shared experts & dense residual (DeepSeek / Arctic variants) ---
        if hasattr(self, "shared"):
            y = y + self.shared(xt)
        if hasattr(self, "dense"):
            y = y + self.dense(xt)
        # (the sums may have taken another operand's placements)
        return hint(y, "data", None).reshape(b, s, d), aux


def _route(probs: torch.Tensor, *, cfg: ArchConfig, c: int):
    """(T, E) router probabilities → the top-k weights and token of every
    (token, choice) (T·K,), whether it keeps a capacity slot and which,
    each slot's token (E·C,) (T where empty), and the aux loss."""
    t, e = probs.shape
    k = cfg.top_k
    dev = probs.device
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]                   # (T, K)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)

    # --- aux load-balance loss (Switch eq. 4) -------------------------------
    frac_tokens = F.one_hot(top_e[:, 0], e).to(torch.float32).mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = cfg.router_aux_weight * e * torch.sum(frac_tokens * mean_prob)

    # --- capacity slots: stable sort by expert, rank within expert ----------
    flat_e = top_e.reshape(-1)                                   # (T·K,)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                                   side="left")
    rank_sorted = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted                                    # unsort
    keep = rank < c
    slot = torch.where(keep, flat_e * c + rank, e * c)           # drop → pad

    tok_for_slot = torch.full((e * c + 1,), t, dtype=torch.int64, device=dev)
    tok_for_slot[slot] = flat_tok                                # pad row last
    return flat_p, flat_tok, keep, slot, tok_for_slot[:e * c], aux


def _dispatch(xt: torch.Tensor, tok_for_slot: torch.Tensor) -> torch.Tensor:
    """Masked safe-gather of token states into (E·C, d): zeros at empty
    slots."""
    empty_slot = tok_for_slot >= xt.shape[0]
    return torch.where(empty_slot[:, None], 0.0,
                       xt[torch.where(empty_slot, 0, tok_for_slot)])


def _combine(out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             flat_p: torch.Tensor, flat_tok: torch.Tensor, *, t: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Scatter-add the weighted expert outputs (E, C, d) back to their
    ``t`` tokens → (T, d) in ``dtype``."""
    e, c, d = out.shape
    gathered = out.reshape(e * c, d)[torch.where(slot >= e * c, 0, slot)]
    weighted = gathered * flat_p[:, None].to(gathered.dtype)
    return torch.zeros((t, d), dtype=dtype, device=out.device).index_add_(
        0, flat_tok, torch.where(keep[:, None], weighted, 0.0).to(dtype))
