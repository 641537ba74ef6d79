"""Decoder assembly for every architecture family (the port of
``repro.models.transformer``).

One code path builds all ten configs. The reference stacks layers on a
leading axis and runs ``lax.scan``; here each stack is an
``nn.ModuleList`` and a loop. Heterogeneous schedules repeat *units*:

  dense / moe / ssm / vlm / audio — one uniform stack of ``num_layers``.
  gemma3 (local:global R:1)       — units of (R local + 1 global) and a
                                    tail of the remaining locals. Local
                                    layers keep ring caches of
                                    ``min(sliding_window, buf_len)``; globals
                                    keep full buffers.
  zamba2 (hybrid)                 — units of (E Mamba2 blocks + the ONE
                                    shared attention+MLP block: a single
                                    module applied at every unit, its
                                    weights once in ``state_dict()``) and a
                                    Mamba2 tail.

Entry points: :meth:`DecoderLM.forward_train` (full-sequence logits and
the MoE aux loss, differentiable, each block — and each unit — under
activation checkpointing), :meth:`DecoderLM.prefill` (populate caches,
last-token logits) and :meth:`DecoderLM.decode_step` (one token, caches
updated in place).

Caches keep the reference's layout and key names, stacked over layers:
``{"blocks": ...}`` for the uniform stack, ``{"units": {"local",
"global"}, "tail"}`` for local:global and ``{"units": {"mamba", "attn"},
"tail"}`` for the hybrid, with leaves ``k``/``v`` (B, buf, KV, hd),
``latent``/``k_rope`` (B, buf, r) and ``conv``/``state`` behind the
stacking axes. ``serve.kv_quant`` picks leaves by these names.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.hints import hint, hint_local, is_sharded, sharded_scope

__all__ = ["Block", "DecoderLM", "init_params", "from_jax_params",
           "from_jax_opt_state", "make_positions", "vlm_positions_3d"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


# ======================================================================
# single blocks
# ======================================================================

def _block_kind(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        return "mamba"
    if cfg.mla:
        return "mla"
    return "gqa"


class Block(nn.Module):
    """Pre-norm residual block of one kind: ``mamba`` (a Mamba2 mixer, and
    an MLP when ``d_ff``), ``gqa`` or ``mla`` (attention, then an MLP or
    the MoE FFN)."""

    def __init__(self, cfg: ArchConfig, kind: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind = kind or _block_kind(cfg)
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps)
        if kind == "mamba":
            self.mixer = S.Mamba2Mixer(cfg)
            if cfg.d_ff:
                self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps)
                self.ffn = L.MLP(cfg.d_model, cfg.d_ff)
            return
        self.attn = A.MLA(cfg) if kind == "mla" else A.GQA(cfg)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps)
        self.ffn = (M.MoE(cfg) if cfg.num_experts
                    else L.MLP(cfg.d_model, cfg.d_ff))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_children(self, generator)

    def _ffn(self, x: torch.Tensor):
        """x + ffn(norm2(x)) and the MoE aux loss (0 without experts)."""
        h2 = self.norm2(x)
        if isinstance(self.ffn, M.MoE):
            y, aux = self.ffn(h2)
            return x + y, aux
        return x + self.ffn(h2), torch.zeros((), device=x.device)

    def block_train(self, x: torch.Tensor, positions: torch.Tensor, *,
                    window: int = 0,
                    positions_3d: Optional[torch.Tensor] = None):
        """x: (B, S, d) → (y, aux loss). Full-sequence, no cache."""
        x = _pin_stream(x)
        h = self.norm1(x)
        if self.kind == "mamba":
            mixed, _ = self.mixer(h)
            x = x + mixed
            if hasattr(self, "ffn"):
                x = x + self.ffn(self.norm2(x))
            return x, torch.zeros((), device=x.device)
        if self.kind == "mla":
            y = self.attn(h, positions, window)
        else:
            y = self.attn(h, positions, window, positions_3d)
        return self._ffn(x + y)

    def block_prefill(self, x: torch.Tensor, positions: torch.Tensor,
                      buf_len: int, *, window: int = 0,
                      positions_3d: Optional[torch.Tensor] = None):
        """x: (B, S, d) → (y, this layer's cache, aux loss)."""
        x = _pin_stream(x)
        h = self.norm1(x)
        if self.kind == "mamba":
            mixed, cache = self.mixer.prefill(h)
            x = x + mixed
            if hasattr(self, "ffn"):
                x = x + self.ffn(self.norm2(x))
            return x, cache, torch.zeros((), device=x.device)
        if self.kind == "mla":
            y, cache = self.attn.prefill(h, positions, buf_len, window)
        else:
            y, cache = self.attn.prefill(h, positions, buf_len, window,
                                         positions_3d)
        x, aux = self._ffn(x + y)
        return x, cache, aux

    def block_decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: int, *, window: int = 0) -> torch.Tensor:
        """x: (B, 1, d); updates this layer's ``cache`` in place."""
        x = _pin_stream(x)
        h = self.norm1(x)
        if self.kind == "mamba":
            x = x + self.mixer.mamba2_decode(h, cache["conv"], cache["state"])
            if hasattr(self, "ffn"):
                x = x + self.ffn(self.norm2(x))
            return x
        x = x + self.attn.decode(h, cache, pos, window)
        return self._ffn(x)[0]


def _pin_stream(x: torch.Tensor) -> torch.Tensor:
    """A sharded model's residual stream at a block's entry: batch over
    ``data``, whole elsewhere (as the embed output). Pinned at every block,
    so that the placements the previous block's products left (partial
    sums, the batch over both axes) do not carry into this one's."""
    return hint(x, "data", None, None)


def _block_cache(cfg: ArchConfig, kind: str, batch: int, buf_len: int,
                 device) -> Dict[str, torch.Tensor]:
    if kind == "mamba":
        return S.init_mamba2_cache(cfg, batch, device)
    if kind == "mla":
        return A.init_mla_cache(cfg, batch, buf_len, device)
    return A.init_gqa_cache(cfg, batch, buf_len, device)


def _stacked(lead, one: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zeros of ``one``'s leaves with leading stacking axes ``lead``."""
    return {k: torch.zeros((*lead, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in one.items()}


def _at(stack: Dict[str, torch.Tensor], *idx) -> Dict[str, torch.Tensor]:
    """One layer's cache: views into the stacked leaves."""
    return {k: v[idx] for k, v in stack.items()}


def _put(stack: Dict[str, torch.Tensor], idx, cache) -> None:
    """Write one layer's cache into the stacks at ``idx``. A sharded
    layer's cache (a sharded model's prefill) turns its plain stack into a
    DTensor placed as the layer's leaves, the stacking axes whole, and is
    written into the local shards."""
    for k, v in cache.items():
        dst = stack[k]
        if not is_sharded(v):
            dst[idx].copy_(v)
            continue
        from torch.distributed import tensor as dt
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        lead, mesh = dst.ndim - v.ndim, v.device_mesh
        if not is_sharded(dst):
            # zeros of this rank's shard, on the stack's device (``meta`` in
            # the dry run)
            placements = [dt.Shard(p.dim + lead) if p.is_shard()
                          else dt.Replicate() for p in v.placements]
            local, _ = compute_local_shape_and_global_offset(
                dst.shape, mesh, placements)
            dst = stack[k] = dt.DTensor.from_local(
                torch.zeros(local, dtype=dst.dtype, device=dst.device), mesh,
                placements, run_check=False, shape=dst.shape,
                stride=dst.stride())
        mine = [dt.Shard(p.dim - lead) if p.is_shard() else p
                for p in dst.placements]
        dst.to_local()[idx].copy_(hint_local(v, mesh, mine))


# ======================================================================
# layer schedules
# ======================================================================

def _schedule(cfg: ArchConfig):
    """Returns (kind, counts...) describing the layer layout."""
    if cfg.family == "dense" and cfg.local_global_ratio:
        r = cfg.local_global_ratio
        units = cfg.num_layers // (r + 1)
        tail = cfg.num_layers - units * (r + 1)
        return ("local_global", r, units, tail)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        e = cfg.hybrid_attn_every
        units = cfg.num_layers // e
        tail = cfg.num_layers - units * e
        return ("hybrid", e, units, tail)
    return ("uniform", cfg.num_layers)


def _window_for(cfg: ArchConfig) -> int:
    if cfg.attention == "sliding" and cfg.sliding_window:
        return cfg.sliding_window
    return 0


# ======================================================================
# positions
# ======================================================================

def make_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32,
                        device=device)[None, :].expand(batch, seq)


def vlm_positions_3d(batch: int, seq: int, num_patches: int,
                     device=None) -> torch.Tensor:
    """Qwen2-VL M-RoPE ids: the patch prefix gets a (t=0, h, w) grid; text
    runs on with t = h = w = index, where M-RoPE is 1-D RoPE (so the decode
    path, which rotates with a scalar position, is consistent).

    Returns (3, B, S) int32.
    """
    side = max(int(num_patches ** 0.5), 1)
    idx = torch.arange(seq, device=device)
    in_img = idx < num_patches
    t = torch.where(in_img, 0, idx)
    h = torch.where(in_img, idx // side, idx)
    w = torch.where(in_img, idx % side, idx)
    pos3 = torch.stack([t, h, w]).to(torch.int32)            # (3, S)
    return pos3[:, None, :].expand(3, batch, seq)


# ======================================================================
# the model
# ======================================================================

class CodebookEmbedding(nn.Module):
    """MusicGen's K codebook tables, ``table`` (K, V, d)."""

    def __init__(self, k: int, vocab: int, d_model: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(k, vocab, d_model))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.table.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, K, S) ids → the sum of the K embeddings, (B, S, d)."""
        books = torch.arange(self.table.shape[0],
                             device=tokens.device)[None, :, None]
        return self.table[books, tokens].sum(dim=1)     # (B, K, S, d) → sum


class CodebookHead(nn.Module):
    """MusicGen's K output heads, ``w`` (K, d, V)."""

    def __init__(self, k: int, d_model: int, vocab: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(k, d_model, vocab))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.w.normal_(0.0, self.w.shape[1] ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, K, V). Sharded, each rank computes its batch
        rows' logits of its vocabulary shard (DTensor's einsum would flatten
        the sharded vocabulary into its product, which torch 2.11
        refuses); the weight's gradient is then a partial sum over the
        batch shards, x's over the vocabulary shards."""
        if not is_sharded(self.w):
            return torch.einsum("bsd,kdv->bskv", x, self.w)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        from repro_torch.launch.shardings import fitted_placements

        mesh = self.w.device_mesh
        xp = fitted_placements(("data", None, None), x.shape, mesh)
        wp = fitted_placements((None, None, "model"), self.w.shape, mesh)
        pairs = list(zip(xp, wp))      # per mesh dim: x's, w's placement
        return local_map(
            lambda a, w: torch.einsum("bsd,kdv->bskv", a, w),
            out_placements=[Shard(0) if a.is_shard() else Shard(3)
                            if w.is_shard() else Replicate()
                            for a, w in pairs],
            in_placements=(xp, wp),
            in_grad_placements=([Partial() if w.is_shard() else a
                                 for a, w in pairs],
                                [Partial() if a.is_shard() else w
                                 for a, w in pairs]),
            device_mesh=mesh, redistribute_inputs=True)(x, self.w)


def _scoped(method):
    """Run an entry point in ``hints.sharded_scope`` of the model's
    parameters: on a sharded model, the plain tensors the model code makes
    meet its DTensors as replicated ones."""
    @functools.wraps(method)
    def scoped(self, *args, **kwargs):
        with sharded_scope(self.final_norm.scale):
            return method(self, *args, **kwargs)
    return scoped


class DecoderLM(nn.Module):
    """Embedding → blocks in the config's schedule → final norm → LM head.

    Parameters are allocated uninitialised (on the default device, or in a
    ``with torch.device(...)`` block); :func:`init_params` draws them and
    :func:`from_jax_params` loads a reference tree.
    """

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family not in _FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                             f"(one of {_FAMILIES})")
        self.cfg = cfg
        if cfg.num_codebooks:
            # MusicGen: K codebook embeddings (summed) + K output heads.
            self.cb_embed = CodebookEmbedding(cfg.num_codebooks,
                                              cfg.vocab_size, cfg.d_model)
            self.cb_head = CodebookHead(cfg.num_codebooks, cfg.d_model,
                                        cfg.vocab_size)
        else:
            self.embed = L.Embedding(cfg.vocab_size, cfg.d_model)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps)
        if not cfg.tie_embeddings:
            # (unused by the audio heads; the reference keeps it too)
            self.lm_head = L.Linear(cfg.d_model, cfg.vocab_size)
        sched = _schedule(cfg)
        if sched[0] == "uniform":
            self.blocks = nn.ModuleList(Block(cfg)
                                        for _ in range(cfg.num_layers))
        elif sched[0] == "local_global":
            _, r, units, tail = sched
            self.units = nn.ModuleList(nn.ModuleDict({
                "local": nn.ModuleList(Block(cfg) for _ in range(r)),
                "global": Block(cfg)}) for _ in range(units))
            if tail:
                self.tail = nn.ModuleList(Block(cfg) for _ in range(tail))
        else:  # hybrid
            _, e, units, tail = sched
            self.units = nn.ModuleList(
                nn.ModuleList(Block(cfg, "mamba") for _ in range(e))
                for _ in range(units))
            if tail:
                self.tail = nn.ModuleList(Block(cfg, "mamba")
                                          for _ in range(tail))
            # ONE shared attention+MLP block reused at every unit boundary.
            self.shared_attn = Block(cfg, "gqa")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``init_params`` distributions, drawn in module
        order from ``generator``."""
        _reset_children(self, generator)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    # ------------------------------------------------------------ helpers

    def _embed_inputs(self, tokens: torch.Tensor,
                      embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens → (B, S, d). Audio sums K codebook embeddings of (B, K, S)
        ids; the VLM prepends the given patch embeddings."""
        if self.cfg.num_codebooks:
            return hint(self.cb_embed(tokens), "data", None, None)
        # (a vocab-sharded lookup's partial sums reduced before the cat)
        x = hint(self.embed(tokens), "data", None, None)
        if self.cfg.mrope and embeds is not None:
            x = torch.cat([embeds.to(x.dtype), x], dim=1)
        # The reference pins the embed output to batch over `data` before
        # any block (on its mesh the vocab-sharded gather feeding the MLA
        # scan miscompiled otherwise); here it places the activations as
        # the batch lies.
        return hint(x, "data", None, None)

    def _lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.num_codebooks:
            return self.cb_head(x)                           # (B, S, K, V)
        if self.cfg.tie_embeddings:
            return x @ self.embed.table.T
        return self.lm_head(x)

    def _caches(self, batch: int, buf_len: int,
                uniform_buf: int) -> Dict[str, Any]:
        """Zero caches in the reference's layout; the uniform stack's
        buffers hold ``uniform_buf`` slots."""
        cfg, dev = self.cfg, self.device
        sched = _schedule(cfg)
        if sched[0] == "uniform":
            return {"blocks": _stacked((cfg.num_layers,), _block_cache(
                cfg, _block_kind(cfg), batch, uniform_buf, dev))}
        if sched[0] == "local_global":
            _, r, units, tail = sched
            wbuf = min(cfg.sliding_window, buf_len)
            local = _block_cache(cfg, "gqa", batch, wbuf, dev)
            out = {"units": {
                "local": _stacked((units, r), local),
                "global": _stacked((units,), _block_cache(
                    cfg, "gqa", batch, buf_len, dev))}}
            if tail:
                out["tail"] = _stacked((tail,), local)
            return out
        _, e, units, tail = sched
        mamba = _block_cache(cfg, "mamba", batch, 0, dev)
        out = {"units": {"mamba": _stacked((units, e), mamba),
                         "attn": _stacked((units,), _block_cache(
                             cfg, "gqa", batch, buf_len, dev))}}
        if tail:
            out["tail"] = _stacked((tail,), mamba)
        return out

    def init_decode_caches(self, batch: int, buf_len: int) -> Dict[str, Any]:
        """Zero caches in :meth:`prefill`'s layout, on the model's device."""
        window = _window_for(self.cfg)
        return self._caches(batch, buf_len,
                            min(window, buf_len) if window else buf_len)

    # -------------------------------------------------------- entry points

    @_scoped
    def forward_train(self, tokens: torch.Tensor, *,
                      embeds: Optional[torch.Tensor] = None,
                      remat: bool = True):
        """Full-sequence forward → (logits, aux loss), differentiable.

        tokens: (B, S) ids, (B, K, S) for audio; ``embeds`` (B, P, d)
        patch embeddings for the VLM. Logits are (B, S, V) ((B, S, K, V)
        for audio; the VLM's cover the P patch positions too). With
        ``remat`` every block runs under ``torch.utils.checkpoint`` (its
        activations recomputed in the backward), and so does every unit of
        the local:global and hybrid schedules, where the reference
        checkpoints the unit's body too.
        """
        cfg = self.cfg
        x = self._embed_inputs(tokens, embeds)
        b, s = x.shape[:2]
        positions = make_positions(b, s, x.device)
        pos3 = (vlm_positions_3d(b, s, cfg.vlm_num_patches, x.device)
                if cfg.mrope else None)
        window = _window_for(cfg)
        sched = _schedule(cfg)

        def remat_call(fn, *args, **kwargs):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False, **kwargs)
            return fn(*args, **kwargs)

        def stack(blocks, x, *, window=0):
            aux = torch.zeros((), device=x.device)
            for blk in blocks:
                x, a = remat_call(blk.block_train, x, positions,
                                  window=window, positions_3d=pos3)
                aux = aux + a
            return x, aux

        if sched[0] == "uniform":
            x, aux = stack(self.blocks, x, window=window)
        else:
            if sched[0] == "local_global":
                tail_window = cfg.sliding_window

                def unit_body(unit, x):
                    y, a1 = stack(unit["local"], x, window=tail_window)
                    y, a2 = unit["global"].block_train(y, positions,
                                                       positions_3d=pos3)
                    return y, a1 + a2
            else:  # hybrid: E Mamba2 blocks, then the one shared block
                tail_window = 0

                def unit_body(unit, x):
                    y, a1 = stack(unit, x)
                    y, a2 = self.shared_attn.block_train(y, positions)
                    return y, a1 + a2
            aux = torch.zeros((), device=x.device)
            for unit in self.units:
                x, a = remat_call(unit_body, unit, x)
                aux = aux + a
            if hasattr(self, "tail"):
                x, a = stack(self.tail, x, window=tail_window)
                aux = aux + a

        x = self.final_norm(x)
        return self._lm_logits(x), aux

    @_scoped
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, buf_len: Optional[int] = None,
                embeds: Optional[torch.Tensor] = None):
        """Populate all caches; return (last-token logits, caches).

        tokens: (B, S) ids, (B, K, S) for audio; ``embeds`` (B, P, d)
        patch embeddings for the VLM. Logits are (B, 1, V), (B, 1, K, V)
        for audio.
        """
        cfg = self.cfg
        x = self._embed_inputs(tokens, embeds)
        b, s = x.shape[:2]
        buf_len = buf_len or s
        positions = make_positions(b, s, x.device)
        pos3 = (vlm_positions_3d(b, s, cfg.vlm_num_patches, x.device)
                if cfg.mrope else None)
        window = _window_for(cfg)
        sched = _schedule(cfg)
        caches = self._caches(b, buf_len, buf_len)

        def run(blk, x, stack, idx, *, window=0, buf=buf_len):
            x, cache, _ = blk.block_prefill(x, positions, buf, window=window,
                                            positions_3d=pos3)
            _put(stack, idx, cache)
            return x

        if sched[0] == "uniform":
            for i, blk in enumerate(self.blocks):
                x = run(blk, x, caches["blocks"], i, window=window)
        elif sched[0] == "local_global":
            win = cfg.sliding_window
            wbuf = min(win, buf_len)
            uc = caches["units"]
            for u, unit in enumerate(self.units):
                for j, blk in enumerate(unit["local"]):
                    x = run(blk, x, uc["local"], (u, j), window=win, buf=wbuf)
                x = run(unit["global"], x, uc["global"], u)
            for i, blk in enumerate(getattr(self, "tail", ())):
                x = run(blk, x, caches["tail"], i, window=win, buf=wbuf)
        else:  # hybrid
            uc = caches["units"]
            for u, unit in enumerate(self.units):
                for j, blk in enumerate(unit):
                    x = run(blk, x, uc["mamba"], (u, j))
                x = run(self.shared_attn, x, uc["attn"], u)
            for i, blk in enumerate(getattr(self, "tail", ())):
                x = run(blk, x, caches["tail"], i)

        x = self.final_norm(x[:, -1:])
        return self._lm_logits(x), caches

    @_scoped
    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: Dict[str, Any],
                    pos: int):
        """One decode step at absolute position ``pos``. tokens: (B, 1)
        ((B, K, 1) for audio) → (logits, caches), the caches updated in
        place and returned."""
        cfg = self.cfg
        x = self._embed_inputs(tokens)
        window = _window_for(cfg)
        sched = _schedule(cfg)
        if sched[0] == "uniform":
            for i, blk in enumerate(self.blocks):
                x = blk.block_decode(x, _at(caches["blocks"], i), pos,
                                     window=window)
        elif sched[0] == "local_global":
            win = cfg.sliding_window
            uc = caches["units"]
            for u, unit in enumerate(self.units):
                for j, blk in enumerate(unit["local"]):
                    x = blk.block_decode(x, _at(uc["local"], u, j), pos,
                                         window=win)
                x = unit["global"].block_decode(x, _at(uc["global"], u), pos)
            for i, blk in enumerate(getattr(self, "tail", ())):
                x = blk.block_decode(x, _at(caches["tail"], i), pos,
                                     window=win)
        else:  # hybrid
            uc = caches["units"]
            for u, unit in enumerate(self.units):
                for j, blk in enumerate(unit):
                    x = blk.block_decode(x, _at(uc["mamba"], u, j), pos)
                x = self.shared_attn.block_decode(x, _at(uc["attn"], u), pos)
            for i, blk in enumerate(getattr(self, "tail", ())):
                x = blk.block_decode(x, _at(caches["tail"], i), pos)
        x = self.final_norm(x)
        return self._lm_logits(x), caches


def _reset_children(mod: nn.Module, generator: torch.Generator) -> None:
    """Each child's ``reset_parameters`` in registration order, looking
    through the containers of the layer stacks."""
    for child in mod.children():
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)):
            _reset_children(child, generator)
        else:
            child.reset_parameters(generator)


def _resolve_device(device) -> torch.device:
    # serve.engine imports this module, hence the import here.
    from repro_torch.serve.engine import resolve_device
    return resolve_device(device)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> DecoderLM:
    """A model with random weights drawn on ``device`` (default the card;
    raises without CUDA) from ``torch.Generator(device).manual_seed(seed)``:
    full-size weights are drawn on the card itself, never staged through
    host memory. The CPU's and the card's generators give different
    numbers."""
    dev = _resolve_device(device)
    with torch.device(dev):
        model = DecoderLM(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model.reset_parameters(gen)
    return model


# ======================================================================
# weights carried from a reference tree
# ======================================================================

def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def _unstack(name: str, arr: np.ndarray, hybrid: bool):
    """(state_dict name, array) pairs of one reference leaf: the stacked
    trees lose their leading layer axes."""
    head, _, rest = name.partition(".")
    if head in ("blocks", "tail"):
        for i in range(arr.shape[0]):
            yield f"{head}.{i}.{rest}", arr[i]
    elif head == "units" and hybrid:           # (units, E, ...)
        for u in range(arr.shape[0]):
            for j in range(arr.shape[1]):
                yield f"units.{u}.{j}.{rest}", arr[u, j]
    elif head == "units":
        part, _, leaf = rest.partition(".")
        for u in range(arr.shape[0]):
            if part == "local":                # (units, R, ...)
                for j in range(arr.shape[1]):
                    yield f"units.{u}.local.{j}.{leaf}", arr[u, j]
            else:                              # global: (units, ...)
                yield f"units.{u}.{part}.{leaf}", arr[u]
    else:
        yield name, arr


def from_jax_params(tree: Mapping[str, Any], cfg: ArchConfig,
                    device=None) -> DecoderLM:
    """The port's model computing the same function as a reference tree.

    ``tree`` is the reference's ``init_params`` pytree as nested dicts of
    numpy arrays, with ``blocks``/``tail`` stacked on a leading layer axis
    and ``units`` on a unit axis (and, inside a unit, a layer axis for the
    local and Mamba2 stacks). Weights keep their layout (``Linear.w`` is
    ``(d_in, d_out)`` in both packages), so loading unstacks the layers and
    renames nothing. The model lands on ``device`` (default the card;
    raises without CUDA).
    """
    dev = _resolve_device(device)
    with torch.device("meta"):
        model = DecoderLM(cfg)
    model.load_state_dict(_state_from_jax(tree, cfg), strict=True,
                          assign=True)
    return model.to(dev)


def _state_from_jax(tree: Mapping[str, Any],
                    cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """A reference tree as ``state_dict`` names → tensors."""
    hybrid = _schedule(cfg)[0] == "hybrid"
    return {key: torch.tensor(val)
            for name, arr in _flatten(tree)
            for key, val in _unstack(name, arr, hybrid)}


def from_jax_opt_state(state: Mapping[str, Any], cfg: ArchConfig,
                       device=None) -> Dict[str, Any]:
    """The reference's AdamW state (``{"step", "m", "v"}``, the moments
    shaped as the parameter tree, as numpy) as the port's: ``step`` an
    int32 scalar and the moments keyed by ``state_dict`` name, as
    ``optim.adamw_init`` lays them out for ``dict(model.named_parameters())``
    (the shared block of the hybrid schedule once). On ``device`` (default
    the card; raises without CUDA)."""
    dev = _resolve_device(device)
    return {"step": torch.tensor(np.asarray(state["step"]),  # squash: ignore[device-sync] -- a one-time conversion of the reference's optimizer state onto the card
                                 dtype=torch.int32, device=dev),
            **{part: {k: v.to(dev) for k, v in
                      _state_from_jax(state[part], cfg).items()}
               for part in ("m", "v")}}
