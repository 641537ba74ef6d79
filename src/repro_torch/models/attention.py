"""Attention blocks: GQA/MQA (+ sliding window, M-RoPE) and MLA (DeepSeek-V2).

The port of ``repro.models.attention``. Three modes per variant:
  * ``forward`` — full-sequence causal, no cache (``gqa_train`` /
    ``mla_train``: training, differentiable).
  * ``prefill`` — full-sequence causal, returns the populated KV cache.
  * ``decode``  — one new token against a cache (ring buffer for windowed
    layers, full buffer otherwise), written into the caller's cache in
    place (the reference returns an updated copy).

Full-sequence attention is **query-chunked** (a loop over blocks of ``Q_CHUNK``
queries) so the (S × S) score matrix never materializes — peak scores are
(chunk × S): llama3-8b's prefill at 8 × 2,048 tokens would otherwise hold
(8, 32, 2,048, 2,048) f32 = 4.3 GB per layer. Decode for MLA uses the
*absorbed* form (q projected into the latent space), so per-step work is
O(S · kv_lora) and per-head keys never materialize.

GQA attention runs at the reference's precision whatever the weights'
dtype: q·k scores, the softmax and the p·v sums in f32 (f64 stays f64),
the probabilities rounded to v's dtype before their product with v, and
the output cast back to v's dtype at the end — what the reference's
``preferred_element_type=jnp.float32`` products on bf16 operands compute.
The operands are widened exactly before each product (a bf16 value is an
f32 value), so an f32 model's products are what they were. Masked scores
take the reference's ``-1e9`` fill (not ``-inf``: a row with no valid key,
a pad query, stays a uniform average as in the reference). MLA's absorbed
decode is all f32, as the reference's.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.hints import (along, hint_local, is_sharded,
                                      merge_heads, mesh_sizes, pad_dim,
                                      split_heads)

__all__ = ["GQA", "MLA", "init_gqa_cache", "init_mla_cache"]

_NEG = -1e9
Q_CHUNK = 512


# ---------------------------------------------------------------- core attend

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
            q_chunk: int = 0) -> torch.Tensor:
    """Chunked masked attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); q_pos: (B, Sq); k_pos: (B, Sk).
    Causal + optional sliding window; k_pos < 0 marks invalid slots and
    q_pos < 0 pad rows. Returns (B, Sq, H, vd).

    On DTensors each rank attends its own block, with batch over ``data``.
    Where ``model`` divides the kv heads, they (with their query groups) lie
    over it; else, where it divides the query heads (llama3-8b's 32 over a
    model axis of 16, with 8 kv heads), the query heads lie over it and
    each rank picks the kv heads its own query heads read from whole k/v,
    as GSPMD shards the reference's query heads; else (gemma3-4b's 8 heads
    over 16) the queries lie over it along the sequence, against whole k/v
    (the reference pads kv heads up to the axis, or leaves the choice to
    GSPMD). Either way no rank repeats another's work, but where no dim
    divides (a decode step's one query). A rank's k and v gradients are
    then partial sums over its own queries. DTensor's einsum would flatten
    a sharded head dim into its batched product, which torch 2.11 refuses.
    """
    if not is_sharded(q):
        return _attend_local(q, k, v, q_pos, k_pos, window=window,
                             q_chunk=q_chunk)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.shardings import fitted_placements

    mesh = q.device_mesh
    m = mesh_sizes(q).get("model", 1)
    h, kv = q.shape[2], k.shape[2]
    by_heads = kv % m == 0 or h % m == 0
    q_heads = "model" if by_heads else None
    q_rows = None if by_heads else "model"
    kv_heads = "model" if kv % m == 0 else None

    def placed(t, spec):
        return fitted_placements(spec, t.shape, mesh)

    def as_dtensor(t):
        return t if is_sharded(t) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    qp = placed(q, ("data", q_rows, q_heads, None))
    kp = placed(k, ("data", None, kv_heads, None))
    fn = functools.partial(_attend_local, window=window, q_chunk=q_chunk)
    if q_heads and not kv_heads:
        fn = functools.partial(_attend_own_heads, fn,
                               mesh.get_local_rank("model"), h // kv)
    kv_grad = [Partial() if c.is_replicate() and a.is_shard() else c
               for c, a in zip(kp, qp)]
    pos = (placed(q_pos, ("data", q_rows)), placed(k_pos, ("data", None)))
    return local_map(
        fn, out_placements=qp, in_placements=(qp, kp, kp, *pos),
        in_grad_placements=(qp, kv_grad, kv_grad, *pos),
        device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, as_dtensor(q_pos), as_dtensor(k_pos))


def _attend_own_heads(attend, rank: int, group: int, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor) -> torch.Tensor:
    """``attend`` on this rank's block of query heads (the ``rank``-th of
    ``q.shape[2]`` heads each, ``group`` query heads a kv head) against the
    kv heads they read, picked from whole k and v: one kv head a query
    head."""
    hl = q.shape[2]
    idx = torch.arange(rank * hl, (rank + 1) * hl, device=k.device) // group
    return attend(q, k.index_select(2, idx), v.index_select(2, idx),
                  q_pos, k_pos)


def _attend_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, *, window: int,
                  q_chunk: int) -> torch.Tensor:
    """:func:`_attend` on plain tensors."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    vd = v.shape[-1]
    g = h // kv
    scale = hd ** -0.5
    acc = _accum_dtype(q, k, v)
    qc = min(q_chunk or Q_CHUNK, sq)
    pad = (-sq) % qc
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    nq = q.shape[1] // qc
    qs = q.reshape(b, nq, qc, kv, g, hd)
    qps = q_pos.reshape(b, nq, qc)
    kp = k_pos[:, None, :]
    kf, vf = k.to(acc), v.to(acc)
    outs = []
    for i in range(nq):
        qp = qps[:, i, :, None]                               # (B, qc, 1)
        s = torch.einsum("bqkgh,bskh->bkgqs", qs[:, i].to(acc), kf) * scale
        mask = (kp <= qp) & (kp >= 0)
        if window:
            mask &= kp > (qp - window)
        mask &= qp >= 0
        s = torch.where(mask[:, None, None, :, :], s, _NEG)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh",
                                 p.to(v.dtype).to(acc), vf))
    out = torch.stack(outs, dim=1).reshape(b, nq * qc, h, vd)
    return out[:, :sq].to(v.dtype)


def _accum_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The dtype attention's products and softmax run in: the operands'
    widest, and at least f32."""
    acc = torch.float32
    for t in ts:
        acc = torch.promote_types(acc, t.dtype)
    return acc


def _decode_positions(b: int, pos: int, device) -> torch.Tensor:
    return torch.full((b, 1), pos, dtype=torch.int32, device=device)


def _update_slot(buf: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``buf[:, slot] = new[:, 0]`` with ``dynamic_update_slice``'s clamp of
    the start index into the buffer. A sharded cache is written in its
    local shards: each rank writes the slot into the shard that holds it
    (the buffer axis lies over ``model`` in the ``seq`` profile), with
    ``new`` placed as the cache."""
    slot = min(max(slot, 0), buf.shape[1] - 1)
    new = new[:, 0].to(buf.dtype)
    if not is_sharded(buf):
        buf[:, slot] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    # new lacks the buffer axis (dim 1): the dims after it move down one.
    placements = [Replicate() if p.is_shard(1) else
                  Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p
                  for p in buf.placements]
    new = hint_local(new, mesh, placements)
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    i = slot - offset[1]
    if 0 <= i < shape[1]:
        buf.to_local()[:, i] = new


# ----------------------------------------------------------------------- GQA

def init_gqa_cache(cfg: ArchConfig, batch: int, buf_len: int,
                   device=None, dtype=None) -> Dict[str, torch.Tensor]:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, buf_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class GQA(nn.Module):
    """Grouped-query attention (MQA at one kv head), RoPE or M-RoPE."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = L.Linear(d, h * hd)
        self.wk = L.Linear(d, kv * hd)
        self.wv = L.Linear(d, kv * hd)
        self.wo = L.Linear(h * hd, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset_parameters(generator)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor,
             positions_3d: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q = split_heads(self.wq(x), h, hd)
        k = split_heads(self.wk(x), kv, hd)
        v = split_heads(self.wv(x), kv, hd)
        if cfg.mrope and positions_3d is not None:
            q = L.apply_mrope(q, positions_3d, cfg.rope_theta)
            k = L.apply_mrope(k, positions_3d, cfg.rope_theta)
        else:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _full(self, x: torch.Tensor, positions: torch.Tensor, window: int,
              positions_3d: Optional[torch.Tensor]):
        """Full-sequence attention → (y, k, v)."""
        q, k, v = self._qkv(x, positions, positions_3d)
        out = _attend(q, k, v, positions, positions, window)
        return self.wo(merge_heads(out)), k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0,
                positions_3d: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention, no cache (the reference's
        ``gqa_train``)."""
        return self._full(x, positions, window, positions_3d)[0]

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, buf_len: int,
                window: int = 0, positions_3d: Optional[torch.Tensor] = None):
        """Full-seq attention + cache population. Returns (y, cache)."""
        s = x.shape[1]
        y, k, v = self._full(x, positions, window, positions_3d)
        if buf_len >= s:
            ck = pad_dim(k, 1, 0, buf_len - s)
            cv = pad_dim(v, 1, 0, buf_len - s)
        else:  # ring buffer keeps the trailing ``buf_len`` positions
            roll = s % buf_len
            ck, cv = (along(lambda t: torch.roll(t[:, s - buf_len:], roll,
                                                dims=1), t, 1)
                      for t in (k, v))
        return y, {"k": ck.to(x.dtype), "v": cv.to(x.dtype)}

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, window: int = 0) -> torch.Tensor:
        """One-token step at absolute position ``pos``; writes the token's
        k/v into ``cache`` in place.

        Full buffers place the token at slot ``pos``; windowed (ring)
        buffers at ``pos % buf_len`` with slot → position recovered
        arithmetically. Rotates with 1-D RoPE, M-RoPE configs too (text
        positions carry t = h = w).
        """
        cfg = self.cfg
        b = x.shape[0]
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        buf = cache["k"].shape[1]
        posv = _decode_positions(b, pos, x.device)
        q = L.apply_rope(split_heads(self.wq(x), h, hd), posv, cfg.rope_theta)
        k = L.apply_rope(split_heads(self.wk(x), kv, hd), posv,
                         cfg.rope_theta)
        v = split_heads(self.wv(x), kv, hd)
        slot = pos % buf if window else pos
        _update_slot(cache["k"], slot, k)
        _update_slot(cache["v"], slot, v)
        idx = torch.arange(buf, device=x.device)
        if window:
            # slot i holds absolute position pos − ((pos − i) mod buf).
            k_pos = pos - torch.remainder(pos - idx, buf)
        else:
            k_pos = torch.where(idx <= pos, idx, -1)
        k_pos = k_pos[None, :].expand(b, buf).to(torch.int32)
        out = _attend(q, cache["k"], cache["v"], posv, k_pos, window,
                      q_chunk=1)
        return self.wo(merge_heads(out))


# ----------------------------------------------------------------------- MLA

def init_mla_cache(cfg: ArchConfig, batch: int, buf_len: int,
                   device=None, dtype=None) -> Dict[str, torch.Tensor]:
    return {
        "latent": torch.zeros((batch, buf_len, cfg.kv_lora_rank),
                              dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, buf_len, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
    }


class MLA(nn.Module):
    """Multi-head latent attention: keys and values through a ``kv_lora``
    latent, with one RoPE key part shared by the heads."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.num_heads
        nope, rope, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                                cfg.v_head_dim, cfg.kv_lora_rank)
        self.wq = L.Linear(d, h * (nope + rope))
        self.w_dkv = L.Linear(d, lora + rope)    # latent + shared k_rope
        self.w_uk = L.Linear(lora, h * nope)
        self.w_uv = L.Linear(lora, h * vd)
        self.wo = L.Linear(h * vd, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.wq, self.w_dkv, self.w_uk, self.w_uv, self.wo):
            lin.reset_parameters(generator)

    def _qkv_full(self, x: torch.Tensor, positions: torch.Tensor):
        """Materialized (prefill) form: per-head k, v built from the latent."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = cfg.num_heads
        nope, rope, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                                cfg.v_head_dim, cfg.kv_lora_rank)
        q = split_heads(self.wq(x), h, nope + rope)
        q_nope = q[..., :nope]
        q_rope = L.apply_rope(q[..., nope:], positions, cfg.rope_theta)
        dkv = self.w_dkv(x)                                   # (B,S,lora+rope)
        latent = dkv[..., :lora]
        k_rope = L.apply_rope(dkv[..., lora:][:, :, None, :], positions,
                              cfg.rope_theta)
        k_nope = split_heads(self.w_uk(latent), h, nope)
        v = split_heads(self.w_uv(latent), h, vd)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
        return q_full, k_full, v, latent, k_rope[:, :, 0, :]

    def _full(self, x: torch.Tensor, positions: torch.Tensor, window: int):
        """Full-sequence attention → (y, latent, k_rope)."""
        q, k, v, latent, k_rope = self._qkv_full(x, positions)
        out = _attend(q, k, v, positions, positions, window)
        return self.wo(merge_heads(out)), latent, k_rope

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0) -> torch.Tensor:
        """Full-sequence attention, no cache (the reference's
        ``mla_train``)."""
        return self._full(x, positions, window)[0]

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, buf_len: int,
                window: int = 0):
        y, latent, k_rope = self._full(x, positions, window)
        pad = buf_len - x.shape[1]
        return y, {"latent": pad_dim(latent, 1, 0, pad).to(x.dtype),
                   "k_rope": pad_dim(k_rope, 1, 0, pad).to(x.dtype)}

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, window: int = 0) -> torch.Tensor:
        """Absorbed-MLA decode: scores and context live in the kv_lora
        latent space; writes the token's latent and k_rope into ``cache``.

        score_h(t) = q_nope_h · (W_uk latent_t)  +  q_rope_h · k_rope_t
                   = (W_uk^T q_nope_h) · latent_t + q_rope_h · k_rope_t
        ctx_h      = Σ_t p_t latent_t  →  out_h = W_uv ctx_h
        """
        cfg = self.cfg
        b = x.shape[0]
        h = cfg.num_heads
        nope, rope, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                                cfg.v_head_dim, cfg.kv_lora_rank)
        buf = cache["latent"].shape[1]
        posv = _decode_positions(b, pos, x.device)
        q = split_heads(self.wq(x), h, nope + rope)
        q_nope = q[..., :nope]
        q_rope = L.apply_rope(q[..., nope:], posv, cfg.rope_theta)
        dkv = self.w_dkv(x)
        k_rope_new = L.apply_rope(dkv[..., lora:][:, :, None, :], posv,
                                  cfg.rope_theta)
        _update_slot(cache["latent"], pos, dkv[..., :lora])
        _update_slot(cache["k_rope"], pos, k_rope_new[:, :, 0, :])
        c_lat = cache["latent"].to(torch.float32)
        c_kr = cache["k_rope"].to(torch.float32)
        # Absorb W_uk into the query.
        w_uk = self.w_uk.w.reshape(lora, h, nope).to(torch.float32)
        q_lat = torch.einsum("bqhn,lhn->bhql", q_nope.to(torch.float32),
                             w_uk)                            # (B,h,1,lora)
        s_lat = torch.einsum("bhql,bsl->bhqs", q_lat, c_lat)
        s_rope = torch.einsum("bqhr,bsr->bhqs", q_rope.to(torch.float32),
                              c_kr)
        s = (s_lat + s_rope) * (nope + rope) ** -0.5
        idx = torch.arange(buf, device=x.device)
        mask = idx <= pos
        if window:
            mask &= idx > (pos - window)
        s = torch.where(mask[None, None, None, :], s, _NEG)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhqs,bsl->bhql", p, c_lat)
        w_uv = self.w_uv.w.reshape(lora, h, vd).to(torch.float32)
        out = torch.einsum("bhql,lhv->bqhv", ctx, w_uv)
        return self.wo(merge_heads(out).to(x.dtype))
