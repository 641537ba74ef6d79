"""Training step: loss → grads → clip → AdamW, with gradient accumulation
(the port of ``repro.train.steps``).

``make_train_step(cfg)`` closes over the architecture and returns a function
``(model, opt_state, batch) -> metrics`` that updates the model's
parameters and ``opt_state`` in place (the reference returns new trees).

Batch layout (tensors on the model's device):
  text / ssm / moe : {"tokens": (B, S+1) int}
  audio            : {"tokens": (B, K, S+1) int}
  vlm              : {"tokens": (B, S+1) int, "embeds": (B, P, d) f32}
                     (the loss skips the P patch-prefix positions)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.hints import hint_batch, is_sharded, sharded_scope
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import AdamWConfig, adamw_update

__all__ = ["loss_fn", "make_train_step"]


def loss_fn(model: DecoderLM, batch: Dict[str, Any], cfg: ArchConfig, *,
            remat: bool = True):
    """Scalar LM loss (mean token CE + router aux) → (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    if cfg.num_codebooks:
        inputs, labels = tokens[:, :, :-1], tokens[:, :, 1:]
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, aux = model.forward_train(inputs, embeds=embeds, remat=remat)
    if cfg.num_codebooks:
        # (B, S, K, V) vs labels (B, K, S): mean CE over codebooks.
        ce = L.cross_entropy_loss(logits.movedim(2, 1), labels)
    elif cfg.mrope:
        # Drop the patch-prefix positions; predict text only.
        ce = L.cross_entropy_loss(logits[:, cfg.vlm_num_patches:], labels)
    else:
        ce = L.cross_entropy_loss(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    lr_schedule: Optional[Callable] = None, *,
                    accum_steps: int = 1, remat: bool = True):
    """Build the train step. With ``accum_steps > 1`` the batch's leading
    dim must be divisible by it: the micro-batches run one after another,
    each with its own backward, and the gradients are averaged.

    The step leaves the averaged gradients (before clipping) in each
    parameter's ``.grad``, and returns ``{"loss", "ce", "aux",
    "grad_norm", "lr"}`` as float32 scalars on the model's device. A
    parameter the loss does not reach (the audio configs' ``lm_head``)
    gets a zero gradient, as ``jax.grad`` gives it, so weight decay still
    moves it.

    A model that ``launch.shardings.shard_model`` sharded trains the same
    way, on a batch from ``shard_batch`` and a state from
    ``shard_opt_state``: each gradient is placed as its parameter before
    the clip and the update.
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(model: DecoderLM, opt_state: Dict,
                   batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with sharded_scope(model.final_norm.scale):
            return step(model, opt_state, batch)

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum_steps == 1:
            loss, parts = loss_fn(model, batch, cfg, remat=remat)
            loss.backward()
        else:
            micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
            lsum = asum = 0.0
            for i in range(accum_steps):
                # (a sharded micro-batch is placed anew as a batch)
                mb = {k: hint_batch(v[i]) for k, v in micro.items()}
                l, pp = loss_fn(model, mb, cfg, remat=remat)
                l.backward()
                lsum = lsum + l.detach()
                asum = asum + pp["aux"].detach()
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            loss = lsum / accum_steps
            parts = {"ce": loss - asum / accum_steps,
                     "aux": asum / accum_steps}
        for p in params.values():
            if p.grad is not None:
                p.grad = _placed_like(p, p.grad)
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        om = adamw_update(params, grads, opt_state, opt_cfg, lr_schedule)
        return {k: _whole(v.detach()) for k, v in
                {"loss": loss, **parts, **om}.items()}

    return train_step


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor: a DTensor's partial sums reduced (its
    ``item()`` would read this rank's part)."""
    return x.full_tensor() if is_sharded(x) else x


def _placed_like(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A sharded parameter's gradient placed as the parameter (it comes back
    as the computation left it: partial sums, other shards), so that the
    clip's norm reduces over every shard once and the update runs on each
    rank's own shard."""
    if is_sharded(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g
