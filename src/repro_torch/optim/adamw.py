"""AdamW with decoupled weight decay over a model's named parameters (the
port of ``repro.optim.adamw``).

Parameters, gradients and the moments are flat ``{name: tensor}`` maps
(``dict(model.named_parameters())``); :func:`adamw_update` writes the new
parameters and moments in place, under ``torch.no_grad()``, where the
reference returns new trees. The formulas are the reference's, term for
term: the global-norm clip scales by ``min(1, max_norm / max(norm, 1e-12))``
(not ``torch.nn.utils.clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``),
the bias corrections are float32 powers of an int32 step, and the update
is ``p - lr·(m̂/(√v̂ + eps) + wd·p)`` in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16 for memory-bound giants


def adamw_init(params: Mapping[str, torch.Tensor],
               cfg: AdamWConfig) -> Dict:
    """``{"step": int32 0, "m": zeros, "v": zeros}`` on the parameters'
    device, the moments in ``cfg.state_dtype`` (placed as their parameters
    where those are DTensors; ``launch.shardings.shard_opt_state`` places
    ``step``)."""
    device = next(iter(params.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.state_dtype,
                                       requires_grad=False)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over leaves of Σ g²), in float32, leaves summed in order."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict,
                 cfg: AdamWConfig,
                 lr_schedule: Optional[Callable] = None
                 ) -> Dict[str, torch.Tensor]:
    """One AdamW step: ``params`` and ``state`` are updated in place (every
    parameter needs a gradient). Returns ``{"grad_norm", "lr"}``, float32
    tensors (the norm before clipping)."""
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state["step"] + 1
    lr = cfg.lr if lr_schedule is None else lr_schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        gf = grads[name].to(torch.float32)
        mf = b1 * m.to(torch.float32) + (1 - b1) * gf
        vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        delta = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        p.copy_(pf)
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return {"grad_norm": gnorm,
            "lr": torch.as_tensor(lr, dtype=torch.float32,
                                  device=step.device)}
