"""Batched serving engine: prefill + greedy/sampled decode (the port of
``repro.serve.engine``).

Prefill is one full-sequence pass that builds each request's decode cache
(for Mamba2, through the SSD intra-chunk kernel once per layer); decode then
runs one token per step against the resident caches. The engine runs on the
CUDA card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM

__all__ = ["ServeConfig", "Engine", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 → greedy
    kv_bits: int = 0                  # 0 → fp cache (OSQ-packed: not ported)
    seed: int = 0


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; raises when the
    device is CUDA and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the engine runs on the CUDA card by default "
                               "and CUDA is not available; pass device='cpu' "
                               "to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Engine:
    """Holds one model and its serving settings.

    ``last_timing`` holds the host-clock seconds of the last
    :meth:`generate`'s prefill (up to its first token on the host) and
    decode steps.
    """

    def __init__(self, cfg: ArchConfig, model: DecoderLM,
                 serve_cfg: Optional[ServeConfig] = None, *, device=None):
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        if self.serve_cfg.kv_bits:
            raise NotImplementedError(
                "kv_bits: the OSQ-quantized KV cache (serve/kv_quant.py) is "
                "not ported yet (ROADMAP.md)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device} and the engine "
                             f"runs on {self.device}: move it with "
                             f"model.to({str(self.device)!r})")
        self.model = model
        self.last_timing = None

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        sc = self.serve_cfg
        if sc.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(self, prompts: np.ndarray, *,
                 max_new_tokens: int = 0) -> np.ndarray:
        """prompts: (B, S) int token ids → generated ids (B, n_new) int32.

        ``temperature > 0`` samples from a ``torch.Generator`` seeded with
        ``ServeConfig.seed``; its numbers differ from ``jax.random``'s.
        """
        n_new = max_new_tokens or self.serve_cfg.max_new_tokens
        gen = None
        if self.serve_cfg.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.serve_cfg.seed)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(tokens)
        tok = self._sample(logits[:, 0], gen)
        outs = [tok.cpu()]                   # waits for the prefill
        t1 = time.perf_counter()
        for _ in range(n_new - 1):
            logits, caches = self.model.decode_step(tok[:, None], caches)
            tok = self._sample(logits[:, 0], gen)
            outs.append(tok.cpu())
        t2 = time.perf_counter()
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                            "decode_steps": n_new - 1}
        return torch.stack(outs, dim=-1).numpy().astype(np.int32)
