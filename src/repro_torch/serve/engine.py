"""Batched serving engine: prefill + greedy/sampled decode over any
architecture (the port of ``repro.serve.engine``).

Prefill is one full-sequence pass that builds each request's decode cache
(for Mamba2 blocks, through the SSD intra-chunk kernel once per layer);
decode then runs one token per step against the resident caches. The
engine runs on the CUDA card unless the caller names another device.

Optional OSQ-quantized KV cache (``kv_bits``): the paper's segment-packed
scalar quantization applied to the KV tensors — per-(head, channel)
ranges, ``kv_bits``-bit codes packed ``32 // kv_bits`` to a 32-bit word.
As in the reference, the caches are quantized and dequantized once after
prefill, so decode reads what the packed cache holds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve.kv_quant import (cache_bytes, dequantize_caches,
                                        quantize_caches)

__all__ = ["ServeConfig", "Engine", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 → greedy
    kv_bits: int = 0                  # 0 → fp cache; 8/4 → OSQ-packed cache
    seed: int = 0


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; raises when the
    device is CUDA and CUDA is not available. The port's model, serving and
    training entry points all resolve their device here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the port runs on the CUDA card by default "
                               "and CUDA is not available; pass device='cpu' "
                               "to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Engine:
    """Holds one model and its serving settings.

    ``last_timing`` holds the host-clock seconds of the last
    :meth:`generate`'s prefill (up to its first token on the host, the KV
    quantization included) and decode steps; ``last_cache_bytes`` the bytes
    of its caches after prefill (``fp``) and packed (``packed``, None
    without ``kv_bits``).
    """

    def __init__(self, cfg: ArchConfig, model: DecoderLM,
                 serve_cfg: Optional[ServeConfig] = None, *, device=None):
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        bits = self.serve_cfg.kv_bits
        if bits < 0 or (bits and 32 % bits):
            raise ValueError(f"kv_bits must be 0 (fp cache) or divide 32, "
                             f"got {bits}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device} and the engine "
                             f"runs on {self.device}: move it with "
                             f"model.to({str(self.device)!r})")
        self.model = model
        self.last_timing = None
        self.last_cache_bytes = None

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        """(..., V) logits → (...) ids."""
        sc = self.serve_cfg
        if sc.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / sc.temperature, dim=-1)
        flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=gen)
        return flat.reshape(probs.shape[:-1])

    def generate(self, prompts: np.ndarray, *, max_new_tokens: int = 0,
                 embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (B, S) int token ids ((B, K, S) for audio) → generated
        ids (B, n_new) ((B, K, n_new) for audio) int32. ``embeds``: the
        VLM's (B, vlm_num_patches, d_model) patch embeddings.

        The buffers hold ``prefix + S + n_new`` slots, ``prefix`` the VLM's
        ``vlm_num_patches``, and decode step i runs at position
        ``prefix + S + i`` — with or without ``embeds``, as the reference
        does (without them the slots between the prompt and the prefix's
        end stay zero and count as attended keys).

        ``temperature > 0`` samples from a ``torch.Generator`` seeded with
        ``ServeConfig.seed``; its numbers differ from ``jax.random``'s.
        """
        cfg, sc = self.cfg, self.serve_cfg
        n_new = max_new_tokens or sc.max_new_tokens
        audio = bool(cfg.num_codebooks)
        s0 = prompts.shape[-1]
        prefix = cfg.vlm_num_patches if cfg.mrope else 0
        gen = None
        if sc.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(sc.seed)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,  # squash: ignore[device-sync] -- the prompts' one upload to the card per generate call
                                 device=self.device)
        emb = (None if embeds is None else torch.as_tensor(  # squash: ignore[device-sync] -- the patch embeddings' one upload to the card per generate call
            np.asarray(embeds), dtype=torch.float32, device=self.device))
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(
            tokens, buf_len=prefix + s0 + n_new, embeds=emb)
        sizes = {"fp": cache_bytes(caches), "packed": None}
        if sc.kv_bits:
            qc, meta = quantize_caches(caches, sc.kv_bits)
            sizes["packed"] = cache_bytes(qc)
            del caches          # frees the fp cache before its unpacked copy
            caches = dequantize_caches(qc, meta)
            del qc, meta
        tok = self._sample(logits[:, 0], gen)            # (B,) or (B, K)
        outs = [tok.cpu()]  # squash: ignore[device-sync] -- the sampled token's copy to the host is the output; it waits for the prefill
        t1 = time.perf_counter()
        for i in range(n_new - 1):
            step_tok = tok[:, :, None] if audio else tok[:, None]
            logits, caches = self.model.decode_step(step_tok, caches,
                                                    prefix + s0 + i)
            tok = self._sample(logits[:, 0], gen)
            outs.append(tok.cpu())  # squash: ignore[device-sync] -- the sampled token's copy to the host is the output; it waits for the step
        t2 = time.perf_counter()
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                            "decode_steps": n_new - 1}
        self.last_cache_bytes = sizes
        return torch.stack(outs, dim=-1).numpy().astype(np.int32)  # squash: ignore[device-sync] -- no sync: `outs` holds tensors already copied to the host, which a syntactic rule cannot tell from card tensors
