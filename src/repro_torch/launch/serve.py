"""Serving launcher: batched generation through the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --requests 8 --prompt-len 2048 --new-tokens 32 [--kv-bits 8]

Any registered config (``--reduced`` for its smoke size). Builds the model
with random weights drawn from a seeded generator on the serving device,
runs the batched requests through prefill + greedy (or sampled) decode on
the CUDA card — or on the CPU with ``--device cpu`` — optionally with the
OSQ-packed KV cache, and reports prefill time, decode time per token,
tokens/s and the bytes of the KV cache (fp, and packed). Audio configs get
(B, K, S) prompts; the VLM gets random patch embeddings.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import resolve_device

__all__ = ["serve", "main"]


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, requests: int = 8, prompt_len: int = 32,
          new_tokens: int = 16, kv_bits: int = 0, temperature: float = 0.0,
          reduced: bool = False, device="cuda", seed: int = 0) -> dict:
    """Generate for ``requests`` random prompts; returns the report.

    The weights and the prompts come from ``seed``. Times are host-clock
    seconds around work that ends with the tokens on the host; ``init_s``
    is the weight draw.
    """
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=seed, device=dev)
    _synchronize(dev)
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, model, ServeConfig(
        max_new_tokens=new_tokens, kv_bits=kv_bits, temperature=temperature,
        seed=seed), device=dev)
    rng = np.random.default_rng(seed)
    shape = ((requests, cfg.num_codebooks, prompt_len) if cfg.num_codebooks
             else (requests, prompt_len))
    prompts = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
    embeds = (rng.normal(size=(requests, cfg.vlm_num_patches,
                               cfg.d_model)).astype(np.float32)
              if cfg.mrope else None)
    _synchronize(dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts, embeds=embeds)
    wall = time.perf_counter() - t0
    timing = eng.last_timing
    return {
        "arch": cfg.name, "device": str(dev), "requests": requests,
        "prompt_len": prompt_len, "new_tokens": new_tokens,
        "kv_bits": kv_bits, "init_s": init_s,
        "prefill_ms": timing["prefill_s"] * 1e3,
        "decode_ms_per_token": (timing["decode_s"] * 1e3
                                / max(timing["decode_steps"], 1)),
        "wall_s": wall, "tokens_per_s": out.size / wall,
        "cache_bytes_fp": eng.last_cache_bytes["fp"],
        "cache_bytes_packed": eng.last_cache_bytes["packed"],
        "tokens": out,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--kv-bits", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rep = serve(args.arch, requests=args.requests, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, kv_bits=args.kv_bits,
                temperature=args.temperature, reduced=args.reduced,
                device=args.device)
    out = rep["tokens"]
    print(f"[serve] {rep['arch']} on {rep['device']}: {args.requests} "
          f"requests × {args.prompt_len} prompt + {args.new_tokens} new tokens "
          f"in {rep['wall_s']:.2f}s (prefill {rep['prefill_ms']:.1f} ms, "
          f"decode {rep['decode_ms_per_token']:.2f} ms/token, "
          f"{rep['tokens_per_s']:.0f} tok/s, kv_bits="
          f"{args.kv_bits or 'fp'})")
    packed = rep["cache_bytes_packed"]
    print(f"[serve] KV cache: {rep['cache_bytes_fp']} bytes fp"
          + ("" if packed is None else f", {packed} bytes packed"))
    print(f"[serve] sample continuation: "
          f"{out.reshape(out.shape[0], -1)[0][:12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
