"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --steps 6 --batch 16 --seq 4096 --accum 2 [--ckpt DIR]

Any registered config (``--reduced`` for its 2-layer smoke size). Draws the
model's weights from ``--seed`` on the training device — the CUDA card
unless ``--device cpu`` — and trains it with AdamW under a cosine schedule
(warmup a tenth of the steps) on the synthetic token stream
``data.synthetic.token_batch``, seeded by the step's index as in the
reference. Reports the first step's seconds (kernel builds included), the
median of the later steps, tokens/s, peak device memory, the loss, grad
norm and lr of every step, and the SSD intra-chunk kernel's launches per
step; ``--ckpt`` writes the parameters and optimizer state at the end.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.data.synthetic import token_batch
from repro_torch.kernels import ops
from repro_torch.launch import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.serve.engine import resolve_device
from repro_torch.train import make_train_step

__all__ = ["train", "make_batch", "main"]


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batch(cfg: ArchConfig, batch: int, seq: int, step: int,
               device) -> dict:
    """The reference launcher's batch of step ``step``: (B, S+1) tokens
    ((B, K, S+1), the same stream in every codebook, for audio), and zero
    patch embeddings for the VLM."""
    toks = token_batch(batch, seq + 1, cfg.vocab_size, seed=step)
    if cfg.num_codebooks:
        toks = np.broadcast_to(toks[:, None, :], (batch, cfg.num_codebooks,
                                                  seq + 1)).copy()
    out = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.mrope:
        out["embeds"] = torch.zeros((batch, cfg.vlm_num_patches, cfg.d_model),
                                    device=device)
    return out


def train(arch: str, *, steps: int = 20, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, accum: int = 1, reduced: bool = False,
          ckpt: Optional[str] = None, device="cuda", seed: int = 0,
          log=None, mesh=None) -> dict:
    """Train ``arch`` for ``steps`` steps; returns the report.

    Times are host-clock seconds around steps that end with a synchronize
    of the device. The report also holds the trained ``model`` and its
    ``opt_state`` (not numbers: a caller that prints the report pops
    them). ``log(i, metrics)`` is called after each step. With ``mesh`` (a
    ("data", "model") ``DeviceMesh`` of the default process group on
    ``device``'s type), the model, its optimizer state and every batch are
    sharded by ``launch.shardings`` and the steps run on DTensors.
    """
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=seed, device=dev)
    _synchronize(dev)
    init_s = time.perf_counter() - t0
    if mesh is not None:
        SH.shard_model(model, mesh)
    opt_cfg = AdamWConfig(lr=lr)
    params = dict(model.named_parameters())
    state = adamw_init(params, opt_cfg)
    if mesh is not None:
        state = SH.shard_opt_state(state, model, mesh)
    sched = cosine_schedule(lr, warmup=max(steps // 10, 1), total=steps)
    step = make_train_step(cfg, opt_cfg, sched, accum_steps=accum)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rows, step_s, launches = [], [], []
    for i in range(steps):
        b = make_batch(cfg, batch, seq, i, dev)
        if mesh is not None:
            b = SH.shard_batch(b, mesh)
        before = ops.launch_counts()["ssd_intra"]
        _synchronize(dev)
        t0 = time.perf_counter()
        m = step(model, state, b)
        _synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        launches.append(ops.launch_counts()["ssd_intra"] - before)
        rows.append({k: float(v) for k, v in m.items()})
        if log is not None:
            log(i, rows[-1])
    steady = step_s[1:] or step_s
    rep = {
        "arch": cfg.name, "device": str(dev),
        "params": sum(p.numel() for p in params.values()),
        "mesh": None if mesh is None else SH.mesh_axes(mesh),
        "steps": steps, "batch": batch, "seq": seq, "accum": accum,
        "init_s": init_s, "first_step_s": step_s[0],
        "steady_step_ms": statistics.median(steady) * 1e3,
        "tokens_per_s": batch * seq / statistics.median(steady),
        "peak_device_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
        "loss": [r["loss"] for r in rows],
        "ce": [r["ce"] for r in rows],
        "grad_norm": [r["grad_norm"] for r in rows],
        "lr": [r["lr"] for r in rows],
        "ssd_intra_launches_per_step": launches,
        "model": model, "opt_state": state,
    }
    if ckpt:
        rep["ckpt_path"] = save_pytree(
            {"params": model.state_dict(), "opt": state}, ckpt,
            name=cfg.name)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke variant")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    every = max(args.steps // 10, 1)

    def log(i, m):
        if i % every == 0 or i == args.steps - 1:
            print(f"  step {i:5d} loss {m['loss']:.4f} "
                  f"|g| {m['grad_norm']:.2f} lr {m['lr']:.2e}", flush=True)

    rep = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, accum=args.accum, reduced=args.reduced,
                ckpt=args.ckpt, device=args.device, seed=args.seed, log=log)
    print(f"[train] {rep['arch']} on {rep['device']}: "
          f"{rep['params'] / 1e6:.1f}M params, {args.steps} steps of "
          f"{args.batch} × {args.seq} tokens (accum {args.accum}): first "
          f"{rep['first_step_s']:.2f}s, then {rep['steady_step_ms']:.1f} "
          f"ms/step, {rep['tokens_per_s']:.0f} tok/s")
    if rep.get("ckpt_path"):
        print(f"[train] checkpoint → {rep['ckpt_path']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
