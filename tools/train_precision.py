#!/usr/bin/env python3
"""How far float32 training gradients of the port lie from float64 ones.

    PYTHONPATH=src python tools/train_precision.py [--layers N] [--no-card]

One ``train.loss_fn`` forward and backward of ``mamba2-370m`` (at full width,
``--layers`` deep, default all 48; random weights from seed 0, drawn on the
CPU) on a seeded 2 × 512-token batch, three times: on the CPU in float32,
on the CPU in float64, and on the card in float32 (kernel 6 through its
autograd Function). For every parameter it prints the largest absolute
difference of two gradients over the leaf's largest float64 magnitude,
and the norm of the difference over the leaf's norm, for CPU f32 against
f64, card against f64 and card against CPU f32; then the worst leaves.

The models compute in float32 by design (as the JAX package's do), so the
float64 run swaps the ``torch.float32`` that ``models.ssm``,
``models.layers`` and ``kernels.ref`` cast to for ``torch.float64`` while
it runs. This is a measurement tool: it says which card-vs-CPU gradient
differences a float32 check at this depth must tolerate.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time
import types

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.train import make_batch  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import loss_fn  # noqa: E402


class _Torch64(types.ModuleType):
    """``torch`` with ``float32`` read as ``float64``."""

    def __init__(self):
        super().__init__("torch")

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


def grads(model, batch, cfg, f64: bool = False):
    mods = (ssm, layers, ref)
    prev = torch.get_default_dtype()
    if f64:
        torch.set_default_dtype(torch.float64)
        for mod in mods:
            mod.torch = _Torch64()
    try:
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, batch, cfg)
        loss.backward()
        if batch["tokens"].is_cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        torch.set_default_dtype(prev)
        for mod in mods:
            mod.torch = torch
    return float(loss.detach()), seconds, {k: p.grad.detach().to("cpu", torch.float64)
                                  for k, p in model.named_parameters()}


def compare(a, b, scale):
    """{leaf: (max |a - b| / max |scale|, ‖a - b‖ / ‖scale‖)}."""
    return {k: (float((a[k] - b[k]).abs().max() / scale[k].abs().max()),
                float((a[k] - b[k]).norm() / scale[k].norm())) for k in scale}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the config's 48)")
    ap.add_argument("--no-card", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config("mamba2-370m")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = T.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, 2, 512, 0, "cpu")
    runs = {"cpu32": grads(copy.deepcopy(model), batch, cfg),
            "cpu64": grads(copy.deepcopy(model).double(), batch, cfg,
                           f64=True)}
    if not args.no_card:
        runs["card"] = grads(copy.deepcopy(model).to("cuda"),
                             {k: v.cuda() for k, v in batch.items()}, cfg)
    g64 = runs["cpu64"][2]
    pairs = {"cpu32_vs_f64": ("cpu32", "cpu64")}
    if "card" in runs:
        pairs.update({"card_vs_f64": ("card", "cpu64"),
                      "card_vs_cpu32": ("card", "cpu32")})
    out = {"layers": cfg.num_layers,
           "loss": {k: v[0] for k, v in runs.items()},
           "seconds": {k: v[1] for k, v in runs.items()}}
    for name, (a, b) in pairs.items():
        errs = compare(runs[a][2], runs[b][2], g64)
        worst = sorted(errs.items(), key=lambda kv: -kv[1][0])
        mixer = [v for k, v in errs.items() if ".mixer." in k]
        out[name] = {
            "worst_max_rel": worst[0][1][0], "worst_leaf": worst[0][0],
            "worst_norm_rel": max(v[1] for v in errs.values()),
            "mixer_worst_max_rel": max((v[0] for v in mixer), default=0.0),
            "top": [[k, v[0], v[1]] for k, v in worst[:8]]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
