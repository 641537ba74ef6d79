#!/usr/bin/env python3
"""mamba2-370m's prefill from another checkout beside this one's, on one card.

    python3 tools/prefill_ab.py --other path/to/other/checkout [--rounds 2]

Runs one fresh process per turn, in the order other, this, this, other
(``--rounds`` such groups), each importing the port from its own
checkout's ``src/`` and building kernel 6 there first (timed apart). A turn
serves 8 × 2,048 prompt tokens + 32 new ones through ``launch.serve.serve``,
as ``chip_smoke.py``'s ``lm_serve`` does (its prefill is the process's first:
``cold_prefill_ms``), then runs three more prefills of the same prompts on
a model drawn from the same seed, timed on the host clock around a
synchronized call (``warm_prefill_ms``), and profiles one more with
``torch.profiler``: device ms by class (matrix products, kernel 6,
elementwise passes and copies) and kernel launches, as ``lm_profile`` splits
them. Prints one JSON line per turn, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUESTS, PROMPT, NEW_TOKENS = 8, 2048, 32

# One turn, run with the checkout's src/ first on the path.
_TURN = r"""
import json, sys, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T

requests, prompt, new_tokens = (int(a) for a in sys.argv[1:4])
t0 = time.perf_counter()
build.build_all(["ssd"])
build_s = time.perf_counter() - t0
rep = launch_serve.serve("mamba2-370m", requests=requests, prompt_len=prompt,
                         new_tokens=new_tokens, device="cuda", seed=0)
cfg = get_config("mamba2-370m")
model = T.init_params(cfg, seed=0, device="cuda")
tokens = torch.from_numpy(np.random.default_rng(1).integers(
    0, cfg.vocab_size, (requests, prompt))).cuda()
warm = []
with torch.no_grad():
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(tokens, buf_len=prompt + 1)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(tokens, buf_len=prompt + 1)
        torch.cuda.synchronize()
split = {"matrix_products": 0.0, "ssd_intra": 0.0,
         "elementwise_and_copies": 0.0}
launches = 0
for ev in prof.key_averages():
    us = getattr(ev, "self_device_time_total",
                 getattr(ev, "self_cuda_time_total", 0))
    if not str(getattr(ev, "device_type", "")).endswith("CUDA") or us <= 0:
        continue
    launches += ev.count
    low = ev.key.lower()
    key = ("ssd_intra" if "ssd_intra" in low else "matrix_products"
           if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma",
                                     "cublas")) else "elementwise_and_copies")
    split[key] += us / 1e3
print("TURN " + json.dumps({
    "build_s": build_s, "cold_prefill_ms": rep["prefill_ms"],
    "decode_ms_per_token": rep["decode_ms_per_token"],
    "warm_prefill_ms": warm, "device_ms": split,
    "device_total_ms": sum(split.values()), "kernel_launches": launches}))
"""


def turn(label: str, root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _TURN, str(REQUESTS), str(PROMPT),
         str(NEW_TOKENS)], cwd=root, env=env, capture_output=True, text=True,
        timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"{label} turn failed:\n{out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("TURN ")]
    return {"tree": label, **json.loads(line[-1][len("TURN "):])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("prefill_ab.py needs a CUDA card")
    trees = {"other": os.path.abspath(args.other), "this": REPO}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            print(json.dumps(turn(label, trees[label])), flush=True)
    sys.path.insert(0, REPO)
    from chip_smoke import card_line

    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
