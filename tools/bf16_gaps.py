#!/usr/bin/env python3
"""Lower and upper readings of the card's bf16 gates (``chip_smoke.lm_bf16``).

    python3 tools/bf16_gaps.py [--out chiprun_out/bf16_gaps.json]

On the card, at full size and the smoke's shapes and seeds: llama3-8b (32
layers, last-token logits of an 8 × 2,048 prefill of the tokens
``chip_smoke.lm_profile`` draws) and mamba2-370m (48 layers, 8 × 2,048,
the tokens of ``lm_bf16``). Each model is drawn in f32 (seed 0), gives its
f32 logits, moves to bf16 in place (``DecoderLM.to_dtype``) and is read
again:

* ``as_shipped``: the bf16 model as the port runs it (the lower reading);
* ``no_reduced_reductions``: the same with cuBLAS's reduced-precision bf16
  reductions off (``allow_bf16_reduced_precision_reduction = False``),
  which says whether the card's own bf16 sums widen the gap;
* controls, each one of the reference's f32 islands rounded to bf16 (the
  upper readings a gate should refuse): ``scores_bf16``, GQA attention's
  scores, softmax and sums in bf16 (the port before it took the
  reference's ``preferred_element_type=f32``); ``norm_bf16``, RMSNorm in
  the stream's dtype; ``rope_bf16``, the rotary angles, cos and sin in the
  stream's dtype (a position of 2,048 is a bf16 value 16 apart from its
  neighbours); ``islands_bf16`` (mamba2 only, run last because it
  rounds the weights), ``Module.to(bfloat16)``, which rounds the mixers'
  ``A_log``, ``D`` and ``dt_bias`` that the reference keeps f32.

Before the models, the smoke's attention gate (``chip_smoke.bf16_attention``:
GQA attention on bf16 inputs at llama3-8b's heads against an f64 model of
the reference's precision) as shipped and with ``scores_bf16``.

For mamba2-370m it also reads the gap on the same weights and the first
512 tokens of the first prompt on the card and on the CPU (the port's CPU
bf16 path is the one ``tests/test_torch_bf16.py`` holds against the
reference), so a card fault would show as a card gap far above the CPU's.

Each reading is the largest |bf16 - f32| over the largest |f32 logit|
(``chip_smoke.bf16_gap``), beside ``chip_smoke.BF16_TOL`` of the model.
Prints one JSON line per reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def _scores_in_operand_dtype(*ts):
    acc = ts[0].dtype
    for t in ts[1:]:
        acc = torch.promote_types(acc, t.dtype)
    return acc


def _rope_in_stream_dtype(x, positions, theta=10_000.0):
    freqs = layers.rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(x.dtype) * freqs.to(x.dtype)
    return layers._rotate(x, torch.cos(ang)[:, :, None, :],
                          torch.sin(ang)[:, :, None, :])


def _norm_in_stream_dtype(self, x):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + self.eps) * self.scale.to(x.dtype)


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _no_reduced_reductions():
    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = old


CONTROLS = {
    "as_shipped": contextlib.nullcontext,
    "no_reduced_reductions": _no_reduced_reductions,
    "scores_bf16": lambda: _patched(A, "_accum_dtype",
                                    _scores_in_operand_dtype),
    "norm_bf16": lambda: _patched(layers.RMSNorm, "forward",
                                  _norm_in_stream_dtype),
    "rope_bf16": lambda: _patched(layers, "apply_rope",
                                  _rope_in_stream_dtype),
}


def _last_logits(model, tokens):
    with torch.no_grad():
        out = model.prefill(tokens, buf_len=tokens.shape[1] + 1)[0]
    if out.is_cuda:
        torch.cuda.synchronize()
    return out


def readings(name, tokens, records, cpu_tokens=None):
    cfg = get_config(name)
    model = T.init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    logits_f = _last_logits(model, tokens)
    cpu = None
    if cpu_tokens is not None:
        cpu = copy.deepcopy(model).to("cpu")
        cpu_f = _last_logits(cpu, cpu_tokens)
        card_f = _last_logits(model, cpu_tokens.cuda())
    model.to_dtype(torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    base = {"arch": name, "layers": cfg.num_layers,
            "tokens": list(tokens.shape), "limit": smoke.BF16_TOL[name]}
    for control, ctx in CONTROLS.items():
        with ctx():
            got = smoke.bf16_gap(_last_logits(model, tokens), logits_f)
        records.append({**base, "reading": control, **got})
        print(json.dumps(records[-1]), flush=True)
    if cpu is not None:
        card_b = _last_logits(model, cpu_tokens.cuda())
        cpu.to_dtype(torch.bfloat16)
        cpu_b = _last_logits(cpu, cpu_tokens)
        for side, (b, f) in {"same_weights_card": (card_b, card_f),
                             "same_weights_cpu": (cpu_b, cpu_f)}.items():
            records.append({**base, "tokens": list(cpu_tokens.shape),
                            "reading": side,
                            **smoke.bf16_gap(b.cpu(), f.cpu())})
            print(json.dumps(records[-1]), flush=True)
        del cpu
    if cfg.family == "ssm":
        model.to(torch.bfloat16)
        got = smoke.bf16_gap(_last_logits(model, tokens), logits_f)
        records.append({**base, "reading": "islands_bf16", **got})
        print(json.dumps(records[-1]), flush=True)
    print(json.dumps({"arch": name, "seconds": time.perf_counter() - t0}),
          flush=True)
    del model, logits_f
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "bf16_gaps.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_gaps: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    n, s = smoke.LM_REQUESTS, smoke.LM_PROMPT_LEN
    records = []
    for control in ("as_shipped", "scores_bf16"):
        with CONTROLS[control]():
            records.append({"attention": "llama3-8b heads", "seq": s,
                            "reading": control, "limits": {
                                "bitwise_share": smoke.BF16_ATTN_EQUAL,
                                "max_gap_over_max": smoke.BF16_STEP},
                            **smoke.bf16_attention(s)})
        print(json.dumps(records[-1]), flush=True)
    llama = get_config(smoke.LLAMA3_SERVE)
    readings(llama.name, torch.from_numpy(np.random.default_rng(1).integers(
        0, llama.vocab_size, (n, s))).cuda(), records)
    mamba = get_config(smoke.LM_ARCH)
    mtok = torch.from_numpy(np.random.default_rng(0).integers(
        0, mamba.vocab_size, (n, s)))
    readings(mamba.name, mtok.cuda(), records, cpu_tokens=mtok[:1, :512])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card.strip(), "readings": records}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
