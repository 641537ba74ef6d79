"""Train a tiny LM end to end with the PyTorch port's training stack.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py [--steps N] [--device cpu]

The twin of ``examples/train_tiny_lm.py``: the llama3 block wiring at toy
scale (~0.4M parameters), AdamW + cosine schedule + grad clipping + grad
accumulation (two micro-batches), deterministic synthetic data with a
learnable bigram structure so the loss provably drops, and a checkpoint
save/restore round trip at the end. Runs on the CUDA card unless
``--device cpu``.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.serve.engine import resolve_device
from repro_torch.train import make_train_step


def make_batch(rng, b, s, vocab, device):
    """Markov bigram stream: next ≡ (5·tok + 1) mod vocab with 10% noise."""
    first = rng.integers(0, vocab, (b, 1), dtype=np.int32)
    toks = [first]
    for _ in range(s):
        nxt = (5 * toks[-1] + 1) % vocab
        noise = rng.random((b, 1)) < 0.1
        rnd = rng.integers(0, vocab, (b, 1), dtype=np.int32)
        toks.append(np.where(noise, rnd, nxt).astype(np.int32))
    return {"tokens": torch.from_numpy(np.concatenate(toks, axis=1))
            .to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("llama3-8b").reduced(
        num_layers=2, d_model=128, d_ff=256, vocab_size=256)
    model = T.init_params(cfg, seed=0, device=dev)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    print(f"model: {n_params / 1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model}) on {dev}")

    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.01)
    sched = cosine_schedule(3e-3, warmup=10, total=args.steps)
    state = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, sched, accum_steps=2)

    rng = np.random.default_rng(0)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = make_batch(rng, b=8, s=64, vocab=cfg.vocab_size, device=dev)
        m = step(model, state, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  step {i:4d}  loss {losses[-1]:.3f}  "
                  f"lr {float(m['lr']):.2e}  |g| {float(m['grad_norm']):.2f}")
    dt = time.time() - t0
    print(f"trained {args.steps} steps in {dt:.0f}s "
          f"({8 * 64 * args.steps / dt:.0f} tok/s)")
    assert losses[-1] < losses[0] * 0.7, "loss must drop"

    with tempfile.TemporaryDirectory() as d:
        tree = {"params": model.state_dict(), "opt": state}
        save_pytree(tree, d)
        restored = restore_pytree(tree, d)
        same = all(torch.equal(a, restored["params"][k])
                   for k, a in tree["params"].items())
        print(f"checkpoint round-trip: {'OK' if same else 'FAILED'}")
        assert same
    return losses


if __name__ == "__main__":
    main()
