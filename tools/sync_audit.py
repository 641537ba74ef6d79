#!/usr/bin/env python3
"""Where the port makes the host wait for the card, path by path.

    python3 tools/sync_audit.py [--rows 100000]

Runs on one card (~75 s of command) with ``chip_smoke.py``'s audit
(``torch.cuda.set_sync_debug_mode("warn")``, each sync charged to the
innermost frame under ``src/repro_torch``), at a cut Path A index:

* the smoke's three audit paths: mamba2-370m ``Engine.generate`` at 1 × 512
  + 8 new tokens, one ``make_train_step`` step at 2 × 512, and one Path A
  batch of ``search(backend="torch")`` in float32, first on a cold index
  (its stacked arrays go to the card in that batch) and then on a warm one;
* the reduced size of llama3-8b, deepseek-v2-lite-16b, gemma3-4b and
  zamba2-7b through ``Engine.generate`` (1 × 64 + 4 new tokens): where
  each family's decode syncs.

Each path prints one ``{"sync_audit": ...}`` line (sites, those inside the
analyzer's SYNC_SCOPE, and those there that ``device-sync`` does not flag
and ``chip_smoke.SYNC_UNSEEN`` does not list); a path whose audit fails is
printed and passed over. Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke as smoke  # noqa: E402

FAMILIES = ("llama3-8b", "deepseek-v2-lite-16b", "gemma3-4b", "zamba2-7b")


def _guarded(fn) -> None:
    try:
        fn()
    except AssertionError:
        traceback.print_exc()


def family_generate(arch, flagged) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(arch).reduced()
    model = T.init_params(cfg, seed=0, device="cuda")
    engine = Engine(cfg, model, ServeConfig(max_new_tokens=4))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 64), dtype=np.int32)
    if cfg.num_codebooks:
        prompts = np.repeat(prompts[:, None], cfg.num_codebooks, axis=1)
    smoke.sync_audit(f"{arch}_reduced_generate",
                     lambda: engine.generate(prompts), [], flagged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000,
                    help="rows of the cut Path A index")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/sync_audit.py needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import SquashConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T

    card = smoke.card_line()
    build.build_all()
    flagged = smoke.flagged_sync_lines()
    model = T.init_params(get_config(smoke.LM_ARCH), seed=0, device="cuda")
    _guarded(lambda: smoke.sync_audit_lm(model, flagged))
    del model
    torch.cuda.empty_cache()
    for arch in FAMILIES:
        _guarded(lambda: family_generate(arch, flagged))
        torch.cuda.empty_cache()
    cfg_a = SquashConfig(num_partitions=10, max_bits_per_dim=8,
                         kmeans_iters=4, lloyd_iters=6)
    ds = smoke.make_dataset()
    index, _ = smoke.build_index(ds, args.rows, cfg_a)
    queries = ds.queries.astype("float64")
    preds = synthetic.default_predicates()
    for state in ("cold", "warm"):
        _guarded(lambda: smoke.sync_audit(
            f"path_a_search_{state}",
            lambda: smoke.search_torch(index, queries, preds, torch.float32),
            ["hamming_stacked", "adc_direct"], flagged))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
