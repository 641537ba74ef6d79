#!/usr/bin/env python3
"""The sharded LM path on real placements across four cards of one host.

    python3 tools/sharded_cards.py

Spawns one process per card; they meet in a NCCL process group on a free
loopback port and build a 2 × 2 ("data", "model") ``DeviceMesh``, where
the placements ``launch.shardings`` gives are real shards (batch over
``data``, projections' growing side and the vocabulary over ``model``).
Rank 0 first runs each case plain on its own card from the same weights
(drawn there from a seed; ``distribute_tensor`` scatters rank 0's copy),
then every rank runs it sharded:

* mamba2-370m at full width, all 48 layers and then 4: one train step at
  4 × 512 tokens (AdamW, remat): loss and grad norm within
  ``chip_smoke.LM_TOL`` relative, every gradient within
  ``chip_smoke.TRAIN_GRAD_TOL`` of its largest magnitude; the three leaves
  farthest from the plain step's, by name; kernel 6 launched on each
  rank's heads (its launches per rank reported). Beside it, the plain step
  again with its batch summed in two micro-batches (its reductions in
  another order, on one card): how far float32 rounding alone moves the
  gradients at that depth. At 48 layers two more sharded steps are timed
  (host clock around synchronized steps);
* llama3-8b at full width and 2 layers: a sharded prefill of 2 × 512 tokens
  and 8 greedy decode steps on caches placed by ``cache_shardings(profile=
  "seq")``: logits within ``LM_TOL`` of their largest magnitude, greedy
  tokens equal.

Prints one JSON line per case from rank 0, then the card's name and
power limit. Needs four cards; imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import queue as queue_mod
import socket
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDS = 4
TRAIN_SHAPE = (4, 512)
TRAIN_LAYERS = (48, 4)
SERVE_SHAPE, DECODE_STEPS = (2, 512), 8


def emit(row) -> None:
    print(json.dumps(row), flush=True)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _grad_errs(got, want):
    """Each leaf's largest gradient difference over its largest plain
    magnitude, worst first."""
    errs = {k: float((got[k] - g).abs().max()) / (float(g.abs().max()) or 1.0)
            for k, g in want.items()}
    return sorted(errs.items(), key=lambda kv: -kv[1])


def train_case(rank, mesh, tol, grad_tol, layers):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.train import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_config("mamba2-370m"), num_layers=layers)
    dev = torch.device("cuda", rank)
    model = T.init_params(cfg, seed=0, device=dev)
    batch = make_batch(cfg, *TRAIN_SHAPE, 0, dev)
    opt = AdamWConfig()
    step = make_train_step(cfg, opt)
    want = reordered = None
    if rank == 0:
        plain = copy.deepcopy(model)
        want = step(plain, adamw_init(dict(plain.named_parameters()), opt),
                    batch)
        want = ({k: float(v) for k, v in want.items()},
                {k: p.grad for k, p in plain.named_parameters()})
        plain = copy.deepcopy(model)
        make_train_step(cfg, opt, accum_steps=2)(
            plain, adamw_init(dict(plain.named_parameters()), opt), batch)
        reordered = {k: p.grad for k, p in plain.named_parameters()}
        del plain
    SH.shard_model(model, mesh)
    state = SH.shard_opt_state(adamw_init(dict(model.named_parameters()),
                                          opt), model, mesh)
    placed = SH.shard_batch(batch, mesh)
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = step(model, state, placed)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()["ssd_intra"]
    grads = {k: _full(p.grad) for k, p in model.named_parameters()}
    local = {k: list(p.to_local().shape)
             for k, p in list(model.named_parameters())[:4]}
    steps_ms = []
    for _ in range(2 if layers == get_config("mamba2-370m").num_layers else 0):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step(model, state, placed)
        torch.cuda.synchronize(dev)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    if rank:
        return None
    metrics, plain_grads = want
    out = {"case": "train", "arch": cfg.name, "layers": layers,
           "mesh": SH.mesh_axes(mesh),
           "batch": list(TRAIN_SHAPE), "first_sharded_step_s": first_s,
           "sharded_step_ms": steps_ms, "ssd_intra_launches_rank0": launches,
           "local_shapes_rank0": local}
    ok = True
    for key in ("loss", "ce", "grad_norm"):
        a, b = metrics[key], float(got[key])
        out[key] = {"plain": a, "sharded": b, "rel_err": abs(b - a) / abs(a)}
        ok = ok and abs(b - a) <= tol * abs(a)
    errs = _grad_errs(grads, plain_grads)
    worst = errs[0][1]
    out["worst_grad_rel_err"] = worst
    out["worst_grad_leaves"] = errs[:3]
    again = _grad_errs(reordered, plain_grads)
    out["plain_reordered_worst_grad_rel_err"] = again[0][1]
    out["plain_reordered_worst_grad_leaves"] = again[:3]
    out["ok"] = bool(ok and worst <= grad_tol and launches > 0)
    return out


def serve_case(rank, mesh, tol):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2)
    dev = torch.device("cuda", rank)
    model = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, SERVE_SHAPE, device=dev,
                           generator=gen)
    buf = SERVE_SHAPE[1] + DECODE_STEPS

    def run(m, place_tokens, place_caches):
        logits, caches = m.prefill(place_tokens(tokens), buf_len=buf)
        caches = place_caches(caches)
        seen, picked = [_full(logits)], []
        for i in range(DECODE_STEPS):
            tok = seen[-1][:, -1].argmax(-1)[:, None]
            picked.append(tok)
            logits, caches = m.decode_step(place_tokens(tok), caches,
                                           SERVE_SHAPE[1] + i)
            seen.append(_full(logits))
        return seen, torch.cat(picked, dim=1)

    def same(x):
        return x

    if rank == 0:
        want, want_tok = run(copy.deepcopy(model), same, same)
    SH.shard_model(model, mesh)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got, got_tok = run(model, lambda t: SH.shard_batch({"t": t}, mesh)["t"],
                       lambda c: SH.shard_caches(c, mesh, profile="seq"))
    torch.cuda.synchronize(dev)
    sharded_s = time.perf_counter() - t0
    if rank:
        return None
    err = max(float((g - w).abs().max()) / float(w.abs().max())
              for g, w in zip(got, want))
    equal = bool(torch.equal(got_tok, want_tok))
    return {"case": "serve", "arch": cfg.name, "layers": cfg.num_layers,
            "mesh": SH.mesh_axes(mesh), "prompt": list(SERVE_SHAPE),
            "decode_steps": DECODE_STEPS, "cache_profile": "seq",
            "sharded_s": sharded_s, "logits_rel_err": err,
            "greedy_tokens_equal": equal, "ok": err <= tol and equal}


def worker(rank, port, queue):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, REPO)
    from chip_smoke import LM_TOL, TRAIN_GRAD_TOL

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=CARDS)
    try:
        mesh = init_device_mesh("cuda", (CARDS // 2, 2),
                                mesh_dim_names=("data", "model"))
        for case in [*(lambda n=n: train_case(rank, mesh, LM_TOL,
                                              TRAIN_GRAD_TOL, n)
                       for n in TRAIN_LAYERS),
                     lambda: serve_case(rank, mesh, LM_TOL)]:
            row = case()
            if rank == 0:
                queue.put(row)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if torch.cuda.device_count() < CARDS:
        raise SystemExit(f"sharded_cards.py needs {CARDS} cards, found "
                         f"{torch.cuda.device_count()}")
    sys.path.insert(0, REPO)
    from chip_smoke import card_line

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, port, queue))
             for r in range(CARDS)]
    for p in procs:
        p.start()
    rows = []
    try:
        while len(rows) < len(TRAIN_LAYERS) + 1:
            try:
                rows.append(queue.get(timeout=10))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break           # a rank failed: its traceback is above
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    for row in rows:
        emit(row)
    print(card_line(), flush=True)
    if (any(codes) or len(rows) < len(TRAIN_LAYERS) + 1
            or not all(row["ok"] for row in rows)):
        print(f"exit codes {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
