#!/usr/bin/env python3
"""Drive the PyTorch port of SQUASH on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (sm_90a), then drives the port's paths on the card:

* Lint: the port's squashlint (``repro_torch.analysis.main(["--strict",
  "--json"])``) over the checkout, with an empty baseline: fails on any
  new finding; prints the findings by rule and, by rule, the findings a
  justified pragma suppresses.
* Sync audit: three paths under ``torch.cuda.set_sync_debug_mode("warn")``,
  each sync charged to the innermost frame under ``src/repro_torch``
  (``sync_sites``): (b) mamba2-370m ``Engine.generate`` at 1 × 512 + 8 new
  tokens on the LM check's model (kernel 6 in its prefill), (c) one
  ``make_train_step`` step at 2 × 512 on it, after the LM phases below,
  and (a) one Path A batch of ``search(backend="torch")`` in float32
  without the ``mark`` hook (kernels 1 and 2b), after the search paths.
  Each prints ``{"sync_audit": {"path", "sites", "in_scope",
  "unflagged", ...}}`` and fails when a sync inside the analyzer's
  ``SYNC_SCOPE`` lies on a line its ``device-sync`` rule does not flag
  and ``SYNC_UNSEEN`` does not list with its reason, when a kernel of the
  path does not launch, or (b) when the audit does not see each decode
  step's token copy. Syncs outside the scope are printed, not held.
* LM check: ``mamba2-370m`` at full width and depth (48 layers, d_model
  1024, vocab 50,280; random weights from a seed, drawn on the CPU and
  copied to the card) on 1 request of 512 tokens (2 chunks of 256) plus 8
  greedy tokens, through the port's ``DecoderLM.prefill`` and ``Engine``
  once on the CPU (plain versions) and once on the card (kernels).
  Prefill logits, final SSM states and conv caches must agree within
  5e-3 of their largest magnitude: the f32 card run lies 3.5e-4-6.5e-4
  from the CPU (the intra-chunk decay ``exp(cs_l - cs_s)`` takes
  differences of cumulative sums that reach |cs| ~ 1e3-1e4 in the
  fast-decaying heads, and the two sides round them differently), and a
  control prefill on the card with TF32 matrix products lies 5.8e-2-6.8e-2
  from it; the check fails unless the control exceeds the tolerance. Token
  agreement and the first divergence are reported.
  The SSD intra-chunk kernel must launch once per layer per prefill.
* LM serve: ``repro_torch.launch.serve``'s path on the card, 8 requests ×
  2,048-token prompts (8 chunks at the published ``ssm_chunk`` 256) and 32
  new tokens: prefill ms, decode ms per token, tokens/s; then one prefill
  and one decode step at that shape under ``torch.profiler`` (device time
  by kernel).
* LM families: llama3-8b, granite-20b, phi4-mini-3.8b, qwen2-vl-2b,
  musicgen-large and deepseek-v2-lite-16b at full width and 2 layers,
  gemma3-4b and zamba2-7b at 7 (one 5+1 local:global unit or one unit of
  6 Mamba2 blocks + the shared attention block, and a tail of one), and
  arctic-480b at its reduced size (one full-width layer alone holds
  53.5 GB of f32 experts); random weights from seed 0 drawn on the card and
  copied to the CPU. 1 request of 512 tokens (gemma3: 1,280, past its
  1,024-token ring; qwen2-vl: after 256 random patch embeddings; musicgen:
  4 codebook streams) prefilled on the CPU and on the card: logits and
  every cache leaf within 5e-3 of their largest magnitude; a TF32 control
  prefill is reported, then 8 greedy tokens through ``Engine.generate`` on
  both (agreement reported). The widths each config cut are printed.
  zamba2's Mamba2 blocks launch kernel 6 (112 heads, N = 64).
* LM serve llama3: ``launch/serve.py``'s path for llama3-8b at full size
  (32 layers, 8.03 B parameters, 32.1 GB f32 drawn on the card), 8 × 2,048
  prompts + 32 new tokens, once with the fp KV cache (4.36 GB) and once
  with ``kv_bits=8`` (the OSQ-packed cache, a quarter of it): prefill ms,
  decode ms per token, tokens/s, cache bytes and the share of greedy
  tokens the two runs agree on; then one prefill and one decode step of
  the same model under ``torch.profiler``. Each model is freed before the
  next phase.
* Train check: ``mamba2-370m`` at full size, weights drawn on the card and
  copied to the CPU, one ``train.make_train_step`` step (AdamW, remat) on
  a seeded 2 × 512-token batch on the CPU and on the card: loss, ce and
  grad norm within 5e-3 relative; every parameter's gradient within 2e-2
  of its largest CPU magnitude (at 48 layers each side's float32
  gradients lie up to 7.3e-3 / 8.4e-3 from float64 ones,
  ``tools/train_precision.py``), the mixer's (``A_log``, ``dt_bias``,
  ``conv_w``, the in-projections) reported apart; every updated parameter
  within 2 · lr
  (Adam's first step moves an element by up to lr either way, so a
  gradient that is 0 up to rounding may take either sign). A control on
  the card with kernel 6's output cut from the graph (its state before
  its autograd Function) must miss the mixer's gradients by more than the
  tolerance. Kernel 6 must launch twice per layer (forward, recompute).
* SSD grad: kernel 6's ``ssd.SsdIntraFunction`` at the training shape (G =
  128, H = 32, lc = 256, N = 128, P = 64) on the strided views, dC, dB,
  d(da) and dx against plain autograd of the plain version (rtol 1e-4,
  atol 1e-5 · max); the forward kernel's and the plain backward's device
  times, the backward's bound.
* Train run: ``launch/train.train`` for mamba2-370m at full size, weights
  drawn on the card, 6 steps of 16 × 4,096 tokens in two micro-batches:
  first-step seconds, steady ms, tokens/s, peak memory, every step's
  loss and grad norm (finite), kernel 6's launches per step (2 × (48 +
  48)); one steady step under ``torch.profiler`` (device ms by class, with
  kernel 6's backward and the AdamW pass as ranges); then a checkpoint of
  the model and optimizer state saved and restored (seconds, bytes) and
  one more step from each on 4 × 4,096 tokens: equal losses, exactly.
* Train llama3 width: llama3-8b at full width and 2 layers (1.487 B
  parameters), the same one-step card-vs-CPU check at 1 × 512 tokens, then
  4 timed steps at 4 × 2,048 (step ms, tokens/s, peak memory): GQA, RoPE
  and the MLP backward at full width.
* Sharded check: the sharded LM path (``launch.shardings`` on a
  ``torch.distributed`` DeviceMesh) on a 1 × 1 NCCL ("data", "model")
  mesh, against the plain one on the card: mamba2-370m at full size, one
  train step from the same weights at 2 × 512 tokens on the sharded model,
  AdamW state and batch (loss, ce and grad norm within 5e-3 relative,
  every gradient within 2e-2 of its largest magnitude, updates within 2 ·
  lr; kernel 6 launched through ``local_map`` twice per layer); then
  llama3-8b at full width and 2 layers: a sharded prefill of 1 × 512 and
  8 greedy decode steps on caches placed by ``cache_shardings(profile=
  "seq")``: logits within 5e-3 of their largest magnitude, greedy tokens
  equal. Whether each comparison was bitwise is reported.
* Sharded train run: ``launch/train.train`` with that mesh, mamba2-370m at
  full size, 2 steps of 16 × 4,096 tokens in two micro-batches: step ms,
  tokens/s, peak memory and kernel 6's launches beside the train run's
  (the gap is DTensor's host dispatch).
* RAG: ``examples/rag_serving_torch.py``'s flow at full size:
  phi4-mini-3.8b (weights drawn on the card) embeds 1,024 documents of 24
  tokens, SQUASH indexes the d = 3,072 embeddings, the example's queries
  search with ``backend="torch"`` (float64 ids and ``SearchStats`` equal
  to the NumPy backend's; kernel 1 and the Stage 4 kernel the index's M+1
  picks must launch, and the line names which), then the LM generates
  from the retrieved prompts with the float and the 8-bit KV cache
  (greedy tokens agree on at least 0.75).
* Dry run: ``python -m repro_torch.launch.dryrun`` for llama3-8b ×
  train_4k and mamba2-370m × decode_32k on a fake 16 × 16 process group,
  two processes on the host started after the build and collected at the
  end (no card): FLOPs, per-rank state bytes, collective bytes, and the
  roofline terms as H100 spec arithmetic.
* Path A (direct Stage 4, the default formulation): the SIFT1M-shaped
  synthetic dataset (1,000,000 × 128, 4 attributes of cardinality 16, the
  §5.1 predicates at ≈8 % joint selectivity), P=10, b=4d, S=8 and
  ``max_bits_per_dim=8`` (M+1 = 257), Q=64, k=10. Float64 ids must equal
  the port's NumPy backend and ``SearchStats`` must be equal; float32
  recall@10 against brute-force filtered ground truth must be within 0.005
  of the NumPy backend's. Then 5 timed batches per float width.
* Path B (the table kernel): the same 1,000,000 rows with
  ``max_bits_per_dim=5`` (M+1 = 33); float64 ids must equal NumPy's. Its
  host index build runs in a spawned worker process beside Path A's, so
  the two builds take the time of the longer one. Both paths' timed
  batches report each stage's device time and the most device memory a
  batch adds to what is resident at its start.
* Segment extraction: every Path A partition's packed segments through
  ``kernels.ops.extract_codes`` on the card must equal its stored codes
  exactly.
* Kernels: each CUDA kernel against its plain PyTorch version at the
  paths' shapes (Hamming and extraction exact; ADC rtol 1e-5, atol 0: f32
  sums of ≤ d non-negative terms in another order, and the direct kernel's
  +inf exactly on the slots past each pair's keep, with Path A's keep and
  with whole and dead pairs put in, and the same for the table kernel with
  Path B's keep, in tables built in f64 and in f32, beside its dense (B, N,
  d) form on the gathered codes; kernels 1, 2b and 2 also at d = 3,072,
  an LM embedding's width, where kernel 2b's shared memory outgrew an
  H100 block before its query rows were tiled over d (G = 96 words; M+1
  = 257 in f32 and f64; M+1 = 33); SSD intra-chunk rtol 1e-4, atol 1e-5 ·
  max |y|: f32 sums of up to lc · N products in another order; held at
  mamba2-370m's serve shape and at zamba2-7b's, on the strided views
  ``ssm.ssd_chunked`` passes and on contiguous copies, with fast decay and
  with slow decay, where every s-tile behind a row tile carries weight),
  with its device time (launches queued behind a spin of
  the card, CUDA events), the plain version's time and its bound on the
  card; the bounds of the two kernels that take ``keep`` count what the
  live slots need.
* Serverless (after the kernels phase, which must see the indexes
  unmutated): ``repro_torch.serverless.ServerlessRuntime`` on Path A's
  index, Coordinator → QA → QP over the Alg. 2 tree (F=4, l_max=2), Q=64,
  k=10. The local transport with its QPs on the card: float64 ids and
  ``SearchStats`` must equal ``index.search(backend="torch")`` (cold and
  warm fleet); float32 recall@10 is reported. The process transport with
  one spawned QP worker per partition on the card (each its own CUDA
  context) and two CPU allocator workers: float64 ids and stats must
  equal the local run's, and the warm batch must fetch nothing. Per
  transport: batch wall ms, modeled makespan and dollars, invocations, QP
  handler ms, worker start-up seconds and the card memory each QP worker
  adds. Its invoke timeout is raised to 600 s for a cold card.
* Serverless over sockets (after the serverless phase): the same runtime
  on Path A's index with ``transport="socket"``: two auto-spawned loopback
  host processes serve the 10 QP links on the card (one CUDA context per
  host, each link on its own compute thread) and the 2 CPU QA links over
  TCP. The cold and warm batches' float64 ids, dists and stats must equal
  the local run's cold batch, the warm batch must fetch nothing, every QP
  node must name its host:port; after ``qp:0``'s connection is dropped,
  one more batch must be equal with ``qp:0`` cold again. Observability is
  on so that the hosts answer the STATS pull, and every host must report
  card memory held (``host.cuda_memory_allocated_bytes``). Reported: host
  spawn and deploy seconds, batch walls, the modeled makespan and
  dollars, the card memory the fleet adds (``nvidia-smi``, and the
  compute-apps rows of the host pids), the memory each host holds before
  and after the reconnect, and the ``transport.socket.*`` counters. The
  kernels run in the host processes, whose launch counts this process
  cannot read.
* Mesh: ``repro_torch.core.distributed.distributed_search`` on a 1 × 1
  NCCL mesh on the card (a process group on a free loopback port,
  destroyed after), on Path A (kernels 1 and 2b) and Path B before the
  live phase mutates it (kernels 1 and 2): float64 ids and dists must
  equal ``index.search(backend="torch")``; both batch walls are reported
  beside the torch backend's.
* Live: Path B's index wrapped in a ``LiveIndex``; 10,000 rows from the
  dataset generator at seed 1 inserted and 1 % of all ids deleted; the
  card's float64 ids must equal the NumPy backend's with no tombstoned id
  returned; a drop-only compaction must leave ids and stats unchanged
  (the reference's contract), a requantizing one the stats (its ids held
  against NumPy's); a local serverless runtime drained across the
  mutations must equal the torch backend throughout. Insert, delete,
  compaction and restack seconds are reported.

Launch counters are set to 0 just before each path (LM serve, each LM
family's card prefill and generation, the train run, the sharded train
step and train run, the RAG search, each search path, the extraction,
the serverless local run, each mesh search, the live phase) and read just
after; every kernel must have launched on the path that runs it.
Every
check raises on failure, so the script exits non-zero. The last lines are a
``{"kernels": [...]}`` JSON line, the card's name and power limit from
``nvidia-smi``, and ``{"ok": true, "device": {...}}``.

Needs: one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``), torch,
numpy. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core rate
ADC_RTOL = 1e-5                # f32 sums of ≤ d non-negative terms, reordered
K = 10
NUM_QUERIES = 64
SLICE_Q = 8                    # queries of the direct kernel's plain check
LM_ARCH = "mamba2-370m"
LM_REQUESTS, LM_PROMPT_LEN, LM_NEW_TOKENS = 8, 2048, 32
LM_TOL = 5e-3                  # of the largest |value|: see the docstring
SSD_RTOL, SSD_ATOL_SCALE = 1e-4, 1e-5
SSD_GRAD_RTOL, SSD_GRAD_ATOL_SCALE = 1e-4, 1e-5
SPIN_CYCLES = 100_000_000      # ~50 ms of the card ahead of timed launches


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-a", type=int, default=1_000_000,
                    help="rows of Path A (default: the full 1M preset)")
    ap.add_argument("--rows-b", type=int, default=1_000_000,
                    help="rows of Path B (first rows of the same dataset)")
    ap.add_argument("--timed-batches", type=int, default=5)
    return ap.parse_args(argv)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------- timing

def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events
    around the loop: the host's time between launches included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` with its launches queued behind
    a spin of the card, so the kernels run back to back and the host's time
    between them stays hidden. Fails if the host took longer to queue the
    launches than the spin lasted."""
    import torch

    fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= spin.elapsed_time(start):
        raise AssertionError(f"queueing {reps} calls took {host_ms:.1f} ms, "
                             "longer than the spin ahead of them")
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, tf32x3_ops: float = 0.0):
    """Least ms for the work: bytes at the memory rate, or ``ops`` at the
    f32 CUDA-core rate plus ``tf32x3_ops`` (f32 products the kernel runs in
    3xTF32, three tensor-core products each) at the TF32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / FP32_OPS_PER_S + 3 * tf32x3_ops / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ search paths

def recall_at_k(ids, gt) -> float:
    hits = total = 0
    for row, truth in zip(ids, gt):
        truth = set(int(t) for t in truth if t >= 0)
        hits += len(truth & set(int(i) for i in row if i >= 0))
        total += len(truth)
    return hits / max(total, 1)


def straddle_diagnosis(index, queries, preds, ids_a, ids_b):
    """Explain f64 id differences as refine-cut straddles, or fail.

    For every id in one result but not the other, recompute its partition's
    Stage 3–4 on the host (NumPy order) and measure how far its f32 squared
    LB lies from the LB at the refine-take cut. A query passes when one of
    its differing ids lies within 4 ULP of the cut — the row that swapped
    across the cut; the documented residual of reordered f32 row sums
    (dataplane.py module docstring). The rows it pushed out of or into the
    top-k may lie anywhere.
    """
    import numpy as np

    from repro_torch.core import adc, autotune
    from repro_torch.core.pipeline import _popcount_u32

    cfg = index.config
    rows = []
    for qi in np.where((ids_a != ids_b).any(axis=1))[0]:
        _, cands, _ = index.select(queries[qi:qi + 1], preds, K)
        nearest = float("inf")
        for vid in sorted(set(ids_a[qi].tolist()) ^ set(ids_b[qi].tolist())):
            if vid < 0:
                raise AssertionError(f"query {qi}: result sizes differ")
            pid = int(index.partitioning.assign[vid])
            part = index.parts[pid]
            local = int(np.searchsorted(part.vector_ids, vid))
            cand = cands[0][pid]
            qbits = part.low.encode_queries((queries[qi] - part.mean)[None])[0]
            ham = _popcount_u32(np.bitwise_xor(part.low.packed[cand],
                                               qbits[None])).sum(axis=1)
            keep = autotune.keep_count(cand.size, cfg.hamming_perc,
                                       cfg.min_hamming_keep)
            comp = ham.astype(np.int64) * cand.size + np.arange(cand.size)
            kept = cand[np.argsort(comp)[:keep]]
            table = adc.build_adc_table(part.transform(queries[qi]),
                                        part.quant.boundaries,
                                        part.quant.cells)
            safe = np.where(np.isfinite(table), table, 0.0)
            sq = safe[part.codes[kept], np.arange(index.dim)[None]].sum(axis=1)
            take = min(int(np.ceil(cfg.refine_ratio * K)), keep)
            cut = np.sort(sq, kind="stable")[take - 1]
            mine = sq[np.where(kept == local)[0]]
            ulps = (float(abs(mine[0] - cut) / np.spacing(np.float32(cut)))
                    if mine.size else float("inf"))
            rows.append({"query": int(qi), "id": int(vid), "partition": pid,
                         "ulps_from_cut": ulps})
            nearest = min(nearest, ulps)
        if nearest > 4:
            emit({"phase": "straddle_diagnosis", "rows": rows})
            raise AssertionError(
                f"query {qi}: ids differ and none lies within 4 ULP of its "
                "partition's refine cut — not a straddle")
    emit({"phase": "straddle_diagnosis", "rows": rows})


def with_dtype(dtype, fn):
    """``fn()`` with ``dtype`` as torch's default float dtype."""
    import torch

    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return fn()
    finally:
        torch.set_default_dtype(prev)


def search_torch(index, queries, preds, dtype):
    return with_dtype(dtype, lambda: index.search(queries, preds, k=K,
                                                  backend="torch"))


def time_batches(index, queries, preds, dtype, batches: int):
    """Host Stage 1–2 (host clock) and the plane's stages (CUDA events)."""
    import numpy as np
    import torch

    device = torch.device("cuda")
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        index.search(queries, preds, k=K, backend="torch")        # warm-up
        torch.cuda.synchronize()
        rows = []
        for _ in range(batches):
            events = {}

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events[name] = ev

            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            q64, cands, stats = index.select(queries, preds, K)
            t1 = time.perf_counter()
            index._search_torch(q64, cands, K, stats, device, mark=mark)
            t2 = time.perf_counter()          # ids are on the host: synced
            peak = torch.cuda.max_memory_allocated()
            row = {
                # Device memory at the batch's start (the stacked indexes
                # resident on the card) and the most the batch added to it.
                "resident_gb": resident / 1e9,
                "batch_peak_gb": (peak - resident) / 1e9,
                "wall_ms": (t2 - t0) * 1e3,
                "host_stage12_ms": (t1 - t0) * 1e3,
                "hamming_ms": events["start"].elapsed_time(events["hamming"]),
                "adc_ms": events["hamming"].elapsed_time(events["adc"]),
                "refine_merge_ms": events["adc"].elapsed_time(
                    events["refine_merge"]),
            }
            # The rest of the wall time: host prep (dense masks, counts),
            # copies to and from the card.
            row["other_ms"] = row["wall_ms"] - sum(
                row[key] for key in ("host_stage12_ms", "hamming_ms",
                                     "adc_ms", "refine_merge_ms"))
            rows.append(row)
    finally:
        torch.set_default_dtype(prev)
    mean = {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
    mean["qps"] = queries.shape[0] / (mean["wall_ms"] / 1e3)
    mean["batches"] = batches
    return mean


def make_dataset():
    from repro_torch.data import synthetic

    return synthetic.make_vector_dataset("sift1m", scale=1.0,
                                         num_queries=NUM_QUERIES, seed=0)


def build_index(ds, rows, config):
    """The host index build of one path; returns (index, seconds)."""
    from repro_torch.core.pipeline import SquashIndex

    t0 = time.perf_counter()
    index = SquashIndex.build(ds.vectors[:rows], ds.attributes[:rows], config,
                              seed=0)
    return index, time.perf_counter() - t0


def build_in_worker(rows, config):
    """:func:`build_index` in a spawned worker, on the dataset made anew
    from the same seed."""
    return build_index(make_dataset(), rows, config)


def emit_build(name, index, rows, config, build_s, **extra):
    from repro_torch.core import dataplane

    n_max = max(pt.size for pt in index.parts)
    m1 = max(pt.quant.boundaries.shape[0] for pt in index.parts)
    keep_s, take_s = dataplane.static_counts(n_max, config, K)
    emit({"phase": f"{name}_build", "rows": int(rows), "dim": index.dim,
          "config": dataclasses.asdict(config), "host_build_s": build_s,
          "n_max": n_max, "G": int(index.parts[0].low.packed.shape[1]),
          "M+1": m1, "keep_s": keep_s, "take_s": take_s,
          "stage4": ("table kernel" if m1 <= dataplane.ADC_TABLE_MAX_M1
                     else "direct kernel"), **extra})


def run_path(name, ds, rows, index, preds, *, check_f32: bool,
             timed_batches: int):
    """Search on numpy and torch and compare; returns the launch counts and
    the brute-force filtered ground truth (None without ``check_f32``)."""
    import numpy as np
    import torch

    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    vectors, attrs = ds.vectors[:rows], ds.attributes[:rows]
    queries = ds.queries.astype(np.float64)
    gt = None
    t0 = time.perf_counter()
    ids_np, d_np, st_np = index.search(queries, preds, k=K, backend="numpy")
    numpy_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    ids_64, d_64, st_64 = search_torch(index, queries, preds, torch.float64)
    result = {"phase": f"{name}_search", "numpy_search_s": numpy_s,
              "f64_ids_equal": bool(np.array_equal(ids_np, ids_64)),
              "f64_stats_equal": st_np == st_64,
              "stats": dataclasses.asdict(st_64)}
    if check_f32:
        ids_32, _, st_32 = search_torch(index, queries, preds, torch.float32)
    counts = ops.launch_counts()
    result["launches"] = counts
    if not result["f64_stats_equal"]:
        emit(result)
        raise AssertionError(f"{name}: SearchStats differ: numpy {st_np} vs "
                             f"torch {st_64}")
    if not result["f64_ids_equal"]:
        emit(result)
        straddle_diagnosis(index, queries, preds, ids_np, ids_64)
    finite = np.isfinite(d_np)
    if not np.array_equal(finite, np.isfinite(d_64)):
        raise AssertionError(f"{name}: finite distance pattern differs")
    result["f64_max_rel_dist_err"] = float(np.max(
        np.abs(d_64[finite] - d_np[finite]) / np.maximum(d_np[finite], 1e-300),
        initial=0.0))
    if check_f32:
        sub = synthetic.VectorDataset(name=ds.name, vectors=vectors,
                                      attributes=attrs, queries=ds.queries,
                                      attr_cardinality=ds.attr_cardinality)
        gt, _ = synthetic.ground_truth(sub, preds, k=K)
        rec_np = recall_at_k(ids_np, gt)
        rec_32 = recall_at_k(ids_32, gt)
        result.update({
            "recall_at_10_numpy": rec_np, "recall_at_10_torch_f64":
            recall_at_k(ids_64, gt), "recall_at_10_torch_f32": rec_32,
            "f32_share_ids_equal_numpy": float(np.mean(ids_32 == ids_np)),
            "f32_stats_equal": st_np == st_32})
        if rec_32 < rec_np - 0.005:
            emit(result)
            raise AssertionError(f"{name}: f32 recall {rec_32} below numpy "
                                 f"{rec_np} - 0.005")
    emit(result)
    for dtype, label in ((torch.float64, "f64"), (torch.float32, "f32")):
        if not timed_batches:
            break
        emit({"phase": f"{name}_timing_{label}", "Q": int(queries.shape[0]),
              **time_batches(index, queries, preds, dtype, timed_batches)})
    return counts, gt


# ------------------------------------------------- serverless and live index

SERVERLESS_TOPOLOGY = dict(branching=4, max_level=2)
# Spawned QP workers import torch, open a CUDA context and copy their slab
# to the card on their first request; the reference's 180 s hang guard is
# raised here only, for a cold card.
SERVERLESS_INVOKE_TIMEOUT_S = 600.0
LIVE_INSERTS, LIVE_INSERT_SEED, LIVE_DELETE_SHARE = 10_000, 1, 0.01


def gpu_memory_used_mb() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout
    return float(out.splitlines()[0])


def same_answer(label, got, want_ids, want_stats=None):
    """Raise unless a result's ids (and stats) equal the wanted ones."""
    import numpy as np

    if not np.array_equal(got[0], want_ids):
        raise AssertionError(f"{label}: ids differ in "
                             f"{int((got[0] != want_ids).any(axis=1).sum())} "
                             "queries")
    if want_stats is not None and got[2] != want_stats:
        raise AssertionError(f"{label}: SearchStats differ: {got[2]} vs "
                             f"{want_stats}")


def run_trace_summary(res, wall_s):
    """What one serverless search cost: the host clock, the modeled §3.5
    timeline and dollars, and the QP handlers' measured times (each ends
    copying its answer to the host, so it covers the QP's device work)."""
    import numpy as np

    qp = [n for n in res.trace.nodes if n.kind == "qp"]
    compute_ms = np.array([n.wall_compute_s for n in qp]) * 1e3
    qa_ms = sum(n.wall_compute_s for n in res.trace.nodes
                if n.kind == "qa") * 1e3
    return {"batch_wall_ms": wall_s * 1e3,
            "qa_compute_ms_sum": qa_ms,
            "qp_compute_ms_sum": float(compute_ms.sum()),
            "modeled_makespan_s": res.trace.makespan_s,
            "measured_makespan_s": res.trace.measured_makespan_s,
            "cost_usd": res.trace.cost["total"],
            "invocations": {kind: res.trace.invocations(kind)
                            for kind in ("co", "qa", "qp")},
            "qp_compute_ms_mean": float(compute_ms.mean()),
            "qp_compute_ms_max": float(compute_ms.max()),
            "qp_fetch_s_max": float(max(n.fetch_s for n in qp)),
            "qp_warm_share": float(np.mean([n.warm for n in qp])),
            "s3_gets": res.trace.dre.s3_gets,
            "payload_bytes": res.trace.payload_bytes}


def serverless_phase(index, queries, preds, gt, rows):
    """The serverless runtime (Coordinator → QA → QP, Alg. 2 tree F=4,
    l_max=2) on Path A's index: the local transport on the card, whose f64
    ids and stats must equal ``index.search(backend="torch")``, f32 recall;
    then the process transport with one spawned QP worker per partition on
    the card (its own CUDA context each), whose f64 ids must equal the
    local run's. Returns the kernel launches of the local f64 run and its
    cold result."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pipeline import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.serverless import RuntimeConfig, ServerlessRuntime

    f64, f32 = torch.float64, torch.float32
    want = search_torch(index, queries, preds, f64)
    out = {"phase": "serverless", "rows": int(rows),
           "P": len(index.parts), "Q": int(queries.shape[0]), "k": K,
           **SERVERLESS_TOPOLOGY}

    def search(rt):
        t0 = time.perf_counter()
        res = rt.search(queries, preds, k=K)
        return res, time.perf_counter() - t0

    # --- local transport, QPs on the card ------------------------------
    local = with_dtype(f64, lambda: ServerlessRuntime(
        index, RuntimeConfig(**SERVERLESS_TOPOLOGY)))
    ops.reset_launch_counts()
    cold, cold_s = with_dtype(f64, lambda: search(local))
    counts = ops.launch_counts()
    warm, warm_s = with_dtype(f64, lambda: search(local))
    # One more warm batch under torch.profiler: the card's kernel time in
    # all QP invocations (the profiler slows the host, so its wall is
    # reported apart).
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled, profiled_s = with_dtype(f64, lambda: search(local))
    rows = _device_kernels(prof)
    device_ms = sum(r[0] for r in rows) / 1e3
    for label, res in (("local cold", cold), ("local warm", warm),
                       ("local profiled", profiled)):
        same_answer(f"serverless {label}", (res.ids, res.dists, res.stats),
                    want[0], want[2])
    out["local_f64"] = {"cold": run_trace_summary(cold, cold_s),
                        "warm": run_trace_summary(warm, warm_s),
                        "profiled_warm": {
                            "host_wall_ms": profiled_s * 1e3,
                            "device_kernel_ms": device_ms,
                            "kernel_launches": sum(r[1] for r in rows),
                            "device_ms_per_qp_invocation":
                                device_ms / profiled.trace.invocations("qp"),
                            "device_busy_share_of_warm_wall":
                                device_ms / (warm_s * 1e3),
                            "top_kernels": [
                                {"name": k[:80], "ms": us / 1e3, "count": n}
                                for us, n, k in rows[:6]]},
                        "ids_equal_torch_backend": True,
                        "stats_equal_torch_backend": True,
                        "launches": counts}
    local32 = with_dtype(f32, lambda: ServerlessRuntime(
        index, RuntimeConfig(**SERVERLESS_TOPOLOGY)))
    r32, s32 = with_dtype(f32, lambda: search(local32))
    want32 = search_torch(index, queries, preds, f32)
    out["local_f32"] = {**run_trace_summary(r32, s32),
                        "recall_at_10": recall_at_k(r32.ids, gt),
                        "recall_at_10_torch_backend": recall_at_k(want32[0], gt),
                        "share_ids_equal_torch_backend":
                            float(np.mean(r32.ids == want32[0]))}
    del local, local32
    for name in ("hamming_stacked", "adc_direct"):
        if counts[name] <= 0:
            raise AssertionError(f"serverless: {name} never launched")

    # --- process transport, one QP worker per partition on the card ----
    slab = index.stacked(f64, resolve_device(None)).part(0)
    slab_mb = sum(getattr(slab, f.name).numel()
                  * getattr(slab, f.name).element_size()
                  for f in dataclasses.fields(slab)) / 2**20
    mem0 = gpu_memory_used_mb()
    proc = with_dtype(f64, lambda: ServerlessRuntime(index, RuntimeConfig(
        transport="process", invoke_timeout_s=SERVERLESS_INVOKE_TIMEOUT_S,
        **SERVERLESS_TOPOLOGY)))
    try:
        t0 = time.perf_counter()
        proc.transport                       # bundles built, workers spawned
        spawn_s = time.perf_counter() - t0
        p_cold, p_cold_s = search(proc)
        mem1 = gpu_memory_used_mb()
        p_warm, p_warm_s = search(proc)
        qa_workers = len(proc.transport.worker_pids("qa"))
    finally:
        proc.close()
    for label, res in (("process cold", p_cold), ("process warm", p_warm)):
        same_answer(f"serverless {label}", (res.ids, res.dists, res.stats),
                    cold.ids, cold.stats)
    if p_warm.trace.dre.s3_gets != 0:
        raise AssertionError("serverless process: the warm batch refetched")
    n_qp = len(index.parts)
    out["process_f64"] = {
        "cold": run_trace_summary(p_cold, p_cold_s),
        "warm": run_trace_summary(p_warm, p_warm_s),
        "ids_equal_local": True, "qp_workers": n_qp,
        "qa_workers": qa_workers,
        "spawn_s": spawn_s,
        "worker_startup_s": spawn_s + float(max(
            n.fetch_s for n in p_cold.trace.nodes if n.kind == "qp")),
        "card_memory_added_mb": mem1 - mem0,
        "card_memory_per_qp_worker_mb": (mem1 - mem0) / n_qp,
        "qp_slab_mb": slab_mb,
        "context_per_qp_worker_mb": (mem1 - mem0) / n_qp - slab_mb,
        "invoke_timeout_s": SERVERLESS_INVOKE_TIMEOUT_S}
    emit(out)
    return counts, cold


def gpu_compute_apps() -> dict:
    """pid → MB of card memory, from ``nvidia-smi --query-compute-apps``
    (pids as the driver sees them, which a container may renumber)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout
    rows = {}
    for line in out.splitlines():
        pid, _, mb = line.partition(",")
        if pid.strip().isdigit():
            rows[int(pid)] = float(mb.strip() or 0)
    return rows


def _host_card_bytes(snapshots) -> dict:
    """host:port/pid label → the CUDA bytes its STATS reply reports."""
    return {source: snap.get("gauges", {}).get(
                "host.cuda_memory_allocated_bytes")
            for source, snap in snapshots.items()}


def serverless_socket_phase(index, queries, preds, local_cold, rows):
    """The serverless runtime over the socket transport on Path A's index:
    two auto-spawned loopback hosts serve the 10 QP links on the card (one
    CUDA context per host) and the 2 QA links. The cold and warm batches'
    f64 ids, dists and stats must equal the local run's cold batch, the warm
    batch must fetch nothing and every QP node names its host:port; then
    ``qp:0``'s connection is dropped and one more batch must still be
    equal, with ``qp:0`` cold again. Observability is on, so that each
    host answers the STATS pull, whose ``host.cuda_memory_allocated_bytes``
    gauge shows every host holding card memory (and the memory after the
    reconnect, when the old link's slab must be gone)."""
    import numpy as np
    import torch

    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serverless import RuntimeConfig, ServerlessRuntime

    f64 = torch.float64
    out = {"phase": "serverless_socket", "rows": int(rows),
           "P": len(index.parts), "Q": int(queries.shape[0]), "k": K,
           **SERVERLESS_TOPOLOGY}
    want = (local_cold.ids, local_cold.dists, local_cold.stats)

    def search(rt):
        t0 = time.perf_counter()
        res = rt.search(queries, preds, k=K)
        return res, time.perf_counter() - t0

    def check(label, res):
        same_answer(f"serverless socket {label}",
                    (res.ids, res.dists, res.stats), want[0], want[2])
        if not np.array_equal(res.dists, want[1]):
            raise AssertionError(f"serverless socket {label}: dists differ")
        qp = [n for n in res.trace.nodes if n.kind == "qp"]
        if not qp or not all(n.worker_host for n in qp):
            raise AssertionError(f"serverless socket {label}: a QP node "
                                 "names no host")

    mem0, apps0 = gpu_memory_used_mb(), gpu_compute_apps()
    t0 = time.perf_counter()
    rt = with_dtype(f64, lambda: ServerlessRuntime(index, RuntimeConfig(
        transport="socket", invoke_timeout_s=SERVERLESS_INVOKE_TIMEOUT_S,
        obs_enabled=True, **SERVERLESS_TOPOLOGY)))
    try:
        transport = rt.transport          # bundles built, hosts up, deployed
        startup_s = time.perf_counter() - t0
        cold, cold_s = search(rt)
        mem1, apps1 = gpu_memory_used_mb(), gpu_compute_apps()
        warm, warm_s = search(rt)
        card_bytes = _host_card_bytes(transport.collect_metrics())
        qp0_host = transport.worker_hosts("qp:0")[0]
        transport.drop_connection("qp:0")
        again, again_s = search(rt)
        card_bytes_after = _host_card_bytes(transport.collect_metrics())
        counters = {name: v for name, v in
                    REGISTRY.fleet_snapshot()["merged"]["counters"].items()
                    if name.startswith("transport.socket.")}
    finally:
        rt.close()
        REGISTRY.disable()
        REGISTRY.reset()
    for label, res in (("cold", cold), ("warm", warm), ("after drop", again)):
        check(label, res)
    if rt.device.type != "cuda":
        raise AssertionError("serverless socket: QP links not on the card")
    if warm.trace.dre.s3_gets != 0:
        raise AssertionError("serverless socket: the warm batch refetched")
    if not any(n.node == "qp:0" and not n.warm for n in again.trace.nodes):
        raise AssertionError("serverless socket: qp:0 is not cold after its "
                             "connection was dropped")
    host_pids = sorted({n.worker_pid for n in cold.trace.nodes
                        if n.kind in ("qa", "qp")})
    if len(card_bytes) != len(host_pids) or not all(
            (b or 0) > 0 for b in card_bytes.values()):
        raise AssertionError(f"serverless socket: a host holds no card "
                             f"memory: {card_bytes}")
    n_qp = len(index.parts)
    added = mem1 - mem0
    qp_ms = [n.wall_compute_s * 1e3 for n in cold.trace.nodes
             if n.kind == "qp"]
    out["socket_f64"] = {
        "cold": run_trace_summary(cold, cold_s),
        "warm": run_trace_summary(warm, warm_s),
        "after_drop_qp0": {**run_trace_summary(again, again_s),
                           "worker_retries": again.trace.worker_retries},
        "ids_dists_stats_equal_local": True,
        "hosts": len(host_pids),
        "startup_s": startup_s,
        "host_spawn_s": transport.spawn_s,
        "deploy_s": transport.deploy_s,
        "cold_worker_retries": cold.trace.worker_retries,
        "qp_handler_ms_sum_cold": float(sum(qp_ms)),
        "card_memory_added_mb": added,
        "card_memory_per_host_mb": added / len(host_pids),
        "card_memory_per_qp_link_mb": added / n_qp,
        "compute_apps_before": apps0,
        "compute_apps_after": apps1,
        "host_pids": host_pids,
        "host_pids_in_compute_apps": sorted(set(host_pids) & set(apps1)),
        "host_cuda_allocated_mb": {k: v / 2**20
                                   for k, v in card_bytes.items()},
        "host_cuda_allocated_mb_after_qp0_reconnect": {
            k: (v or 0) / 2**20 for k, v in card_bytes_after.items()},
        "qp0_host": qp0_host,
        "transport_socket_counters": counters,
        "invoke_timeout_s": SERVERLESS_INVOKE_TIMEOUT_S}
    emit(out)


def mesh_phase(index_a, index_b, queries, preds):
    """``repro_torch.core.distributed.distributed_search`` on a 1 × 1 NCCL
    mesh on the card (its process group on a free loopback port, destroyed
    after): on Path A (kernels 1 and 2b) and Path B (kernels 1 and 2), in
    f64, ids and dists must equal ``index.search(backend="torch")``. The
    counts are set to 0 just before each mesh search and read just after;
    returns their sum over both paths."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.distributed import distributed_search
    from repro_torch.kernels import ops

    f64 = torch.float64
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    out = {"phase": "mesh", "mesh": [1, 1], "backend": dist.get_backend(),
           "Q": int(queries.shape[0]), "k": K}
    total = None
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        def timed(fn):
            t0 = time.perf_counter()
            res = fn()
            return res, (time.perf_counter() - t0) * 1e3

        for name, index, stage4 in (("path_a", index_a, "adc_direct"),
                                    ("path_b", index_b, "adc_batch")):
            want, torch_ms = timed(
                lambda: search_torch(index, queries, preds, f64))
            ops.reset_launch_counts()
            (ids, dists), mesh_ms = timed(lambda: with_dtype(
                f64, lambda: distributed_search(index, queries, preds, K,
                                                mesh=mesh)))
            counts = ops.launch_counts()
            # Once more each, in turns: the first mesh call of the run also
            # opens the NCCL communicator.
            again, mesh_ms2 = timed(lambda: with_dtype(
                f64, lambda: distributed_search(index, queries, preds, K,
                                                mesh=mesh)))
            _, torch_ms2 = timed(
                lambda: search_torch(index, queries, preds, f64))
            for got in ((ids, dists), again):
                if not (np.array_equal(got[0], want[0])
                        and np.array_equal(got[1], want[1])):
                    raise AssertionError(f"mesh {name}: ids or dists differ "
                                         "from the torch backend's")
            for kernel in ("hamming_stacked", stage4):
                if counts[kernel] <= 0:
                    raise AssertionError(f"mesh {name}: {kernel} never "
                                         "launched")
            total = counts if total is None else {
                k: total[k] + counts[k] for k in total}
            out[name] = {"batch_wall_ms": [mesh_ms, mesh_ms2],
                         "torch_backend_batch_wall_ms": [torch_ms, torch_ms2],
                         "ids_dists_equal_torch_backend": True,
                         "launches": counts}
    finally:
        dist.destroy_process_group()
    emit(out)
    return total


def live_phase(index, queries, preds):
    """Path B's index wrapped in a LiveIndex: 10,000 inserted rows from the
    dataset generator at another seed, 1 % of all ids deleted; the card's
    f64 ids equal NumPy's and no tombstoned id comes back; a drop-only
    compaction is bitwise invisible (ids and stats); a requantizing one
    keeps the stats, with ids equal on both backends; a local serverless
    runtime drained across the mutations equals the torch backend
    throughout. Returns the kernel launches of the phase."""
    import numpy as np
    import torch

    from repro_torch.core.live import LiveIndex
    from repro_torch.core.pipeline import resolve_device
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.serverless import RuntimeConfig, ServerlessRuntime

    f64, cuda = torch.float64, resolve_device(None)
    n0 = index.partitioning.assign.shape[0]
    extra = synthetic.make_vector_dataset(
        "sift1m", scale=LIVE_INSERTS / synthetic.DATASET_PRESETS["sift1m"]["n"],
        num_queries=1, seed=LIVE_INSERT_SEED)
    out = {"phase": "live", "rows": int(n0), "M+1": int(max(
        pt.quant.boundaries.shape[0] for pt in index.parts)),
        "inserts": int(extra.n), "insert_seed": LIVE_INSERT_SEED}

    def torch_search():
        return search_torch(index, queries, preds, f64)

    live = LiveIndex(index)
    rt = with_dtype(f64, lambda: ServerlessRuntime(
        live, RuntimeConfig(**SERVERLESS_TOPOLOGY)))

    def runtime_matches(label, want):
        res = with_dtype(f64, lambda: rt.search(queries, preds, k=K))
        same_answer(f"live runtime {label}", (res.ids, res.dists, res.stats),
                    want[0], want[2])

    ops.reset_launch_counts()
    runtime_matches("before mutation", torch_search())

    t0 = time.perf_counter()
    new_ids = live.insert(extra.vectors, extra.attributes)
    out["insert_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(LIVE_INSERT_SEED)
    n1 = index.partitioning.assign.shape[0]
    victims = rng.choice(n1, size=int(LIVE_DELETE_SHARE * n1), replace=False)
    t0 = time.perf_counter()
    deleted = live.delete(victims)
    out["delete_s"] = time.perf_counter() - t0
    out.update(deleted=deleted, inserted_ids=[int(new_ids[0]),
                                              int(new_ids[-1])])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.stacked(f64, cuda)
    torch.cuda.synchronize()
    out["restack_f64_s"] = time.perf_counter() - t0
    out["restacked_rows"] = int(sum(pt.size for pt in index.parts))

    during = torch_search()
    t0 = time.perf_counter()
    during_np = index.search(queries, preds, k=K, backend="numpy")
    out["numpy_search_s"] = time.perf_counter() - t0
    same_answer("live tombstone phase (torch vs numpy)", during,
                during_np[0], during_np[2])
    dead = np.intersect1d(during[0].ravel(), victims)
    if dead.size:
        raise AssertionError(f"live: tombstoned ids came back: {dead[:10]}")
    runtime_matches("tombstone phase", during)
    out["new_ids_returned"] = int(np.isin(during[0], new_ids).sum())

    dirty = live.dirty_partitions()
    if len(dirty) < 2:
        raise AssertionError(f"live: {len(dirty)} dirty partitions, not two")
    pid_drop, pid_req = dirty[0], dirty[-1]
    t0 = time.perf_counter()
    live.compact(pid_drop, requantize=False)
    out["compact_drop_s"] = time.perf_counter() - t0
    after_drop = torch_search()
    same_answer("live drop-only compaction", after_drop, during[0], during[2])
    t0 = time.perf_counter()
    live.compact(pid_req, requantize=True)
    out["compact_requantize_s"] = time.perf_counter() - t0
    after_req = torch_search()
    after_req_np = index.search(queries, preds, k=K, backend="numpy")
    same_answer("live requantized compaction (torch vs numpy)", after_req,
                after_req_np[0], after_req_np[2])
    if after_req[2] != during[2]:
        raise AssertionError("live: requantized compaction changed the "
                             "SearchStats")
    if np.intersect1d(after_req[0].ravel(), victims).size:
        raise AssertionError("live: tombstoned ids came back after "
                             "compaction")
    runtime_matches("after compaction", after_req)
    counts = ops.launch_counts()
    out.update(
        compacted={"drop_only": int(pid_drop), "requantized": int(pid_req)},
        dirty_after=list(live.dirty_partitions()),
        generations=list(live.generations), version=live.version,
        share_ids_unchanged_by_requantize=float(np.mean(
            after_req[0] == during[0])),
        ids_equal_numpy=True, drop_only_bitwise_invisible=True,
        runtime_equal_torch_backend=True, launches=counts)
    emit(out)
    for name in ("hamming_stacked", "adc_batch"):
        if counts[name] <= 0:
            raise AssertionError(f"live: {name} never launched")
    return counts


# --------------------------------------------------------- language model

def _first_divergence(a, b):
    """[request, token] of the first differing token, or None."""
    import numpy as np

    idx = np.argwhere(a != b)
    return idx[0].tolist() if idx.size else None


def lm_check(prompt_len: int = 512, new_tokens: int = 8):
    """The full-size model on the CPU (plain versions) and on the card;
    returns the card's model."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model_cpu = T.init_params(cfg, seed=0, device="cpu")
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, prompt_len), dtype=np.int32)
    tokens = torch.from_numpy(prompts).long()

    t0 = time.perf_counter()
    logits_c, caches_c = model_cpu.prefill(tokens)
    cpu_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits_g, caches_g = model_gpu.prefill(tokens.cuda())
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    prefill_launches = ops.launch_counts()["ssd_intra"]

    # Control: the card's prefill again with TF32 matrix products (about 3
    # decimal digits). The tolerance must tell it from the f32 run.
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        logits_t, caches_t = model_gpu.prefill(tokens.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    result = {"phase": "lm_check", "arch": cfg.name,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "chunk": cfg.ssm_chunk,
              "prompt_len": prompt_len, "init_s": init_s,
              "cpu_prefill_s": cpu_s, "card_prefill_s": gpu_s,
              "ssd_intra_launches_per_prefill": prefill_launches,
              "tolerance": f"max |card - cpu| <= {LM_TOL} * max |cpu|"}
    ok, caught = True, False
    for name, c, g, t in (
            ("logits", logits_c, logits_g, logits_t),
            ("ssm_states", caches_c["blocks"]["state"],
             caches_g["blocks"]["state"], caches_t["blocks"]["state"]),
            ("conv_caches", caches_c["blocks"]["conv"],
             caches_g["blocks"]["conv"], caches_t["blocks"]["conv"])):
        g, t = g.cpu(), t.cpu()
        err = float((g - c).abs().max())
        err_t = float((t - c).abs().max())
        scale = float(c.abs().max())
        finite = bool(torch.isfinite(g).all())
        result[f"{name}_max_abs_err"] = err
        result[f"{name}_max_abs"] = scale
        result[f"{name}_rel_err"] = err / scale
        result[f"{name}_tf32_control_rel_err"] = err_t / scale
        ok = ok and finite and err <= LM_TOL * scale
        caught = caught or err_t > LM_TOL * scale
    del caches_c, caches_g, caches_t

    eng_c = Engine(cfg, model_cpu, ServeConfig(max_new_tokens=new_tokens),
                   device="cpu")
    eng_g = Engine(cfg, model_gpu, ServeConfig(max_new_tokens=new_tokens))
    out_c = eng_c.generate(prompts)
    ops.reset_launch_counts()
    out_g = eng_g.generate(prompts)
    gen_launches = ops.launch_counts()["ssd_intra"]
    result.update({
        "new_tokens": new_tokens, "tokens_cpu": out_c.tolist(),
        "tokens_card": out_g.tolist(),
        "token_agreement": float(np.mean(out_c == out_g)),
        "first_divergence": _first_divergence(out_c, out_g),
        "ssd_intra_launches_per_generate": gen_launches})
    emit(result)
    if not ok:
        raise AssertionError("lm_check: card and CPU prefill disagree beyond "
                             f"{LM_TOL} of the largest magnitude")
    if not caught:
        raise AssertionError(f"lm_check: a tolerance of {LM_TOL} does not tell "
                             "the card's TF32 prefill from its f32 prefill")
    if prefill_launches != cfg.num_layers or gen_launches != cfg.num_layers:
        raise AssertionError(
            f"lm_check: ssd_intra launched {prefill_launches} / {gen_launches} "
            f"times per prefill, expected {cfg.num_layers} (one per layer)")
    return model_gpu


def _device_kernels(prof):
    """(device µs, launches, name) of each CUDA kernel in a profile."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def _split(rows):
    """Device ms by class: matrix products (cuBLAS / CUTLASS GEMMs), kernel
    6, and elementwise passes and copies (everything else), with the share
    of the last in PyTorch's non-vectorized (strided) elementwise kernel."""
    out = {"matrix_products": 0.0, "ssd_intra": 0.0,
           "elementwise_and_copies": 0.0, "of_which_strided_elementwise": 0.0}
    for us, _, name in rows:
        low = name.lower()
        if "ssd_intra" in low:
            out["ssd_intra"] += us / 1e3
        elif any(k in low for k in ("gemm", "gemv", "cutlass", "xmma",
                                    "cublas")):
            out["matrix_products"] += us / 1e3
        else:
            out["elementwise_and_copies"] += us / 1e3
            if name.startswith("void at::native::elementwise_kernel"):
                out["of_which_strided_elementwise"] += us / 1e3
    return out


def lm_profile(model, requests: int, prompt_len: int):
    """Device time by kernel of one prefill and of one decode step at the
    serve shape (``torch.profiler``), beside their host-clock times."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (requests, prompt_len))).cuda()
    buf_len = prompt_len + 1
    logits, caches = model.prefill(tokens, buf_len=buf_len)  # warm-up
    model.decode_step(logits[:, 0].argmax(-1)[:, None], caches, prompt_len)
    result = {"phase": "lm_profile", "arch": model.cfg.name,
              "requests": requests, "prompt_len": prompt_len}
    for step in ("prefill", "decode_step"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if step == "prefill":
                logits, caches = model.prefill(tokens, buf_len=buf_len)
            else:
                model.decode_step(logits[:, 0].argmax(-1)[:, None], caches,
                                  prompt_len)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _device_kernels(prof)
        result[step] = {
            "host_wall_ms": wall_ms,
            "device_kernel_ms": sum(r[0] for r in rows) / 1e3,
            "kernel_launches": sum(r[1] for r in rows),
            "split_ms": _split(rows),
            "top_kernels": [{"name": k[:100], "ms": us / 1e3, "count": n}
                            for us, n, k in rows[:12]]}
    emit(result)


def lm_serve(requests: int, prompt_len: int, new_tokens: int):
    """``launch.serve``'s path on the card; returns the launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    vocab = get_config(LM_ARCH).vocab_size
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = launch_serve.serve(LM_ARCH, requests=requests, prompt_len=prompt_len,
                             new_tokens=new_tokens, device="cuda", seed=0)
    counts = ops.launch_counts()
    out = rep.pop("tokens")
    rep.update({"phase": "lm_serve", "launches": counts,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "tokens_shape": list(out.shape),
                "tokens_in_vocab": bool(((out >= 0) & (out < vocab)).all()),
                "sample_continuation": out[0][:12].tolist()})
    emit(rep)
    if out.shape != (requests, new_tokens) or not rep["tokens_in_vocab"]:
        raise AssertionError("lm_serve: malformed generated tokens")
    if counts["ssd_intra"] <= 0:
        raise AssertionError("lm_serve: ssd_intra never launched")
    return counts


# Every LM family of the port at full width and cut depth (layers), the
# depth the smallest that keeps the schedule: one 5+1 local:global unit and
# a local tail for gemma3, one unit of 6 Mamba2 blocks + the shared block
# and a Mamba2 tail for zamba2.
LM_FAMILIES = (("llama3-8b", 2), ("granite-20b", 2), ("phi4-mini-3.8b", 2),
               ("gemma3-4b", 7), ("qwen2-vl-2b", 2), ("musicgen-large", 2),
               ("deepseek-v2-lite-16b", 2), ("zamba2-7b", 7))
FAMILY_PROMPT, FAMILY_NEW_TOKENS = 512, 8
GEMMA3_PROMPT = 1280          # > the 1,024-token ring: it wraps in prefill
LLAMA3_SERVE = "llama3-8b"


def _cache_leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _cache_leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _cut(full, run) -> dict:
    """The config fields a run changed: {field: [published, run]}."""
    a, b = dataclasses.asdict(full), dataclasses.asdict(run)
    return {k: [a[k], b[k]] for k in a if a[k] != b[k]}


def card_and_cpu_models(cfg):
    """``cfg``'s model with weights from seed 0 drawn on the card (seconds,
    where the CPU takes a minute for the LM families' ~11 B parameters)
    and a copy of it on the CPU: (card model, CPU model, draw s, copy s)."""
    import torch

    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    model_gpu = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model_cpu = copy.deepcopy(model_gpu).cpu()
    return model_gpu, model_cpu, init_s, time.perf_counter() - t0


def family_check(cfg, full_cfg, prompt_len: int, new_tokens: int):
    """One config at ``cfg``'s size on the CPU (plain versions) and on the
    card: prefill logits and every cache leaf within ``LM_TOL`` of their
    largest magnitude, a TF32 control prefill (reported), then greedy
    tokens through ``Engine.generate`` on both. Returns the card's kernel
    6 launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, ServeConfig

    rng = np.random.default_rng(0)
    shape = ((1, cfg.num_codebooks, prompt_len) if cfg.num_codebooks
             else (1, prompt_len))
    prompts = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
    embeds = (rng.normal(size=(1, cfg.vlm_num_patches, cfg.d_model))
              .astype(np.float32) if cfg.mrope else None)
    prefix = cfg.vlm_num_patches if cfg.mrope else 0
    buf_len = prefix + prompt_len + new_tokens
    model_gpu, model_cpu, init_s, copy_s = card_and_cpu_models(cfg)
    tokens = torch.from_numpy(prompts).long()
    emb = None if embeds is None else torch.from_numpy(embeds)

    def on_card():
        return model_gpu.prefill(tokens.cuda(), buf_len=buf_len,
                                 embeds=None if emb is None else emb.cuda())

    t0 = time.perf_counter()
    logits_c, caches_c = model_cpu.prefill(tokens, buf_len=buf_len,
                                           embeds=emb)
    cpu_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits_g, caches_g = on_card()
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = ops.launch_counts()["ssd_intra"]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        logits_t, caches_t = on_card()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    result = {"phase": "lm_families", "arch": cfg.name,
              "params": sum(p.numel() for p in model_cpu.parameters()),
              "cut": _cut(full_cfg, cfg), "prompt_len": prompt_len,
              "embeds": None if embeds is None else list(embeds.shape),
              "buf_len": buf_len, "init_card_s": init_s, "to_cpu_s": copy_s,
              "cpu_prefill_s": cpu_s, "card_prefill_s": gpu_s,
              "ssd_intra_launches_per_prefill": launches,
              "tolerance": f"max |card - cpu| <= {LM_TOL} * max |cpu|"}
    worst, worst_t = 0.0, 0.0
    pairs = [("logits", logits_c, logits_g, logits_t)]
    card, control = dict(_cache_leaves(caches_g)), dict(_cache_leaves(caches_t))
    pairs += [(f"cache.{k}", v, card[k], control[k])
              for k, v in _cache_leaves(caches_c)]
    errs = {}
    ok = True
    for name, c, g, t in pairs:
        if c.numel() == 0:
            continue
        g, t = g.cpu(), t.cpu()
        scale = float(c.abs().max()) or 1.0
        rel = float((g - c).abs().max()) / scale
        rel_t = float((t - c).abs().max()) / scale
        errs[name] = {"rel_err": rel, "tf32_control_rel_err": rel_t,
                      "max_abs": scale}
        ok = ok and bool(torch.isfinite(g).all()) and rel <= LM_TOL
        worst, worst_t = max(worst, rel), max(worst_t, rel_t)
    result.update({"rel_err": errs, "worst_rel_err": worst,
                   "worst_tf32_control_rel_err": worst_t})
    del caches_c, caches_g, caches_t, logits_t

    sc = ServeConfig(max_new_tokens=new_tokens)
    out_c = Engine(cfg, model_cpu, sc, device="cpu").generate(
        prompts, embeds=embeds)
    ops.reset_launch_counts()
    out_g = Engine(cfg, model_gpu, sc).generate(prompts, embeds=embeds)
    launches += ops.launch_counts()["ssd_intra"]
    result.update({"new_tokens": new_tokens, "tokens_shape": list(out_g.shape),
                   "token_agreement": float(np.mean(out_c == out_g)),
                   "first_divergence": _first_divergence(out_c, out_g),
                   "ssd_intra_launches": launches})
    emit(result)
    del model_cpu, model_gpu
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"lm_families: {cfg.name} card and CPU prefill "
                             f"disagree beyond {LM_TOL} of the largest "
                             f"magnitude (worst {worst})")
    return launches


def lm_families():
    """Each LM family at full width and cut depth (arctic-480b at its
    reduced size: one full-width layer alone is 53.5 GB of f32 experts),
    card against CPU. Returns zamba2's kernel 6 launches and its shape."""
    from repro_torch.configs import get_config

    zamba = None
    for name, layers in LM_FAMILIES:
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=layers)
        prompt = GEMMA3_PROMPT if name == "gemma3-4b" else FAMILY_PROMPT
        launches = family_check(cfg, full, prompt, FAMILY_NEW_TOKENS)
        if name == "zamba2-7b":
            heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
            shape = (-(-prompt // cfg.ssm_chunk), heads, cfg.ssm_chunk,
                     cfg.ssm_state, cfg.ssm_headdim)
            zamba = (launches, shape)
        elif launches:
            raise AssertionError(f"lm_families: {name} launched kernel 6")
    full = get_config("arctic-480b")
    family_check(full.reduced(), full, FAMILY_PROMPT, FAMILY_NEW_TOKENS)
    if not zamba[0]:
        raise AssertionError("lm_families: ssd_intra never launched on the "
                             "zamba2-7b path")
    return zamba


def lm_serve_llama3(requests: int, prompt_len: int, new_tokens: int):
    """``launch.serve``'s path for llama3-8b at full size (32 layers, 8.03 B
    parameters drawn on the card), once with the fp KV cache and once with
    the 8-bit OSQ-packed one."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as T

    vocab = get_config(LLAMA3_SERVE).vocab_size
    tokens = {}
    for bits in (0, 8):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = launch_serve.serve(LLAMA3_SERVE, requests=requests,
                                 prompt_len=prompt_len, new_tokens=new_tokens,
                                 kv_bits=bits, device="cuda", seed=0)
        total_s = time.perf_counter() - t0
        out = tokens[bits] = rep.pop("tokens")
        rep.update({"phase": "lm_serve_llama3", "total_s": total_s,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "tokens_shape": list(out.shape),
                    "tokens_in_vocab": bool(((out >= 0) & (out < vocab))
                                            .all()),
                    "sample_continuation": out[0][:12].tolist()})
        emit(rep)
        gc.collect()
        torch.cuda.empty_cache()
        if out.shape != (requests, new_tokens) or not rep["tokens_in_vocab"]:
            raise AssertionError("lm_serve_llama3: malformed generated tokens")
        if bits and not rep["cache_bytes_packed"] * 32 // bits == \
                rep["cache_bytes_fp"]:
            raise AssertionError("lm_serve_llama3: the packed KV cache is not "
                                 f"{bits}/32 of the fp cache")
    emit({"phase": "lm_serve_llama3_agreement",
          "token_agreement_kv8_vs_fp": float(np.mean(tokens[0] == tokens[8])),
          "first_divergence": _first_divergence(tokens[0], tokens[8])})
    model = T.init_params(get_config(LLAMA3_SERVE), seed=0, device="cuda")
    lm_profile(model, requests, prompt_len)
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- training

TRAIN_LR = 3e-4               # AdamWConfig's default
# Gradients, card vs CPU, of the largest CPU magnitude of each leaf. At
# mamba2-370m's 48 layers the CPU's own float32 gradients lie up to 7.3e-3
# of a leaf's largest magnitude from float64 ones, and the card's 8.4e-3
# (tools/train_precision.py, on one H100), so LM_TOL is below the float32
# floor: two float32 runs may differ by about the sum of the two. A
# gradient cut from kernel 6 misses the mixer's by 1.1.
TRAIN_GRAD_TOL = 2e-2
TRAIN_CHECK_SHAPE = (2, 512)  # card vs CPU, one step
TRAIN_RUN = dict(steps=6, batch=16, seq=4096, accum=2)
LLAMA3_TRAIN_CHECK, LLAMA3_TRAIN_TIMED = (1, 512), (4, 2048)
LLAMA3_TRAIN_STEPS = 4
RESUME_BATCH = (4, 4096)      # the step after a checkpoint's restore
MIXER_GRADS = ("A_log", "dt_bias", "conv_w", "in_z", "in_xbc", "in_dt")


def one_step_check(phase, cfg, model_gpu, model_cpu, shape, extra=None):
    """One train step on the CPU and one on the card from the same weights
    (``model_cpu`` a copy of ``model_gpu``),
    zero optimizer state and seeded batch: loss, ce and grad norm within
    ``LM_TOL`` relative, every parameter's gradient within
    ``TRAIN_GRAD_TOL`` of its largest magnitude, every updated parameter
    within ``2 · lr``
    (Adam's first step moves an element by ``lr · g/(|g| + eps)``, up to
    ``lr`` either way: a gradient that is 0 up to rounding may take either
    sign on the two sides). Returns the card's model, the CPU's gradients,
    the result and whether every check held."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    batch = make_batch(cfg, *shape, 0, "cpu")
    batch_g = {k: v.cuda() for k, v in batch.items()}
    opt = AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(cfg, opt)
    result = {"phase": phase, "arch": cfg.name,
              "params": sum(p.numel() for p in model_cpu.parameters()),
              "batch": list(shape),
              "tolerance": f"loss, ce and grad norm: |card - cpu| <= "
              f"{LM_TOL} * |cpu|; each gradient: max |card - cpu| <= "
              f"{TRAIN_GRAD_TOL} * max |cpu| (the float32 floor at depth: "
              f"see TRAIN_GRAD_TOL); updated parameters: max "
              f"|card - cpu| <= 2 * lr = {2 * TRAIN_LR} (Adam's first step "
              f"moves an element by lr * g / (|g| + eps), up to lr either "
              f"way, so a gradient that is 0 up to rounding may take either "
              f"sign on the two sides)", **(extra or {})}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m_c = step(model_cpu, adamw_init(dict(model_cpu.named_parameters()), opt),
               batch)
    result["cpu_step_s"] = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m_g = step(model_gpu, adamw_init(dict(model_gpu.named_parameters()), opt),
               batch_g)
    torch.cuda.synchronize()
    result["card_step_s"] = time.perf_counter() - t0
    result["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result["ssd_intra_launches"] = ops.launch_counts()["ssd_intra"]
    ok = True
    for key in ("loss", "ce", "grad_norm"):
        c, g = float(m_c[key]), float(m_g[key])
        result[key] = {"cpu": c, "card": g, "rel_err": abs(g - c) / abs(c)}
        ok = ok and math.isfinite(g) and abs(g - c) <= LM_TOL * abs(c)
    grads_c = {name: p.grad for name, p in model_cpu.named_parameters()}
    worst, worst_name, worst_mixer = 0.0, None, 0.0
    for (name, p_c), p_g in zip(model_cpu.named_parameters(),
                                model_gpu.parameters()):
        g_c = grads_c[name]
        g_g = p_g.grad.detach().cpu()
        rel = float((g_g - g_c).abs().max()) / (float(g_c.abs().max())
                                                or 1.0)
        ok = ok and bool(torch.isfinite(g_g).all()) and rel <= TRAIN_GRAD_TOL
        if rel > worst:
            worst, worst_name = rel, name
        if any(f".{k}" in name for k in MIXER_GRADS):
            worst_mixer = max(worst_mixer, rel)
    upd = max(float((p_g.detach().cpu() - p_c.detach()).abs().max())
              for p_c, p_g in zip(model_cpu.parameters(),
                                  model_gpu.parameters()))
    ok = ok and upd <= 2 * TRAIN_LR
    result.update({"worst_grad_rel_err": worst, "worst_grad": worst_name,
                   "updated_params_max_abs_diff": upd})
    if cfg.family in ("ssm", "hybrid"):
        result["mixer_grads_worst_rel_err"] = worst_mixer
    return model_gpu, grads_c, result, ok


def train_check():
    """mamba2-370m at full size: one train step on the CPU and on the card
    (``one_step_check``), then a control: the card's gradients with kernel
    6's output cut from the graph (its state before the autograd
    Function) must differ from the CPU's beyond the tolerance in the
    mixer's parameters."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ssd
    from repro_torch.launch.train import make_batch
    from repro_torch.train import loss_fn

    cfg = get_config(LM_ARCH)
    model_gpu, model_cpu, init_s, copy_s = card_and_cpu_models(cfg)
    control = copy.deepcopy(model_gpu)
    model_gpu, grads_c, result, ok = one_step_check(
        "train_check", cfg, model_gpu, model_cpu, TRAIN_CHECK_SHAPE,
        {"init_card_s": init_s, "to_cpu_s": copy_s})
    del model_gpu, model_cpu
    # The control: kernel 6's output as it was before its autograd Function
    # (no grad_fn) in a forward and backward on the card.
    kernel_with_grad = ops.ssd_intra
    ops.ssd_intra = ssd.ssd_intra
    try:
        batch = make_batch(cfg, *TRAIN_CHECK_SHAPE, 0, "cuda")
        loss_fn(control, batch, cfg)[0].backward()
    finally:
        ops.ssd_intra = kernel_with_grad
    worst = 0.0
    for name, p in control.named_parameters():
        if any(f".{k}" in name for k in MIXER_GRADS):
            g_c = grads_c[name]
            worst = max(worst, float((p.grad.cpu() - g_c).abs().max())
                        / (float(g_c.abs().max()) or 1.0))
    result["control_without_grad_fn_mixer_rel_err"] = worst
    emit(result)
    del control
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("train_check: the card's step disagrees with "
                             "the CPU's beyond the tolerance")
    if worst <= TRAIN_GRAD_TOL:
        raise AssertionError("train_check: cutting kernel 6's gradient does "
                             "not move the mixer's gradients past the "
                             "tolerance; the check cannot see that fault")
    if result["ssd_intra_launches"] != 2 * cfg.num_layers:
        raise AssertionError(
            f"train_check: kernel 6 launched {result['ssd_intra_launches']} "
            f"times in a step, expected {2 * cfg.num_layers} (forward and "
            "recompute of each layer)")


def ssd_grad():
    """Kernel 6's autograd Function at the training shape (8 × 4,096
    tokens: G = 128) on the strided views ``ssd_chunked`` passes, against
    plain autograd of the plain version: dC, dB, d(da), dx; the forward
    kernel's and the plain backward's device times."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, ssd

    cfg = get_config(LM_ARCH)
    h = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    lc, nst, pd = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_headdim
    g = TRAIN_RUN["batch"] // TRAIN_RUN["accum"] * TRAIN_RUN["seq"] // lc
    d_inner = h * pd
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = torch.randn((g, lc, d_inner + 2 * nst), device="cuda",
                       generator=gen).requires_grad_()
    da_l = (-torch.empty((g, lc, h), device="cuda").exponential_(
        generator=gen)).requires_grad_()
    x_l = torch.randn((g, lc, h, pd), device="cuda",
                      generator=gen).requires_grad_()
    dy = torch.randn((g, h, lc, pd), device="cuda", generator=gen)
    views = ssd_views(conv, da_l, x_l, nst)
    got = torch.autograd.grad(ssd.ssd_intra_autograd(*views),
                              (conv, da_l, x_l), dy)
    want = torch.autograd.grad(ref.ssd_intra_ref(*views), (conv, da_l, x_l),
                               dy)
    parts = {"dC": (got[0][..., d_inner + nst:], want[0][..., d_inner + nst:]),
             "dB": (got[0][..., d_inner:d_inner + nst],
                    want[0][..., d_inner:d_inner + nst]),
             "d(da)": (got[1], want[1]), "dx": (got[2], want[2])}
    errs = {}
    for name, (a, b) in parts.items():
        scale = float(b.abs().max())
        errs[name] = {"max_abs_err": float((a - b).abs().max()),
                      "max_abs_ref": scale}
        torch.testing.assert_close(a, b, rtol=SSD_GRAD_RTOL,
                                   atol=SSD_GRAD_ATOL_SCALE * scale,
                                   msg=f"ssd_grad {name}")
    del got, want
    vjp_in = [t.detach() for t in views]
    pairs = lc * (lc + 1) // 2
    # What the backward must move and compute: read C, B, da, x and dy,
    # write dC, dB, d(da) and dx; per causal pair the score (2N) and its
    # two gradient products (2N each, once per g), and per head and pair
    # dM (2P), dx (2P), the decay and its gradient (~8 f32 operations).
    nbytes = 4 * (4 * g * lc * nst + 2 * g * h * lc + 3 * g * h * lc * pd)
    ops_ = g * pairs * (6 * nst + h * (4 * pd + 8))
    b_ms, b_by = bound(nbytes, ops_)
    result = {
        "phase": "ssd_grad", "shape": {"G": g, "H": h, "lc": lc, "N": nst,
                                       "P": pd},
        "tolerance": f"rtol={SSD_GRAD_RTOL}, atol={SSD_GRAD_ATOL_SCALE} * "
        "max |grad| (f32 sums of up to lc * max(N, P) products in another "
        "order; d(da) a reverse cumulative sum of sums that cancel)",
        "grads": errs,
        "forward_kernel_ms": device_ms(lambda: ssd.ssd_intra(*vjp_in), 10),
        "backward_ms": device_ms(
            lambda: ref.ssd_intra_vjp(*vjp_in, dy), 3),
        "backward_bound_ms": b_ms, "backward_bound_by": b_by,
        "backward_bytes": nbytes, "backward_f32_ops": ops_,
        "plain_forward_ms": cuda_ms(lambda: ref.ssd_intra_ref(*vjp_in), 3)}
    emit(result)
    del conv, da_l, x_l, dy, views, vjp_in
    torch.cuda.empty_cache()
    return result


def _train_profile(model, state, batch, step):
    """Device time of one train step by class (``torch.profiler``): matrix
    products, kernel 6, elementwise passes and copies; and, inside those,
    the ranges of kernel 6's plain backward and of the AdamW pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ref
    from repro_torch.train import steps as train_steps

    vjp, update = ref.ssd_intra_vjp, train_steps.adamw_update

    def vjp_ranged(*a):
        with record_function("ssd_intra_backward"):
            return vjp(*a)

    def update_ranged(*a, **kw):
        with record_function("adamw_update"):
            return update(*a, **kw)

    ref.ssd_intra_vjp, train_steps.adamw_update = vjp_ranged, update_ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(model, state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ref.ssd_intra_vjp, train_steps.adamw_update = vjp, update
    ranges = {"ssd_intra_backward": 0.0, "adamw_update": 0.0}
    rows = [r for r in _device_kernels(prof) if r[2] not in ranges]
    for ev in prof.events():
        if ev.name in ranges and str(ev.device_type).endswith("CPU"):
            ranges[ev.name] += ev.device_time_total / 1e3
    kernel_ms = sum(r[0] for r in rows) / 1e3
    return {"host_wall_ms": wall_ms, "device_kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall_ms,
            "kernel_launches": sum(r[1] for r in rows),
            "split_ms": _split(rows),
            "of_which_ms": {"intra_chunk_backward": ranges[
                "ssd_intra_backward"], "adamw_pass": ranges["adamw_update"]},
            "top_kernels": [{"name": k[:100], "ms": us / 1e3, "count": n}
                            for us, n, k in rows[:12]]}


def train_run():
    """``launch/train.train``: mamba2-370m at full size, weights drawn on
    the card, 6 steps of 16 × 4,096 tokens in two micro-batches; then one
    steady step profiled, and a save / restore of the model and optimizer
    state with one more step from each. Returns kernel 6's launches and
    the report."""
    import tempfile

    import torch

    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.train import make_train_step

    cfg = get_config(LM_ARCH)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = launch_train.train(LM_ARCH, lr=TRAIN_LR, device="cuda", seed=0,
                             **TRAIN_RUN)
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()["ssd_intra"]
    model, state = rep.pop("model"), rep.pop("opt_state")
    per_micro = 2 * cfg.num_layers
    rep.update({"phase": "train_run", "total_s": total_s,
                "tokens_per_step": TRAIN_RUN["batch"] * TRAIN_RUN["seq"],
                "ssd_intra_launches": launches,
                "expected_launches_per_step": per_micro * TRAIN_RUN["accum"]})
    finite = all(math.isfinite(v) for v in rep["loss"] + rep["grad_norm"])
    steps = rep["ssd_intra_launches_per_step"]
    step = make_train_step(
        cfg, AdamWConfig(lr=TRAIN_LR),
        cosine_schedule(TRAIN_LR, warmup=max(TRAIN_RUN["steps"] // 10, 1),
                        total=TRAIN_RUN["steps"]),
        accum_steps=TRAIN_RUN["accum"])
    batch = launch_train.make_batch(cfg, TRAIN_RUN["batch"], TRAIN_RUN["seq"],
                                    TRAIN_RUN["steps"], "cuda")
    rep["profile"] = _train_profile(model, state, batch, step)

    # Checkpoint: save, restore into a fresh model and state, and take one
    # more step from each on the same batch.
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = save_pytree({"params": model.state_dict(), "opt": state}, d)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        fresh = T.init_params(cfg, seed=1, device="cuda")
        t0 = time.perf_counter()
        back = restore_pytree(
            {"params": fresh.state_dict(),
             "opt": adamw_init(dict(fresh.named_parameters()),
                               AdamWConfig())}, d)
        fresh.load_state_dict(back["params"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    resume = launch_train.make_batch(cfg, *RESUME_BATCH, TRAIN_RUN["steps"] + 1,
                                     "cuda")
    one = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
    m_live = one(model, state, resume)
    m_back = one(fresh, back["opt"], resume)
    rep["checkpoint"] = {
        "save_s": save_s, "restore_s": restore_s, "bytes": nbytes,
        "resume_batch": list(RESUME_BATCH),
        "loss_live": float(m_live["loss"]),
        "loss_restored": float(m_back["loss"]),
        "grad_norm_live": float(m_live["grad_norm"]),
        "grad_norm_restored": float(m_back["grad_norm"])}
    emit(rep)
    del model, state, fresh, back
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("train_run: a loss or grad norm is not finite")
    if any(n != per_micro * TRAIN_RUN["accum"] for n in steps):
        raise AssertionError(f"train_run: kernel 6 launched {steps} times per "
                             f"step, expected {per_micro * TRAIN_RUN['accum']}")
    if rep["checkpoint"]["loss_live"] != rep["checkpoint"]["loss_restored"]:
        raise AssertionError("train_run: the step after restore differs from "
                             "the live step")
    return launches, rep


def train_llama3_width():
    """llama3-8b at full width and 2 layers (as lm_families runs it): the
    one-step card-vs-CPU check at 1 × 512 tokens, then 4 timed steps at
    4 × 2,048 on the card."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    full = get_config(LLAMA3_SERVE)
    cfg = dataclasses.replace(full, num_layers=2)
    model, model_cpu, init_s, copy_s = card_and_cpu_models(cfg)
    model, _, result, ok = one_step_check(
        "train_llama3_width", cfg, model, model_cpu, LLAMA3_TRAIN_CHECK,
        {"cut": _cut(full, cfg), "init_card_s": init_s, "to_cpu_s": copy_s})
    del model_cpu
    opt = AdamWConfig(lr=TRAIN_LR)
    state = adamw_init(dict(model.named_parameters()), opt)
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(LLAMA3_TRAIN_STEPS):
        batch = make_batch(cfg, *LLAMA3_TRAIN_TIMED, i, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    steady = statistics.median(times[1:])
    b, s = LLAMA3_TRAIN_TIMED
    result["timed"] = {
        "batch": [b, s], "steps": LLAMA3_TRAIN_STEPS,
        "step_s": times, "steady_step_ms": steady * 1e3,
        "tokens_per_s": b * s / steady, "loss": losses,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    del model, state
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("train_llama3_width: the card's step disagrees "
                             "with the CPU's beyond the tolerance")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("train_llama3_width: a loss is not finite")


# ------------------------------------------- the sharded LM path, the RAG

SHARDED_TRAIN_RUN = dict(TRAIN_RUN, steps=2)
SHARDED_DECODE_STEPS = 8
DRYRUN_PAIRS = (("llama3-8b", "train_4k"), ("mamba2-370m", "decode_32k"))
RAG_ARCH = "phi4-mini-3.8b"
RAG_DOCS, RAG_DOC_LEN = 1024, 24


def nccl_group():
    """A one-rank NCCL default process group on a free loopback port and a
    1 × 1 ("data", "model") mesh of it on the card (``launch.mesh``).
    The caller destroys the group."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    return make_host_mesh(model=1, device_type="cuda")


def _full(x):
    """A DTensor gathered whole (a plain tensor as it is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def sharded_check():
    """The sharded LM path on a 1 × 1 NCCL mesh, against the plain one on
    the card: mamba2-370m at full size, one train step from the same
    weights at ``TRAIN_CHECK_SHAPE`` plain and on the model, state and
    batch ``launch.shardings`` placed (loss, ce and grad norm within
    ``LM_TOL`` relative, each gradient within ``TRAIN_GRAD_TOL`` of its
    largest magnitude, each updated parameter within 2 · lr; kernel 6
    launched in the sharded step, through ``local_map``, twice per layer);
    then llama3-8b at full width and 2 layers: a sharded prefill of 1 × 512
    tokens and 8 greedy decode steps on caches placed by
    ``cache_shardings(profile="seq")``, against the plain model: logits
    within ``LM_TOL`` of their largest magnitude, greedy tokens equal.
    Whether each comparison was bitwise is reported. Returns kernel 6's
    launches in the sharded step."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.train import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    mesh = nccl_group()
    out = {"phase": "sharded_check", "mesh": SH.mesh_axes(mesh),
           "backend": dist.get_backend()}
    try:
        cfg = get_config(LM_ARCH)
        plain = T.init_params(cfg, seed=0, device="cuda")
        sharded = SH.shard_model(copy.deepcopy(plain), mesh)
        batch = make_batch(cfg, *TRAIN_CHECK_SHAPE, 0, "cuda")
        opt = AdamWConfig(lr=TRAIN_LR)
        step = make_train_step(cfg, opt)
        m_p = step(plain, adamw_init(dict(plain.named_parameters()), opt),
                   batch)
        state = SH.shard_opt_state(
            adamw_init(dict(sharded.named_parameters()), opt), sharded, mesh)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_s = step(sharded, state, SH.shard_batch(batch, mesh))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = ops.launch_counts()["ssd_intra"]
        train = {"arch": cfg.name, "batch": list(TRAIN_CHECK_SHAPE),
                 "sharded_step_s": step_s, "ssd_intra_launches": launches}
        ok = True
        for key in ("loss", "ce", "grad_norm"):
            a, b = float(m_p[key]), float(_full(m_s[key]))
            train[key] = {"plain": a, "sharded": b,
                          "rel_err": abs(b - a) / abs(a)}
            ok = ok and math.isfinite(b) and abs(b - a) <= LM_TOL * abs(a)
        worst, upd, bitwise = 0.0, 0.0, True
        for (name, p), q in zip(plain.named_parameters(),
                                sharded.parameters()):
            g_s, p_s = _full(q.grad), _full(q.detach())
            worst = max(worst, float((g_s - p.grad).abs().max())
                        / (float(p.grad.abs().max()) or 1.0))
            upd = max(upd, float((p_s - p.detach()).abs().max()))
            bitwise = (bitwise and torch.equal(g_s, p.grad)
                       and torch.equal(p_s, p.detach()))
        ok = ok and worst <= TRAIN_GRAD_TOL and upd <= 2 * TRAIN_LR
        train.update({"worst_grad_rel_err": worst,
                      "updated_params_max_abs_diff": upd,
                      "bitwise_grads_and_params": bitwise})
        out["train"] = train
        del plain, sharded, state, m_p, m_s
        gc.collect()
        torch.cuda.empty_cache()
        if not ok:
            emit(out)
            raise AssertionError("sharded_check: the sharded train step "
                                 "disagrees with the plain one")
        if launches != 2 * cfg.num_layers:
            emit(out)
            raise AssertionError(f"sharded_check: kernel 6 launched "
                                 f"{launches} times in the sharded step, "
                                 f"expected {2 * cfg.num_layers}")

        full = get_config("llama3-8b")
        cfg = dataclasses.replace(full, num_layers=2)
        plain = T.init_params(cfg, seed=0, device="cuda")
        sharded = SH.shard_model(copy.deepcopy(plain), mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT),
                               device="cuda", generator=gen)
        buf = FAMILY_PROMPT + SHARDED_DECODE_STEPS

        def run(model, place_tokens, place_caches):
            logits, caches = model.prefill(place_tokens(tokens), buf_len=buf)
            caches = place_caches(caches)
            seen, picked = [logits], []
            for i in range(SHARDED_DECODE_STEPS):
                tok = _full(logits[:, -1]).argmax(-1)[:, None]
                picked.append(tok)
                logits, caches = model.decode_step(place_tokens(tok), caches,
                                                   FAMILY_PROMPT + i)
                seen.append(logits)
            return [_full(x) for x in seen], torch.cat(picked, dim=1)

        def same(x):
            return x

        want, want_tok = run(plain, same, same)
        t0 = time.perf_counter()
        got, got_tok = run(
            sharded, lambda t: SH.shard_batch({"t": t}, mesh)["t"],
            lambda c: SH.shard_caches(c, mesh, profile="seq"))
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        err = max(float((g - w).abs().max()) / float(w.abs().max())
                  for g, w in zip(got, want))
        out["serve"] = {
            "arch": full.name, "layers": cfg.num_layers,
            "prompt": [1, FAMILY_PROMPT], "decode_steps": SHARDED_DECODE_STEPS,
            "cache_profile": "seq", "sharded_s": serve_s,
            "logits_rel_err": err,
            "bitwise_logits": all(torch.equal(g, w)
                                  for g, w in zip(got, want)),
            "greedy_tokens_equal": bool(torch.equal(got_tok, want_tok))}
        del plain, sharded
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["tolerance"] = (f"train: loss, ce, grad norm |s - p| <= {LM_TOL} |p|;"
                        f" gradients <= {TRAIN_GRAD_TOL} of their max; "
                        f"updates <= 2 lr; serve: logits <= {LM_TOL} of "
                        "their max, greedy tokens equal")
    emit(out)
    if err > LM_TOL or not out["serve"]["greedy_tokens_equal"]:
        raise AssertionError("sharded_check: the sharded prefill/decode "
                             "disagrees with the plain model")
    return launches


def sharded_train_run(train_rep):
    """``launch/train.train`` with a 1 × 1 NCCL mesh: mamba2-370m at full
    size on the sharded model, state and batches, 2 steps of 16 × 4,096
    tokens in two micro-batches; step ms, tokens/s, peak memory and kernel
    6's launches beside ``train_run``'s (``train_rep``). The gap is
    DTensor's host dispatch. Returns kernel 6's launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = get_config(LM_ARCH)
    mesh = nccl_group()
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = launch_train.train(LM_ARCH, lr=TRAIN_LR, device="cuda", seed=0,
                                 mesh=mesh, **SHARDED_TRAIN_RUN)
        total_s = time.perf_counter() - t0
        launches = ops.launch_counts()["ssd_intra"]
    finally:
        dist.destroy_process_group()
    rep.pop("model"), rep.pop("opt_state")
    per_step = 2 * cfg.num_layers * SHARDED_TRAIN_RUN["accum"]
    rep.update({"phase": "sharded_train_run", "total_s": total_s,
                "ssd_intra_launches": launches,
                "expected_launches_per_step": per_step,
                "plain_train_run": {key: train_rep[key] for key in (
                    "steady_step_ms", "tokens_per_s", "peak_device_gb",
                    "first_step_s", "loss")}})
    rep["steady_step_ms_over_plain"] = (rep["steady_step_ms"]
                                        / train_rep["steady_step_ms"])
    emit(rep)
    if not all(math.isfinite(v) for v in rep["loss"] + rep["grad_norm"]):
        raise AssertionError("sharded_train_run: a loss or grad norm is not "
                             "finite")
    if abs(rep["loss"][0] - train_rep["loss"][0]) > LM_TOL * abs(
            train_rep["loss"][0]):
        raise AssertionError("sharded_train_run: the first loss differs from "
                             "train_run's")
    if any(n != per_step for n in rep["ssd_intra_launches_per_step"]):
        raise AssertionError(f"sharded_train_run: kernel 6 launched "
                             f"{rep['ssd_intra_launches_per_step']} times per "
                             f"step, expected {per_step}")
    return launches


def start_dryruns(out_dir):
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_PAIRS, one
    process each, on the CPU (no card visible), writing JSON under
    ``out_dir``. Returns {pair: (process, json path)}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = {}
    for arch, shape in DRYRUN_PAIRS:
        path = os.path.join(out_dir, f"dryrun-{arch}-{shape}.json")
        procs[arch, shape] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--json", path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path)
    return procs


def collect_dryruns(procs):
    """Wait for the dry runs and emit their results; fails if one failed."""
    results, failed = [], []
    for (arch, shape), (proc, path) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f"{arch} × {shape} (exit {proc.returncode}):\n"
                          f"{log[-3000:]}")
            continue
        with open(path) as f:
            res = json.load(f)
        results.append(res)
        if not res["flops"] > 0 or not res["memory"]["argument_bytes"] > 0:
            failed.append(f"{arch} × {shape}: no FLOPs or no state counted")
    emit({"phase": "dryrun", "roofline": "H100 spec arithmetic "
          "(launch.mesh.HW), not measured", "pairs": results})
    if failed:
        raise AssertionError("dryrun failed: " + "\n".join(failed))


def _example(name):
    """A module of ``examples/`` by its file name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rag_phase():
    """``examples/rag_serving_torch.py``'s flow at full size: phi4-mini-3.8b
    (weights drawn on the card from seed 0) embeds RAG_DOCS documents of 24
    tokens, SQUASH indexes the d = 3,072 embeddings with the example's
    attributes, the example's queries search with ``backend="torch"`` on
    the card (float64 ids and ``SearchStats`` must equal the NumPy
    backend's; kernel 1 and a Stage 4 kernel must launch), then the LM
    generates from the retrieved prompts with the float and the 8-bit
    OSQ-packed KV cache (greedy tokens agree on >= 0.75). Returns the
    search's launch counts."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dataplane
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    ex = _example("rag_serving_torch")
    cfg = get_config(RAG_ARCH)
    out = {"phase": "rag", "arch": cfg.name, "d_model": cfg.d_model,
           "layers": cfg.num_layers, "docs": RAG_DOCS, "doc_len": RAG_DOC_LEN}
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out["init_card_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    docs = rng.integers(0, cfg.vocab_size, (RAG_DOCS, RAG_DOC_LEN),
                        dtype=np.int32)
    t0 = time.perf_counter()
    embs = ex.embed_documents(model, torch.from_numpy(docs).cuda())
    out["embed_s"] = time.perf_counter() - t0
    if embs.shape != (RAG_DOCS, cfg.d_model) or not np.isfinite(embs).all():
        raise AssertionError(f"rag: malformed embeddings {embs.shape}")
    t0 = time.perf_counter()
    index = ex.build(embs, rng)
    out["index_build_s"] = time.perf_counter() - t0
    m1 = max(pt.quant.boundaries.shape[0] for pt in index.parts)
    out.update({"M+1": m1, "G": int(index.parts[0].low.packed.shape[1]),
                "stage4": ("adc_batch" if m1 <= dataplane.ADC_TABLE_MAX_M1
                           else "adc_direct")})
    queries = ex.queries_for(embs, rng).astype(np.float64)
    want = index.search(queries, ex.PREDICATES, k=ex.K, backend="numpy")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = with_dtype(torch.float64, lambda: index.search(
        queries, ex.PREDICATES, k=ex.K, backend="torch"))
    out["search_ms"] = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    ids32 = with_dtype(torch.float32, lambda: index.search(
        queries, ex.PREDICATES, k=ex.K, backend="torch"))[0]
    out.update({"launches": counts,
                "f64_ids_equal": bool(np.array_equal(got[0], want[0])),
                "f64_stats_equal": got[2] == want[2],
                "f32_share_ids_equal_numpy": float(np.mean(ids32 == want[0])),
                "retrieved": got[0][:, :3].tolist()})
    prompts = ex.prompts_for(docs, got[0])
    tokens, timing = {}, {}
    for bits in (0, 8):
        t0 = time.perf_counter()
        tokens[bits], eng = ex.generate(cfg, model, prompts, "cuda", bits)
        timing[bits] = {"total_s": time.perf_counter() - t0,
                        **eng.last_timing, "cache_bytes": eng.last_cache_bytes}
    out["generate"] = timing
    out["token_agreement_kv8_vs_fp"] = float(np.mean(tokens[0] == tokens[8]))
    out["tokens_in_vocab"] = bool(all(((t >= 0) & (t < cfg.vocab_size)).all()
                                      for t in tokens.values()))
    emit(out)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if not (out["f64_ids_equal"] and out["f64_stats_equal"]):
        raise AssertionError("rag: the torch backend's float64 ids or stats "
                             "differ from the NumPy backend's")
    if counts["hamming_stacked"] <= 0 or counts[out["stage4"]] <= 0:
        raise AssertionError(f"rag: a kernel of the search never launched: "
                             f"{counts}")
    if out["token_agreement_kv8_vs_fp"] < 0.75 or not out["tokens_in_vocab"]:
        raise AssertionError("rag: the 8-bit KV cache's tokens agree on less "
                             "than 0.75, or a token lies outside the vocab")
    return counts


def extract_path(index):
    """Every partition's packed segments through ``ops.extract_codes`` on
    the card; each must equal the partition's stored codes exactly."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    packed = [torch.from_numpy(np.ascontiguousarray(part.packed)).cuda()
              for part in index.parts]
    ops.reset_launch_counts()
    outs = [ops.extract_codes(seg, part.layout)
            for seg, part in zip(packed, index.parts)]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    equal = [bool(torch.equal(out.cpu(), torch.from_numpy(
        part.codes.astype(np.int32)))) for out, part in zip(outs, index.parts)]
    emit({"phase": "extract", "partitions": len(equal),
          "rows": int(sum(part.packed.shape[0] for part in index.parts)),
          "G": int(index.parts[0].packed.shape[1]),
          "seg_bits": index.parts[0].layout.seg_bits,
          "d": index.parts[0].layout.d, "equal_stored_codes": equal,
          "launches": counts})
    if not all(equal):
        raise AssertionError("extract: kernel codes differ from the stored "
                             "codes")
    if counts["extract_codes"] <= 0:
        raise AssertionError("extract: extract_codes never launched")
    return packed, counts


# ----------------------------------------------------------------- kernels

def stage_inputs(index, queries, preds, dtype):
    """The kernels' inputs at a path's shapes, made with plain versions."""
    import torch

    from repro_torch.core import dataplane
    from repro_torch.kernels import ref

    device = torch.device("cuda")
    q64, cands, _ = index.select(queries, preds, K)
    stacked = index.stacked(dtype, device)
    p, n_max = stacked.num_partitions, stacked.n_max
    cand_mask, n_cand = dataplane.build_cand_arrays(cands, q64.shape[0], p,
                                                    n_max)
    keep, _ = dataplane.stage_counts(n_cand, index.config, K, index.profile)
    keep_s, _ = dataplane.static_counts(n_max, index.config, K, index.profile)
    q = torch.from_numpy(q64).to(device=device, dtype=dtype)
    qc = q[:, None, :] - stacked.part_mean[None]
    qbits = dataplane.pack_query_bits(
        (qc - stacked.low_mean[None]) / stacked.low_std[None])
    ham = ref.hamming_stacked_ref(qbits, stacked.low_packed)
    alive = torch.from_numpy(cand_mask).to(device) & stacked.valid[None]
    key = (torch.where(alive, ham, 1 << 30).to(torch.int64) * n_max
           + torch.arange(n_max, device=device))
    sel = torch.topk(key, keep_s, dim=-1, largest=False, sorted=True).indices
    qt = torch.einsum("qpd,pde->qpe", qc, stacked.klt).contiguous()
    return stacked, qbits, sel, qt, torch.from_numpy(keep).to(device)


def kernel_entry(name, source, replaces, launches, max_err, ms, plain_ms,
                 nbytes, ops, tf32x3_ops=0.0, **extra):
    b_ms, b_by = bound(nbytes, ops, tf32x3_ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bytes": float(nbytes), **extra}


def check_kernels(index_a, index_b, queries, preds, launches, packed_a,
                  ssd_shapes):
    """Every kernel against its plain version; the ``kernels`` line's
    entries in the order 1, 2b, 3 (view), 2, 4 (view), 5, 6."""
    import torch

    from repro_torch.core import dataplane
    from repro_torch.kernels import adc_lookup, hamming, ref

    entries = []
    # --- kernel 1 (Hamming) at Path A's shapes, exact ------------------
    stacked, qbits, sel, qt32, keep = stage_inputs(index_a, queries, preds,
                                                   torch.float32)
    ham_k = hamming.hamming_stacked(qbits, stacked.low_packed)
    ham_p = ref.hamming_stacked_ref(qbits, stacked.low_packed)
    if not torch.equal(ham_k, ham_p):
        raise AssertionError("hamming_stacked differs from its plain version")
    qn, p, g = qbits.shape
    n = stacked.n_max
    entries.append(kernel_entry(
        "hamming_stacked", "src/repro_torch/kernels/csrc/hamming.cu",
        "src/repro/kernels/hamming.py:92", launches["hamming_stacked"], 0,
        device_ms(lambda: hamming.hamming_stacked(qbits, stacked.low_packed),
                  20),
        cuda_ms(lambda: ref.hamming_stacked_ref(qbits, stacked.low_packed), 3),
        4 * (qn * p * g + p * n * g + qn * p * n), 3 * qn * p * n * g,
        shape={"Q": qn, "P": p, "N": n, "G": g}, tolerance="exact",
        call_ms=cuda_ms(
            lambda: hamming.hamming_stacked(qbits, stacked.low_packed), 20)))
    # view 3: packed_hamming = kernel 1 at Q = P = 1
    q1 = qbits[0, 0].contiguous()
    db1 = stacked.low_packed[0].contiguous()
    v3 = hamming.packed_hamming(q1, db1)
    if not torch.equal(v3, ref.hamming_ref(q1, db1)):
        raise AssertionError("packed_hamming view differs from hamming_ref")
    entries.append(kernel_entry(
        "packed_hamming", "src/repro_torch/kernels/csrc/hamming.cu",
        "src/repro/kernels/hamming.py:45", 0, 0,
        device_ms(lambda: hamming.packed_hamming(q1, db1), 20),
        cuda_ms(lambda: ref.hamming_ref(q1, db1), 3),
        4 * (g + n * g + n), 3 * n * g, shape={"N": n, "G": g},
        tolerance="exact", path="none: kernel 1 at Q = P = 1",
        call_ms=cuda_ms(lambda: hamming.packed_hamming(q1, db1), 20)))
    # view 1v: packed_hamming_multi = kernel 1 at P = 1 (the port calls
    # hamming_stacked at that shape; it has no wrapper of its own)
    qm = qbits[:, :1].contiguous()
    dbm = stacked.low_packed[:1].contiguous()
    if not torch.equal(hamming.hamming_stacked(qm, dbm),
                       ref.hamming_stacked_ref(qm, dbm)):
        raise AssertionError("kernel 1 at P = 1 differs from its plain "
                             "version")
    entries.append(kernel_entry(
        "packed_hamming_multi", "src/repro_torch/kernels/csrc/hamming.cu",
        "src/repro/kernels/hamming.py:130", 0, 0,
        device_ms(lambda: hamming.hamming_stacked(qm, dbm), 20),
        cuda_ms(lambda: ref.hamming_stacked_ref(qm, dbm), 3),
        4 * (qn * g + n * g + qn * n), 3 * qn * n * g,
        shape={"Q": qn, "N": n, "G": g}, tolerance="exact",
        path="none: kernel 1 at P = 1",
        call_ms=cuda_ms(lambda: hamming.hamming_stacked(qm, dbm), 20)))

    # --- kernel 2b (direct) at Path A's shapes, both float widths -------
    entries.append(check_direct(index_a, queries, preds, launches, stacked,
                                sel, qt32, keep))
    del stacked, sel, qt32, keep

    # --- kernel 2 (table) at Path B's shapes, and view 4 ----------------
    entries.extend(check_table(index_b, queries, preds, launches))
    emit({"phase": "views", "packed_hamming": "equal",
          "adc_lb_distances": "within tolerance"})
    entries.append(check_extract(index_a, packed_a, launches))
    entries.append(check_ssd(ssd_shapes))
    return entries


def hold_keep(name, label, out_k, out_p, keep, cases) -> float:
    """Hold a kernel that takes ``keep`` against its plain version: +inf
    exactly on the dead slots (s ≥ keep), the live ones within rtol 1e-5,
    atol 0. Records the case under ``label``; returns its largest live
    error."""
    import torch

    s = out_k.shape[-1]
    dead = torch.arange(s, device=keep.device)[None, None, :] >= keep[:, :, None]
    if not torch.equal(torch.isposinf(out_k), dead):
        raise AssertionError(f"{name} ({label}): +inf does not lie exactly "
                             "on the dead slots")
    torch.testing.assert_close(out_k, out_p, rtol=ADC_RTOL, atol=0)
    live = ~dead
    e = float((out_k[live] - out_p[live]).abs().max()) if live.any() else 0.0
    cases[label] = {"max_abs_err": e, "live_slots": int(live.sum()),
                    "dead_pairs": int((keep <= 0).sum()),
                    "whole_pairs": int((keep >= s).sum())}
    return e


def check_table(index_b, queries, preds, launches):
    """Kernel 2 at Path B's shapes: the plane's call (each pair's live
    survivors read through ``sel`` from the stacked codes in place) against
    its plain version with Path B's keep and with whole and dead pairs put
    in, for tables built in f64 and in f32: rtol 1e-5, atol 0, +inf exactly
    on dead slots. Timed at Path B's keep; the bound counts what the live
    slots need. Then the TPU kernel's dense (B, N, d) contract on the
    gathered codes (``ms_dense``) and its B = 1 view (view 4), each against
    its plain version. Returns the entries of view 4 and kernel 2."""
    import torch

    from repro_torch.core import dataplane
    from repro_torch.kernels import adc_lookup, ref

    cases, err = {}, 0.0

    def hold(label, args, sqrt=True):
        nonlocal err
        err = max(err, hold_keep(
            "adc_table", label, adc_lookup.adc_table(*args, sqrt=sqrt),
            ref.adc_table_ref(*args, sqrt=sqrt), args[-1], cases))

    def table_args(dtype):
        stacked, _, sel, qt, keep = stage_inputs(index_b, queries, preds,
                                                 dtype)
        qn, p = sel.shape[:2]
        m1, d = stacked.boundaries.shape[1], qt.shape[-1]
        tables = dataplane.adc_table_batch(
            qt, stacked.boundaries[None], stacked.cells[None]).reshape(
            qn, p, m1, d).to(torch.float32).contiguous()
        return tables, stacked.codes, sel, keep

    args32 = table_args(torch.float32)
    hold("f32", args32)
    hold("f32_edges", (*args32[:3], _edge_keep(args32[3], args32[2].shape[-1])))
    del args32
    args = table_args(torch.float64)        # the parity config's tables
    tables, codes, sel, keep = args
    qn, p, s = sel.shape
    m1, d = tables.shape[2:]
    n = codes.shape[1]
    hold("f64", args)
    hold("f64_edges", (tables, codes, sel, _edge_keep(keep, s)))
    hold("f64_squared", args, sqrt=False)
    ms = device_ms(lambda: adc_lookup.adc_table(*args), 20)
    call_ms = cuda_ms(lambda: adc_lookup.adc_table(*args), 20)
    plain_ms = cuda_ms(lambda: ref.adc_table_ref(*args), 3)

    # What the live slots need: each live survivor's code row (unique) and
    # sel entry, the live pairs' tables, keep, and the whole (Q, P, S)
    # output written once.
    slot = torch.arange(s, device=sel.device)[None, None, :]
    live = slot < keep[:, :, None]
    live_slots = int(live.sum())
    p_idx = torch.arange(p, device=sel.device)[None, :, None]
    live_rows = int(torch.unique((p_idx * n + sel)[live]).numel())
    live_pairs = int((keep > 0).sum())
    nbytes = (4 * live_rows * d + 8 * live_slots + 4 * live_pairs * m1 * d
              + 4 * qn * p + 4 * qn * p * s)

    # The dense (B, N, d) contract on the gathered codes: every slot live.
    b = qn * p
    t_b = tables.reshape(b, m1, d)
    c_b = codes[p_idx, sel].reshape(b, s, d)
    for sqrt in (True, False):
        out_k = adc_lookup.adc_batch(t_b, c_b, sqrt=sqrt)
        out_p = ref.adc_lb_batch_ref(t_b, c_b, sqrt=sqrt)
        torch.testing.assert_close(out_k, out_p, rtol=ADC_RTOL, atol=0)
        cases[f"dense_sqrt_{sqrt}"] = {
            "max_abs_err": float((out_k - out_p).abs().max())}
        err = max(err, cases[f"dense_sqrt_{sqrt}"]["max_abs_err"])
        del out_k, out_p
    ms_dense = device_ms(lambda: adc_lookup.adc_batch(t_b, c_b), 10)
    call_ms_dense = cuda_ms(lambda: adc_lookup.adc_batch(t_b, c_b), 10)
    plain_ms_dense = cuda_ms(lambda: ref.adc_lb_batch_ref(t_b, c_b), 3)
    dense_bound_ms, _ = bound(4 * (b * m1 * d + b * s * d + b * s), b * s * d)

    # view 4: adc_lb_distances = kernel 2 at B = 1
    t1, c1 = t_b[0].contiguous(), c_b[0].contiguous()
    v4 = adc_lookup.adc_lb_distances(t1, c1)
    v4_p = ref.adc_lb_ref(t1, c1)
    torch.testing.assert_close(v4, v4_p, rtol=ADC_RTOL, atol=0)
    view4 = kernel_entry(
        "adc_lb_distances", "src/repro_torch/kernels/csrc/adc_lookup.cu",
        "src/repro/kernels/adc_lookup.py:59", 0,
        float((v4 - v4_p).abs().max()),
        device_ms(lambda: adc_lookup.adc_lb_distances(t1, c1), 20),
        cuda_ms(lambda: ref.adc_lb_ref(t1, c1), 3),
        4 * (m1 * d + s * d + s), s * d, shape={"M+1": m1, "N": s, "d": d},
        tolerance=f"rtol={ADC_RTOL}, atol=0",
        path="none: kernel 2 at B = 1",
        call_ms=cuda_ms(lambda: adc_lookup.adc_lb_distances(t1, c1), 20))
    del c_b
    table = kernel_entry(
        "adc_batch", "src/repro_torch/kernels/csrc/adc_lookup.cu",
        "src/repro/kernels/adc_lookup.py:127", launches["adc_batch"], err,
        ms, plain_ms, nbytes, live_slots * d,
        shape={"Q": qn, "P": p, "S": s, "d": d, "M+1": m1, "n_max": n},
        redesigned_in=14,
        live_slots=live_slots, live_rows=live_rows, live_pairs=live_pairs,
        slots=qn * p * s,
        bound_counts="live slots: their code rows (unique), sel entries, "
        "the live pairs' tables, keep, and the whole (Q, P, S) output",
        timed="the plane's call: tables built in f64, Path B's sel and keep",
        call_ms=call_ms, ms_dense=ms_dense, call_ms_dense=call_ms_dense,
        plain_ms_dense=plain_ms_dense, dense_bound_ms=dense_bound_ms,
        dense_shape={"B": b, "N": s, "d": d, "M+1": m1}, cases=cases,
        tolerance=f"rtol={ADC_RTOL}, atol=0; +inf exactly on dead slots")
    return [view4, table]


def _edge_keep(keep, s):
    """``keep`` with whole pairs (keep = S) and dead ones (keep = 0) put
    in: every visited pair of the first query made whole, the second
    query's pairs all dead."""
    edges = keep.clone()
    edges[0] = keep[0].masked_fill(keep[0] > 0, s)
    edges[1] = 0
    return edges


def check_direct(index_a, queries, preds, launches, stacked, sel, qt32, keep):
    """Kernel 2b against its plain version on the first SLICE_Q queries
    (the plain version gathers a (Q, P, S, d) tensor), with Path A's keep
    and with whole and dead pairs put in, in f32 and f64: rtol 1e-5, atol
    0, +inf exactly on dead slots. Timed on all queries at Path A's keep;
    the bound counts what the live slots need."""
    import torch

    from repro_torch.core import dataplane
    from repro_torch.kernels import adc_lookup, ref

    qn, p, s = sel.shape
    m1, d = stacked.boundaries.shape[1], qt32.shape[-1]
    n = stacked.n_max
    sl = slice(0, SLICE_Q)
    cases, err = {}, 0.0

    def hold(label, args):
        nonlocal err
        err = max(err, hold_keep(
            "adc_direct", label, adc_lookup.adc_direct(*args),
            ref.adc_direct_ref(*args), args[-1], cases))

    qcell32 = dataplane.query_cells(qt32, stacked.boundaries)
    args32 = (qt32, qcell32, stacked.boundaries, stacked.codes, sel, keep)
    sliced = [t[sl].contiguous() for t in (qt32, qcell32)]
    hold("f32", (*sliced, stacked.boundaries, stacked.codes,
                 sel[sl].contiguous(), keep[sl].contiguous()))
    hold("f32_edges", (*sliced, stacked.boundaries, stacked.codes,
                       sel[sl].contiguous(), _edge_keep(keep[sl], s)))
    direct_ms = device_ms(lambda: adc_lookup.adc_direct(*args32), 20)
    call_ms = cuda_ms(lambda: adc_lookup.adc_direct(*args32), 20)
    plain_ms = cuda_ms(lambda: ref.adc_direct_ref(
        *sliced, stacked.boundaries, stacked.codes, sel[sl].contiguous(),
        keep[sl].contiguous()), 2)
    ms_on_plain_queries = device_ms(lambda: adc_lookup.adc_direct(
        *sliced, stacked.boundaries, stacked.codes, sel[sl].contiguous(),
        keep[sl].contiguous()), 20)

    # What the live slots need: each live survivor's code row and sel entry,
    # the boundaries of the partitions they lie in, qt and qcell of live
    # pairs, keep, and the whole (Q, P, S) output written once.
    slot = torch.arange(s, device=sel.device)[None, None, :]
    live = slot < keep[:, :, None]
    live_slots = int(live.sum())
    p_idx = torch.arange(p, device=sel.device)[None, :, None].expand_as(sel)
    live_rows = int(torch.unique((p_idx * n + sel)[live]).numel())
    live_parts = int((keep > 0).any(dim=0).sum())
    live_pairs = int((keep > 0).sum())
    nbytes = (4 * live_rows * d + 8 * live_slots + 4 * live_parts * m1 * d
              + 8 * live_pairs * d + 4 * qn * p + 4 * qn * p * s)
    ops_live = 4 * live_slots * d
    del sliced

    stacked64 = index_a.stacked(torch.float64, torch.device("cuda"))
    qt64 = torch.einsum("qpd,pde->qpe", torch.from_numpy(queries).cuda()[
        :, None, :] - stacked64.part_mean[None], stacked64.klt).contiguous()
    qcell64 = dataplane.query_cells(qt64, stacked64.boundaries)
    sliced64 = [t[sl].contiguous() for t in (qt64, qcell64)]
    hold("f64", (*sliced64, stacked64.boundaries, stacked64.codes,
                 sel[sl].contiguous(), keep[sl].contiguous()))
    hold("f64_edges", (*sliced64, stacked64.boundaries, stacked64.codes,
                       sel[sl].contiguous(), _edge_keep(keep[sl], s)))
    ms_f64 = device_ms(lambda: adc_lookup.adc_direct(
        qt64, qcell64, stacked64.boundaries, stacked64.codes, sel, keep), 20)
    call_ms_f64 = cuda_ms(lambda: adc_lookup.adc_direct(
        qt64, qcell64, stacked64.boundaries, stacked64.codes, sel, keep), 20)
    del stacked64, qt64, qcell64, sliced64
    return kernel_entry(
        "adc_direct", "src/repro_torch/kernels/csrc/adc_lookup.cu",
        "src/repro/core/dataplane.py:282", launches["adc_direct"], err,
        direct_ms, plain_ms, nbytes, ops_live,
        shape={"Q": qn, "P": p, "S": s, "d": d, "M+1": m1, "n_max": n,
               "dtype": "float32"},
        redesigned_in=13,
        live_slots=live_slots, live_rows=live_rows, live_pairs=live_pairs,
        live_partitions=live_parts, slots=qn * p * s,
        bound_counts="live slots: their code rows (unique), sel entries, "
        "their partitions' boundaries, qt/qcell of live pairs, keep, and "
        "the whole (Q, P, S) output",
        plain_queries=SLICE_Q, plain_ms_on="the first SLICE_Q queries",
        ms_on_plain_queries=ms_on_plain_queries, ms_f64=ms_f64,
        call_ms=call_ms, call_ms_f64=call_ms_f64, cases=cases,
        tolerance=f"rtol={ADC_RTOL}, atol=0; +inf exactly on dead slots")


WIDE_D = 3072                  # phi4-mini-3.8b's d_model: the RAG index's width
WIDE = dict(q=8, p=4, n_max=1024, s=256, m1_direct=257, m1_table=33, g=96)


def wide_inputs(dtype, m1, d=WIDE_D, seed=0):
    """Stage 4 inputs at ``d`` dims on the card: sorted boundaries (P, m1,
    d) with -inf/+inf ends, codes, sel, keep with a whole pair and a dead
    pair put in, a query's qt and its cells. Returns (qt, qcell, bnd,
    codes, sel, keep)."""
    import torch

    from repro_torch.core import dataplane

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, p, n, s = WIDE["q"], WIDE["p"], WIDE["n_max"], WIDE["s"]
    bnd = torch.sort(torch.randn((p, m1, d), device="cuda", generator=gen,
                                 dtype=torch.float64), dim=1).values
    bnd[:, 0], bnd[:, -1] = -math.inf, math.inf
    bnd = bnd.to(dtype).contiguous()
    codes = torch.randint(0, m1 - 1, (p, n, d), device="cuda", generator=gen,
                          dtype=torch.int32)
    sel = torch.randint(0, n, (q, p, s), device="cuda", generator=gen)
    keep = torch.randint(0, s + 1, (q, p), device="cuda", generator=gen,
                         dtype=torch.int32)
    keep[0, 0], keep[0, 1] = s, 0
    qt = torch.randn((q, p, d), device="cuda", generator=gen, dtype=dtype)
    return qt, dataplane.query_cells(qt, bnd), bnd, codes, sel, keep


def _live_counts(sel, keep, n_max):
    """(live slots, unique live code rows, live pairs) of ``sel``/``keep``."""
    import torch

    qn, p, s = sel.shape
    live = (torch.arange(s, device=sel.device)[None, None, :]
            < keep[:, :, None])
    p_idx = torch.arange(p, device=sel.device)[None, :, None]
    rows = torch.unique(((p_idx * n_max + sel)[live])).numel()
    return int(live.sum()), int(rows), int((keep > 0).sum())


def check_wide():
    """Kernels 1, 2b and 2 at d = WIDE_D against their plain versions
    (kernel 1 at G = 96 words, exact; 2b at M+1 = 257 in f32 and f64 and 2
    at M+1 = 33, rtol 1e-5, atol 0, +inf exactly on dead slots), each timed
    beside its plain version and its bound. The direct kernel staged a
    whole qt and qcell row per warp before it was tiled over d, which
    outgrew an H100 block's shared memory at this width. Returns
    {kernel name: result}."""
    import torch

    from repro_torch.kernels import adc_lookup, hamming, ref

    q, p, n, s, d = (WIDE["q"], WIDE["p"], WIDE["n_max"], WIDE["s"], WIDE_D)
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = WIDE["g"]
    qbits = torch.randint(-2 ** 31, 2 ** 31 - 1, (q, p, g), device="cuda",
                          generator=gen, dtype=torch.int32)
    db = torch.randint(-2 ** 31, 2 ** 31 - 1, (p, 4 * n, g), device="cuda",
                       generator=gen, dtype=torch.int32)
    if not torch.equal(hamming.hamming_stacked(qbits, db),
                       ref.hamming_stacked_ref(qbits, db)):
        raise AssertionError(f"hamming_stacked at G={g} differs from its "
                             "plain version")
    b_ms, b_by = bound(4 * (q * p * g + p * 4 * n * g + q * p * 4 * n),
                       3 * q * p * 4 * n * g)
    out["hamming_stacked"] = {
        "shape": {"Q": q, "P": p, "N": 4 * n, "G": g}, "max_abs_err": 0,
        "ms": device_ms(lambda: hamming.hamming_stacked(qbits, db), 20),
        "plain_ms": cuda_ms(lambda: ref.hamming_stacked_ref(qbits, db), 3),
        "bound_ms": b_ms, "bound_by": b_by, "tolerance": "exact"}
    del qbits, db

    cases, err = {}, 0.0
    m1 = WIDE["m1_direct"]
    ms = {}
    for dtype in (torch.float32, torch.float64):
        args = wide_inputs(dtype, m1)
        keep = args[-1]
        err = max(err, hold_keep("adc_direct", f"d{d}_{str(dtype)[6:]}",
                                 adc_lookup.adc_direct(*args),
                                 ref.adc_direct_ref(*args), keep, cases))
        ms[dtype] = device_ms(lambda: adc_lookup.adc_direct(*args), 20)
        if dtype == torch.float32:
            plain_ms = cuda_ms(lambda: ref.adc_direct_ref(*args), 3)
            live, rows, pairs = _live_counts(args[4], keep, n)
            # the live rows' codes, sel entries, every partition's
            # boundaries, the live pairs' qt and qcell, keep and the output
            nbytes = (4 * rows * d + 8 * live + 4 * p * m1 * d
                      + 8 * pairs * d + 4 * q * p + 4 * q * p * s)
            b_ms, b_by = bound(nbytes, 4 * live * d)
        del args
    out["adc_direct"] = {
        "shape": {"Q": q, "P": p, "S": s, "d": d, "M+1": m1, "n_max": n},
        "max_abs_err": err, "ms": ms[torch.float32],
        "ms_f64": ms[torch.float64], "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "smem_bytes_f32": adc_lookup.direct_smem_bytes(
            m1, d, torch.float32),
        "smem_bytes_f64": adc_lookup.direct_smem_bytes(m1, d, torch.float64),
        "cases": cases,
        "tolerance": f"rtol={ADC_RTOL}, atol=0; +inf exactly on dead slots"}

    m1 = WIDE["m1_table"]
    _, _, _, codes, sel, keep = wide_inputs(torch.float32, m1, seed=2)
    tables = torch.rand((q, p, m1, d), device="cuda", generator=gen)
    cases = {}
    err = hold_keep("adc_table", f"d{d}", adc_lookup.adc_table(
        tables, codes, sel, keep), ref.adc_table_ref(tables, codes, sel, keep),
        keep, cases)
    live, rows, pairs = _live_counts(sel, keep, n)
    b_ms, b_by = bound(4 * rows * d + 8 * live + 4 * pairs * m1 * d
                       + 4 * q * p + 4 * q * p * s, live * d)
    out["adc_batch"] = {
        "shape": {"Q": q, "P": p, "S": s, "d": d, "M+1": m1, "n_max": n},
        "max_abs_err": err,
        "ms": device_ms(lambda: adc_lookup.adc_table(tables, codes, sel,
                                                     keep), 20),
        "plain_ms": cuda_ms(lambda: ref.adc_table_ref(tables, codes, sel,
                                                      keep), 3),
        "bound_ms": b_ms, "bound_by": b_by, "cases": cases,
        "tolerance": f"rtol={ADC_RTOL}, atol=0; +inf exactly on dead slots"}
    emit({"phase": "kernels_wide_d", **out})
    return out


def check_extract(index_a, packed_a, launches):
    """Kernel 5 on every Path A partition against its plain version, exact."""
    import torch

    from repro_torch.kernels import bitpack, ref

    parts = index_a.parts
    for seg, part in zip(packed_a, parts):
        if not torch.equal(bitpack.extract_codes(seg, part.layout),
                           ref.extract_ref(seg, part.layout)):
            raise AssertionError("extract_codes differs from its plain version")
    rows = sum(seg.shape[0] for seg in packed_a)
    g = packed_a[0].shape[1]
    d = parts[0].layout.d
    pieces = sum(len(plan) for plan in parts[0].layout.plans)

    def sweep():
        return [bitpack.extract_codes(seg, part.layout)
                for seg, part in zip(packed_a, parts)]

    def sweep_uncached():                 # the plan built and uploaded anew
        out = []
        for seg, part in zip(packed_a, parts):
            bitpack._plan.cache_clear()
            out.append(bitpack.extract_codes(seg, part.layout))
        return out

    return kernel_entry(
        "extract_codes", "src/repro_torch/kernels/csrc/bitpack.cu",
        "src/repro/kernels/bitpack.py:51", launches["extract_codes"], 0,
        device_ms(sweep, 10),
        cuda_ms(lambda: [ref.extract_ref(seg, part.layout)
                         for seg, part in zip(packed_a, parts)], 2),
        sum(seg.numel() * seg.element_size() for seg in packed_a) + 4 * rows * d,
        4 * rows * pieces,
        shape={"partitions": len(parts), "rows": rows, "G": g, "d": d,
               "seg_bits": parts[0].layout.seg_bits, "pieces": pieces},
        tolerance="exact", timed="one sweep over all partitions "
        "(one launch each)", call_ms=cuda_ms(sweep, 10),
        call_ms_without_plan_cache=cuda_ms(sweep_uncached, 10),
        ops_rate="integer ops counted at the f32 rate",
        max_pieces_per_dim=max(len(plan) for plan in parts[0].layout.plans),
        redesigned_in=14)


def _far_tiles(c_mat, b_mat, da, x, tile=64):
    """The plain output's part from s-tiles two or more tiles behind the
    l-tile: what a kernel that skipped them would miss."""
    import torch

    lc = da.shape[-1]
    t = torch.arange(lc, device=da.device) // tile
    far = (t[:, None] - t[None, :]) >= 2
    cs = torch.cumsum(da, dim=-1)
    decay = torch.exp(torch.where(far, cs[..., :, None] - cs[..., None, :], 0))
    decay = torch.where(far, decay, 0)
    scores = torch.einsum("gln,gsn->gls", c_mat, b_mat)
    return torch.einsum("gls,ghls,ghsp->ghlp", scores, decay, x)


def ssd_views(conv, da_l, x_l, n):
    """Kernel 6's arguments as ``ssm.ssd_chunked`` passes them: C and B
    slices of the (G, lc, d_inner + 2N) conv stream, da (G, lc, H) and x
    (G, lc, H, P) with the heads innermost, viewed as (G, H, lc[, P])."""
    d_inner = conv.shape[-1] - 2 * n
    return (conv[..., d_inner + n:], conv[..., d_inner:d_inner + n],
            da_l.transpose(1, 2), x_l.transpose(1, 2))


def ssd_case(ssd_shape):
    """Kernel 6 at one shape against its plain version, on the model's
    strided views and on contiguous copies, with fast decay (da ~ -Exp(1),
    the random-init model's heads; timed) and with slow decay (da ~ -Exp(1)
    · 1e-3, small dt as trained models run), where the s-tiles far behind
    each l-tile carry weight. Returns its numbers and work."""
    import torch

    from repro_torch.kernels import ref, ssd

    g, h, lc, nst, pd = ssd_shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = torch.randn((g, lc, h * pd + 2 * nst), device="cuda",
                       generator=gen)
    da_l = -torch.empty((g, lc, h), device="cuda").exponential_(generator=gen)
    x_l = torch.randn((g, lc, h, pd), device="cuda", generator=gen)
    cases = {}
    for name, scale in (("fast_decay", 1.0), ("slow_decay", 1e-3)):
        views = ssd_views(conv, da_l * scale, x_l, nst)
        dense = [t.contiguous() for t in views]
        for layout, args in (("strided", views), ("contiguous", dense)):
            y_k = ssd.ssd_intra(*args)
            y_p = ref.ssd_intra_ref(*args)
            y_max = float(y_p.abs().max())
            torch.testing.assert_close(y_k, y_p, rtol=SSD_RTOL,
                                       atol=SSD_ATOL_SCALE * y_max)
            cases[f"{name}_{layout}"] = {
                "max_abs_err": float((y_k - y_p).abs().max()),
                "max_abs_ref": y_max}
            del y_k, y_p
        cases[f"{name}_contiguous"]["far_tiles_max_abs"] = float(
            _far_tiles(*dense).abs().max())
    views = ssd_views(conv, da_l, x_l, nst)       # fast decay, timed
    dense = [t.contiguous() for t in views]
    slow = cases["slow_decay_contiguous"]
    if slow["far_tiles_max_abs"] <= 1e3 * SSD_ATOL_SCALE * slow["max_abs_ref"]:
        raise AssertionError("ssd_intra: the slow-decay case does not weigh "
                             "the far s-tiles")
    pairs = lc * (lc + 1) // 2
    return {
        "shape": {"G": g, "H": h, "lc": lc, "N": nst, "P": pd},
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": device_ms(lambda: ssd.ssd_intra(*views), 20),
        "plain_ms": cuda_ms(lambda: ref.ssd_intra_ref(*dense), 3),
        "nbytes": 4 * (2 * g * lc * nst + g * h * lc + 2 * g * h * lc * pd),
        "ops": g * pairs * h * 3,
        "tf32x3_ops": g * pairs * (2 * nst + h * 2 * pd),
        "cases": cases,
        "ms_contiguous": device_ms(lambda: ssd.ssd_intra(*dense), 20),
        "call_ms": cuda_ms(lambda: ssd.ssd_intra(*views), 20)}


def check_ssd(ssd_shapes):
    """Kernel 6 at the LM serve prefill's shape (mamba2-370m, the entry's
    numbers) and at zamba2-7b's (its ``zamba2_7b`` part); ``ssd_shapes``
    maps each config to (shape, launches on its path)."""
    (shape, serve_launches), (z_shape, z_launches) = (
        ssd_shapes[LM_ARCH], ssd_shapes["zamba2-7b"])
    main_case, z = ssd_case(shape), ssd_case(z_shape)
    z_bound, z_by = bound(z["nbytes"], z["ops"], z["tf32x3_ops"])
    return kernel_entry(
        "ssd_intra", "src/repro_torch/kernels/csrc/ssd.cu",
        "src/repro/kernels/ssd.py:54", serve_launches + z_launches,
        max(main_case["max_abs_err"], z["max_abs_err"]), main_case["ms"],
        main_case["plain_ms"], main_case["nbytes"], main_case["ops"],
        tf32x3_ops=main_case["tf32x3_ops"], shape=main_case["shape"],
        cases=main_case["cases"],
        launches_by_phase={"lm_serve": serve_launches,
                           "lm_families_zamba2": z_launches},
        zamba2_7b={"shape": z["shape"], "launches": z_launches,
                   "max_abs_err": z["max_abs_err"], "ms": z["ms"],
                   "plain_ms": z["plain_ms"], "bound_ms": z_bound,
                   "bound_by": z_by, "call_ms": z["call_ms"],
                   "ms_contiguous": z["ms_contiguous"], "bytes": z["nbytes"],
                   "cases": z["cases"]},
        tolerance=f"rtol={SSD_RTOL}, atol={SSD_ATOL_SCALE} * max |y|",
        timed="fast decay, on the strided views ssm.ssd_chunked passes",
        ms_contiguous=main_case["ms_contiguous"],
        call_ms=main_case["call_ms"],
        redesigned_in=13,
        products="mma.sync m16n8k8 TF32 with 3xTF32 compensation",
        ops_counted="causal pairs: the products (scores 2N once per g, 2P "
        "per head for the output) at the 3xTF32 tensor-core rate, a third "
        "of the TF32 peak; per head and pair a subtract, an exp and a "
        "multiply at the f32 CUDA-core rate")


# -------------------------------------------------------------------- main

# ------------------------------------------------- lint and the sync audit

# Syncs the card takes inside the analyzer's SYNC_SCOPE on lines that its
# ``device-sync`` rule does not flag: "path:line" (under src/repro_torch)
# → the text that line holds and why the rule cannot see the sync there.
SYNC_UNSEEN = {
    "optim/adamw.py:100": {
        "line": '"lr": torch.as_tensor(lr, dtype=torch.float32,',
        "why": "`lr` is `cfg.lr` (a Python float) or the schedule's value "
               "(a tensor), one expression; the rule cannot tell which, and "
               "a float's `torch.as_tensor(..., device=)` is a blocking "
               "copy to the card, once per step"},
}
SYNC_AUDIT_LM = (1, 512, 8)        # requests, prompt tokens, new tokens
SYNC_AUDIT_TRAIN = (2, 512)        # batch, tokens: train_check's shape


def lint_phase():
    """The port's squashlint (``python -m repro_torch.analysis --strict
    --json``) over the checkout: fails on any new finding. Reports the
    findings by rule and, by rule, the findings a justified pragma
    suppresses."""
    import contextlib
    import io
    import re

    from repro_torch.analysis import runner

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner.main(["--strict", "--json"])
    report, _ = json.JSONDecoder().raw_decode(out.getvalue())
    by_rule = {}
    for line in report["new"] + report["baselined"]:
        rule = re.search(r": \[([a-z-]+)\] ", line).group(1)
        by_rule[rule] = by_rule.get(rule, 0) + 1
    suppressed = {}
    for f in runner.unsuppressed_findings():
        suppressed[f.rule] = suppressed.get(f.rule, 0) + 1
    suppressed = {rule: n - by_rule.get(rule, 0)
                  for rule, n in sorted(suppressed.items())}
    emit({"phase": "lint", "rc": rc, "new": len(report["new"]),
          "baselined": len(report["baselined"]),
          "stale_baseline": report["stale_baseline"],
          "findings_by_rule": by_rule, "pragma_suppressed_by_rule":
          suppressed, "seconds": time.perf_counter() - t0})
    if rc != 0 or report["new"]:
        raise AssertionError(f"lint: squashlint exits {rc} with new findings "
                             f"{report['new']}")


def flagged_sync_lines() -> set:
    """"path:line" of every line the ``device-sync`` rule flags, those a
    pragma justifies included."""
    from repro_torch.analysis import runner

    return {f"{f.path}:{f.line}" for f in runner.unsuppressed_findings()
            if f.rule == "device-sync"}


def in_sync_scope(site: str) -> bool:
    from repro_torch.analysis.runner import SYNC_SCOPE

    rel = site.rsplit(":", 1)[0]
    return any(rel == s or rel.startswith(s) for s in SYNC_SCOPE)


def _site(frame) -> str:
    """"path:line" of a frame: under ``src/repro_torch`` for the port,
    under the checkout for the rest of it, under ``site-packages`` for an
    installed package."""
    path = os.path.abspath(frame.filename)
    port = os.path.join(REPO, "src", "repro_torch") + os.sep
    if path.startswith(port):
        rel = os.path.relpath(path, port)
    elif path.startswith(REPO + os.sep):
        rel = os.path.relpath(path, REPO)
    elif "site-packages" + os.sep in path:
        rel = path.split("site-packages" + os.sep, 1)[1]
    else:
        rel = os.path.basename(path)
    return rel.replace(os.sep, "/") + f":{frame.lineno}"


def sync_sites(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: every
    sync the card takes, charged to the innermost frame under
    ``src/repro_torch`` ("path:line" under it). A sync with no frame of
    the port on the stack is charged to its innermost frame and the one
    that called it ("site < caller"). Returns (sites → count, fn's
    result)."""
    import traceback
    import warnings

    import torch

    port = os.path.join(REPO, "src", "repro_torch") + os.sep
    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if os.path.basename(f.filename) != "warnings.py"]
        ours = [f for f in stack if os.path.abspath(f.filename)
                .startswith(port)]
        site = (_site(ours[-1]) if ours else
                " < ".join(_site(f) for f in stack[-2:][::-1]))
        sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sorted(sites.items())), out


def sync_audit(path, fn, kernels, flagged, expect=None):
    """One path's syncs: every site inside SYNC_SCOPE must be on a line
    ``device-sync`` flags or in ``SYNC_UNSEEN``; the path must launch each
    of ``kernels``; ``expect`` ("path:line" → count) are sites the audit
    must see, so that it is known to reach the port's frames."""
    from repro_torch.kernels import ops

    stale = {site: entry["line"] for site, entry in SYNC_UNSEEN.items()
             if entry["line"] not in _port_text(site)}
    if stale:
        raise AssertionError(f"SYNC_UNSEEN names lines that no longer hold "
                             f"their text: {stale}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sites, _ = sync_sites(fn)
    seconds = time.perf_counter() - t0
    launches = {name: ops.launch_counts()[name] for name in kernels}
    in_scope = {s: n for s, n in sites.items() if in_sync_scope(s)}
    unflagged = [s for s in in_scope if s not in flagged
                 and s not in SYNC_UNSEEN]
    emit({"sync_audit": {
        "path": path, "syncs": sum(sites.values()), "sites": sites,
        "in_scope": in_scope, "unflagged": unflagged,
        "unseen": {s: SYNC_UNSEEN[s]["why"] for s in in_scope
                   if s in SYNC_UNSEEN},
        "out_of_scope": {s: n for s, n in sites.items() if s not in in_scope},
        "launches": launches, "seconds": seconds}})
    missed = {s: (n, sites.get(s, 0)) for s, n in (expect or {}).items()
              if sites.get(s, 0) != n}
    if missed:
        raise AssertionError(f"sync_audit {path}: expected syncs (want, got) "
                             f"{missed}: the audit does not see them")
    if unflagged:
        raise AssertionError(f"sync_audit {path}: syncs inside SYNC_SCOPE "
                             f"on lines device-sync does not flag: "
                             f"{unflagged}")
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"sync_audit {path}: kernels {idle} never "
                             "launched")


def _port_text(site) -> str:
    """The text of the line a "path:line" site under ``src/repro_torch``
    names ("" past the file's end)."""
    rel, line = site.rsplit(":", 1)
    with open(os.path.join(REPO, "src", "repro_torch", rel),
              encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    return lines[int(line) - 1] if int(line) <= len(lines) else ""


def _port_line(rel, text):
    """"rel:line" of the first line of ``src/repro_torch/rel`` that holds
    ``text``."""
    with open(os.path.join(REPO, "src", "repro_torch", rel),
              encoding="utf-8") as fh:
        for i, line in enumerate(fh, start=1):
            if text in line:
                return f"{rel}:{i}"
    raise AssertionError(f"{rel} holds no line with {text!r}")


def sync_audit_lm(model, flagged):
    """Audit paths (b) and (c): ``Engine.generate`` of mamba2-370m at 1 ×
    512 + 8 new tokens (kernel 6 in its prefill), then one
    ``make_train_step`` step at 2 × 512 (which updates ``model``)."""
    import numpy as np

    from repro_torch.launch.train import make_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train import make_train_step

    cfg = model.cfg
    requests, prompt_len, new_tokens = SYNC_AUDIT_LM
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (requests, prompt_len), dtype=np.int32)
    engine = Engine(cfg, model, ServeConfig(max_new_tokens=new_tokens))
    token_copy = _port_line("serve/engine.py", "outs.append(tok.cpu())")
    sync_audit("lm_generate", lambda: engine.generate(prompts),
               ["ssd_intra"], flagged, expect={token_copy: new_tokens - 1})
    opt = AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(cfg, opt)
    state = adamw_init(dict(model.named_parameters()), opt)
    batch = make_batch(cfg, *SYNC_AUDIT_TRAIN, 0, "cuda")
    sync_audit("train_step", lambda: step(model, state, batch),
               ["ssd_intra"], flagged)


def sync_audit_search(index, queries, preds, flagged):
    """Audit path (a): one Path A batch of ``search(backend="torch")`` in
    float32, without the ``mark`` hook (its CUDA events would sync)."""
    import torch

    sync_audit("path_a_search",
               lambda: search_torch(index, queries, preds, torch.float32),
               ["hamming_stacked", "adc_direct"], flagged)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit("run chip_smoke.py from the root of a checkout: "
                         f"{src}/repro_torch is missing")
    sys.path.insert(0, src)          # a spawned worker inherits sys.path
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    per_lib = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in build.build_logs().items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": per_lib, "ptxas": ptxas})

    # The dry runs need no card: they run on the host beside everything
    # else and are collected at the end.
    dry_dir = tempfile.mkdtemp(prefix="dryrun-")
    dryruns = start_dryruns(dry_dir)
    try:
        return run_phases(args, card, t_start, dryruns)
    finally:
        for proc, _ in dryruns.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(dry_dir, ignore_errors=True)


def run_phases(args, card, t_start, dryruns) -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import SquashConfig
    from repro_torch.data import synthetic

    lint_phase()
    flagged = flagged_sync_lines()
    lm_model = lm_check()
    lm_launches = lm_serve(LM_REQUESTS, LM_PROMPT_LEN, LM_NEW_TOKENS)
    lm_profile(lm_model, LM_REQUESTS, LM_PROMPT_LEN)
    sync_audit_lm(lm_model, flagged)
    del lm_model
    torch.cuda.empty_cache()
    zamba_launches, zamba_shape = lm_families()
    lm_serve_llama3(LM_REQUESTS, LM_PROMPT_LEN, LM_NEW_TOKENS)
    train_check()
    grad_res = ssd_grad()
    train_launches, train_rep = train_run()
    train_llama3_width()
    sharded_launches = {"sharded_check": sharded_check(),
                        "sharded_train_run": sharded_train_run(train_rep)}
    rag_counts = rag_phase()
    wide = check_wide()

    cfg_a = SquashConfig(num_partitions=10, max_bits_per_dim=8,
                         kmeans_iters=4, lloyd_iters=6)
    cfg_b = dataclasses.replace(cfg_a, max_bits_per_dim=5)
    # Both host builds at once: Path B's in a spawned worker (terminated
    # when the pool closes), Path A's here.
    t_builds = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending_b = pool.apply_async(build_in_worker, (args.rows_b, cfg_b))
        t0 = time.perf_counter()
        ds = make_dataset()
        preds = synthetic.default_predicates()
        emit({"phase": "dataset", "rows": ds.n, "dim": ds.d,
              "queries": int(ds.queries.shape[0]), "seconds":
              time.perf_counter() - t0, "predicates": [dataclasses.asdict(p)
                                                       for p in preds]})
        for path, rows in (("A", args.rows_a), ("B", args.rows_b)):
            if rows != ds.n:
                emit({"phase": "cut", "path": path, "rows": rows, "of": ds.n})
        index_a, build_a = build_index(ds, args.rows_a, cfg_a)
        index_b, build_b = pending_b.get()
    builds_s = time.perf_counter() - t_builds
    emit_build("path_a", index_a, args.rows_a, cfg_a, build_a)
    emit_build("path_b", index_b, args.rows_b, cfg_b, build_b,
               built_in="a worker process, beside Path A's build",
               both_builds_wall_s=builds_s)

    launches_a, gt_a = run_path("path_a", ds, args.rows_a, index_a, preds,
                                check_f32=True,
                                timed_batches=args.timed_batches)
    launches_b, _ = run_path("path_b", ds, args.rows_b, index_b, preds,
                             check_f32=False,
                             timed_batches=args.timed_batches)
    sync_audit_search(index_a, ds.queries.astype("float64"), preds, flagged)

    packed_a, extract_launches = extract_path(index_a)

    launches = {name: launches_a[name] + launches_b[name]
                for name in launches_a}
    per_path = {"hamming_stacked": launches["hamming_stacked"],
                "adc_direct": launches_a["adc_direct"],
                "adc_batch": launches_b["adc_batch"],
                "extract_codes": extract_launches["extract_codes"],
                "ssd_intra": (lm_launches["ssd_intra"] + zamba_launches
                              + train_launches
                              + sum(sharded_launches.values()))}
    missing = [name for name, n in per_path.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing} (counts A {launches_a}, B "
                             f"{launches_b}, extraction {extract_launches}, "
                             f"LM serve {lm_launches})")

    lm_cfg = get_config(LM_ARCH)
    heads = lm_cfg.ssm_expand * lm_cfg.d_model // lm_cfg.ssm_headdim
    ssd_shape = (LM_REQUESTS * LM_PROMPT_LEN // lm_cfg.ssm_chunk, heads,
                 lm_cfg.ssm_chunk, lm_cfg.ssm_state, lm_cfg.ssm_headdim)
    queries = ds.queries.astype("float64")
    entries = check_kernels(
        index_a, index_b, queries, preds, {**launches, **per_path}, packed_a,
        {LM_ARCH: (ssd_shape, lm_launches["ssd_intra"]),
         "zamba2-7b": (zamba_shape, zamba_launches)})
    # The new phases come after the kernels phase, which must see the
    # indexes unmutated; their launches join the kernels line below.
    # The socket and mesh phases come before live, which mutates Path B.
    serverless_counts, local_cold = serverless_phase(
        index_a, queries, preds, gt_a, args.rows_a)
    serverless_socket_phase(index_a, queries, preds, local_cold, args.rows_a)
    by_phase = {"path_a": launches_a, "path_b": launches_b,
                "serverless_local": serverless_counts,
                "mesh": mesh_phase(index_a, index_b, queries, preds),
                "live": live_phase(index_b, queries, preds),
                "rag": rag_counts}
    collect_dryruns(dryruns)
    for entry in entries:
        if entry["name"] in wide:
            entry["wide_d"] = wide[entry["name"]]
        if entry["name"] == "ssd_intra":
            entry["launches_by_phase"]["train"] = train_launches
            entry["launches_by_phase"].update(sharded_launches)
            entry["launches"] += train_launches + sum(
                sharded_launches.values())
            entry["training"] = {
                key: grad_res[key] for key in (
                    "shape", "forward_kernel_ms", "backward_ms",
                    "backward_bound_ms", "backward_bound_by",
                    "plain_forward_ms")}
            entry["training"]["backward"] = (
                "plain PyTorch (ref.ssd_intra_vjp) through "
                "ssd.SsdIntraFunction: the TPU kernel has no backward")
        if entry["name"] in ("hamming_stacked", "adc_direct", "adc_batch"):
            entry["launches_by_phase"] = {
                phase: counts[entry["name"]]
                for phase, counts in by_phase.items()
                if counts[entry["name"]] or phase != "rag"}
            entry["launches"] = sum(entry["launches_by_phase"].values())
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
