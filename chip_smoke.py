#!/usr/bin/env python3
"""Drive the PyTorch port of SQUASH on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (sm_90a), then drives the port's main path — filtered top-k search
(host Stage 1–2 → Hamming prune → ADC lower bounds → refine → merge) —
through ``SquashIndex.search(backend="torch")`` on the card:

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
  the two builds take the time of the longer one.
* Kernels: each CUDA kernel against its plain PyTorch version at the
  paths' shapes (Hamming exact; ADC rtol 1e-5, atol 0: f32 sums of ≤ d
  non-negative terms in another order), with its time, the plain
  version's time and its bound on the card.

Launch counters are set to 0 just before each path's searches and read just
after; every kernel must have launched on the path that runs it. Every
check raises on failure, so the script exits non-zero. The last lines are a
``{"kernels": [...]}`` JSON line, the card's name and power limit from
``nvidia-smi``, and ``{"ok": true, "device": {...}}``.

Needs: one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``), torch,
numpy. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate
ADC_RTOL = 1e-5                # f32 sums of ≤ d non-negative terms, reordered
K = 10
NUM_QUERIES = 64
SLICE_Q = 8                    # queries of the direct kernel's plain check


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
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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


def search_torch(index, queries, preds, dtype):
    import torch

    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return index.search(queries, preds, k=K, backend="torch")
    finally:
        torch.set_default_dtype(prev)


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

            t0 = time.perf_counter()
            q64, cands, stats = index.select(queries, preds, K)
            t1 = time.perf_counter()
            index._search_torch(q64, cands, K, stats, device, mark=mark)
            t2 = time.perf_counter()          # ids are on the host: synced
            row = {
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
    """Search on numpy and torch and compare; returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    vectors, attrs = ds.vectors[:rows], ds.attributes[:rows]
    queries = ds.queries.astype(np.float64)
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
    return counts


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
    cand_mask, _ = dataplane.build_cand_arrays(cands, q64.shape[0], p, n_max)
    keep_s, _ = dataplane.static_counts(n_max, index.config, K)
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
    return stacked, qbits, sel, qt


def kernel_entry(name, source, replaces, launches, max_err, ms, plain_ms,
                 nbytes, ops, **extra):
    b_ms, b_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bytes": float(nbytes), **extra}


def check_kernels(index_a, index_b, queries, preds, launches):
    import torch

    from repro_torch.core import dataplane
    from repro_torch.kernels import adc_lookup, hamming, ref

    entries = []
    # --- kernel 1 (Hamming) at Path A's shapes, exact ------------------
    stacked, qbits, sel, qt32 = stage_inputs(index_a, queries, preds,
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
        cuda_ms(lambda: hamming.hamming_stacked(qbits, stacked.low_packed), 20),
        cuda_ms(lambda: ref.hamming_stacked_ref(qbits, stacked.low_packed), 3),
        4 * (qn * p * g + p * n * g + qn * p * n), 3 * qn * p * n * g,
        shape={"Q": qn, "P": p, "N": n, "G": g}, tolerance="exact"))
    # view 3: packed_hamming = kernel 1 at Q = P = 1
    v3 = hamming.packed_hamming(qbits[0, 0].contiguous(),
                                stacked.low_packed[0].contiguous())
    if not torch.equal(v3, ref.hamming_ref(qbits[0, 0], stacked.low_packed[0])):
        raise AssertionError("packed_hamming view differs from hamming_ref")

    # --- kernel 2b (direct) at Path A's shapes, both float widths -------
    m1 = stacked.boundaries.shape[1]
    d = qt32.shape[-1]
    s = sel.shape[-1]
    qcell = dataplane.query_cells(qt32, stacked.boundaries)
    args32 = (qt32, qcell, stacked.boundaries, stacked.codes, sel)
    direct_ms = cuda_ms(lambda: adc_lookup.adc_direct(*args32), 5)
    sl = slice(0, SLICE_Q)
    sliced32 = (qt32[sl].contiguous(), qcell[sl].contiguous(),
                stacked.boundaries, stacked.codes, sel[sl].contiguous())
    out_k = adc_lookup.adc_direct(*sliced32)
    out_p = ref.adc_direct_ref(*sliced32)
    torch.testing.assert_close(out_k, out_p, rtol=ADC_RTOL, atol=0)
    err = float((out_k - out_p).abs().max())
    stacked64, _, sel64, qt64 = stage_inputs(index_a, queries, preds,
                                             torch.float64)
    qcell64 = dataplane.query_cells(qt64, stacked64.boundaries)
    sliced64 = (qt64[sl].contiguous(), qcell64[sl].contiguous(),
                stacked64.boundaries, stacked64.codes, sel64[sl].contiguous())
    out_k64 = adc_lookup.adc_direct(*sliced64)
    out_p64 = ref.adc_direct_ref(*sliced64)
    torch.testing.assert_close(out_k64, out_p64, rtol=ADC_RTOL, atol=0)
    err = max(err, float((out_k64 - out_p64).abs().max()))
    rows_needed = torch.unique(
        sel + torch.arange(p, device=sel.device)[None, :, None] * n).numel()
    entries.append(kernel_entry(
        "adc_direct", "src/repro_torch/kernels/csrc/adc_lookup.cu",
        "src/repro/core/dataplane.py:282", launches["adc_direct"], err,
        direct_ms, cuda_ms(lambda: ref.adc_direct_ref(*sliced32), 2),
        4 * (2 * qn * p * d + p * m1 * d + rows_needed * d + qn * p * s)
        + 8 * qn * p * s,
        4 * qn * p * s * d,
        shape={"Q": qn, "P": p, "S": s, "d": d, "M+1": m1,
               "n_max": n, "dtype": "float32"},
        plain_queries=SLICE_Q,
        ms_on_plain_queries=cuda_ms(lambda: adc_lookup.adc_direct(*sliced32),
                                    5),
        ms_f64=cuda_ms(lambda: adc_lookup.adc_direct(
            qt64, qcell64, stacked64.boundaries, stacked64.codes, sel64), 5),
        gathered_code_bytes=4 * qn * p * s * d,
        tolerance=f"rtol={ADC_RTOL}, atol=0"))
    del stacked64, sel64, qt64, qcell64, out_p, out_p64

    # --- kernel 2 (table) at Path B's shapes ---------------------------
    stacked, _, sel, qt = stage_inputs(index_b, queries, preds, torch.float64)
    qn, p, s = sel.shape
    m1 = stacked.boundaries.shape[1]
    p_idx = torch.arange(p, device=sel.device)[None, :, None]
    codes = stacked.codes[p_idx, sel].reshape(qn * p, s, d)
    tables = dataplane.adc_table_batch(
        qt, stacked.boundaries[None], stacked.cells[None]).reshape(
        qn * p, m1, d).to(torch.float32).contiguous()
    out_k = adc_lookup.adc_batch(tables, codes)
    out_p = ref.adc_lb_batch_ref(tables, codes)
    torch.testing.assert_close(out_k, out_p, rtol=ADC_RTOL, atol=0)
    err = float((out_k - out_p).abs().max())
    sq_k = adc_lookup.adc_batch(tables, codes, sqrt=False)
    sq_p = ref.adc_lb_batch_ref(tables, codes, sqrt=False)
    torch.testing.assert_close(sq_k, sq_p, rtol=ADC_RTOL, atol=0)
    err = max(err, float((sq_k - sq_p).abs().max()))
    # view 4: adc_lb_distances = kernel 2 at B = 1
    v4 = adc_lookup.adc_lb_distances(tables[0].contiguous(),
                                     codes[0].contiguous())
    torch.testing.assert_close(v4, ref.adc_lb_ref(tables[0], codes[0]),
                               rtol=ADC_RTOL, atol=0)
    b = qn * p
    entries.append(kernel_entry(
        "adc_batch", "src/repro_torch/kernels/csrc/adc_lookup.cu",
        "src/repro/kernels/adc_lookup.py:127", launches["adc_batch"], err,
        cuda_ms(lambda: adc_lookup.adc_batch(tables, codes), 10),
        cuda_ms(lambda: ref.adc_lb_batch_ref(tables, codes), 3),
        4 * (b * m1 * d + b * s * d + b * s), b * s * d,
        shape={"B": b, "M+1": m1, "N": s, "d": d},
        tolerance=f"rtol={ADC_RTOL}, atol=0"))
    emit({"phase": "views", "packed_hamming": "equal",
          "adc_lb_distances": "within tolerance"})
    return entries


# -------------------------------------------------------------------- main

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
    from repro_torch.core.pipeline import SquashConfig
    from repro_torch.data import synthetic
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
                    if "registers" in ln or "spill" in ln]
             for name, log in build.build_logs().items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": per_lib, "ptxas": ptxas})

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

    launches_a = run_path("path_a", ds, args.rows_a, index_a, preds,
                          check_f32=True, timed_batches=args.timed_batches)
    launches_b = run_path("path_b", ds, args.rows_b, index_b, preds,
                          check_f32=False, timed_batches=args.timed_batches)

    launches = {name: launches_a[name] + launches_b[name]
                for name in launches_a}
    per_path = {"hamming_stacked": launches["hamming_stacked"],
                "adc_direct": launches_a["adc_direct"],
                "adc_batch": launches_b["adc_batch"]}
    missing = [name for name, n in per_path.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing} (counts A {launches_a}, B "
                             f"{launches_b})")

    entries = check_kernels(index_a, index_b, ds.queries.astype("float64"),
                            preds, launches)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
