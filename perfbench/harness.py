"""One run of one cell: set-up, the measured window under C clients, the
post-window memory reading, and the comparison with the reference.

The program under test is ``repro_torch`` (the PyTorch and CUDA port):
``SquashIndex.build`` in set-up and ``SquashIndex.search(..., backend=
"torch")`` in the window. Everything else is the benchmark's own: the
corpus and batches (``gen``), the reference (``reference/``), the bounds
(``bounds``), the trace reduction (``devtrace``) and the metric readers
(``metrics/``).
"""

from __future__ import annotations

import math
import os
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import bounds, gen, load

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def src_path(root: Path = load.ROOT) -> None:
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


class Memory:
    """Device memory readings; zeros on the CPU (tests only)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def peak(self) -> int:
        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def allocated(self) -> int:
        return int(torch.cuda.memory_allocated()) if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()


class Cell:
    """A cell's inputs, made from the seed, and (after :meth:`build`) the
    program's index on the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.k = traffic["k"]
        self.idx_cfg = config["index"]
        self.cardinality = config["data"]["attr_cardinality"]
        self.corpus = gen.corpus(config, traffic, seed)
        self.index = self.stacked = None

    def build(self) -> None:
        """The program's set-up: the host index build and the stack on the
        device, in the configuration's dtype."""
        from repro_torch.core.pipeline import SquashConfig, SquashIndex

        fields = {f: self.idx_cfg[f] for f in SquashConfig.__dataclass_fields__
                  if f in self.idx_cfg}
        t0 = time.perf_counter()
        self.index = SquashIndex.build(
            self.corpus.vectors, self.corpus.attributes,
            SquashConfig(**fields), seed=self.idx_cfg["build_seed"])
        t1 = time.perf_counter()
        torch.set_default_dtype(getattr(torch, self.config["dtype"]))
        self.stacked = self.index.stacked(torch.get_default_dtype(),
                                          torch.device(self.device))
        self.build_phases = {"index_build_s": t1 - t0,
                             "stack_s": time.perf_counter() - t1}

    def free(self) -> None:
        """Drop the program's device state."""
        self.index._stacked_cache.clear()
        self.stacked = None

    def batch(self, b: int):
        """Batch ``b``'s queries, its predicate as (attr, lo, hi) triples,
        and the same predicate as the program's ``Predicate`` objects."""
        q, preds = gen.batch_inputs(self.traffic, self.cardinality,
                                    self.corpus.queries, self.seed, b)
        if self.index is None:
            return q, preds, None
        from repro_torch.core.attributes import Predicate

        return q, preds, [Predicate(attr=a, op="B", lo=lo, hi=hi)
                          for a, lo, hi in preds]

    def shape(self) -> dict:
        st = self.stacked
        keep_s, take_s = bounds.static_slots(st.n_max, self.idx_cfg, self.k)
        return {"Q": self.traffic["batch"], "P": st.num_partitions,
                "n_max": st.n_max, "G": int(st.low_packed.shape[2]),
                "d": int(st.codes.shape[2]),
                "m1": int(st.boundaries.shape[1]), "keep_s": keep_s,
                "take_s": take_s, "k": self.k}


class Clients:
    """C client threads in a closed loop, each sending its next batch when
    the answer to the last has come."""

    def __init__(self, cell: Cell, clients: int, trace: bool):
        self.cell, self.trace = cell, trace
        self.clients = clients
        self.lock = threading.Lock()
        self.next_b = 0
        self.stop = threading.Event()
        self.records: List[dict] = []
        self.errors: List[str] = []

    def _take(self) -> int:
        with self.lock:
            b = self.next_b
            self.next_b += 1
            return b

    def one(self, b: int) -> dict:
        cell = self.cell
        q, _, preds = cell.batch(b)
        rec = {"b": b}
        t0 = time.perf_counter()
        rec["t_send"] = t0
        if not self.trace:
            ids, dists, stats = cell.index.search(
                q, preds, k=cell.k, backend="torch", device=cell.device)
        else:
            rf = torch.profiler.record_function
            with rf("bench.select"):
                q64, cands, stats = cell.index.select(q, preds, cell.k)
            t1 = time.perf_counter()
            rec["select_s"] = t1 - t0
            ranges = {"start": "bench.stage3", "hamming": "bench.stage4",
                      "adc": "bench.stage5", "refine_merge": "bench.fetch"}
            open_rf = [rf("bench.prep")]
            open_rf[0].__enter__()

            def mark(name):
                if name == "start":
                    rec["prep_s"] = time.perf_counter() - t1
                open_rf[0].__exit__(None, None, None)
                open_rf[0] = rf(ranges[name])
                open_rf[0].__enter__()

            try:
                ids, dists, stats = cell.index._search_torch(
                    q64, cands, cell.k, stats, torch.device(cell.device),
                    mark=mark)
            finally:
                open_rf[0].__exit__(None, None, None)
        rec["t_done"] = time.perf_counter()
        rec["ids"], rec["dists"] = ids, dists
        rec["stats"] = {f: getattr(stats, f) for f in (
            "queries", "filter_pass", "partitions_visited", "hamming_in",
            "hamming_kept", "adc_evals", "refined")}
        return rec

    def _loop(self, warm: int, barrier: threading.Barrier):
        try:
            self.one(-1 - warm)
        except Exception as exc:  # reported as the run's failure
            self.errors.append(f"warm-up: {exc!r}")
        barrier.wait()
        while not self.stop.is_set():
            b = self._take()
            try:
                rec = self.one(b)
            except Exception as exc:  # a failed batch counts as failed
                self.errors.append(f"batch {b}: {exc!r}")
                rec = {"b": b, "failed": True, "t_done": time.perf_counter()}
            with self.lock:
                self.records.append(rec)

    def start(self) -> threading.Barrier:
        barrier = threading.Barrier(self.clients + 1)
        self.threads = [threading.Thread(target=self._loop, args=(i, barrier),
                                         daemon=True)
                        for i in range(self.clients)]
        for t in self.threads:
            t.start()
        return barrier

    def join(self, timeout: float) -> bool:
        self.stop.set()
        end = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(end - time.perf_counter(), 0.0))
        return not any(t.is_alive() for t in self.threads)


def one_batch_memory(cell: Cell, mem: Memory):
    """(peak bytes, bytes the batch added): one batch of the cell's shape
    alone, after the window."""
    mem.sync()
    mem.reset_peak()
    resident = mem.allocated()
    q, _, preds = cell.batch(-1)
    cell.index.search(q, preds, k=cell.k, backend="torch", device=cell.device)
    mem.sync()
    peak = mem.peak()
    return peak, peak - resident


def eval_batches(done: List[int], traffic: dict, seed: int) -> List[int]:
    """The batches whose answers are compared: a draw from the seed among
    the first ``eval_range`` batches answered in the window."""
    pool = sorted(done)[:traffic["eval_range"]]
    rng = np.random.default_rng([int(seed), 2])
    n = min(traffic["eval_batches"], len(pool))
    return sorted(rng.choice(pool, size=n, replace=False).tolist())


class Reference:
    """The reference index, built again from the cell's corpus, on
    ``device``; judges answers against its own."""

    def __init__(self, cell: Cell, device: str, dtype: str = "float64"):
        from perfbench.reference import build as rbuild, search as rsearch

        t0 = time.perf_counter()
        self.cell, self.device, self.rsearch = cell, device, rsearch
        index = rbuild.build(cell.corpus.vectors, cell.idx_cfg)
        self.dev = rsearch.DeviceIndex(index, device, getattr(torch, dtype))
        self.vec = torch.as_tensor(cell.corpus.vectors, dtype=torch.float64,
                                   device=device)
        self.norms = (self.vec * self.vec).sum(-1)
        self.build_s = time.perf_counter() - t0

    def answer(self, b: int, dev=None, tf32: bool = False):
        """The reference's (ids, dists, stats) for batch ``b``; ``dev`` and
        ``tf32`` give the control (another precision of the same search)."""
        cell = self.cell
        q, preds, _ = cell.batch(b)
        return self.rsearch.search(dev or self.dev, cell.corpus.attributes,
                                   q, preds, cell.idx_cfg, cell.k, tf32=tf32)

    def judge(self, answers: Dict[int, dict], batches: List[int]) -> dict:
        """The numbers compared for the answers of ``batches``, and
        recall@k against the exact filtered top-k."""
        t0 = time.perf_counter()
        cell, device = self.cell, self.device
        stats_gap, gap, missed, total, hits, truth = 0, 0.0, 0, 0, 0, 0
        n = self.vec.shape[0]
        for b in batches:
            rec = answers[b]
            q, preds, _ = cell.batch(b)
            r_ids, _, r_stats = self.answer(b)
            stats_gap += sum(abs(int(rec["stats"][f]) - r_stats[f])
                             for f in r_stats)
            ids = np.asarray(rec["ids"])
            dists = np.asarray(rec["dists"], np.float64)
            ok = (ids >= 0) & (ids < n)
            if np.any(ok != np.isfinite(dists)):
                gap = math.inf
            if ok.any():
                qt = torch.as_tensor(q, dtype=torch.float64, device=device)
                qi, si = np.nonzero(ok)
                x = self.vec[torch.as_tensor(ids[qi, si], device=device)]
                d = x - qt[torch.as_tensor(qi, device=device)]
                exact = torch.sqrt((d * d).sum(-1)).cpu().numpy()
                rel = np.abs(dists[qi, si] - exact) / np.maximum(exact, 1e-30)
                gap = max(gap, float(rel.max()))
            for row, ref_row in zip(ids, r_ids):
                want = {int(i) for i in ref_row if i >= 0}
                missed += len(want - {int(i) for i in row if i >= 0})
                total += len(want)
            mask = gen.filter_mask(cell.corpus.attributes, preds)
            best = self.rsearch.exact_topk(self.vec, self.norms, mask, q,
                                           cell.k)
            for row, want in zip(ids, best):
                hits += len(want & {int(i) for i in row if i >= 0})
                truth += len(want)
        return {"stats_gap": stats_gap, "dist_gap": gap,
                "id_miss": missed / max(total, 1),
                "recall": hits / max(truth, 1),
                "queries": int(sum(len(answers[b]["ids"]) for b in batches)),
                "reference_build_s": self.build_s,
                "reference_s": self.build_s + time.perf_counter() - t0}


COMPARED = ("stats_gap", "dist_gap", "id_miss")


def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values), 95))


def window(cell: Cell, n_clients: int, seconds: float, trace: bool,
           mem: Memory, t_start: float) -> dict:
    """Warm up one batch per client, then measure ``seconds`` under
    ``n_clients`` closed-loop clients (traced with ``trace``). Returns the
    batch records, the window's bounds, set-up seconds from ``t_start``
    and, traced, the trace's summary."""
    cl = Clients(cell, n_clients, trace)
    barrier = cl.start()
    while barrier.n_waiting < n_clients:      # the warm-up batches run
        time.sleep(0.01)
    mem.sync()
    prof = window_rf = None
    if trace:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        # The client threads' ranges are recorded only with all threads on.
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if mem.cuda else []),
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
        window_rf = torch.profiler.record_function("bench.window")
    t0 = time.perf_counter()
    t_end = t0 + seconds
    if window_rf is not None:
        window_rf.__enter__()
    barrier.wait()
    time.sleep(max(t_end - time.perf_counter(), 0.0))
    if window_rf is not None:
        window_rf.__exit__(None, None, None)
    joined = cl.join(60.0 + seconds)
    mem.sync()
    summary = None
    if prof is not None:
        prof.stop()
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(tmp)
            del prof
            if mem.cuda:
                from perfbench import devtrace

                summary = devtrace.summarize(tmp)
        finally:
            os.unlink(tmp)
    records = sorted(cl.records, key=lambda r: r["b"])
    done = [r for r in records if not r.get("failed")]
    in_window = [r for r in done if r["t_done"] <= t_end]
    lat = [(r["t_done"] - r["t_send"]) * 1e3 for r in in_window]
    return {"setup_s": t0 - t_start, "seconds": seconds, "records": records,
            "done": done, "in_window": in_window, "latency_ms": lat,
            "qps": sum(len(r["ids"]) for r in in_window) / seconds,
            "joined": joined, "errors": cl.errors, "summary": summary,
            "memory_peak": mem.peak()}


def run(workload_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = load.ROOT,
        t_start: Optional[float] = None) -> dict:
    """One run of a cell; returns the result object (``correct`` and all).

    ``t_start`` is the process's start on the host clock, from which
    ``setup_s`` counts.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load.benchmark(root)
    work = load.workload(bench, workload_name)
    config = load.config(bench, work["config"], root)
    traffic = load.traffic(work["traffic"], Path(root) / "perfbench")
    readers = load.per_layer(bench, workload_name, Path(root) / "perfbench")
    torch.set_num_threads(traffic["threads"]["torch_intra_op"])
    mem = Memory(device)
    phases = {}
    t = time.perf_counter()
    if mem.cuda:
        from repro_torch.kernels import build as kbuild

        kbuild.build_all(["hamming", "adc_lookup"])
    phases["kernels_s"] = time.perf_counter() - t
    cell = Cell(config, traffic, seed, device)
    phases["corpus_s"] = time.perf_counter() - t - phases["kernels_s"]
    cell.build()
    phases.update(cell.build_phases)
    w = window(cell, traffic["clients"], seconds, trace, mem, t_start)
    peak_one, added_one = one_batch_memory(cell, mem)
    shape = cell.shape()
    # Free the program's device state before the reference runs.
    cell.free()
    if mem.cuda:
        torch.cuda.empty_cache()
    answers = {r["b"]: r for r in w["done"]}
    chosen = eval_batches([r["b"] for r in w["in_window"]] or list(answers),
                          traffic, seed)
    check = Reference(cell, device).judge(answers, chosen)
    limits = config["limits"]
    compared = {name: {"value": check[name], "limit": limits[name]}
                for name in COMPARED}
    correct = (w["joined"] and not w["errors"] and bool(chosen)
               and all(v["value"] <= v["limit"] for v in compared.values()))
    records = w["records"]
    result = {"correct": bool(correct),
              "attempted": traffic["batch"] * len(records),
              "failed": traffic["batch"] * sum(1 for r in records
                                               if r.get("failed"))}
    if not trace:
        lat = w["latency_ms"]
        metrics = {"qps": w["qps"],
                   "batch_p95_ms": p95(lat) if lat else None,
                   "recall_at_10": check["recall"],
                   "device_gb": peak_one / 1e9,
                   "setup_s": w["setup_s"]}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        wanted = [m["name"] for m in load.end_to_end(bench, workload_name)]
        result["metrics"] = {n: {"value": metrics[n], "unit": units[n]}
                             for n in wanted if metrics.get(n) is not None}
    else:
        rec = {"batches": [{"select_s": r["select_s"], "prep_s": r["prep_s"],
                            "queries": len(r["ids"]),
                            "live_slots": r["stats"]["hamming_kept"]}
                           for r in w["done"] if "prep_s" in r],
               "shape": shape, "batch_added_bytes": added_one,
               **(w["summary"] or {})}
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        result["metrics"] = {}
        for name, read in readers.items():
            value = read(rec)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": units[name]}
    result["device"] = device_info(device, w["memory_peak"])
    if w["summary"] is not None:
        result["device"]["busy_s"] = w["summary"]["busy_s"]
        result["device"]["window_s"] = w["summary"]["window_s"]
        result["breakdown"] = w["summary"]["breakdown"]
    lat = w["latency_ms"]
    result["info"] = {
        "clients": traffic["clients"], "batches_in_window": len(w["in_window"]),
        "batches_sent": len(records), "errors": w["errors"][:5],
        "eval_batches": chosen, "eval_queries": check["queries"],
        "reference_build_s": check["reference_build_s"],
        "reference_s": check["reference_s"], "shape": shape,
        "batch_ms_median": statistics.median(lat) if lat else None,
        "stage_device_s": (w["summary"] or {}).get("stage_device_s"),
        "setup_phases": phases,
        "trace_ops": [(w["summary"] or {}).get(k) for k in (
            "device_ops", "device_ops_in_spans")],
    }
    for name, v in compared.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result["check"] = compared
    return result


def device_info(device: str, memory_peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": 1, "memory_peak_bytes": int(memory_peak)}
