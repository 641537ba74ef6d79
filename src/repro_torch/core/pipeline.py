"""SQUASH multi-stage search pipeline (paper §2.4, Fig. 4 + Fig. 5 data plane).

The port of the JAX package's ``repro.core.pipeline``.

Build (NumPy, bit for bit as the reference): balanced partitions →
per-partition KLT → variance-greedy bit allocation → Lloyd-Max scalar
quantizers → segment-packed primary OSQ index + 1-bit low-bit OSQ index →
quantized attribute index.

Search: predicate parse → R lookup → filter mask F → Algorithm 1 partition
selection → per-partition: low-bit Hamming prune → ADC lookup-table LB
distances → optional R·k full-precision post-refinement → single-pass
MPI-style top-k merge.

Two query data planes execute Stages 3–5, selected by
``SquashConfig.backend`` (or per-call via ``search(..., backend=...)``):

* ``"numpy"`` — the per-query reference loop in this module: per visited
  partition, NumPy stage math with deterministic (score, row) tie-breaking.
* ``"torch"`` — the batched plane in ``repro_torch.core.dataplane``: all
  queries × all partitions stacked to fixed shapes, on the card by default
  (``device=None`` means ``"cuda"``; without CUDA the call raises unless the
  caller passes ``device="cpu"``). Float width follows
  ``torch.get_default_dtype()``: float64 is the parity configuration,
  float32 the deployment one. Returns bitwise-identical ids to the NumPy
  plane in float64.

:func:`index_to_arrays` / :func:`index_from_arrays` carry a built index
across as plain numpy arrays — also a reference-built one, since the
reader goes by attribute name — with a live index's tombstones and mutation
ledger (generations, version, segment blocks, dirty partitions).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import adc, attributes as attr_mod, lowbit, osq, partitions, segments
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.spans import profiler_range as _span

__all__ = ["SquashConfig", "PartitionIndex", "SquashIndex", "SearchStats",
           "BACKENDS", "resolve_device", "index_to_arrays",
           "index_from_arrays"]

BACKENDS = ("numpy", "torch")


@dataclasses.dataclass
class SquashConfig:
    """Index + search hyper-parameters (paper §5.1/§5.3 defaults)."""

    num_partitions: int = 10
    bits_per_dim: float = 4.0          # bit budget b = bits_per_dim * d
    segment_bits: int = 8              # S
    use_klt: bool = True               # unitary decorrelating transform
    hamming_perc: float = 10.0         # H_perc — % of candidates kept (static;
                                       # superseded per-partition by an
                                       # installed autotune CalibrationProfile)
    refine_ratio: float = 2.0          # R — full-precision re-rank multiplier
    beta: float = 0.001                # Eq. 1 β
    threshold_override: Optional[float] = None
    kmeans_iters: int = 10
    lloyd_iters: int = 15
    max_bits_per_dim: int = 12
    enable_refine: bool = True
    min_hamming_keep: int = 64         # floor so tiny candidate sets survive
    backend: str = "numpy"             # Stage 3–5 data plane: numpy | torch


@dataclasses.dataclass
class PartitionIndex:
    """Per-partition OSQ index — what one QueryProcessor holds (paper §3.1)."""

    vector_ids: np.ndarray           # (n_p,) global ids, local order
    klt: Optional[np.ndarray]        # (d, d) unitary transform (or None)
    mean: np.ndarray                 # (d,) transform centering
    quant: osq.OSQQuantizer
    layout: segments.SegmentLayout
    packed: np.ndarray               # (n_p, G) packed primary codes
    codes: np.ndarray                # (n_p, d) unpacked codes (in-memory Q-index)
    low: lowbit.LowBitIndex          # 1-bit secondary index
    vectors: np.ndarray              # (n_p, d) full precision (the 'EFS' copy)

    @property
    def size(self) -> int:
        return int(self.vector_ids.shape[0])

    def transform(self, q: np.ndarray) -> np.ndarray:
        q = q - self.mean
        return q @ self.klt if self.klt is not None else q

    def index_bytes(self) -> int:
        return int(self.packed.nbytes + self.low.packed.nbytes)


@dataclasses.dataclass
class SearchStats:
    """Per-stage pruning accounting (drives the cost model)."""

    queries: int = 0
    filter_pass: int = 0
    partitions_visited: int = 0
    hamming_in: int = 0
    hamming_kept: int = 0
    adc_evals: int = 0
    refined: int = 0

    def merge(self, other: "SearchStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


def resolve_device(device=None) -> torch.device:
    """The torch backend's device: the card unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend='torch' runs on the CUDA card by default and CUDA is "
                "not available; pass device='cpu' to run it on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _build_partition(x: np.ndarray, ids: np.ndarray, config: SquashConfig,
                     budget: int) -> PartitionIndex:
    """One partition's OSQ index from its rows ``x`` (global ids ``ids``)."""
    d = x.shape[1]
    mean = x.mean(axis=0)
    xc = x - mean
    if config.use_klt and x.shape[0] > d:
        cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
        _, eigvec = np.linalg.eigh(cov)
        klt = eigvec[:, ::-1]            # descending-variance order
        xt = xc @ klt
    else:
        klt = None
        xt = xc
    var = xt.var(axis=0)
    bits = osq.allocate_bits(var, budget, max_bits=config.max_bits_per_dim)
    quant = osq.design_quantizers(xt, bits, iters=config.lloyd_iters)
    codes = osq.encode(quant, xt)
    layout = segments.build_layout(bits, seg_bits=config.segment_bits)
    packed = segments.pack_codes(layout, codes)
    # Low-bit index binarizes the *raw* (centered) space: KLT compacts
    # energy into few dims, and post-KLT standardization would amplify
    # the near-noise trailing dims into uninformative random bits.
    low = lowbit.build_lowbit_index(xc)
    return PartitionIndex(
        vector_ids=ids,
        klt=klt,
        mean=mean,
        quant=quant,
        layout=layout,
        packed=packed,
        codes=codes.astype(np.int32),
        low=low,
        vectors=x,
    )


class SquashIndex:
    """End-to-end SQUASH index over a vector dataset + attribute table."""

    def __init__(
        self,
        config: SquashConfig,
        partitioning: partitions.Partitioning,
        parts: List[PartitionIndex],
        attr_index: attr_mod.AttributeIndex,
        dim: int,
    ):
        self.config = config
        self.partitioning = partitioning
        self.parts = parts
        self.attr_index = attr_index
        self.dim = dim
        # Liveness bitmap over global vector ids. None for a frozen index;
        # when set, dead rows fail the Stage 1 filter and are masked again in
        # Stage 3 on every backend.
        self.live_mask: Optional[np.ndarray] = None
        # The owning LiveIndex (set by core/live.py), from which the
        # serverless runtime pulls mutation events.
        self.live_owner = None
        # Optional recall-targeted calibration (core/autotune.py): when set,
        # per-partition keep fractions + a calibrated floor replace the
        # static hamming_perc / min_hamming_keep in every data plane.
        self.profile = None
        # torch-backend cache: stacked payload per (dtype, device).
        self._stacked_cache: Dict = {}

    def set_profile(self, profile) -> None:
        """Install (or clear) a calibration profile for this index.

        ``profile`` is a :class:`repro_torch.core.autotune.CalibrationProfile`
        whose partition count must match; ``None`` restores the static
        config knobs.
        """
        if profile is not None and profile.num_partitions != len(self.parts):
            raise ValueError(
                f"profile covers {profile.num_partitions} partitions, index "
                f"has {len(self.parts)}")
        self.profile = profile

    def autotune(self, queries=None, *, recall_target: float = 0.95,
                 k: int = 10, sample: int = 64, seed: int = 0, **kw):
        """Calibrate + install a recall-targeted profile; returns it."""
        from repro_torch.core import autotune as at

        profile = at.calibrate(self, queries, recall_target=recall_target,
                               k=k, sample=sample, seed=seed, **kw)
        self.set_profile(profile)
        return profile

    # ------------------------------------------------------------------ build

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        attrs: np.ndarray,
        config: Optional[SquashConfig] = None,
        attr_bits: Optional[Sequence[int]] = None,
        seed: int = 0,
    ) -> "SquashIndex":
        config = config or SquashConfig()
        vectors = np.asarray(vectors, dtype=np.float64)
        n, d = vectors.shape
        cent, assign = partitions.balanced_kmeans(
            vectors, config.num_partitions, iters=config.kmeans_iters, seed=seed
        )
        t = (
            config.threshold_override
            if config.threshold_override is not None
            else partitions.compute_threshold(vectors, cent, assign, beta=config.beta)
        )
        part_obj = partitions.Partitioning(centroids=cent, assign=assign, threshold=t)
        budget = int(round(config.bits_per_dim * d))
        parts: List[PartitionIndex] = []
        for pid in range(config.num_partitions):
            ids = np.where(assign == pid)[0]
            parts.append(_build_partition(vectors[ids], ids, config, budget))
        attr_index = attr_mod.build_attribute_index(attrs, bits=attr_bits)
        return cls(config, part_obj, parts, attr_index, dim=d)

    # ----------------------------------------------------------------- search

    def search(
        self,
        queries: np.ndarray,
        predicates: Sequence[attr_mod.Predicate],
        k: int = 10,
        collect_stats: bool = False,
        backend: Optional[str] = None,
        device=None,
    ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Batched hybrid top-k. Returns (ids (Q,k), dists (Q,k), stats).

        The arguments keep the reference's order (``device`` after them);
        ``collect_stats`` is accepted and unused, as in the reference: the
        stats are always counted. ``backend`` overrides ``config.backend``
        for this call: ``"numpy"`` runs the per-query reference loop,
        ``"torch"`` the batched plane on ``device`` (default ``"cuda"``;
        raises without CUDA unless ``device="cpu"``) — identical ids, same
        stats counters.
        """
        del collect_stats
        backend = backend or self.config.backend
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected "
                             f"{BACKENDS}")
        if backend == "torch":
            device = resolve_device(device)
        with _span("squash.search"):
            queries, cands, stats = self.select(queries, predicates, k)
            if backend == "torch":
                return self._search_torch(queries, cands, k, stats, device)
            return self._search_numpy(queries, cands, k, stats)

    def select(
        self, queries: np.ndarray, predicates: Sequence[attr_mod.Predicate],
        k: int,
    ) -> Tuple[np.ndarray, List[Dict[int, np.ndarray]], SearchStats]:
        """Stages 1–2 on the host: filter mask F, then Algorithm 1.

        Returns the queries as (Q, d) float64, each query's candidate rows
        per visited partition, and the stats counted so far.
        """
        with _span("squash.select"):
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
            qn = queries.shape[0]
            stats = SearchStats(queries=qn)

            # Stage 1 — attribute filtering (global mask F per query). Dead
            # (tombstoned) rows fail the filter outright.
            with _span("squash.filter"):
                r = attr_mod.build_r_lookup(self.attr_index, predicates)
                f_one = attr_mod.filter_mask(r, self.attr_index.codes).numpy()
                if self.live_mask is not None:
                    f_one = f_one & self.live_mask
                f = np.broadcast_to(f_one, (qn, f_one.shape[0]))
                stats.filter_pass += int(f_one.sum()) * qn

            # Stage 2 — Algorithm 1 partition ranking/selection.
            scanned, shared = [0], [0]
            with _span("squash.alg1"):
                visit, cands = partitions.select_partitions(
                    queries,
                    self.partitioning.centroids,
                    f,
                    self.partitioning.assign,
                    self.partitioning.threshold,
                    k,
                    scanned=scanned,
                    shared_scans=shared,
                )
            stats.partitions_visited += int(visit.sum())
            _METRICS.counter("search.alg1.rows_scanned").inc(scanned[0])
            _METRICS.counter("search.alg1.shared_scans").inc(shared[0])
        return queries, cands, stats

    def _search_numpy(
        self,
        queries: np.ndarray,
        cands,
        k: int,
        stats: SearchStats,
    ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Reference Stage 3–5 plane: per-query loop over visited partitions.

        Candidate streams are consumed in ascending-partition order and every
        sort is stable, so ties resolve as (score, partition, row) — exactly
        the order the torch plane produces.
        """
        qn = queries.shape[0]
        all_ids = np.full((qn, k), -1, dtype=np.int64)
        all_dists = np.full((qn, k), np.inf, dtype=np.float64)
        for qi in range(qn):
            heap: List[Tuple[float, int]] = []
            for pid in sorted(cands[qi]):
                ids, dists = self._search_partition(
                    self.parts[pid], pid, queries[qi], cands[qi][pid], k,
                    stats
                )
                heap.extend(zip(dists.tolist(), ids.tolist()))
            # Single-pass MPI-style reduce: merge per-partition local top-k.
            # Stable sort on distance alone keeps (partition, rank) tie order.
            heap.sort(key=lambda t: t[0])
            top = heap[:k]
            for r_i, (dist, vid) in enumerate(top):
                all_ids[qi, r_i] = vid
                all_dists[qi, r_i] = dist
        return all_ids, all_dists, stats

    def stacked(self, dtype: torch.dtype, device) -> "dataplane.StackedIndex":
        """The stacked payload on ``device`` in ``dtype`` (built once).

        ``"cuda"`` and ``"cuda:<current device>"`` name one device and share
        one payload.
        """
        from repro_torch.core import dataplane

        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (dtype, str(device))
        stacked = self._stacked_cache.get(key)
        if stacked is None:
            stacked = dataplane.stack_index(self, dtype=dtype, device=device)
            self._stacked_cache[key] = stacked
        return stacked

    def _search_torch(
        self,
        queries: np.ndarray,
        cands,
        k: int,
        stats: SearchStats,
        device,
        mark: Optional[Callable[[str], None]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        """Batched Stage 3–5 plane (repro_torch.core.dataplane) on ``device``.

        Host side prepares dense masks + per-(query, partition) keep/take
        counts; one plane call executes Hamming prune, ADC lower bounds,
        refinement and the cross-partition merge for the whole batch.
        ``mark`` is the plane's per-stage timing hook.
        """
        from repro_torch.core import dataplane

        with _span("squash.plane"):
            cfg = self.config
            qn = queries.shape[0]
            dtype = torch.get_default_dtype()
            stacked = self.stacked(dtype, device)
            p, n_max = stacked.num_partitions, stacked.n_max

            with _span("squash.densify"):
                cand_mask, n_cand = dataplane.build_cand_arrays(
                    cands, qn, p, n_max)
                keep, take = dataplane.stage_counts(n_cand, cfg, k,
                                                    self.profile)
                keep_s, take_s = dataplane.static_counts(n_max, cfg, k,
                                                         self.profile)

                # Bucket Q to the next power of two, as the reference does,
                # so the kernels see the reference's shapes. Padded queries
                # are dead (keep=0, empty mask) and sliced off below.
                bucket = 1 << (qn - 1).bit_length() if qn > 1 else 1
                if bucket != qn:
                    pad = bucket - qn
                    queries = np.pad(queries, ((0, pad), (0, 0)))
                    cand_mask = np.pad(cand_mask, ((0, pad), (0, 0), (0, 0)))
                    keep = np.pad(keep, ((0, pad), (0, 0)))
                    take = np.pad(take, ((0, pad), (0, 0)))

            with _span("squash.upload"):
                _METRICS.counter("search.upload.bytes").inc(
                    queries.nbytes + cand_mask.nbytes + keep.nbytes
                    + take.nbytes)
                q_dev = torch.from_numpy(queries).to(device=device,
                                                     dtype=dtype)
                mask_dev = torch.from_numpy(cand_mask).to(device)
                keep_dev = torch.from_numpy(keep).to(device)
                take_dev = torch.from_numpy(take).to(device)
            ids, dists = dataplane.batched_stage345(
                q_dev, stacked, mask_dev, keep_dev, take_dev,
                k=k, keep_s=keep_s, take_s=take_s, refine=cfg.enable_refine,
                mark=mark,
            )
            # The host waits here until the card has finished the plane.
            with _span("squash.fetch"):
                ids = ids[:qn].cpu().numpy().astype(np.int64)
                dists = dists[:qn].cpu().numpy().astype(np.float64)
                stats.hamming_in += int(n_cand.sum())
                stats.hamming_kept += int(keep.sum())
                stats.adc_evals += int(keep.sum())
                if cfg.enable_refine:
                    stats.refined += int(take.sum())
        return ids, dists, stats

    def _search_partition(
        self,
        part: PartitionIndex,
        pid: int,
        query: np.ndarray,
        local_rows: np.ndarray,
        k: int,
        stats: SearchStats,
    ) -> Tuple[np.ndarray, np.ndarray]:
        from repro_torch.core import autotune

        cfg = self.config
        # Stage 3 tombstone mask (defense in depth): Stage 1 already fails
        # dead rows.
        if self.live_mask is not None:
            alive = self.live_mask[part.vector_ids[local_rows]]
            if not alive.all():
                local_rows = local_rows[alive]
        if local_rows.size == 0:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64))
        qt = part.transform(query)

        # Stage 3 — low-bit OSQ Hamming pruning (only rows passing the filter).
        # Binary codes live in the raw centered space (see build()).
        qbits = part.low.encode_queries((query - part.mean)[None, :])[0]
        cand_packed = part.low.packed[local_rows]
        x = np.bitwise_xor(cand_packed, qbits[None, :])
        ham = _popcount_u32(x).sum(axis=1)
        stats.hamming_in += local_rows.size
        # Keep budget: the partition's calibrated fraction + global floor
        # under an active profile, the static config knobs otherwise — the
        # same keep_count formula stage_counts applies in the batched plane.
        if self.profile is not None:
            frac = float(self.profile.keep_frac[pid])
            floor = int(self.profile.min_keep)
        else:
            frac, floor = cfg.hamming_perc, cfg.min_hamming_keep
        keep = autotune.keep_count(local_rows.size, frac, floor)
        # Total-order composite key (ham, row): keeps the O(n) argpartition
        # while resolving ties by ascending row — the order the torch plane's
        # Stage 3 key produces, required for backend id parity.
        n_c = local_rows.size
        comp = ham.astype(np.int64) * n_c + np.arange(n_c)
        kept_sel = np.argpartition(comp, keep - 1)[:keep]
        kept_sel = kept_sel[np.argsort(comp[kept_sel])]
        kept_rows = local_rows[kept_sel]
        stats.hamming_kept += keep

        # Stage 4 — ADC lookup-table LB distances on survivors.
        table = adc.build_adc_table(qt, part.quant.boundaries, part.quant.cells)
        codes = part.codes[kept_rows]
        safe = np.where(np.isfinite(table), table, 0.0)
        lb = np.sqrt(safe[codes, np.arange(self.dim)[None, :]].sum(axis=1))
        stats.adc_evals += keep

        take = min(int(np.ceil(cfg.refine_ratio * k)), keep) if cfg.enable_refine \
            else min(k, keep)
        order = np.argsort(lb, kind="stable")[:take]
        cand = kept_rows[order]

        if cfg.enable_refine:
            # Stage 5 — post-refinement on full-precision rows ('EFS' reads).
            full = part.vectors[cand]
            exact = np.sqrt(((full - query[None, :]) ** 2).sum(axis=1))
            stats.refined += cand.size
            fin = np.argsort(exact, kind="stable")[:k]
            return part.vector_ids[cand[fin]], exact[fin]
        return part.vector_ids[cand[:k]], lb[order][:k]

    # ------------------------------------------------------------- accounting

    def index_bytes(self) -> Dict[str, int]:
        primary = sum(p.packed.nbytes for p in self.parts)
        low = sum(p.low.packed.nbytes for p in self.parts)
        attrs = self.attr_index.codes.nbytes
        full = sum(p.vectors.nbytes for p in self.parts)
        return {
            "primary_osq": int(primary),
            "lowbit_osq": int(low),
            "attr_codes": int(attrs),
            "full_precision": int(full),
        }


# ------------------------------------------------------ arrays in and out

def index_to_arrays(index) -> Dict[str, np.ndarray]:
    """A built index as a flat dict of numpy arrays.

    Reads the index by attribute name only (``parts[i].quant.boundaries``,
    ``attr_index.codes``, ...), so it accepts this package's ``SquashIndex``
    and the JAX package's alike without importing the latter, or either's
    ``LiveIndex`` wrapper. A live index also carries its ledger under
    ``live.*``: generations (P,), version, dirty partitions, and the segment
    blocks as (pid, lo, hi, generation) rows.
    """
    base = getattr(index, "base", None)
    if base is not None and getattr(base, "live_owner", None) is index:
        index = base
    out: Dict[str, np.ndarray] = {
        "dim": np.asarray(index.dim, np.int64),
        "num_parts": np.asarray(len(index.parts), np.int64),
        "partitioning.centroids": np.asarray(index.partitioning.centroids),
        "partitioning.assign": np.asarray(index.partitioning.assign),
        "partitioning.threshold": np.asarray(index.partitioning.threshold,
                                             np.float64),
        "attr.codes": np.asarray(index.attr_index.codes),
        "attr.boundaries": np.asarray(index.attr_index.boundaries),
        "attr.centers": np.asarray(index.attr_index.centers),
        "attr.cells": np.asarray(index.attr_index.cells),
    }
    if getattr(index, "live_mask", None) is not None:
        out["live_mask"] = np.asarray(index.live_mask, bool)
    live = getattr(index, "live_owner", None)
    if live is not None:
        p = len(index.parts)
        out["live.generations"] = np.asarray(live.generations, np.int64)
        out["live.version"] = np.asarray(live.version, np.int64)
        out["live.dirty"] = np.asarray(live.dirty_partitions(), np.int64)
        out["live.segments"] = np.asarray(
            [(pid, b.lo, b.hi, b.generation) for pid in range(p)
             for b in live.segments_of(pid)], np.int64).reshape(-1, 4)
    for i, pt in enumerate(index.parts):
        pre = f"part{i}."
        out[pre + "vector_ids"] = np.asarray(pt.vector_ids)
        if pt.klt is not None:
            out[pre + "klt"] = np.asarray(pt.klt)
        out[pre + "mean"] = np.asarray(pt.mean)
        out[pre + "quant.bits"] = np.asarray(pt.quant.bits)
        out[pre + "quant.boundaries"] = np.asarray(pt.quant.boundaries)
        out[pre + "quant.centers"] = np.asarray(pt.quant.centers)
        out[pre + "layout.seg_bits"] = np.asarray(pt.layout.seg_bits, np.int64)
        out[pre + "packed"] = np.asarray(pt.packed)
        out[pre + "codes"] = np.asarray(pt.codes)
        out[pre + "low.packed"] = np.asarray(pt.low.packed)
        out[pre + "low.mean"] = np.asarray(pt.low.mean)
        out[pre + "low.std"] = np.asarray(pt.low.std)
        out[pre + "vectors"] = np.asarray(pt.vectors)
    return out


def index_from_arrays(arrays: Dict[str, np.ndarray],
                      config: Optional[SquashConfig] = None) -> SquashIndex:
    """Rebuild a :class:`SquashIndex` from :func:`index_to_arrays` output.

    A carried live ledger comes back as a ``LiveIndex`` owning the index
    (``index.live_owner``), with its tombstones, generations, version,
    dirty partitions and segment blocks; its event log starts empty.
    """
    config = config or SquashConfig()
    dim = int(arrays["dim"])
    parts: List[PartitionIndex] = []
    for i in range(int(arrays["num_parts"])):
        pre = f"part{i}."
        bits = np.asarray(arrays[pre + "quant.bits"])
        parts.append(PartitionIndex(
            vector_ids=arrays[pre + "vector_ids"],
            klt=arrays.get(pre + "klt"),
            mean=arrays[pre + "mean"],
            quant=osq.OSQQuantizer(bits=bits,
                                   boundaries=arrays[pre + "quant.boundaries"],
                                   centers=arrays[pre + "quant.centers"]),
            layout=segments.build_layout(
                bits, seg_bits=int(arrays[pre + "layout.seg_bits"])),
            packed=arrays[pre + "packed"],
            codes=arrays[pre + "codes"],
            low=lowbit.LowBitIndex(packed=arrays[pre + "low.packed"],
                                   mean=arrays[pre + "low.mean"],
                                   std=arrays[pre + "low.std"], d=dim),
            vectors=arrays[pre + "vectors"],
        ))
    partitioning = partitions.Partitioning(
        centroids=arrays["partitioning.centroids"],
        assign=arrays["partitioning.assign"],
        threshold=float(arrays["partitioning.threshold"]))
    attr_index = attr_mod.AttributeIndex(
        codes=arrays["attr.codes"], boundaries=arrays["attr.boundaries"],
        centers=arrays["attr.centers"], cells=arrays["attr.cells"])
    index = SquashIndex(config, partitioning, parts, attr_index, dim=dim)
    if "live.version" in arrays:
        from repro_torch.core.live import LiveIndex

        LiveIndex.from_ledger(
            index, generations=arrays["live.generations"],
            version=int(arrays["live.version"]), dirty=arrays["live.dirty"],
            segments=arrays["live.segments"])
    if "live_mask" in arrays:
        index.live_mask = arrays["live_mask"]
    return index


_POP_TABLE = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    """Byte-table popcount for uint32 arrays (NumPy reference path)."""
    b = x.view(np.uint8).reshape(*x.shape, 4)
    return _POP_TABLE[b].sum(axis=-1).astype(np.int32)
