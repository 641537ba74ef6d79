"""Actor roles of the serverless runtime (paper §3.1): compute logic only.

The port of the JAX package's ``repro.serverless.nodes``: the allocator and
the merge are its NumPy, copied as is; the QueryProcessor runs the port's
torch plane on its partition's slice, on the slice's device.

The event choreography (invocation latencies, payload budgets, DRE leases)
lives in ``runtime.py``; this module holds what each function *computes* when
its handler runs:

* :class:`Coordinator` / :class:`QueryAllocator` — Stage 1 attribute
  filtering + Algorithm 1 partition ranking/selection over the node's own
  query slice, including the §2.5 single-pass guarantee (partitions past the
  Eq. 1 threshold cut are escalated into the visit set until ≥ k
  predicate-passing candidates exist — reported as ``escalations``), then
  the per-partition QueryProcessor request payloads.
* :class:`QueryProcessor` — Stages 3–5 of the real batched data plane
  (``core.dataplane``) over one partition shard, the same plane the
  ``backend="torch"`` path runs, so ids are bitwise-identical.
* :func:`merge_partition_topk` — the MPI-style single-pass top-k combine
  (§2.4.5) applied to response streams in ascending-partition order, which
  reproduces the reference tie-breaking exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import attributes as attr_mod
from repro_torch.core import dataplane
from repro_torch.core import partitions as part_mod
from repro_torch.core.pipeline import SquashIndex

__all__ = ["Coordinator", "QueryAllocator", "QueryProcessor", "QAPlan",
           "merge_partition_topk", "split_search_request",
           "split_processor_request", "split_processor_rows"]


# ------------------------------------------------------------- request splits

def split_search_request(req: Dict, lo: int, hi: int) -> Dict:
    """Sub-request over query positions [lo, hi) (payload chunking)."""
    out = dict(req)
    out["qidx"] = req["qidx"][lo:hi]
    out["queries"] = req["queries"][lo:hi]
    return out


def split_processor_request(req: Dict, lo: int, hi: int) -> Dict:
    """QP sub-request over query positions [lo, hi), re-based row offsets."""
    off = req["row_offsets"]
    out = dict(req)
    out["qidx"] = req["qidx"][lo:hi]
    out["queries"] = req["queries"][lo:hi]
    out["keep"] = req["keep"][lo:hi]
    out["take"] = req["take"][lo:hi]
    out["rows"] = req["rows"][off[lo]:off[hi]]
    out["row_offsets"] = (off[lo : hi + 1] - off[lo]).astype(np.int32)
    return out


def split_processor_rows(req: Dict, lo: int, hi: int) -> Dict:
    """Secondary (candidate-row) axis split of a *single-query* QP request.

    When one query's candidate list alone busts the payload budget, the
    request splits along the partition's row axis instead of erroring (the
    ROADMAP's known limit). Each row chunk keeps at most its own row count
    (``keep``/``take`` clamp), which preserves a **superset** of the
    unsplit stages' survivors: a row inside the unsplit top-``keep`` by
    Hamming is top-``keep`` within any chunk containing it (fewer
    competitors), and likewise for the ADC take — so the exact-distance
    merge of the chunk responses returns the same ids. The runtime merges
    same-query chunk responses in ascending chunk order, matching the
    ascending-row tie order of the unsplit stream.
    """
    if int(req["qidx"].shape[0]) != 1:
        raise ValueError("row-axis split applies to single-query requests")
    rows = req["rows"][lo:hi]
    out = dict(req)
    out["rows"] = rows
    out["row_offsets"] = np.asarray([0, rows.shape[0]], dtype=np.int32)
    keep = np.minimum(np.asarray(req["keep"]), rows.shape[0])
    out["keep"] = keep.astype(np.asarray(req["keep"]).dtype)
    out["take"] = np.minimum(np.asarray(req["take"]), keep).astype(
        np.asarray(req["take"]).dtype)
    return out


# ------------------------------------------------------------ QueryAllocator

@dataclasses.dataclass
class QAPlan:
    """Result of one QA's dynamic stages over its own query slice."""

    qidx: np.ndarray                     # (m,) global query indices
    qp_requests: Dict[int, Dict]         # partition id → request payload
    filter_pass: int
    partitions_visited: int
    escalations: int                     # visits past the Eq. 1 threshold cut


class QueryAllocator:
    """Stage 1 + Algorithm 1 for one node's query slice (paper §3.1 QA)."""

    def __init__(self, index: SquashIndex):
        self.index = index

    def plan(self, qidx: np.ndarray, queries: np.ndarray,
             predicates: Sequence[attr_mod.Predicate], k: int) -> QAPlan:
        idx = self.index
        m = queries.shape[0]
        if m == 0:
            return QAPlan(qidx=qidx, qp_requests={}, filter_pass=0,
                          partitions_visited=0, escalations=0)
        r = attr_mod.build_r_lookup(idx.attr_index, predicates)
        f_one = attr_mod.filter_mask(r, idx.attr_index.codes).numpy()
        live = getattr(idx, "live_mask", None)
        if live is not None:
            # Live-index tombstones fail Stage 1 — same masking the
            # in-process pipeline applies, so QA candidate sets (and hence
            # every downstream stage counter) stay bitwise-identical.
            f_one = f_one & live
        f = np.broadcast_to(f_one, (m, f_one.shape[0]))
        pg = idx.partitioning
        # §2.5 escalation accounting happens inside Alg. 1 itself (visits
        # past the T·d_min cut taken to reach ≥ k passing candidates).
        esc_box = [0]
        visit, cands = part_mod.select_partitions(
            queries, pg.centroids, f, pg.assign, pg.threshold, k,
            escalations=esc_box)
        p, n_max = len(idx.parts), max(pt.size for pt in idx.parts)
        _, n_cand = dataplane.build_cand_arrays(cands, m, p, n_max)
        # Per-partition budgets: under a calibration profile each partition
        # gets its own keep fraction (core/autotune.py); the derived keep /
        # take vectors ship to the QPs inside the Alg. 2 request payloads.
        keep, take = dataplane.stage_counts(n_cand, idx.config, k,
                                            getattr(idx, "profile", None))

        qp_requests: Dict[int, Dict] = {}
        for pid in range(p):
            rows_q = [cands[qi].get(pid) for qi in range(m)]
            sel = [qi for qi in range(m) if rows_q[qi] is not None]
            if not sel:
                continue
            rows = np.concatenate([rows_q[qi] for qi in sel]).astype(np.int32)
            offsets = np.zeros(len(sel) + 1, dtype=np.int32)
            offsets[1:] = np.cumsum([rows_q[qi].size for qi in sel])
            qp_requests[pid] = {
                "pid": pid,
                "k": int(k),
                "qidx": qidx[sel],
                "queries": queries[sel],
                "rows": rows,
                "row_offsets": offsets,
                "keep": keep[sel, pid],
                "take": take[sel, pid],
            }
        return QAPlan(
            qidx=qidx,
            qp_requests=qp_requests,
            filter_pass=int(f_one.sum()) * m,
            partitions_visited=int(visit.sum()),
            escalations=esc_box[0],
        )


class Coordinator(QueryAllocator):
    """Root of the tree (id −1). Owns no query slice; fans out and merges."""


# ------------------------------------------------------------ QueryProcessor

class QueryProcessor:
    """Stage 3–5 executor for one partition (function squash-processor-<pid>).

    Holds the partition's slice of the stacked payload — the DRE singleton,
    resident on its device — and runs the same plane as ``backend="torch"``.
    ``query_dtype`` is the payload's torch float dtype.
    """

    def __init__(self, pid: int, stacked_slice, plane_for, config,
                 query_dtype):
        self.pid = pid
        self.stacked_slice = stacked_slice
        self._plane_for = plane_for       # k -> plane callable
        self.config = config
        self.query_dtype = query_dtype

    def handle(self, req: Dict) -> Tuple[Dict, Dict]:
        """Execute one request payload. Returns (response, stage counters).

        The response's arrays are copied back to the host, which waits for
        the device: the handler returns only when its work on the card is
        done, so a measured handler time is the device's work too.
        """
        m = int(req["qidx"].shape[0])
        k = int(req["k"])
        n_max = int(self.stacked_slice.n_max)
        off = req["row_offsets"]
        cand_mask = np.zeros((m, 1, n_max), dtype=bool)
        for qi in range(m):
            cand_mask[qi, 0, req["rows"][off[qi]:off[qi + 1]]] = True

        # Bucket the slice to a power of two, as the reference does, so
        # repeated invocations share one plane shape per (bucket, k). Padded
        # queries are dead (keep = 0, empty mask).
        qb = 1 << (m - 1).bit_length() if m > 1 else 1
        queries = np.zeros((qb, req["queries"].shape[1]), dtype=np.float64)
        queries[:m] = req["queries"]
        mask = np.zeros((qb, 1, n_max), dtype=bool)
        mask[:m] = cand_mask
        keep = np.zeros((qb, 1), dtype=np.int32)
        keep[:m, 0] = req["keep"]
        take = np.zeros((qb, 1), dtype=np.int32)
        take[:m, 0] = req["take"]

        plane = self._plane_for(k)
        dev = self.stacked_slice.device
        ids, dists = plane(
            torch.from_numpy(queries).to(device=dev, dtype=self.query_dtype),
            self.stacked_slice, torch.from_numpy(mask).to(dev),
            torch.from_numpy(keep).to(dev), torch.from_numpy(take).to(dev),
        )
        resp = {
            "pid": self.pid,
            "qidx": req["qidx"],
            "ids": ids[:m].cpu().numpy().astype(np.int64),
            "dists": dists[:m].cpu().numpy().astype(np.float64),
        }
        refined = int(take.sum()) if self.config.enable_refine else 0
        counters = {
            "hamming_in": int(req["rows"].shape[0]),
            "hamming_kept": int(keep.sum()),
            "adc_evals": int(keep.sum()),
            "refined": refined,
        }
        return resp, counters


# ------------------------------------------------------------------- merging

def merge_partition_topk(
    m: int,
    k: int,
    streams: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-pass MPI-style top-k combine over per-partition responses.

    ``streams`` must be in **ascending partition order**; each entry is
    (row_positions (s,), ids (s, k), dists (s, k)) scattering that
    partition's response into the node's own query rows. Ties resolve by
    (distance, partition, rank) — identical to both reference planes.
    """
    out_ids = np.full((m, k), -1, dtype=np.int64)
    out_d = np.full((m, k), np.inf, dtype=np.float64)
    if not streams:
        return out_ids, out_d
    ns = len(streams)
    all_i = np.full((m, ns, k), -1, dtype=np.int64)
    all_d = np.full((m, ns, k), np.inf, dtype=np.float64)
    for j, (rows, ids, dists) in enumerate(streams):
        all_i[rows, j] = ids
        all_d[rows, j] = dists
    flat_i = all_i.reshape(m, ns * k)
    flat_d = all_d.reshape(m, ns * k)
    order = np.argsort(flat_d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(flat_i, order, axis=1),
            np.take_along_axis(flat_d, order, axis=1))
