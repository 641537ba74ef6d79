"""SQUASH's filtered search (paper §2.4), written out for the reference.

Stage 1 evaluates the predicate on the raw attribute values; Stage 2 is
Algorithm 1 over the query-centroid distances (NumPy, float64). Stages 3–5
and the merge run in plain PyTorch on any device, per partition over the
queries that visit it:

* Stage 3 — XOR and popcount of the query's 1-bit code against each
  candidate's; the ``keep`` smallest (Hamming, row) keys survive, in order.
* Stage 4 — the OSQ lower bound: per dimension, the squared distance from
  the transformed query to the nearest edge of the survivor's cell (0 in the
  query's own cell); the ``take`` smallest bounds, ties by survivor order.
* Stage 5 — exact distances of those rows by the norm expansion
  ``|x|² + |q|² − 2 x·q``; the partition's k best, ties by order.
* Merge — every visited partition's k best, in ascending partition order,
  sorted stably by distance; the first k.

``dtype`` is the float width of Stages 3–5. ``tf32=True`` rounds the
operands of both products (the KLT transform and the expansion's dot
products) to TF32's 10-bit mantissa first, as a tensor core does: the
benchmark's control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.bounds import keep_count
from perfbench.gen import filter_mask
from perfbench.reference.build import Index, sqdist

_M32 = 0xFFFFFFFF


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest value with a 10-bit mantissa (TF32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & _M32) >> 24


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., d) bool → (..., ceil(d/32)) int64 words, first dim on top."""
    d = bits.shape[-1]
    g = -(-d // 32)
    padded = torch.nn.functional.pad(bits.to(torch.int64), (0, g * 32 - d))
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(31, -1, -1, device=bits.device)
    return (padded.reshape(*bits.shape[:-1], g, 32) * weights).sum(-1)


class DeviceIndex:
    """The reference index's partitions as tensors on one device."""

    def __init__(self, index: Index, device, dtype):
        self.index = index
        self.device = torch.device(device)
        self.dtype = dtype

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=self.device)

        self.parts = []
        for pt in index.parts:
            self.parts.append(dict(
                ids=pt.ids,
                mean=t(pt.mean), klt=t(pt.klt), low_mean=t(pt.low_mean),
                low_std=t(pt.low_std),
                inner=t(pt.boundaries[1:]), bnd=t(pt.boundaries),
                codes=t(pt.codes, torch.int64),
                words=t(pt.low_words.astype(np.int64), torch.int64),
                vectors=t(pt.vectors), norms=t((pt.vectors ** 2).sum(-1))))


def plan(index: Index, mask: np.ndarray, queries: np.ndarray, idx_cfg: dict,
         k: int):
    """Stages 1–2 on the host: the visit matrix (Q, P), each partition's
    candidate rows (local positions), the keep and take counts per
    partition, and the stats a batch counts."""
    qn = queries.shape[0]
    p = len(index.parts)
    local = [np.nonzero(mask[pt.ids])[0] for pt in index.parts]
    cnt = np.array([rows.size for rows in local], dtype=np.int64)
    dists = np.sqrt(sqdist(queries, index.centroids))
    visit = np.zeros((qn, p), dtype=bool)
    t = index.threshold
    for qi in range(qn):
        ranked = np.argsort(dists[qi])
        dmin = dists[qi, ranked[0]]
        total = 0
        for pid in ranked:
            if dists[qi, pid] > t * max(dmin, 1e-12) and total >= k:
                break
            if cnt[pid]:
                visit[qi, pid] = True
                total += cnt[pid]
    keep = np.array([keep_count(c, idx_cfg["hamming_perc"],
                                idx_cfg["min_hamming_keep"]) for c in cnt])
    take = np.minimum(math.ceil(idx_cfg["refine_ratio"] * k), keep)
    v = visit.sum(axis=0)
    stats = {
        "filter_pass": int(mask.sum()) * qn,
        "partitions_visited": int(visit.sum()),
        "hamming_in": int((v * cnt).sum()),
        "hamming_kept": int((v * keep).sum()),
        "adc_evals": int((v * keep).sum()),
        "refined": int((v * take).sum()),
    }
    return visit, local, keep, take, stats


def stage345(dev: DeviceIndex, pid: int, q: torch.Tensor, rows: np.ndarray,
             keep: int, take: int, k: int, tf32: bool):
    """One partition for the queries ``q`` (Q_p, d) that visit it; returns
    its k best (dists (Q_p, kk), global ids (Q_p, kk)), kk = min(k, take)."""
    pt = dev.parts[pid]
    n_c = rows.size
    rows_t = torch.as_tensor(rows, device=dev.device)
    # Stage 3.
    qc = q - pt["mean"]
    qbits = _pack((qc - pt["low_mean"]) / pt["low_std"] > 0)      # (Q_p, G)
    cw = pt["words"][rows_t]                                      # (n_c, G)
    ham = _popcount((qbits[:, None, :] ^ cw[None]) & _M32).sum(-1)
    key = ham * n_c + torch.arange(n_c, device=dev.device)
    surv = torch.sort(key, dim=1).indices[:, :keep]               # (Q_p, keep)
    # Stage 4.
    qt = _mm(qc, pt["klt"], tf32)                                 # (Q_p, d)
    qcell = (pt["inner"][None] <= qt[:, None, :]).sum(1)          # (Q_p, d)
    codes = pt["codes"][rows_t[surv]]                             # (Q_p, keep, d)
    d = qt.shape[1]
    dim = torch.arange(d, device=dev.device)
    right = pt["bnd"][(codes + 1).clamp(max=pt["bnd"].shape[0] - 1), dim]
    left = pt["bnd"][codes, dim]
    qte, qce = qt[:, None, :], qcell[:, None, :]
    zero = torch.zeros((), dtype=qt.dtype, device=dev.device)
    edge = torch.where(codes < qce, qte - right,
                       torch.where(codes > qce, left - qte, zero))
    lb = torch.sqrt((edge * edge).sum(-1))                        # (Q_p, keep)
    order = torch.sort(lb, dim=1, stable=True).indices[:, :take]
    cand = rows_t[torch.gather(surv, 1, order)]                   # (Q_p, take)
    # Stage 5.
    x = pt["vectors"][cand]                                       # (Q_p, take, d)
    dot = _mm(x, q[:, :, None], tf32)[..., 0]
    sq = pt["norms"][cand] + (q * q).sum(-1, keepdim=True) - 2 * dot
    exact = torch.sqrt(sq.clamp(min=0))
    kk = min(k, take)
    best, fin = torch.sort(exact, dim=1, stable=True)
    local = torch.gather(cand, 1, fin[:, :kk]).cpu().numpy()
    return best[:, :kk], pt["ids"][local]


def search(dev: DeviceIndex, attributes: np.ndarray, queries: np.ndarray,
           preds, idx_cfg: dict, k: int, tf32: bool = False
           ) -> Tuple[np.ndarray, np.ndarray, Dict[str, int]]:
    """One batch: (ids (Q, k) int64, dists (Q, k) float64, stats)."""
    mask = filter_mask(attributes, preds)
    visit, local, keep, take, stats = plan(dev.index, mask, queries, idx_cfg,
                                           k)
    qn, p = visit.shape
    dists = torch.full((qn, p, k), math.inf, dtype=torch.float64,
                       device=dev.device)
    ids = np.full((qn, p, k), -1, dtype=np.int64)
    q_all = torch.as_tensor(queries, dtype=dev.dtype, device=dev.device)
    for pid in range(p):
        qs = np.nonzero(visit[:, pid])[0]
        if qs.size == 0:
            continue
        best, gid = stage345(dev, pid, q_all[qs], local[pid], int(keep[pid]),
                             int(take[pid]), k, tf32)
        kk = best.shape[1]
        dists[torch.as_tensor(qs, device=dev.device), pid, :kk] = \
            best.to(torch.float64)
        ids[qs, pid, :kk] = gid
    flat = dists.reshape(qn, p * k)
    out_d, order = torch.sort(flat, dim=1, stable=True)
    order = order[:, :k].cpu().numpy()
    out_i = np.take_along_axis(ids.reshape(qn, p * k), order, axis=1)
    out_d = out_d[:, :k].cpu().numpy()
    out_i[~np.isfinite(out_d)] = -1
    return out_i, out_d, stats


def exact_topk(vectors: torch.Tensor, norms: torch.Tensor, mask: np.ndarray,
               queries: np.ndarray, k: int) -> List[set]:
    """Brute-force filtered top-k ids of each query (float64), as sets."""
    rows = np.nonzero(mask)[0]
    rows_t = torch.as_tensor(rows, device=vectors.device)
    x, n2 = vectors[rows_t], norms[rows_t]
    q = torch.as_tensor(queries, dtype=torch.float64, device=vectors.device)
    sq = n2[None, :] + (q * q).sum(-1, keepdim=True) - 2 * q @ x.T
    kk = min(k, rows.size)
    best = torch.topk(sq, kk, dim=1, largest=False).indices.cpu().numpy()
    return [set(rows[b].tolist()) for b in best]
