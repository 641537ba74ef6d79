"""Distributed SQUASH search over a ``torch.distributed`` device mesh.

The serverless topology maps onto a two-dimensional mesh of ranks:

* ``model`` axis = QueryProcessors: each rank holds a fixed-size stack of
  partitions (packed low-bit codes, primary codes, full-precision rows).
* ``data`` axis = QueryAllocators: the query batch is sharded.
* The paper's single-parallel-pass guarantee becomes a single collective
  round: each rank computes the local top-k for (its queries × its
  partitions), then one ``all_gather`` over ``model`` + merge produces the
  global results — the MPI-style reduce of §2.4.5.

Stages 3–5 on each rank are the **same batched data plane** the torch
backend uses (``repro_torch.core.dataplane.batched_stage345``, so kernels 1
and 2b or 2 run inside it), over the rank's slice of the partition stack,
so single-device and distributed search cannot drift apart. The dynamic
stages (predicate parsing, Algorithm 1) run on the host of every rank for
the whole batch — deterministic NumPy, so every rank derives the same dense
masks and keep/take counts without a broadcast — mirroring how QAs ship
bitmaps to QPs in request payloads.

The port of the JAX package's ``repro.core.distributed``: its ``shard_map``
over a (data, model) ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with dimensions named
``("data", "model")`` (NCCL on the card, gloo on the CPU). The merge keeps
the reference's tie order: ``lax.top_k`` over the gathered distances picks
the lower index on ties, i.e. the lower model rank, and so does a stable
ascending sort of the gathered lists concatenated in rank order. Padded
partitions answer +inf with id -1 and sort last.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dataplane
from repro_torch.core.dataplane import StackedIndex, stack_index
from repro_torch.core.pipeline import SquashIndex, resolve_device

__all__ = ["StackedIndex", "stack_index", "distributed_search",
           "make_search_fn"]

MESH_DIMS = ("data", "model")


class _Axes:
    """This rank's place on the (data, model) mesh and its two gathers.

    ``mesh=None`` is the 1 × 1 mesh of one process: both gathers are the
    identity and no process group is needed.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        if mesh is None:
            self.size = {"data": 1, "model": 1}
            self.rank = {"data": 0, "model": 0}
            return
        if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
            raise ValueError(f"the mesh's dimensions must be named "
                             f"{MESH_DIMS}, not {mesh.mesh_dim_names}")
        self.size = {a: int(mesh.shape[i]) for i, a in enumerate(MESH_DIMS)}
        self.rank = {a: int(mesh.get_local_rank(a)) for a in MESH_DIMS}

    def gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """``t`` of every rank along ``axis``, concatenated on ``dim`` in
        rank order (a collective on every mesh, of one rank too)."""
        if self.mesh is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size[axis])]
        dist.all_gather(parts, t.contiguous(),
                        group=self.mesh.get_group(axis))
        return torch.cat(parts, dim=dim)


def _mesh_device(mesh) -> torch.device:
    """The device of this rank's shard of ``mesh`` (its current CUDA
    device on a ``"cuda"`` mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_search_fn(
    mesh,
    *,
    k: int,
    keep_s: int,
    take_s: int,
    refine: bool = True,
) -> Callable:
    """The distributed search function for ``mesh`` (None: one process).

    ``search(queries, cand_mask, keep, take, stacked)`` takes the global
    arrays, identical on every rank:
      queries     (Q, d)        — Q a multiple of the ``data`` size
      cand_mask   (Q, P, n_max) — filter ∧ residency ∧ visit (from Alg. 1)
      keep, take  (Q, P) int32  — per-pair dynamic stage counts
      stacked     StackedIndex  — all P partitions on this rank's device, P
                                  a multiple of the ``model`` size
    and returns ids (Q, k) int32 and dists (Q, k) float, on every rank. A
    rank runs the plane on its rows of queries and a view of its
    partitions; ``keep_s``/``take_s`` are the static selection sizes (see
    ``dataplane.static_counts``).
    """
    axes = _Axes(mesh)

    def search(queries, cand_mask, keep, take, stacked: StackedIndex):
        qn, p = cand_mask.shape[:2]
        nd, nm = axes.size["data"], axes.size["model"]
        if qn % nd or p % nm:
            raise ValueError(f"Q={qn} and P={p} must be multiples of the "
                             f"mesh's (data, model) = ({nd}, {nm})")
        qs, ps = qn // nd, p // nm
        rows = slice(axes.rank["data"] * qs, (axes.rank["data"] + 1) * qs)
        lo = axes.rank["model"] * ps
        local = StackedIndex(**{                # views, not copies
            name: getattr(stacked, name)[lo:lo + ps]
            for name in StackedIndex.__dataclass_fields__})
        dev = stacked.device
        ids, dists = dataplane.batched_stage345(
            torch.as_tensor(queries[rows]).to(  # squash: ignore[device-sync] -- this rank's slice of the batch's host inputs goes to the card once per batch
                device=dev, dtype=stacked.vectors.dtype),
            local,
            torch.as_tensor(cand_mask[rows, lo:lo + ps]).to(dev),  # squash: ignore[device-sync] -- this rank's slice of the batch's host inputs goes to the card once per batch
            torch.as_tensor(keep[rows, lo:lo + ps]).to(dev),  # squash: ignore[device-sync] -- this rank's slice of the batch's host inputs goes to the card once per batch
            torch.as_tensor(take[rows, lo:lo + ps]).to(dev),  # squash: ignore[device-sync] -- this rank's slice of the batch's host inputs goes to the card once per batch
            k=k, keep_s=keep_s, take_s=take_s, refine=refine,
        )                                                       # (Qs, k)
        # Single-pass MPI-style reduce over the model axis (§2.4.5): the
        # stable sort keeps rank order on ties, as lax.top_k does.
        all_ids = axes.gather(ids, "model", dim=1)              # (Qs, nm·k)
        all_d = axes.gather(dists, "model", dim=1)
        top_d, sel = torch.sort(all_d, dim=1, stable=True)
        ids = torch.gather(all_ids, 1, sel[:, :k])
        return (axes.gather(ids, "data", dim=0),
                axes.gather(top_d[:, :k].contiguous(), "data", dim=0))

    return search


def distributed_search(
    index: SquashIndex,
    queries: np.ndarray,
    predicates,
    k: int,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-orchestrated distributed hybrid search (QA plane + QP plane).

    Every rank runs the dynamic stages (predicate parse → filter mask →
    Algorithm 1) on its host for the whole batch, then its share of Stages
    3–5 and the collectives. Returns the global ids (Q, k) int64 and dists
    (Q, k) float64 on every rank, equal to ``index.search(backend="torch")``
    (ids bitwise, order included). ``mesh`` is a ``DeviceMesh`` with
    dimensions ``("data", "model")``; None runs the 1 × 1 mesh on ``device``
    (the card unless ``device="cpu"``). The float width is
    ``torch.get_default_dtype()``, as the torch backend's.
    """
    queries, cands, _ = index.select(queries, predicates, k)
    qn = queries.shape[0]
    cfg = index.config
    axes = _Axes(mesh)
    dev = resolve_device(device) if mesh is None else _mesh_device(mesh)
    dtype = torch.get_default_dtype()
    nm, nd = axes.size["model"], axes.size["data"]
    if nm == 1:
        stacked = index.stacked(dtype, dev)      # the torch backend's stack
    else:
        stacked = stack_index(index, pad_to_multiple=nm, dtype=dtype,
                              device=dev)
    p, n_max = stacked.num_partitions, stacked.n_max

    # Dense per-(query, partition) payloads: mask + dynamic stage counts.
    cand_mask, n_cand = dataplane.build_cand_arrays(cands, qn, p, n_max)
    profile = index.profile
    keep, take = dataplane.stage_counts(n_cand, cfg, k, profile)
    keep_s, take_s = dataplane.static_counts(n_max, cfg, k, profile)

    # Each rank's rows are a power of two, as the torch backend buckets Q,
    # so a 1 × 1 mesh runs the plane at the torch backend's shapes. Padded
    # queries are dead (keep = 0, empty mask) and sliced off below.
    per_rank = -(-qn // nd)
    pad_q = nd * (1 << (per_rank - 1).bit_length() if per_rank > 1 else 1)
    if pad_q != qn:
        queries = np.pad(queries, ((0, pad_q - qn), (0, 0)))
        cand_mask = np.pad(cand_mask, ((0, pad_q - qn), (0, 0), (0, 0)))
        keep = np.pad(keep, ((0, pad_q - qn), (0, 0)))
        take = np.pad(take, ((0, pad_q - qn), (0, 0)))

    search = make_search_fn(mesh, k=k, keep_s=keep_s, take_s=take_s,
                            refine=cfg.enable_refine)
    ids, dists = search(torch.from_numpy(queries), torch.from_numpy(cand_mask),
                        torch.from_numpy(keep), torch.from_numpy(take),
                        stacked)
    return (ids[:qn].cpu().numpy().astype(np.int64),  # squash: ignore[device-sync] -- the results' copy to the host is the answer the caller asked for
            dists[:qn].cpu().numpy().astype(np.float64))  # squash: ignore[device-sync] -- the results' copy to the host is the answer the caller asked for
