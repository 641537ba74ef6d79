"""Live (mutable) index layer: streaming inserts/deletes over SQUASH segments.

The port of the JAX package's ``repro.core.live`` (NumPy, copied as is over
the port's ``pipeline``, ``osq``, ``segments`` and ``lowbit``).

The paper's index is built once and frozen; a serving system needs a mutable
corpus. This module wraps a built :class:`~repro_torch.core.pipeline.SquashIndex`
with the three mutation primitives the segment-based storage (§2.2) makes
cheap:

* **insert** — new vectors append to their nearest partition as a *tail
  segment*: codes are quantized under the partition's frozen transform /
  quantizers and packed incrementally with ``segments.pack_codes``, so an
  insert never rewrites existing rows. Global ids grow monotonically, which
  keeps every partition's local order ascending-by-global-id — the invariant
  ``partitions.select_partitions`` derives local row positions from.
* **delete** — tombstones. A global liveness bitmap (``base.live_mask``) is
  flipped off; dead rows fail Stage 1 filtering on every backend and are
  defensively masked again in Stage 3 (numpy ``_search_partition``, the torch
  plane's ``StackedIndex.valid``, serverless QP bundles), so a tombstoned id
  can never be returned — even by a hand-built QP request naming it.
* **compact** — physically drops a dirty partition's dead rows and (by
  default) re-runs OSQ on the survivors (fresh KLT / bit allocation /
  Lloyd-Max quantizers / low-bit stats), collapsing the tail-segment ledger
  to a single block under a **new generation**. Compacted-away rows keep
  their global id forever but their partition assignment becomes the
  out-of-range sentinel ``P``, so id space stays append-only.

Every mutation bumps the touched partitions' **generation** and appends an
event to a log the serverless runtime drains lazily (pull model — the index
has no reference to any runtime): generations feed the DRE fetch/derived
singleton keys so warm containers cannot serve stale partition bytes, and
events drive segment-granular ``ResultCache`` invalidation instead of
whole-index drops.

Parity contract (pinned by ``tests/test_torch_live.py`` and the ``live``
phase of ``chip_smoke.py``): a search during the tombstone phase and the same search
after ``compact`` return bitwise-identical ids *and* ``SearchStats`` —
candidate sets, visit sets and all stage counters depend only on live rows,
and compaction preserves relative local order, so every backend's
deterministic (score, partition, row) tie-breaking is unaffected.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import lowbit, osq, segments
from repro_torch.core.pipeline import PartitionIndex, SquashIndex

__all__ = ["LiveIndex", "SegmentBlock", "MutationEvent"]


@dataclasses.dataclass(frozen=True)
class SegmentBlock:
    """One contiguous block of a partition's local rows: ``[lo, hi)``.

    ``generation`` is the partition generation the block was published
    under; a compaction collapses all blocks into one with a fresh
    generation.
    """

    lo: int
    hi: int
    generation: int


@dataclasses.dataclass(frozen=True)
class MutationEvent:
    """One entry of the mutation log the runtime drains via `events_since`."""

    seq: int
    kind: str                      # "insert" | "delete" | "compact"
    pids: Tuple[int, ...]          # partitions whose bytes changed
    ids: Tuple[int, ...] = ()      # delete: tombstoned global ids
    vectors: Optional[np.ndarray] = None   # insert: the new rows (m, d)
    requantize: bool = False       # compact: whether OSQ was re-run


class LiveIndex:
    """Streaming mutation wrapper around a built :class:`SquashIndex`.

    The wrapped index stays the single source of truth for search — all
    backends keep reading ``base.parts`` / ``base.partitioning`` /
    ``base.attr_index`` / ``base.live_mask`` directly, so a ``LiveIndex``
    never forks query behavior; it only mutates those structures under the
    invariants documented in the module docstring.
    """

    def __init__(self, base: SquashIndex):
        if getattr(base, "live_owner", None) is not None:
            raise ValueError("index already wrapped by a LiveIndex")
        self.base = base
        n = base.partitioning.assign.shape[0]
        p = len(base.parts)
        base.live_mask = np.ones(n, dtype=bool)
        base.live_owner = self
        self.generations: List[int] = [0] * p
        self._segments: Dict[int, List[SegmentBlock]] = {
            pid: [SegmentBlock(0, base.parts[pid].size, 0)] for pid in range(p)
        }
        self._dirty: set = set()
        self._events: List[MutationEvent] = []
        self._seq = 0

    @classmethod
    def from_ledger(cls, base: SquashIndex, *, generations: Sequence[int],
                    version: int, dirty: Sequence[int],
                    segments: np.ndarray) -> "LiveIndex":
        """Wrap ``base`` with a carried mutation ledger.

        ``segments`` holds one (pid, lo, hi, generation) row per block. The
        event log starts empty at ``version``, so a runtime bound afterwards
        starts its cursor there. The caller restores ``base.live_mask``.
        """
        live = cls(base)
        live.generations = [int(g) for g in generations]
        live._seq = int(version)
        live._dirty = {int(p) for p in dirty}
        live._segments = {pid: [] for pid in range(len(base.parts))}
        for pid, lo, hi, gen in np.asarray(segments, np.int64):
            live._segments[int(pid)].append(
                SegmentBlock(int(lo), int(hi), int(gen)))
        return live

    # ------------------------------------------------------------- inspection

    @property
    def version(self) -> int:
        """Monotone mutation counter (0 for a freshly wrapped index)."""
        return self._seq

    @property
    def num_partitions(self) -> int:
        return len(self.base.parts)

    @property
    def sentinel(self) -> int:
        """Out-of-range assignment marking compacted-away rows."""
        return len(self.base.parts)

    def segments_of(self, pid: int) -> Tuple[SegmentBlock, ...]:
        """The partition's current tail-segment ledger."""
        return tuple(self._segments[pid])

    def dirty_partitions(self) -> Tuple[int, ...]:
        """Partitions holding tombstones or un-requantized tail rows."""
        return tuple(sorted(self._dirty))

    def live_count(self) -> int:
        return int(self.base.live_mask.sum())

    def events_since(self, cursor: int) -> Tuple[int, List[MutationEvent]]:
        """Events with ``seq > cursor`` plus the new cursor (pull model)."""
        return self._seq, [e for e in self._events if e.seq > cursor]

    # -------------------------------------------------------------- mutations

    def insert(self, vectors: np.ndarray, attrs: np.ndarray) -> np.ndarray:
        """Append new (vector, attribute) rows; returns their global ids.

        Rows join the partition of their nearest centroid as a tail segment
        encoded under that partition's *frozen* transform and quantizers
        (requantization is compaction's job). Attribute values quantize
        against the existing cell boundaries — exact for values seen at
        build time, nearest-cell for novel ones.
        """
        base = self.base
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float64))
        attrs = np.atleast_2d(np.asarray(attrs, dtype=np.float64))
        m, d = vectors.shape
        if d != base.dim:
            raise ValueError(f"dim mismatch {d} != {base.dim}")
        if attrs.shape != (m, base.attr_index.num_attributes):
            raise ValueError(
                f"attrs shape {attrs.shape} != "
                f"({m}, {base.attr_index.num_attributes})")
        part_obj = base.partitioning
        n0 = part_obj.assign.shape[0]
        new_ids = np.arange(n0, n0 + m, dtype=np.int64)

        d2 = ((vectors[:, None, :] - part_obj.centroids[None, :, :]) ** 2
              ).sum(axis=-1)
        assign_new = np.argmin(d2, axis=1).astype(part_obj.assign.dtype)

        touched = sorted(int(pid) for pid in np.unique(assign_new))
        for pid in touched:
            rows = np.where(assign_new == pid)[0]
            self._append_tail(pid, new_ids[rows], vectors[rows])

        part_obj.assign = np.concatenate([part_obj.assign, assign_new])
        ai = base.attr_index
        ai.codes = np.concatenate(
            [ai.codes, _encode_attrs(ai, attrs)], axis=0)
        base.live_mask = np.concatenate(
            [base.live_mask, np.ones(m, dtype=bool)])
        self._dirty.update(touched)
        self._record("insert", touched, vectors=vectors.copy())
        return new_ids

    def delete(self, ids: Sequence[int]) -> int:
        """Tombstone global ids; returns how many were newly deleted.

        Unknown or already-dead ids are ignored. Rows stay physically
        resident (and keep their local positions — the parity invariant)
        until ``compact`` runs on their partition.
        """
        base = self.base
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        n = base.live_mask.shape[0]
        ids = ids[(ids >= 0) & (ids < n)]
        ids = ids[base.live_mask[ids]]
        if ids.size == 0:
            return 0
        base.live_mask[ids] = False
        pids = sorted(int(p) for p in np.unique(base.partitioning.assign[ids])
                      if p < self.sentinel)
        self._dirty.update(pids)
        self._record("delete", pids, ids=tuple(int(i) for i in ids))
        return int(ids.size)

    def compact(self, pid: int, requantize: bool = True) -> bool:
        """Drop partition ``pid``'s dead rows; optionally re-run OSQ.

        Returns False (no-op, no generation bump) when the partition is
        clean. With ``requantize`` the surviving rows get a fresh KLT, bit
        allocation, Lloyd-Max quantizers and low-bit stats — the "background
        requantize" path; without it the frozen codes are merely sliced
        (bitwise-invisible to search). Either way the tail-segment ledger
        collapses to one block under a new generation and the compacted-away
        rows' assignment becomes the ``P`` sentinel.
        """
        base = self.base
        if pid not in self._dirty and len(self._segments[pid]) <= 1:
            return False
        part = base.parts[pid]
        live_rows = base.live_mask[part.vector_ids]
        alive_ids = part.vector_ids[live_rows]
        dead_ids = part.vector_ids[~live_rows]
        x = part.vectors[live_rows]

        if dead_ids.size:
            base.partitioning.assign[dead_ids] = self.sentinel
        if requantize and alive_ids.size:
            base.parts[pid] = _requantize_partition(
                base.config, alive_ids, x, base.dim)
        else:
            base.parts[pid] = PartitionIndex(
                vector_ids=alive_ids,
                klt=part.klt,
                mean=part.mean,
                quant=part.quant,
                layout=part.layout,
                packed=part.packed[live_rows],
                codes=part.codes[live_rows],
                low=lowbit.LowBitIndex(
                    packed=part.low.packed[live_rows],
                    mean=part.low.mean, std=part.low.std, d=part.low.d),
                vectors=x,
            )
        self._dirty.discard(pid)
        self._record("compact", [pid], requantize=bool(requantize))
        self._segments[pid] = [SegmentBlock(
            0, int(alive_ids.size), self.generations[pid])]
        return True

    # --------------------------------------------------------------- internal

    def _append_tail(self, pid: int, ids: np.ndarray,
                     x: np.ndarray) -> None:
        """Encode + append rows under the partition's frozen quantizers."""
        base = self.base
        part = base.parts[pid]
        xc = x - part.mean
        xt = xc @ part.klt if part.klt is not None else xc
        codes = osq.encode(part.quant, xt)
        packed = segments.pack_codes(part.layout, codes)
        low_packed = lowbit.pack_bits_u32(
            lowbit.binarize(xc, part.low.mean, part.low.std))
        lo = part.size
        base.parts[pid] = PartitionIndex(
            vector_ids=np.concatenate([part.vector_ids, ids]),
            klt=part.klt,
            mean=part.mean,
            quant=part.quant,
            layout=part.layout,
            packed=np.concatenate([part.packed, packed], axis=0),
            codes=np.concatenate(
                [part.codes, codes.astype(np.int32)], axis=0),
            low=lowbit.LowBitIndex(
                packed=np.concatenate([part.low.packed, low_packed], axis=0),
                mean=part.low.mean, std=part.low.std, d=part.low.d),
            vectors=np.concatenate([part.vectors, x], axis=0),
        )
        self._segments[pid].append(SegmentBlock(
            lo, lo + int(ids.size), self.generations[pid] + 1))

    def _record(self, kind: str, pids, *, ids: Tuple[int, ...] = (),
                vectors: Optional[np.ndarray] = None,
                requantize: bool = False) -> None:
        for pid in pids:
            self.generations[pid] += 1
        self._seq += 1
        self._events.append(MutationEvent(
            seq=self._seq, kind=kind, pids=tuple(int(p) for p in pids),
            ids=ids, vectors=vectors, requantize=requantize))
        # Mutation invalidates the stacked payload on every (dtype, device)
        # it was built for (shapes / valid bits changed): the next torch
        # search restacks, on the card too.
        self.base._stacked_cache.clear()

    # ------------------------------------------------------------ convenience

    def search(self, *args, **kw):
        return self.base.search(*args, **kw)

    def autotune(self, *args, **kw):
        return self.base.autotune(*args, **kw)


def _encode_attrs(ai, attrs: np.ndarray) -> np.ndarray:
    """Quantize new attribute rows against the frozen cell boundaries.

    Mirrors ``build_attribute_index``'s encode: interior boundaries +
    ``side="right"`` searchsorted reproduce the build-time codes exactly for
    any value already in an attribute's domain.
    """
    m, a = attrs.shape
    codes = np.empty((m, a), dtype=np.int32)
    for i in range(a):
        k = int(ai.cells[i])
        if k <= 1:
            codes[:, i] = 0
        else:
            inner = ai.boundaries[1:k, i]
            codes[:, i] = np.searchsorted(inner, attrs[:, i], side="right")
    return codes


def _requantize_partition(config, ids: np.ndarray, x: np.ndarray,
                          d: int) -> PartitionIndex:
    """Re-run the per-partition build (KLT → bits → Lloyd-Max → pack) on the
    surviving rows — the same procedure ``SquashIndex.build`` applies."""
    mean = x.mean(axis=0)
    xc = x - mean
    if config.use_klt and x.shape[0] > d:
        cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
        _, eigvec = np.linalg.eigh(cov)
        klt = eigvec[:, ::-1]
        xt = xc @ klt
    else:
        klt = None
        xt = xc
    budget = int(round(config.bits_per_dim * d))
    var = xt.var(axis=0)
    bits = osq.allocate_bits(var, budget, max_bits=config.max_bits_per_dim)
    quant = osq.design_quantizers(xt, bits, iters=config.lloyd_iters)
    codes = osq.encode(quant, xt)
    layout = segments.build_layout(bits, seg_bits=config.segment_bits)
    packed = segments.pack_codes(layout, codes)
    low = lowbit.build_lowbit_index(xc)
    return PartitionIndex(
        vector_ids=ids, klt=klt, mean=mean, quant=quant, layout=layout,
        packed=packed, codes=codes.astype(np.int32), low=low, vectors=x)
