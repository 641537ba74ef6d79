"""Quantized attribute index + hybrid-filter machinery (paper §2.3).

Attributes are scalar-quantized with the same OSQ machinery as vector
dimensions. At query time each predicate compiles to a binary lookup array
``R[(M+1), A]`` over quantization cells; the global filter mask ``F`` is a
cascade of vectorized lookups combined with bitwise ANDs (conjunctive
predicates; the OR extension the paper mentions is supported via the ``IN``
operator and disjunct groups).

Supported operators (Def. 1): <, <=, =, >, >=, B (between), plus IN for
categorical sets. Any subset of attributes may be filtered.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import osq

__all__ = ["Predicate", "AttributeIndex", "build_attribute_index",
           "build_r_lookup", "filter_mask", "predicate_selectivity"]

_OPS = ("<", "<=", "=", ">", ">=", "B", "IN")


@dataclasses.dataclass(frozen=True)
class Predicate:
    """One per-attribute constraint: (attr, op, operands) — Def. 1 triple.

    ``group`` forms disjunct groups: predicates sharing a (non-None) group id
    on the same attribute are OR-combined before the cross-group AND cascade.
    A group must stay within one attribute — the filter array R factorizes
    per attribute, so cross-attribute disjunction cannot be represented.
    """

    attr: int
    op: str
    lo: float = 0.0
    hi: float = 0.0
    values: Tuple[float, ...] = ()
    group: Optional[int] = None

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown operator {self.op!r}; expected {_OPS}")

    def eval(self, x: np.ndarray) -> np.ndarray:
        """Evaluate on raw attribute values (ground-truth semantics)."""
        if self.op == "<":
            return x < self.lo
        if self.op == "<=":
            return x <= self.lo
        if self.op == "=":
            return x == self.lo
        if self.op == ">":
            return x > self.lo
        if self.op == ">=":
            return x >= self.lo
        if self.op == "B":
            return (x >= self.lo) & (x <= self.hi)
        if self.op == "IN":
            return np.isin(x, np.asarray(self.values))
        raise AssertionError(self.op)


@dataclasses.dataclass
class AttributeIndex:
    """Quantized attribute data (the 'Attribute Q-Index' of Fig. 4).

    Attributes:
      codes: (N, A) int32 quantized cells, held in memory for all vectors.
      boundaries: (M+1, A) boundary values V.
      centers: (M, A) cell representatives (for categorical: the value map).
      cells: (A,) cell counts.
    """

    codes: np.ndarray
    boundaries: np.ndarray
    centers: np.ndarray
    cells: np.ndarray

    @property
    def num_attributes(self) -> int:
        return int(self.codes.shape[1])

    @property
    def max_cells(self) -> int:
        return int(self.cells.max())


def build_attribute_index(
    attrs: np.ndarray, bits: Optional[Sequence[int]] = None
) -> AttributeIndex:
    """Quantize (N, A) attribute matrix.

    If ``bits`` is None, each attribute gets enough cells to give every
    distinct value its own cell when cardinality permits (exact filtering —
    matches the paper's uniform-attribute setup), capped at 8 bits.
    """
    attrs = np.asarray(attrs, dtype=np.float64)
    n, a = attrs.shape
    uniques = [np.unique(attrs[:, i]) for i in range(a)]
    if bits is None:
        bits = [
            int(min(8, max(1, np.ceil(np.log2(max(u.size, 2))))))
            for u in uniques
        ]
    bits = np.asarray(bits, dtype=np.int32)
    cells = (1 << bits.astype(np.int64)).astype(np.int64)
    m = int(cells.max())
    boundaries = np.full((m + 1, a), np.inf)
    centers = np.full((m, a), np.inf)
    codes = np.empty((n, a), dtype=np.int32)
    for i in range(a):
        u = uniques[i]
        k = int(cells[i])
        if u.size <= k:
            # Exact: one cell per distinct value (filtering is lossless —
            # the paper's categorical cell→value mapping).
            cells[i] = u.size
            boundaries[0, i] = -np.inf
            boundaries[1 : u.size, i] = (u[:-1] + u[1:]) / 2.0
            boundaries[u.size, i] = np.inf
            centers[: u.size, i] = u
            codes[:, i] = np.searchsorted(u, attrs[:, i])
        else:
            quant = osq.design_quantizers(attrs[:, i : i + 1], bits[i : i + 1])
            boundaries[: k + 1, i] = quant.boundaries[:, 0]
            centers[:k, i] = quant.centers[:, 0]
            codes[:, i] = osq.encode(quant, attrs[:, i : i + 1])[:, 0]
    return AttributeIndex(
        codes=codes,
        boundaries=boundaries,
        centers=centers,
        cells=cells,
    )


def build_r_lookup(
    index: AttributeIndex, predicates: Sequence[Predicate]
) -> np.ndarray:
    """Compile predicates to the binary cell-satisfaction array R (Fig. 4 step 1).

    Returns (M+1, A) uint8 — R[c, a] = 1 iff quantization cell c of attribute a
    satisfies the predicates on a; attributes without predicates are all-1.
    Cells are tested on their representative value (centers), which is exact
    when each distinct attribute value owns a cell. Predicates sharing a
    ``group`` id are OR-combined (disjunct group), groups and ungrouped
    predicates AND together.
    """
    m1, a = index.boundaries.shape
    r = np.ones((m1, a), dtype=np.uint8)
    # Padding cells never pass (defensive; valid codes never reach them).
    cell_idx = np.arange(m1)[:, None]
    r = np.where(cell_idx < index.cells[None, :], r, 0).astype(np.uint8)

    def cell_col(pred: Predicate) -> np.ndarray:
        k = int(index.cells[pred.attr])
        reps = index.centers[:k, pred.attr]
        col = np.zeros(m1, dtype=np.uint8)
        col[:k] = pred.eval(reps).astype(np.uint8)
        return col

    for attr, cols in _conjunct_terms(
            predicates, cell_col, lambda c1, c2: np.bitwise_or(c1, c2)):
        r[:, attr] &= cols
    return r


def _conjunct_terms(predicates, evaluate, disjoin):
    """Group-aware predicate combination shared by R-lookup and ground truth.

    Yields (attr, term) pairs to AND together, where each term is either one
    ungrouped predicate's evaluation or the OR over a disjunct group. Raises
    if a disjunct group spans attributes (R factorizes per attribute).
    """
    groups: Dict[int, List[Predicate]] = {}
    for pred in predicates:
        if pred.group is None:
            yield pred.attr, evaluate(pred)
        else:
            groups.setdefault(pred.group, []).append(pred)
    for gid, members in groups.items():
        attrs = {p.attr for p in members}
        if len(attrs) > 1:
            raise ValueError(
                f"disjunct group {gid} spans attributes {sorted(attrs)}; "
                "OR groups must reference a single attribute")
        term = evaluate(members[0])
        for pred in members[1:]:
            term = disjoin(term, evaluate(pred))
        yield members[0].attr, term


def filter_mask(r_lookup, codes):
    """Cascaded lookup + bitwise AND (Fig. 4 steps 2–3) as torch ops.

    Args:
      r_lookup: (M+1, A) binary satisfaction array for one query.
      codes: (N, A) in-memory quantized attribute codes.
    Returns:
      (N,) bool tensor F, on ``r_lookup``'s device — 1 where *all*
      attribute predicates pass.
    """
    r = torch.as_tensor(r_lookup)
    c = torch.as_tensor(codes, device=r.device).to(torch.int64)
    n, a = c.shape
    f = torch.ones((n,), dtype=torch.bool, device=r.device)
    for attr in range(a):
        s = r[:, attr][c[:, attr]].to(torch.bool)      # vectorized lookup
        f = torch.logical_and(f, s)                    # F = F ∧ S_a
    return f


def predicate_selectivity(attrs: np.ndarray, predicates: Sequence[Predicate]) -> float:
    """Exact joint selectivity on raw values (for experiment calibration)."""
    return float(ground_truth_mask(attrs, predicates).mean())


def ground_truth_mask(attrs: np.ndarray, predicates: Sequence[Predicate]) -> np.ndarray:
    """Raw-value filter semantics: OR within disjunct groups, AND across."""
    mask = np.ones(attrs.shape[0], dtype=bool)
    for _, term in _conjunct_terms(
            predicates, lambda p: p.eval(attrs[:, p.attr]), np.logical_or):
        mask &= term
    return mask
