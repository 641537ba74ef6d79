"""Tree-based FaaS invocation scheme (paper §3.3, Algorithm 2).

The Coordinator (id = −1) synchronously invokes F children; each internal
QueryAllocator invokes F more with geometrically shrinking ID jumps so that
the sub-tree rooted at a node with id x (next-sibling x + J_S) contains
exactly the ids y with x < y < x + J_S. That invariant lets every node know
which child ids will return results to it — bi-directional data flow over
request/response payloads with no storage rendezvous.

The port of the JAX package's ``repro.core.invocation`` (pure Python, copied
as is). The serverless runtime walks this tree; the simulator serves (a)
correctness tests of the ID scheme and (b) the latency / cost models of
Figs. 8–10, where invocation fan-out time matters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

__all__ = ["tree_size", "children_of", "build_tree", "tree_nodes",
           "NodeSpec", "InvocationSim"]


def tree_size(branching: int, max_level: int) -> int:
    """N_QA = F · (1 − F^l_max) / (1 − F)   (Alg. 2, line 1)."""
    f, l = branching, max_level
    if f == 1:
        return l
    return f * (1 - f**l) // (1 - f)


def children_of(
    node_id: int, level: int, branching: int, max_level: int
) -> List[int]:
    """Child ids a node invokes (Alg. 2). Coordinator is (id=−1, level=0).

    QA ids are 0-based. A node at level l with id x owns the id range
    (x, x + J_S(l)) where the jump sizes shrink geometrically by F per level.
    """
    f = branching
    n_qa = tree_size(f, max_level)
    if node_id == -1:
        js = math.ceil(n_qa / f)
        return [i * js for i in range(f) if i * js < n_qa]
    # Remaining depth below this node.
    depth_left = max_level - level
    if depth_left < 1:
        return []
    # Jump size at this node's level: the sub-tree below holds
    # tree_size(f, depth_left) ids; children split it in f.
    sub = tree_size(f, depth_left)
    js = math.ceil(sub / f)
    kids = []
    for i in range(f):
        cid = node_id + 1 + i * js
        if cid <= node_id + sub and cid < n_qa:
            kids.append(cid)
    return kids


def build_tree(branching: int, max_level: int) -> Dict[int, List[int]]:
    """Materialize the full invocation tree: parent id → child ids."""
    tree: Dict[int, List[int]] = {}
    frontier: List[Tuple[int, int]] = [(-1, 0)]
    while frontier:
        nid, lvl = frontier.pop()
        kids = children_of(nid, lvl, branching, max_level)
        tree[nid] = kids
        frontier.extend((k, lvl + 1) for k in kids)
    return tree


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One tree node with everything the runtime needs to route payloads.

    ``subtree`` counts the QA ids strictly below this node, so the id range
    a node is responsible for is ``[node_id, node_id + subtree]`` (inclusive;
    the coordinator covers ``[0, n_qa)``). That range is what makes
    bi-directional request/response routing storage-free: a parent knows
    exactly which ids — hence which query slices — return through each child.
    """

    node_id: int
    level: int
    children: Tuple[int, ...]
    subtree: int

    def id_range(self, n_qa: int) -> Tuple[int, int]:
        """[lo, hi) of QA ids this node's subtree covers (self included)."""
        if self.node_id == -1:
            return 0, n_qa
        return self.node_id, min(self.node_id + self.subtree + 1, n_qa)


def tree_nodes(branching: int, max_level: int) -> Dict[int, NodeSpec]:
    """Alg. 2 tree with levels + subtree spans (the runtime's routing table)."""
    nodes: Dict[int, NodeSpec] = {}
    frontier: List[Tuple[int, int]] = [(-1, 0)]
    while frontier:
        nid, lvl = frontier.pop()
        kids = children_of(nid, lvl, branching, max_level)
        sub = (tree_size(branching, max_level) if nid == -1
               else tree_size(branching, max_level - lvl))
        nodes[nid] = NodeSpec(node_id=nid, level=lvl,
                              children=tuple(kids), subtree=sub)
        frontier.extend((k, lvl + 1) for k in kids)
    return nodes


@dataclasses.dataclass
class InvocationSim:
    """Latency simulator for the invocation tree.

    Models per-invocation overhead (cold vs warm) and per-node compute, and
    returns the critical-path makespan — sequential CO fan-out vs the tree.
    """

    branching: int
    max_level: int
    invoke_latency_warm: float = 0.015   # s — warm synchronous Lambda invoke
    invoke_latency_cold: float = 0.400   # s — cold start
    warm_fraction: float = 1.0
    node_compute: float = 0.050          # s — QA-side work per node

    def _invoke_cost(self, child_index: int) -> float:
        # Children are launched on threads; model thread spawn serialization
        # as a small per-child stagger before overlap.
        stagger = 0.002 * child_index
        cold = self.invoke_latency_cold if self.warm_fraction < 1.0 else 0.0
        lat = (
            self.warm_fraction * self.invoke_latency_warm
            + (1.0 - self.warm_fraction) * self.invoke_latency_cold
        )
        del cold
        return stagger + lat

    def makespan(self) -> float:
        """Critical path of the tree launch + response gathering."""
        tree = build_tree(self.branching, self.max_level)

        def finish(nid: int) -> float:
            kids = tree.get(nid, [])
            t_children = 0.0
            for i, kid in enumerate(kids):
                t_children = max(
                    t_children, self._invoke_cost(i) + finish(kid)
                )
            return self.node_compute + t_children

        return finish(-1)

    def sequential_makespan(self) -> float:
        """Naïve CO-invokes-everything baseline (paper's strawman)."""
        n = tree_size(self.branching, self.max_level)
        launch = sum(self._invoke_cost(i) for i in range(n))
        return launch + self.node_compute * 2  # CO work + slowest QA overlap
