"""Lock-discipline checker: guarded-attribute access + acquisition order.

Two rules over the same traversal:

* ``lock-guarded-access`` — an attribute declared ``# guarded-by: <lock>``
  (see :mod:`repro_torch.analysis.source`) is read or written while no ``with
  <obj>.<lock>:`` scope is lexically active and the enclosing function does
  not carry a ``# squash: holds[<lock>]`` contract. Matching is by *name*:
  the checker cannot resolve runtime types, so ``worker.assigned`` matches a
  guard declared on ``_Worker.assigned`` even though the lock lives on the
  managing transport — exactly the shape of this repo's transports, where
  one manager lock guards the per-worker bookkeeping fields.
* ``lock-order`` — whenever lock B is acquired lexically inside a scope
  holding lock A, the edge A→B enters a global acquisition-order graph
  (aggregated across files by the runner). A cycle in that graph is a
  potential deadlock inversion and is reported at every edge on the cycle.

Scoping rules that keep the name-matching honest:

* ``__init__``/``__new__`` bodies are exempt — the object is not published
  to other threads until construction returns.
* A nested ``def`` does **not** inherit the lexical held-set (it usually
  becomes a thread target or callback that runs on another stack); a
  ``lambda`` does (it runs synchronously at its use site — ``min(...,
  key=...)`` under the caller's lock).
* Guards declared in a file apply to that file only, plus any entries the
  runner's third-party registry contributes for shapes we cannot annotate.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile

__all__ = ["LockEdge", "check_locks", "order_cycles"]

_CONSTRUCTORS = {"__init__", "__new__"}


@dataclasses.dataclass(frozen=True)
class LockEdge:
    """Acquisition of ``inner`` while ``outer`` is held, at path:line."""

    outer: str
    inner: str
    path: str
    line: int


def _with_locks(node: ast.With, lock_names: Set[str]) -> Set[str]:
    """Lock names acquired by a ``with`` statement's items."""
    out: Set[str] = set()
    for item in node.items:
        expr = item.context_expr
        # `with self._lock:` / `with t._lock:` / `with w.send_lock:`
        if isinstance(expr, ast.Attribute):
            name = expr.attr
        elif isinstance(expr, ast.Name):
            name = expr.id
        else:
            continue
        if name in lock_names or name.endswith("lock"):
            out.add(name)
    return out


class _LockVisitor(ast.NodeVisitor):
    def __init__(self, src: SourceFile, guards: Dict[str, Set[str]]):
        self.src = src
        self.guards = guards
        self.lock_names: Set[str] = set()
        for locks in guards.values():
            self.lock_names |= locks
        self.held: Set[str] = set()
        self.findings: List[Finding] = []
        self.edges: List[LockEdge] = []
        self._flagged: Set[Tuple[int, str]] = set()

    # ------------------------------------------------------------ functions

    def _enter_function(self, node, constructor: bool) -> None:
        saved = self.held
        if constructor:
            # Constructor writes are pre-publication; grant every guard.
            self.held = set().union(*self.guards.values()) if self.guards \
                else set()
            self.held |= self.lock_names
        else:
            self.held = set(self.src.holds_for_def(node))
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_function(node, node.name in _CONSTRUCTORS)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter_function(node, node.name in _CONSTRUCTORS)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # Lambdas run synchronously at their use site: inherit the held-set.
        self.visit(node.body)

    # ---------------------------------------------------------------- with

    def visit_With(self, node: ast.With) -> None:
        acquired = _with_locks(node, self.lock_names)
        for outer in self.held:
            for inner in acquired - {outer}:
                self.edges.append(LockEdge(outer, inner, self.src.rel,
                                           node.lineno))
        for item in node.items:
            self.visit(item.context_expr)
        self.held = self.held | acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held = self.held - acquired

    # ------------------------------------------------------------ accesses

    def _check_attr(self, name: str, line: int) -> None:
        locks = self.guards.get(name)
        if not locks or locks & self.held:
            return
        if (line, name) in self._flagged:
            return
        self._flagged.add((line, name))
        want = "/".join(sorted(locks))
        self.findings.append(Finding(
            self.src.rel, line, "lock-guarded-access",
            f"access to guarded attribute `{name}` outside `with "
            f"...{want}:` (declare `# squash: holds[{want}]` if the caller "
            f"holds it)"))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._check_attr(node.attr, node.lineno)
        self.generic_visit(node)


def check_locks(src: SourceFile,
                extra_guards: Dict[str, Set[str]] = None
                ) -> Tuple[List[Finding], List[LockEdge]]:
    """Run the lock-discipline rules over one file.

    ``extra_guards`` merges the runner's third-party registry (attr name →
    lock names) into the file's own ``# guarded-by:`` declarations.
    """
    if src.tree is None:
        return [], []
    guards = src.guarded_attrs()
    for attr, locks in (extra_guards or {}).items():
        guards.setdefault(attr, set()).update(locks)
    if not guards:
        # Still walk `with` nesting so unannotated files contribute
        # acquisition-order edges (e.g. third-party lock pairings).
        guards = {}
    visitor = _LockVisitor(src, guards)
    visitor.visit(src.tree)
    return visitor.findings, visitor.edges


def order_cycles(edges: List[LockEdge]) -> List[Finding]:
    """Cycle detection over the aggregated acquisition-order graph.

    Every edge participating in a cycle gets one ``lock-order`` finding at
    its acquisition site, so the report names each inversion pair —
    ``_lock → send_lock`` in one file vs ``send_lock → _lock`` in another
    shows up as two anchored findings.
    """
    graph: Dict[str, Set[str]] = {}
    for e in edges:
        graph.setdefault(e.outer, set()).add(e.inner)

    # Nodes on any cycle: iterative DFS with colors.
    on_cycle: Set[Tuple[str, str]] = set()

    def reachable(frm: str, to: str) -> bool:
        seen, stack = set(), [frm]
        while stack:
            n = stack.pop()
            if n == to:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(graph.get(n, ()))
        return False

    for e in edges:
        if reachable(e.inner, e.outer):
            on_cycle.add((e.outer, e.inner))

    findings: List[Finding] = []
    seen_sites: Set[Tuple[str, int, str, str]] = set()
    for e in edges:
        if (e.outer, e.inner) not in on_cycle:
            continue
        site = (e.path, e.line, e.outer, e.inner)
        if site in seen_sites:
            continue
        seen_sites.add(site)
        findings.append(Finding(
            e.path, e.line, "lock-order",
            f"acquiring `{e.inner}` while holding `{e.outer}` completes an "
            f"acquisition-order cycle (deadlock inversion)"))
    return findings
