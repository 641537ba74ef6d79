"""Parsed source file + the comment conventions squashlint understands.

Three line-comment conventions carry checker metadata (they are plain
comments, invisible to the runtime):

* ``# guarded-by: <lock>`` on an attribute assignment declares that the
  assigned attribute may only be read/written while ``<lock>`` (an attribute
  of the owning object or its manager — matched by *name*) is held.
* ``# squash: holds[<lock>, ...]`` on a ``def`` line declares a contract:
  every caller of this function already holds the named locks (the checker
  seeds its held-set instead of flagging the body).
* ``# squash: ignore[rule-id, ...] -- <justification>`` suppresses the named
  rules on that line. The justification is **mandatory** — a pragma without
  one is itself a finding (``bad-pragma``), so every suppression in the tree
  records why it is sound.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["SourceFile", "parse_source"]

_IGNORE_RE = re.compile(
    r"#\s*squash:\s*ignore\[([A-Za-z0-9_,\-\s]*)\]\s*(--\s*(\S.*))?")
_HOLDS_RE = re.compile(r"#\s*squash:\s*holds\[([A-Za-z0-9_,\s]+)\]")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")


class SourceFile:
    """One parsed module: text, AST, and the squashlint comment maps."""

    def __init__(self, rel: str, text: str):
        self.rel = rel                    # repo-relative posix path
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        # line → (set of suppressed rule ids, justification or None)
        self.ignores: Dict[int, Tuple[Set[str], Optional[str]]] = {}
        # line → lock names a `def` on that line holds by contract
        self.holds: Dict[int, Set[str]] = {}
        # line → lock name guarding the attribute assigned on that line
        self.guard_lines: Dict[int, str] = {}
        try:
            self.tree = ast.parse(text)
        except SyntaxError as exc:
            self.parse_error = f"{exc.msg} (line {exc.lineno})"
        for i, raw in enumerate(self.lines, start=1):
            if "#" not in raw:
                continue
            m = _IGNORE_RE.search(raw)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.ignores[i] = (rules, m.group(3))
            m = _HOLDS_RE.search(raw)
            if m:
                self.holds[i] = {
                    n.strip() for n in m.group(1).split(",") if n.strip()}
            m = _GUARDED_RE.search(raw)
            if m:
                self.guard_lines[i] = m.group(1)

    # -------------------------------------------------------------- helpers

    def guarded_attrs(self) -> Dict[str, Set[str]]:
        """attr name → lock names, from ``# guarded-by:`` assignment lines.

        The attribute name is taken from the AST assignment whose line
        carries the annotation (``self.x = ...`` or ``x: T = ...``), so the
        comment can never drift from a renamed field silently — an
        annotation on a non-assignment line is simply inert.
        """
        out: Dict[str, Set[str]] = {}
        if self.tree is None:
            return out
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                lock = self.guard_lines.get(node.lineno)
                if lock is None:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        out.setdefault(t.attr, set()).add(lock)
                    elif isinstance(t, ast.Name):
                        out.setdefault(t.id, set()).add(lock)
        return out

    def holds_for_def(self, node: ast.AST) -> Set[str]:
        """Locks a function holds by contract (``# squash: holds[...]``).

        The pragma may sit on any line of the signature (``def`` through the
        line before the first body statement, covering wrapped parameter
        lists) or on the line of any of its decorators.
        """
        last_sig_line = node.lineno
        body = getattr(node, "body", None)
        if body:
            last_sig_line = max(node.lineno, body[0].lineno - 1)
        lines = list(range(node.lineno, last_sig_line + 1))
        for dec in getattr(node, "decorator_list", []):
            lines.append(dec.lineno)
        held: Set[str] = set()
        for ln in lines:
            held |= self.holds.get(ln, set())
        return held


def parse_source(rel: str, text: str) -> SourceFile:
    return SourceFile(rel, text)
