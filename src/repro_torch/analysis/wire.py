"""Wire-discipline checker: every byte on the wire goes through the codec.

The §3.3 6 MB payload budget is only honest if *every* path that moves
bytes between processes/hosts flows through ``serverless/payload.py``'s
helpers (``encode_message``/``decode_message`` for codec bodies,
``write_frame``/``read_frame`` for TCP frames, ``encode_init``/
``decode_init`` for the budget-exempt deployment bundle). Two rules:

* ``wire-pickle`` — ``pickle.dumps``/``loads``/``dump``/``load`` anywhere
  outside the allowlisted codec module. Pickled bytes bypass the codec's
  byte accounting (and accept arbitrary object graphs the framing cannot
  paginate), so ad-hoc pickling is how a payload sneaks past the budget.
* ``wire-raw-socket`` — ``.sendall(...)`` / ``.recv(...)`` method calls
  outside the codec module. Raw socket I/O skips the per-frame budget
  check in ``write_frame`` and the exact-length framing of ``read_frame``.
  Multiprocessing-pipe ``Connection.recv`` sites share the method name and
  are suppressed inline with a justification (the pipes carry bytes the
  submit path already budget-checked).

The allowlist is by repo-relative path (see the runner's configuration).
"""

from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile

__all__ = ["check_wire"]

_PICKLE_FNS = {"dumps", "loads", "dump", "load"}
_RAW_SOCKET_METHODS = {"sendall", "recv", "recv_into", "recvfrom"}


class _WireVisitor(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id in ("pickle", "cPickle") \
                    and func.attr in _PICKLE_FNS:
                self.findings.append(Finding(
                    self.src.rel, node.lineno, "wire-pickle",
                    f"`pickle.{func.attr}` outside serverless/payload.py — "
                    "wire bytes must flow through the budgeted codec "
                    "(encode_message/encode_init)"))
            elif func.attr in _RAW_SOCKET_METHODS:
                self.findings.append(Finding(
                    self.src.rel, node.lineno, "wire-raw-socket",
                    f"raw `.{func.attr}()` outside serverless/payload.py — "
                    "socket I/O must go through write_frame/read_frame so "
                    "the 6 MB per-frame budget applies"))
        self.generic_visit(node)


def check_wire(src: SourceFile) -> List[Finding]:
    if src.tree is None:
        return []
    visitor = _WireVisitor(src)
    visitor.visit(src.tree)
    return visitor.findings
