"""Shared finding model for the squashlint checker suite.

Every checker (``locks``, ``determinism``, ``wire``, ``sync``) emits
:class:`Finding` records; the runner handles suppression (inline pragmas),
baselining (the grandfather ratchet) and reporting, so checkers stay pure
AST visitors. A finding is identified for baseline purposes by its
``(rule, path)`` pair — counts per pair ratchet downward — while the report
shows exact ``file:line`` anchors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["Finding", "RULES", "count_by_key"]

# rule id → (severity, one-line description). Rule ids are the tokens inline
# pragmas name: ``# squash: ignore[rule-id] -- justification``.
RULES: Dict[str, Tuple[str, str]] = {
    # -- lock discipline (locks.py)
    "lock-guarded-access": (
        "error",
        "read/write of a `# guarded-by:` attribute outside its lock"),
    "lock-order": (
        "error",
        "lock-acquisition-order cycle (potential deadlock inversion)"),
    # -- determinism (determinism.py)
    "wallclock": (
        "error",
        "wall-clock call inside a bitwise-parity module"),
    "unseeded-rng": (
        "error",
        "module-level / unseeded RNG inside a bitwise-parity module"),
    "set-iteration": (
        "error",
        "iteration over an unordered set feeding result ordering"),
    # -- wire discipline (wire.py)
    "wire-pickle": (
        "error",
        "pickle outside serverless/payload.py bypasses budget accounting"),
    "wire-raw-socket": (
        "error",
        "raw sendall/recv outside serverless/payload.py frame helpers"),
    # -- device-sync / compile hygiene (sync.py)
    "device-sync": (
        "error",
        "host read of a card tensor (.item()/.cpu()/float() ...) waits "
        "for the device"),
    "compile-per-call": (
        "error",
        "fresh torch.compile(...)(...) per call rebuilds the compiled "
        "wrapper"),
    # -- meta (runner/pragmas)
    "bad-pragma": (
        "error",
        "suppression pragma without a `-- justification`"),
    "parse-error": ("error", "file failed to parse"),
}


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One checker hit, anchored to ``path:line``.

    ``path`` is repo-relative with forward slashes (stable across hosts so
    baseline entries and pragma bookkeeping never depend on the checkout
    location).
    """

    path: str
    line: int
    rule: str
    message: str

    @property
    def severity(self) -> str:
        return RULES.get(self.rule, ("error", ""))[0]

    @property
    def key(self) -> str:
        """Baseline aggregation key (line numbers drift; rule+path don't)."""
        return f"{self.rule}:{self.path}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def count_by_key(findings: List[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.key] = out.get(f.key, 0) + 1
    return out
