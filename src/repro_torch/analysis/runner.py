"""squashlint runner: scoping, pragma suppression, baseline ratchet, CLI.

``python -m repro_torch.analysis`` walks ``src/repro_torch``, applies each
checker to its configured scope, filters findings through inline
``# squash: ignore[rule] -- justification`` pragmas, and compares what is
left against ``baseline.json``:

* a finding not covered by the baseline **fails** the run;
* a baseline entry whose finding count *shrank* (or vanished) fails
  ``--strict`` with a ratchet message until the baseline is re-recorded
  (``--update-baseline``) — grandfathered debt may only go down, never
  quietly stay stale;
* ``--update-baseline`` rewrites the file from the current findings.

Scopes (repo-relative, under ``src/repro_torch``; the first three are the
JAX package's own, at the same paths):

* lock discipline — every module (annotations are opt-in per file; the
  acquisition-order graph aggregates over all of them);
* determinism — the bitwise-parity surface: ``core/``, ``kernels/`` and the
  serverless *choreography* (``runtime``/``nodes``/``events``/``payload``).
  Transports and workers measure wall-clock by design and stay out;
* wire discipline — every module, with ``serverless/payload.py`` (the codec
  itself) allowlisted;
* device-sync hygiene — where tensors live on the card: the JAX package's
  jit scope (``core/dataplane.py``, ``core/distributed.py``, ``kernels/``)
  plus ``models/``, ``optim/``, ``train/steps.py`` and ``serve/engine.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import determinism, locks, sync, wire
from repro_torch.analysis.findings import Finding, count_by_key
from repro_torch.analysis.source import SourceFile, parse_source

__all__ = [
    "DETERMINISM_SCOPE", "WIRE_ALLOWLIST", "SYNC_SCOPE", "EXTERNAL_GUARDS",
    "analyze_source", "analyze_tree", "unsuppressed_findings", "Report",
    "load_baseline", "main",
]

# ------------------------------------------------------------------- scopes

# Bitwise-parity modules: ids/SearchStats computed here must never consult
# ambient nondeterminism (prefix match on repo-relative paths).
DETERMINISM_SCOPE: Tuple[str, ...] = (
    "core/",
    "kernels/",
    "serverless/runtime.py",
    "serverless/nodes.py",
    "serverless/events.py",
    "serverless/payload.py",
)

# The codec module itself — the only place pickle / raw socket I/O may live.
WIRE_ALLOWLIST: Tuple[str, ...] = ("serverless/payload.py",)

# Where tensors live on the card: a host read there waits for the device.
SYNC_SCOPE: Tuple[str, ...] = (
    "core/dataplane.py",
    "core/distributed.py",
    "kernels/",
    "models/",
    "optim/",
    "train/steps.py",
    "serve/engine.py",
)

# Third-party / cross-file guarded shapes the `# guarded-by:` convention
# cannot annotate in place: repo-relative path → {attr name → lock names}.
# (Currently empty — every guarded field in the tree is annotated at its
# assignment; keep entries here for vendored classes only.)
EXTERNAL_GUARDS: Dict[str, Dict[str, Set[str]]] = {}

_BASELINE_NAME = "baseline.json"


def _in_scope(rel: str, scope: Iterable[str]) -> bool:
    return any(rel == s or rel.startswith(s) for s in scope)


# ------------------------------------------------------------------ analysis

def analyze_source(rel: str, text: str
                   ) -> Tuple[List[Finding], List[locks.LockEdge]]:
    """All applicable checkers over one in-memory module.

    Returns (findings after pragma suppression, lock-order edges). Pragma
    misuse (missing justification) surfaces as ``bad-pragma`` findings.
    """
    src = parse_source(rel, text)
    if src.parse_error is not None:
        return [Finding(rel, 1, "parse-error", src.parse_error)], []
    raw, edges = _check(src)
    return _apply_pragmas(src, raw), edges


def _check(src: SourceFile
           ) -> Tuple[List[Finding], List[locks.LockEdge]]:
    """Every checker whose scope holds ``src``, before pragmas apply."""
    rel = src.rel
    raw: List[Finding] = []
    lf, edges = locks.check_locks(src, EXTERNAL_GUARDS.get(rel))
    raw.extend(lf)
    if _in_scope(rel, DETERMINISM_SCOPE):
        raw.extend(determinism.check_determinism(src))
    if not _in_scope(rel, WIRE_ALLOWLIST):
        raw.extend(wire.check_wire(src))
    if _in_scope(rel, SYNC_SCOPE):
        raw.extend(sync.check_sync(src))
    return raw, edges


def unsuppressed_findings(root: Optional[str] = None) -> List[Finding]:
    """Every module's findings under ``root`` as if it carried no pragma:
    what the rules see, the lines a pragma justifies included."""
    out: List[Finding] = []
    for rel, path in sorted(_iter_py(root or default_root())):
        with open(path, "r", encoding="utf-8") as fh:
            src = parse_source(rel, fh.read())
        if src.tree is not None:
            out.extend(_check(src)[0])
    return sorted(out)


def _apply_pragmas(src: SourceFile, raw: List[Finding]) -> List[Finding]:
    kept: List[Finding] = []
    for f in raw:
        pragma = src.ignores.get(f.line)
        if pragma is not None and f.rule in pragma[0]:
            continue                      # suppressed (justified or not —
                                          # bad-pragma reports the latter)
        kept.append(f)
    for line, (rules, justification) in sorted(src.ignores.items()):
        if justification is None:
            kept.append(Finding(
                src.rel, line, "bad-pragma",
                f"`squash: ignore[{', '.join(sorted(rules))}]` without a "
                "`-- justification`; every suppression must say why"))
    return kept


class Report:
    """Outcome of a tree run: findings vs the baseline ratchet."""

    def __init__(self, findings: List[Finding], baseline: Dict[str, int]):
        self.findings = sorted(findings)
        self.baseline = dict(baseline)
        counts = count_by_key(self.findings)
        self.new: List[Finding] = []
        self.baselined: List[Finding] = []
        remaining = dict(self.baseline)
        for f in self.findings:
            if remaining.get(f.key, 0) > 0:
                remaining[f.key] -= 1
                self.baselined.append(f)
            else:
                self.new.append(f)
        # Ratchet: baseline entries that no longer match reality.
        self.stale: Dict[str, int] = {
            k: self.baseline[k] - counts.get(k, 0)
            for k in self.baseline
            if self.baseline[k] > counts.get(k, 0)
        }

    @property
    def clean(self) -> bool:
        return not self.new

    @property
    def ratchet_ok(self) -> bool:
        return not self.stale


def analyze_tree(root: str, baseline: Optional[Dict[str, int]] = None
                 ) -> Report:
    """Run every checker over ``root`` (the ``src/repro_torch`` package
    dir)."""
    findings: List[Finding] = []
    edges: List[locks.LockEdge] = []
    for rel, path in sorted(_iter_py(root)):
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
        f, e = analyze_source(rel, text)
        findings.extend(f)
        edges.extend(e)
    findings.extend(locks.order_cycles(edges))
    if baseline is None:
        baseline = load_baseline()
    return Report(findings, baseline)


def _iter_py(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            yield rel, path


# ------------------------------------------------------------------ baseline

def baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), _BASELINE_NAME)


def load_baseline(path: Optional[str] = None) -> Dict[str, int]:
    path = path or baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {str(k): int(v) for k, v in data.get("entries", {}).items()}


def save_baseline(entries: Dict[str, int],
                  path: Optional[str] = None) -> None:
    path = path or baseline_path()
    payload = {
        "comment": "squashlint grandfathered findings: `rule:path` → count. "
                   "The ratchet only goes down — fix findings and rerun "
                   "`python -m repro_torch.analysis --update-baseline`.",
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")


# ----------------------------------------------------------------------- CLI

def default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="squashlint: AST invariants checker (lock discipline, "
                    "determinism, wire discipline, device-sync hygiene) "
                    "for the PyTorch port.")
    ap.add_argument("--root", default=None,
                    help="package root to scan (default: the installed "
                         "repro_torch package directory)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail when the baseline is stale (the ratchet "
                         "must shrink) — the CI mode")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite baseline.json from the current findings")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    root = args.root or default_root()
    report = analyze_tree(root)

    if args.update_baseline:
        save_baseline(count_by_key(report.findings))
        print(f"baseline updated: {len(report.findings)} finding(s) "
              f"grandfathered in {baseline_path()}")
        return 0

    if args.json:
        print(json.dumps({
            "new": [f.render() for f in report.new],
            "baselined": [f.render() for f in report.baselined],
            "stale_baseline": report.stale,
        }, indent=2))
    else:
        for f in report.new:
            print(f.render())
        if report.baselined:
            print(f"[baseline] {len(report.baselined)} grandfathered "
                  "finding(s) suppressed")
        for key, by in sorted(report.stale.items()):
            print(f"[ratchet] baseline entry `{key}` overcounts by {by} — "
                  "run --update-baseline to shrink it")

    if report.new:
        print(f"squashlint: {len(report.new)} new finding(s)",
              file=sys.stderr)
        return 1
    if args.strict and not report.ratchet_ok:
        print("squashlint: baseline is stale (ratchet must shrink)",
              file=sys.stderr)
        return 1
    print(f"squashlint: clean ({len(report.findings)} finding(s) total, "
          f"{len(report.baselined)} baselined)")
    return 0
