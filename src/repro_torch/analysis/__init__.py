"""squashlint for the PyTorch port: AST-based invariant checkers.

The counterpart of the JAX package's ``analysis`` package, with its module
names, pragma conventions and report format. Four checker families over
``src/repro_torch``:

* :mod:`repro_torch.analysis.locks` — ``# guarded-by:`` field discipline
  and the cross-file lock-acquisition-order graph;
* :mod:`repro_torch.analysis.determinism` — wall-clock / unseeded-RNG
  (numpy's, the stdlib's and torch's global generators) / set-iteration
  bans inside the bitwise-parity modules;
* :mod:`repro_torch.analysis.wire` — pickle and raw socket I/O confined to
  the ``serverless/payload.py`` codec;
* :mod:`repro_torch.analysis.sync` — host reads that wait for the card
  (``device-sync``) and per-call compiled wrappers (``compile-per-call``)
  where tensors live on the card; it takes the place of the JAX package's
  jit-hygiene checker.

Run with ``python -m repro_torch.analysis`` (``--strict`` as the gate).
Suppress a finding inline with
``# squash: ignore[rule-id] -- justification`` or grandfather it in
``baseline.json`` (the ratchet only shrinks).
"""

from repro_torch.analysis.findings import Finding, RULES
from repro_torch.analysis.runner import analyze_source, analyze_tree, main

__all__ = ["Finding", "RULES", "analyze_source", "analyze_tree", "main"]
