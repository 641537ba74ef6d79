"""The port passes the JAX package's static analysis (squashlint) with an
empty baseline: lock discipline and lock order, wire discipline, and the
determinism rules (no wall clock or unseeded randomness in the parity
scope without a justified pragma). The analyzer runs read-only over
``src/repro_torch``; its baseline file is not touched.
"""

import os

import pytest

pytest.importorskip("torch")

from repro.analysis.runner import analyze_tree  # noqa: E402

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch")


def test_port_has_no_squashlint_finding():
    report = analyze_tree(PORT, baseline={})
    assert not report.new, "\n".join(str(f) for f in report.new)
    assert report.clean and report.ratchet_ok


def test_gate_sees_the_port_build_timer_without_its_pragma():
    """The gate is live on the port's paths: ``kernels/build.py`` with its
    two ``wallclock`` pragmas taken out gives exactly those findings."""
    from repro.analysis.runner import analyze_source

    path = os.path.join(PORT, "kernels", "build.py")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    pragma = "  # squash: ignore[wallclock]"
    lines = [ln.split(pragma)[0] for ln in text.splitlines()]
    findings, _ = analyze_source("kernels/build.py", "\n".join(lines) + "\n")
    assert sorted(f.rule for f in findings) == ["wallclock", "wallclock"]
    assert analyze_source("kernels/build.py", text)[0] == []
