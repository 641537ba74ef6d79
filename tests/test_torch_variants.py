"""The edits of ``tools/kernel_variants.py`` still apply to the current
CUDA sources, so a variant's time measures the kernel as it stands.

CPU only: the script's module imports nothing beyond the standard library,
and the variants are built and timed on the card by running the script.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "kernel_variants", ROOT / "tools" / "kernel_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
CASES = [(src, name) for src, variants in TOOL.VARIANTS.items()
         for name in variants]


@pytest.mark.parametrize("source,name", CASES)
def test_variant_edits_find_their_text(source, name):
    text = (CSRC / source).read_text()
    edits = TOOL.VARIANTS[source][name]
    body = TOOL.variant_source(text, name, edits)
    if edits:
        assert body != text
    else:
        assert body == text              # the unedited kernel, timed beside


def test_variant_source_refuses_a_missing_target():
    with pytest.raises(RuntimeError, match="edit target not found"):
        TOOL.variant_source("int x;", "gone", [("float y;", "")])
