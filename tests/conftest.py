"""Shared test configuration: imports, determinism, markers (tier-1 suite).

Responsibilities (kept in one place so ``pytest -q`` works from a bare
checkout, with or without PYTHONPATH=src, with or without hypothesis):

* Path bootstrap — make ``repro`` importable when PYTHONPATH was not set.
* Hypothesis fallback — when the real ``hypothesis`` package is missing,
  install :mod:`tests._hypothesis_shim` so the 7 property-test modules
  collect and run as fixed-example parametrized tests instead of erroring.
* JAX config — force the CPU platform (this container has no accelerator;
  kernels run under ``interpret=True`` / XLA-CPU) and enable x64 so the JAX
  query data plane matches the float64 NumPy reference bit-for-bit in the
  backend-parity tests.
* Seeded RNG fixtures — every test draws from a generator seeded by its own
  node id, so runs are order-independent and reproducible.
* Markers — ``slow`` (multi-minute builds) and ``multidevice`` (subprocess
  host-device meshes), auto-applied by module name and filterable with
  ``-m "not slow"`` / ``-m "not multidevice"``.
"""

from __future__ import annotations

import os
import sys
import zlib

# --- path bootstrap (before any repro import) ----------------------------
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# --- hypothesis fallback (before test modules are collected) -------------
try:  # pragma: no cover - exercised implicitly at collection time
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_shim

    _hypothesis_shim.install()

# --- jax config (before any jax computation) -----------------------------
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute index builds / end-to-end runs")
    config.addinivalue_line(
        "markers",
        "multidevice: spawns subprocesses with XLA host-device meshes")
    config.addinivalue_line(
        "markers",
        "transport: spawns ProcessTransport worker processes (run in CI "
        "under a hard timeout; deselect with -m 'not transport')")
    config.addinivalue_line(
        "markers",
        "mutation: live-index mutation regression tier (insert/delete/"
        "compact parity and stale-retention guards; select with -m mutation)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "without one — run on the card with -m cuda")


_AUTO_MARKS = {
    "test_multidevice": ("multidevice", "slow"),
    "test_distributed": ("slow",),
    "test_system": ("slow",),
    "test_archs": ("slow",),
    "test_transport": ("transport",),
    "test_obs_transport": ("transport",),
    "test_live": ("mutation",),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        module = item.nodeid.split("::", 1)[0].rsplit("/", 1)[-1]
        module = module.removesuffix(".py")
        for mark in _AUTO_MARKS.get(module, ()):
            item.add_marker(getattr(pytest.mark, mark))
        if "eight_device" in item.nodeid or "subprocess" in item.nodeid:
            item.add_marker(pytest.mark.multidevice)


@pytest.fixture
def rng(request) -> np.random.Generator:
    """Per-test deterministic generator (seeded by the test's node id)."""
    seed = zlib.crc32(request.node.nodeid.encode("utf-8")) & 0x7FFFFFFF
    return np.random.default_rng(seed)


@pytest.fixture
def seed(request) -> int:
    """Stable integer seed derived from the test's node id."""
    return zlib.crc32(request.node.nodeid.encode("utf-8")) & 0x7FFFFFFF
