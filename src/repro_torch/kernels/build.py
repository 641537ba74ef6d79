"""Build and load the port's CUDA kernels (``csrc/*.cu``) for Hopper.

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`. Nothing is built
at import time: :func:`library` builds a source the first time a kernel from
it launches, and :func:`build_all` starts one ``nvcc`` per source at once (the
way ``chip_smoke.py`` builds everything up front).

Libraries land in ``<checkout>/build/repro_torch/`` (listed in
``.gitignore``), named by a hash of the source text and the compiler flags,
so an edited source rebuilds and an unchanged one is reused. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build_all", "library",
           "build_logs"]

_CSRC = Path(__file__).resolve().parent / "csrc"

# Library name → source file under csrc/.
SOURCES = {
    "hamming": "hamming.cu",
    "adc_lookup": "adc_lookup.cu",
    "bitpack": "bitpack.cu",
    "ssd": "ssd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}
# Serializes load-or-build within a process: the threads of one socket host
# (a compute thread per QP link) may reach an unbuilt library at once, and
# two builds in one process would write the same pid-named temporary file.
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``<checkout>/build/repro_torch`` (this file is src/repro_torch/kernels/)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from csrc/ with nvcc on the machine with the card")


def _target(name: str) -> Path:
    src = _CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns the seconds each compiled library took (0.0 where it was already
    built). The compiler's output (``-Xptxas -v`` register and shared-memory
    report) is kept in :func:`build_logs`. Raises on the first failure.
    """
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())  # squash: ignore[wallclock] -- times the nvcc build for the build report; no kernel's answer depends on it
    failed = []
    for name, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0  # squash: ignore[wallclock] -- times the nvcc build for the build report; no kernel's answer depends on it
        _LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def build_logs() -> Dict[str, str]:
    """Compiler output of the libraries built by this process."""
    return dict(_LOGS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing (thread-safe)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all([name])
            lib = ctypes.CDLL(str(target))
            _LOADED[name] = lib
        return lib
