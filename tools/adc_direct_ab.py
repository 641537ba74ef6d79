#!/usr/bin/env python3
"""Kernel 2b (``adc_direct``) of another ``adc_lookup.cu`` beside the
checkout's, on one card: does each launch at a wide d, and what does each
take at d = 128.

    python3 tools/adc_direct_ab.py --other path/to/adc_lookup.cu

Builds both sources with the port's nvcc flags (one nvcc each, at once),
then:

* at d = 3,072 (``chip_smoke.WIDE``: Q = 8, P = 4, M+1 = 257, S = 256), in
  f32 and f64, launches each library's kernel and holds what it returns
  against the plain version (rtol 1e-5, atol 0, +inf exactly on dead
  slots), or prints the error the launch raised;
* at d = 128 on the synthetic Path A shape of ``tools/kernel_variants.py``
  (Q = 64, P = 10, S = 10,500, n_max = 105,000, M+1 = 257, 77 live pairs of
  200-2,000 slots), times each library's kernel in turns (other, checkout,
  checkout, other; device time, ``chip_smoke.device_ms``) and checks that
  the two give equal results bit for bit.

Prints one JSON line per result, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(row) -> None:
    print(json.dumps(row), flush=True)


def build_pair(build, other_src: str, out_dir: str):
    """{"other": CDLL, "checkout": CDLL}, both built at once."""
    srcs = {"other": other_src,
            "checkout": os.path.join(build._CSRC, "adc_lookup.cu")}
    jobs = {}
    for name, src in srcs.items():
        so = os.path.join(out_dir, f"libadc_lookup-{name}.so")
        jobs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def direct_launcher(lib):
    """The library's ``adc_direct_launch`` with its C interface declared
    (the same in both sources)."""
    fn = lib.adc_direct_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the adc_lookup.cu to hold beside the checkout's")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("adc_direct_ab.py needs a CUDA card")
    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, REPO)
    from chip_smoke import (ADC_RTOL, WIDE, card_line, device_ms, hold_keep,
                            wide_inputs)
    from repro_torch.core import dataplane
    from repro_torch.kernels import adc_lookup, build, ref

    out_dir = os.path.join(REPO, "build", "adc_direct_ab")
    os.makedirs(out_dir, exist_ok=True)
    fns = {name: direct_launcher(lib)
           for name, lib in build_pair(build, args.other, out_dir).items()}

    for dtype in (torch.float32, torch.float64):
        inputs = wide_inputs(dtype, WIDE["m1_direct"])
        want = ref.adc_direct_ref(*inputs)
        for name, fn in fns.items():
            row = {"kernel": "2b", "library": name, "d": inputs[0].shape[-1],
                   "dtype": str(dtype)[6:], "shape": WIDE}
            try:
                got = adc_lookup.adc_direct_with(fn, *inputs)
                torch.cuda.synchronize()
            except RuntimeError as exc:      # the launch refused: report it
                row["error"] = str(exc)
            else:
                row["max_abs_err"] = hold_keep("adc_direct", name, got, want,
                                               inputs[-1], {})
                row["tolerance"] = f"rtol={ADC_RTOL}, atol=0"
            emit(row)
        del inputs, want

    rng = np.random.default_rng(0)
    q, parts, s, n_max, d, m1 = 64, 10, 10_500, 105_000, 128, 257
    bnd = torch.sort(torch.randn((parts, m1, d), device="cuda",
                                 dtype=torch.float64), dim=1).values
    bnd[:, 0], bnd[:, -1] = -float("inf"), float("inf")
    codes = torch.randint(0, m1 - 1, (parts, n_max, d), device="cuda",
                          dtype=torch.int32)
    sel = torch.randint(0, n_max, (q, parts, s), device="cuda",
                        dtype=torch.int64)
    keep = torch.zeros(q * parts, dtype=torch.int32)
    live = torch.from_numpy(rng.choice(q * parts, 77, replace=False))
    keep[live] = torch.from_numpy(rng.integers(200, 2000, 77).astype(np.int32))
    keep = keep.reshape(q, parts).cuda()
    for dtype in (torch.float32, torch.float64):
        b = bnd.to(dtype)
        qt = torch.randn((q, parts, d), device="cuda", dtype=dtype)
        qcell = dataplane.query_cells(qt, b)
        outs = {name: adc_lookup.adc_direct_with(fn, qt, qcell, b, codes, sel,
                                                 keep)
                for name, fn in fns.items()}
        times = {name: [] for name in fns}
        for name in ("other", "checkout", "checkout", "other"):
            times[name].append(device_ms(
                lambda: adc_lookup.adc_direct_with(fns[name], qt, qcell, b,
                                                   codes, sel, keep), 20))
        emit({"kernel": "2b", "d": d, "dtype": str(dtype)[6:],
              "shape": {"Q": q, "P": parts, "S": s, "n_max": n_max,
                        "M+1": m1}, "live_slots": int(keep.sum()),
              "ms_other": times["other"], "ms_checkout": times["checkout"],
              "bitwise_equal": bool(torch.equal(outs["other"],
                                                outs["checkout"]))})
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
