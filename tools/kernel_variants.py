#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels 6 and 2b on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 tools/kernel_variants.py

Each variant is the kernel's source with one part taken out or changed (a
text edit, built with the port's nvcc flags into ``build/variants/``) and
is timed through the port's own wrapper, launched from the variant's
library (``ssd.ssd_intra_with``, ``adc_lookup.adc_direct_with``), so the
difference to the unedited kernel says what that part costs.
``tests/test_torch_variants.py`` checks on the CPU that every edit still
finds its text in the current sources. Variants that change the arithmetic
print their error against the plain version; they are measurements, not
kernels of the port. Kernel 6 runs at the LM serve prefill's shape (G=64, H=32, lc=256,
N=128, P=64) on the strided views ``ssm.ssd_chunked`` passes; kernel 2b on
a synthetic Path A shape (Q=64, P=10, S=10,500, n_max=105,000, d=128,
M+1=257) with 77 live pairs of 200-2,000 live slots each, in f32 and f64.
Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SSD = {
    "ssd_intra": [],
    "one_tf32_pass": [("  mma(d, as, b0b, b1b);\n  mma(d, ab, b0s, b1s);\n", "")],
    "unsplit_operands": [
        ("  big = __float_as_uint(a) & 0xffffe000u;\n"
         "  small = __float_as_uint(a - __uint_as_float(big));",
         "  big = __float_as_uint(a);\n  small = 0u;")],
    "no_decay_exp": [(f"expf(cl{r} - csv.{c})", "1.f")
                     for r in "ab" for c in "xy"],
    "exp_intrinsic": [(f"expf(cl{r} - csv.{c})", f"__expf(cl{r} - csv.{c})")
                      for r in "ab" for c in "xy"],
    "f32_prefix_sums": [
        ("  if (warp < n_heads) {\n",
         "  if (warp < n_heads) {\n#define double float\n"),
        ("  }  // cs is next read after the score phase's barriers",
         "#undef double\n  }  // cs is next read after the score phase's "
         "barriers")],
}
ADC = {
    "adc_direct": [],
    "no_term_sums": [("        if (live) {\n          if (VEC) {",
                      "        if (live && d0 < 0) {\n          if (VEC) {")],
    "no_code_staging": [("            if (r_live && col < w)\n",
                         "            if (r_live && col < 0)\n")],
    "no_dead_fill": [("      o[s] = INFINITY;", "      if (s < 0) o[s] = INFINITY;")],
}
VARIANTS = {"ssd.cu": SSD, "adc_lookup.cu": ADC}


def variant_source(text, name, edits):
    """``text`` with each (old, new) edit made at every place it occurs;
    raises where an old text is not in it (the source changed under the
    variant)."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: edit target not found: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(build, source, variants, out_dir):
    text = open(os.path.join(build._CSRC, source)).read()
    bodies = {name: variant_source(text, name, edits)
              for name, edits in variants.items()}
    jobs = {}
    for name, body in bodies.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        so = os.path.join(out_dir, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(body)
        jobs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        libs[name] = (ctypes.CDLL(so), [ln.strip() for ln in log.splitlines()
                                        if "registers" in ln])
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants.py needs a CUDA card")
    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, device_ms, ssd_views
    from repro_torch.core import dataplane
    from repro_torch.kernels import adc_lookup, build, ref, ssd

    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    ssd_libs = build_variants(build, "ssd.cu", SSD, out_dir)
    adc_libs = build_variants(build, "adc_lookup.cu", ADC, out_dir)

    g, h, lc, n, p = 64, 32, 256, 128, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = torch.randn((g, lc, h * p + 2 * n), device="cuda", generator=gen)
    da_l = -torch.empty((g, lc, h), device="cuda").exponential_(generator=gen)
    x_l = torch.randn((g, lc, h, p), device="cuda", generator=gen)
    views = ssd_views(conv, da_l, x_l, n)
    want = ref.ssd_intra_ref(*views)
    for name, (lib, regs) in ssd_libs.items():
        lib = ssd.bind(lib)
        err = float((ssd.ssd_intra_with(lib, *views) - want).abs().max())
        print(json.dumps({"kernel": 6, "variant": name, "ptxas": regs,
                          "ms": device_ms(
                              lambda: ssd.ssd_intra_with(lib, *views), 20),
                          "max_abs_err": err,
                          "max_abs_ref": float(want.abs().max())}), flush=True)
    del conv, x_l, views, want

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
    for name, (lib, regs) in adc_libs.items():
        fn = adc_lookup.bind(lib)[1]
        row = {"kernel": "2b", "variant": name, "ptxas": regs,
               "live_slots": int(keep.sum())}
        for dtype in (torch.float32, torch.float64):
            b = bnd.to(dtype)
            qt = torch.randn((q, parts, d), device="cuda", dtype=dtype)
            qcell = dataplane.query_cells(qt, b)
            row[f"ms_{str(dtype)[6:]}"] = device_ms(
                lambda: adc_lookup.adc_direct_with(fn, qt, qcell, b, codes,
                                                   sel, keep), 20)
        print(json.dumps(row), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
