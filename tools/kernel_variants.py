#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels 6, 2b, 2 and 5 on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 tools/kernel_variants.py

Each variant is the kernel's source with one part taken out or changed (a
text edit, built with the port's nvcc flags into ``build/variants/``) and
is timed through the port's own wrapper, launched from the variant's
library (``ssd.ssd_intra_with``, ``adc_lookup.adc_direct_with``,
``adc_lookup.adc_table_with``, ``bitpack.extract_codes_with``), so the
difference to the unedited kernel says what that part costs.
``tests/test_torch_variants.py`` checks on the CPU that every edit still
finds its text in the current sources. Variants that change the arithmetic
print their error against the plain version; they are measurements, not
kernels of the port. Kernel 6 runs at the LM serve prefill's shape (G=64,
H=32, lc=256, N=128, P=64) on the strided views ``ssm.ssd_chunked`` passes.
Kernels 2b and 2 share ``adc_lookup.cu`` (its variants time both), on a
synthetic Path A / Path B shape (Q=64, P=10, S=10,500, n_max=105,000,
d=128, M+1=257 for 2b in f32 and f64, M+1=33 for 2) with 77 live pairs of
200-2,000 live slots each; kernel 2 is also timed in its dense (B, N, d)
form at B=640, N=10,500. Kernel 5 sweeps 10 partitions of 100,000 rows,
d=128, in two S=8 layouts: 1-8 bits a dim, 4 on average (G=64), and 12
bits a dim after one of 2 (G=191, up to 3 pieces a dim).
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
    "no_code_staging": [("      if (r_live && col < w)\n",
                         "      if (r_live && col < 0)\n")],
    "no_dead_fill": [("      o[s] = INFINITY;", "      if (s < 0) o[s] = INFINITY;")],
    "no_table_staging": [(
        "  const bool table_in_smem = table_smem(M1, D, true) <= SMEM_LIMIT;",
        "  const bool table_in_smem = false;")],
    "unpadded_pitch": [("constexpr int TABLE_PAD = 1;",
                        "constexpr int TABLE_PAD = 0;")],
}
BITPACK = {
    "extract_codes": [],
    "plan_in_smem": [("  const bool regs = (D + 3) / 4 <= THREADS;",
                      "  const bool regs = false;")],
    "three_piece_plan": [("  if (regs && max_pieces <= 2)\n",
                          "  if (false)\n")],
    "byte_loads": [(
        "  const int vec_in = (reinterpret_cast<uintptr_t>(seg) & 15) == 0;",
        "  const int vec_in = 0;")],
}
VARIANTS = {"ssd.cu": SSD, "adc_lookup.cu": ADC, "bitpack.cu": BITPACK}


def variant_source(text, name, edits):
    """``text`` with each (old, new) edit made at every place it occurs;
    raises where an old text is not in it (the source changed under the
    variant)."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: edit target not found: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(build, out_dir):
    """Every variant of every source, one nvcc each, all at once; returns
    {source: {variant: (library, ptxas register lines)}}."""
    jobs = {}
    for source, variants in VARIANTS.items():
        text = open(os.path.join(build._CSRC, source)).read()
        stem = source.split(".")[0]
        for name, edits in variants.items():
            cu = os.path.join(out_dir, f"{stem}-{name}.cu")
            so = os.path.join(out_dir, f"lib{stem}-{name}.so")
            with open(cu, "w") as f:
                f.write(variant_source(text, name, edits))
            jobs[source, name] = (subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so)
    libs = {source: {} for source in VARIANTS}
    for (source, name), (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{source} {name}: nvcc failed:\n{log}")
        libs[source][name] = (ctypes.CDLL(so), [
            ln.strip() for ln in log.splitlines() if "registers" in ln])
    return libs


def emit(row) -> None:
    print(json.dumps(row), flush=True)


def time_ssd(libs, device_ms, ssd_views):
    import torch

    from repro_torch.kernels import ref, ssd

    g, h, lc, n, p = 64, 32, 256, 128, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = torch.randn((g, lc, h * p + 2 * n), device="cuda", generator=gen)
    da_l = -torch.empty((g, lc, h), device="cuda").exponential_(generator=gen)
    x_l = torch.randn((g, lc, h, p), device="cuda", generator=gen)
    views = ssd_views(conv, da_l, x_l, n)
    want = ref.ssd_intra_ref(*views)
    for name, (lib, regs) in libs.items():
        lib = ssd.bind(lib)
        err = float((ssd.ssd_intra_with(lib, *views) - want).abs().max())
        emit({"kernel": 6, "variant": name, "ptxas": regs,
              "ms": device_ms(lambda: ssd.ssd_intra_with(lib, *views), 20),
              "max_abs_err": err, "max_abs_ref": float(want.abs().max())})


def time_adc(libs, device_ms):
    """Kernels 2b and 2 of each adc_lookup.cu variant."""
    import numpy as np
    import torch

    from repro_torch.core import dataplane
    from repro_torch.kernels import adc_lookup

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
    m1_t = 33                                   # Path B's table height
    codes_t = torch.randint(0, m1_t, (parts, n_max, d), device="cuda",
                            dtype=torch.int32)
    tables = torch.rand((q, parts, m1_t, d), device="cuda")
    dense_codes = torch.randint(0, m1_t, (q * parts, s, d), device="cuda",
                                dtype=torch.int32)
    dense_tables = tables.reshape(1, q * parts, m1_t, d)
    for name, (lib, regs) in libs.items():
        table_fn, direct_fn = adc_lookup.bind(lib)
        row = {"kernel": "2b", "variant": name, "ptxas": regs,
               "live_slots": int(keep.sum())}
        for dtype in (torch.float32, torch.float64):
            b = bnd.to(dtype)
            qt = torch.randn((q, parts, d), device="cuda", dtype=dtype)
            qcell = dataplane.query_cells(qt, b)
            row[f"ms_{str(dtype)[6:]}"] = device_ms(
                lambda: adc_lookup.adc_direct_with(direct_fn, qt, qcell, b,
                                                   codes, sel, keep), 20)
        emit(row)
        emit({"kernel": 2, "variant": name, "live_slots": int(keep.sum()),
              "M+1": m1_t, "ms": device_ms(
                  lambda: adc_lookup.adc_table_with(table_fn, tables, codes_t,
                                                    sel, keep), 20),
              "ms_dense": device_ms(
                  lambda: adc_lookup.adc_table_with(
                      table_fn, dense_tables, dense_codes, None, None), 5),
              "dense_shape": {"B": q * parts, "N": s, "d": d}})


def time_extract(libs, device_ms):
    """Kernel 5 of each bitpack.cu variant: one sweep of 10 partitions, in
    two layouts: 1-8 bits a dim (4 on average, as the index's b = 4d) and
    12 bits a dim after one of 2 bits (3 pieces in half the dims)."""
    import numpy as np
    import torch

    from repro_torch.core import segments
    from repro_torch.kernels import bitpack, ref

    rng = np.random.default_rng(0)
    bits = [4] * 128
    for _ in range(400):                        # 1-8 bits a dim, sum 512
        a, b = rng.integers(0, 128, 2)
        if bits[a] > 1 and bits[b] < 8:
            bits[a] -= 1
            bits[b] += 1
    for name, layout in (("b_4d", segments.build_layout(bits, seg_bits=8)),
                         ("12_bit", segments.build_layout(
                             [2] + [12] * 127, seg_bits=8))):
        parts = [torch.randint(0, 256, (100_000, layout.num_segments),
                               device="cuda", dtype=torch.uint8)
                 for _ in range(10)]
        want = [ref.extract_ref(seg, layout) for seg in parts]
        for variant, (lib, regs) in libs.items():
            fn = bitpack.bind(lib)
            equal = all(torch.equal(bitpack.extract_codes_with(fn, seg,
                                                               layout), w)
                        for seg, w in zip(parts, want))
            emit({"kernel": 5, "variant": variant, "layout": name,
                  "ptxas": regs, "equal": equal,
                  "pieces": sum(len(plan) for plan in layout.plans),
                  "max_pieces": max(len(plan) for plan in layout.plans),
                  "ms_per_sweep": device_ms(lambda: [
                      bitpack.extract_codes_with(fn, seg, layout)
                      for seg in parts], 10)})
        del parts, want


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants.py needs a CUDA card")
    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, device_ms, ssd_views
    from repro_torch.kernels import build

    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = build_variants(build, out_dir)
    time_ssd(libs["ssd.cu"], device_ms, ssd_views)
    time_adc(libs["adc_lookup.cu"], device_ms)
    time_extract(libs["bitpack.cu"], device_ms)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
