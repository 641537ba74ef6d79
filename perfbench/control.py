"""Readings of the correctness check's control on the card.

    python3 perfbench/control.py --workload osq.clients-q512-sel8 \
        --seeds 11,12,13 [--out <file>]

The control is the reference put in the program's place and computed one
precision below the configuration's: float32 with both of its products in
TF32 (``tf32=True``). Its answers to the batches a run would compare are
judged exactly as the program's are. Beside it, the same search in plain
float32 (no TF32) shows how much of the control's reading is TF32's.
No program code runs here.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# The script's own folder would shadow modules of the standard library.
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(ROOT))


def readings(cell, ref, device: str) -> dict:
    """Judge the float32 and TF32 searches' answers to the run's batches."""
    import torch
    from perfbench import harness

    batches = harness.eval_batches(list(range(cell.traffic["eval_range"])),
                                   cell.traffic, cell.seed)
    f32 = ref.rsearch.DeviceIndex(ref.dev.index, device, torch.float32)
    out = {}
    for name, tf32 in (("f32", False), ("tf32", True)):
        answers = {}
        for b in batches:
            ids, dists, stats = ref.answer(b, dev=f32, tf32=tf32)
            answers[b] = {"ids": ids, "dists": dists, "stats": stats}
        j = ref.judge(answers, batches)
        out[name] = {k: j[k] for k in harness.COMPARED + ("recall",)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench import harness, load

    bench = load.benchmark(ROOT)
    work = load.workload(bench, args.workload)
    config = load.config(bench, work["config"], ROOT)
    traffic = load.traffic(work["traffic"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.Cell(config, traffic, seed, args.device)
        ref = harness.Reference(cell, args.device)
        row = {"seed": seed, **readings(cell, ref, args.device),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
