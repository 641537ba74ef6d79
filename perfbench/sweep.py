"""The client sweep that fixes a traffic mix's client count, run once on
the card when the cell is defined.

    python3 perfbench/sweep.py --workload osq.clients-q512-sel8 \
        --seed <n> --seconds 15 [--batches 512,1024] [--out <file>]

Builds the cell's index once, then for C = 1, 2, 4, ... up to the cores
this process may use: ``--repeat`` windows untraced (the median qps and
its quartile spread, p95, peak memory) and one traced (the card's idle
share). It stops before a C whose in-flight
batches would not fit on the card, and names the C to fix: the smallest
past which doubling adds less than a tenth to qps.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The script's own folder would shadow modules of the standard library.
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(ROOT))
from perfbench.run import threads_env  # noqa: E402


def spread(values):
    """Quartile distance over the median."""
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def choose(rows):
    """The smallest C past which doubling adds less than a tenth to qps."""
    for a, b in zip(rows, rows[1:]):
        if b["qps"] < 1.1 * a["qps"]:
            return a["clients"]
    return rows[-1]["clients"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--batches", default=None,
                    help="batch sizes to sweep, comma-separated (default: "
                         "the traffic's)")
    ap.add_argument("--counts", default="1,2,4,8,16,32")
    ap.add_argument("--repeat", type=int, default=4,
                    help="untraced windows at each C (their median and "
                         "quartile spread are kept)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    threads_env(args.workload)
    from perfbench import harness, load

    harness.src_path(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.sweep: needs a CUDA card", file=sys.stderr)
        return 3
    bench = load.benchmark(ROOT)
    work = load.workload(bench, args.workload)
    config = load.config(bench, work["config"], ROOT)
    traffic = load.traffic(work["traffic"])
    torch.set_num_threads(traffic["threads"]["torch_intra_op"])
    from repro_torch.kernels import build as kbuild

    kbuild.build_all(["hamming", "adc_lookup"])
    cell = harness.Cell(config, traffic, args.seed, "cuda")
    cell.build()
    mem = harness.Memory("cuda")
    card = torch.cuda.get_device_properties(0).total_memory
    cores = len(os.sched_getaffinity(0))
    head = {"card": torch.cuda.get_device_name(), "cores": cores,
            "setup_s": time.perf_counter() - T_START}
    print(json.dumps(head), flush=True)
    out = {**head, "by_batch": {}}
    batches = ([int(x) for x in args.batches.split(",")] if args.batches
               else [traffic["batch"]])
    for q in batches:
        traffic["batch"] = q
        _, added = harness.one_batch_memory(cell, mem)
        resident = mem.allocated()
        rows = []
        for c in (int(x) for x in args.counts.split(",")):
            if c > cores:
                break
            if resident + c * added > 0.9 * card:
                print(json.dumps({"stop": c, "why": "in-flight batches "
                                  "would not fit"}), flush=True)
                break
            mem.reset_peak()
            ws = [harness.window(cell, c, args.seconds, False, mem,
                                 time.perf_counter())
                  for _ in range(args.repeat)]
            t = harness.window(cell, c, args.seconds, True, mem,
                               time.perf_counter())
            s = t["summary"]
            qps = [w["qps"] for w in ws]
            w = ws[0]
            row = {"batch": q, "clients": c, "qps": statistics.median(qps),
                   "qps_runs": qps, "qps_spread": spread(qps),
                   "batch_p95_ms": statistics.median(
                       harness.p95(w["latency_ms"]) for w in ws),
                   "peak_gb": w["memory_peak"] / 1e9,
                   "device_idle_pct": 100 * (1 - s["busy_s"] / s["window_s"]),
                   "traced_qps": t["qps"], "errors": w["errors"][:3],
                   "stage_device_s": s["stage_device_s"],
                   "breakdown": s["breakdown"]}
            rows.append(row)
            print(json.dumps(row), flush=True)
        out["by_batch"][q] = {
            "resident_gb": resident / 1e9, "batch_added_gb": added / 1e9,
            "rows": rows, "chosen": choose(rows)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, **out}, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
