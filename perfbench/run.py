"""Run one cell of the benchmark once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON result line as the last line of standard
output. Exits non-zero, printing no result, without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The script's own folder would shadow modules of the standard library.
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]


def threads_env(workload: str) -> int:
    """Fix the host's thread pools from the traffic file, before NumPy and
    torch are loaded; returns the cards the cell asks for."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if work is None:
        raise SystemExit(f"perfbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    traffic = json.loads(
        (ROOT / "perfbench" / "traffic" / f"{work['traffic']}.json").read_text())
    n = str(traffic["threads"]["blas"])
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = n
    return work["chips"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = threads_env(args.workload)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    harness.src_path(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", root=ROOT,
                         t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    check = result.pop("check")
    result["check"] = check          # the compared numbers come last
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
