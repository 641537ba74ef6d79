"""Live fleet dashboard (``python -m repro_torch.obs.top TRACE.jsonl``).

A text ``top`` for a SQUASH fleet, rendered from the JSONL run-record
stream the runtime exports (``repro_torch.obs.export``). Three panes:

* **fleet metrics** — the latest record's merged registry snapshot
  (client + every pipe worker / socket host the aggregation layer pulled),
  with the remote sources listed so a silent host is visible at a glance;
* **SLO** — rolling p50/p99 latency, retry/error budgets and cache hit
  rate over the last ``--window`` runs, gated by the default policy
  (``repro_torch.obs.slo``);
* **$/query** — the latest run's per-node cost attribution
  (``RunTrace.dollars_attributed``) folded by kind, plus the running
  average dollars per query over the window.

``--follow`` re-reads the file every ``--interval`` seconds and redraws,
so a long benchmark can be watched live; a single shot is the default (CI
logs, piping to a file). Everything here is read-only over persisted
records — it never touches a runtime.

The port of the JAX package's ``repro.obs.top``, copied as is.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List, Optional

from repro_torch.obs.export import read_jsonl
from repro_torch.obs.metrics import Histogram, bounds_from_buckets
from repro_torch.obs.slo import SloPolicy, SloTracker, default_policy

__all__ = ["render_metrics", "render_slo", "render_cost",
           "render_dashboard", "main"]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e-3:
        return f"{v:.4g}"
    return f"{v:.3e}"


def _registry_snapshot(snapshot: Dict) -> Dict:
    """Accept either a plain registry snapshot or a fleet snapshot
    (``{"local", "remote", "merged"}``) — render the merged view."""
    if "merged" in snapshot and "counters" not in snapshot:
        return snapshot.get("merged") or {}
    return snapshot


def render_metrics(snapshot: Dict, limit: int = 16) -> str:
    """Summarize a registry snapshot: counters, then histogram quantiles.

    ``snapshot`` may be a fleet snapshot, in which case the merged view is
    rendered and the remote source labels are listed first.
    """
    lines: List[str] = []
    sources = sorted((snapshot.get("remote") or {})
                     if "merged" in snapshot else ())
    if sources:
        lines.append(f"  sources: local + {', '.join(sources)}")
    reg = _registry_snapshot(snapshot)
    counters = reg.get("counters") or {}
    for name in sorted(counters)[:limit]:
        lines.append(f"  {name:<40s} {counters[name]}")
    if len(counters) > limit:
        lines.append(f"  ... {len(counters) - limit} more counters")
    for name in sorted(reg.get("gauges") or {}):
        lines.append(f"  {name:<40s} {_fmt(reg['gauges'][name])}")
    for name, h in sorted((reg.get("histograms") or {}).items()):
        # Rebuild a Histogram from the snapshot so quantiles use the same
        # interpolation the live registry reports.
        hist = Histogram(name, buckets=bounds_from_buckets(h["buckets"]))
        hist.merge(h)
        mean = h["sum"] / h["count"] if h["count"] else 0.0
        lines.append(
            f"  {name:<40s} n={h['count']} mean={_fmt(mean)} "
            f"p50={_fmt(hist.quantile(0.5) or 0.0)} "
            f"p99={_fmt(hist.quantile(0.99) or 0.0)}")
    return "\n".join(lines) if lines else "  (no metrics)"


def render_slo(tracker: SloTracker,
               policy: Optional[SloPolicy] = None) -> str:
    policy = policy or default_policy()
    report = policy.evaluate(tracker)
    gate = "PASS" if report.ok else "FAIL"
    if not report.conclusive:
        gate += " (partial data)"
    lines = [f"  gate [{policy.name}]: {gate}"]
    for e in report.entries:
        val = "n/a" if e["value"] is None else _fmt(e["value"])
        mark = {True: "ok", False: "VIOLATED", None: "no-data"}[e["ok"]]
        lines.append(f"  {e['name']:<16s} {val:>10s} {e['op']} "
                     f"{_fmt(e['threshold'])}  [{mark}]")
    snap = tracker.snapshot()
    hit = snap["cache_hit_rate"]
    lines.append(f"  window: {snap['samples']}/{snap['window']} runs"
                 + ("" if hit is None else f", cache hit {hit:.1%}"))
    return "\n".join(lines)


def render_cost(record: Dict) -> str:
    """The latest run's $/query attribution, folded by node kind."""
    trace = record.get("run_trace") or {}
    rows = trace.get("dollars_attributed") or []
    cost = trace.get("cost") or {}
    if not rows:
        return "  (no cost attribution in latest record)"
    queries = max(int((record.get("meta") or {}).get("queries", 0))
                  or int(trace.get("stats", {}).get("queries", 0)), 1)
    by_kind: Dict[str, Dict[str, float]] = {}
    for row in rows:
        agg = by_kind.setdefault(row["kind"],
                                 {"n": 0, "invocation": 0.0, "runtime": 0.0,
                                  "s3": 0.0, "efs": 0.0, "total": 0.0})
        agg["n"] += 1
        for comp in ("invocation", "runtime", "s3", "efs", "total"):
            agg[comp] += row[comp]
    lines = [f"  {'kind':<6s} {'n':>4s} {'invoke':>10s} {'runtime':>10s} "
             f"{'s3':>10s} {'efs':>10s} {'total':>10s}"]
    for kind in ("co", "qa", "qp"):
        agg = by_kind.get(kind)
        if agg is None:
            continue
        lines.append(f"  {kind:<6s} {agg['n']:>4d} "
                     + " ".join(f"{_fmt(agg[c]):>10s}" for c in
                                ("invocation", "runtime", "s3", "efs",
                                 "total")))
    total = cost.get("total", math.fsum(r["total"] for r in rows))
    lines.append(f"  run total ${_fmt(total)}  "
                 f"(${_fmt(total / queries)}/query over {queries} queries)")
    return "\n".join(lines)


def render_dashboard(records: List[Dict], *, window: int = 256,
                     policy: Optional[SloPolicy] = None,
                     metrics: Optional[Dict] = None) -> str:
    """One full dashboard frame from a record stream.

    ``metrics`` overrides the metrics pane's snapshot (e.g. a standalone
    ``SMOKE_metrics.json``); by default the latest record that carried a
    fleet snapshot supplies it.
    """
    if not records:
        return "(no run records yet)"
    last = records[-1]
    if metrics is None:
        for rec in reversed(records):
            if rec.get("metrics"):
                metrics = rec["metrics"]
                break
    tracker = SloTracker.from_records(records, window=window)
    avg_cost = math.fsum(
        (r.get("run_trace") or {}).get("cost", {}).get("total", 0.0)
        for r in records) / len(records)
    meta = last.get("meta") or {}
    lines = [
        f"squash top — {len(records)} runs, latest "
        f"run={last.get('run', '?')} transport={meta.get('transport', '?')} "
        f"avg ${_fmt(avg_cost)}/run",
        "fleet metrics:",
        render_metrics(metrics or {}),
        "slo:",
        render_slo(tracker, policy),
        "cost attribution (latest run):",
        render_cost(last),
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.top",
        description="Live text dashboard over an obs run-record JSONL: "
                    "fleet metrics, SLO gate, per-query cost.")
    ap.add_argument("trace", help="JSONL trace file (repro_torch.obs.export)")
    ap.add_argument("--window", type=int, default=256, metavar="N",
                    help="SLO rolling window (runs)")
    ap.add_argument("--follow", action="store_true",
                    help="redraw every --interval seconds until ^C")
    ap.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="refresh period with --follow")
    args = ap.parse_args(argv)
    while True:
        try:
            records = read_jsonl(args.trace)
        except FileNotFoundError:
            records = []
        frame = render_dashboard(records, window=args.window)
        if args.follow:
            print(f"\x1b[2J\x1b[H{frame}", flush=True)
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0
        else:
            print(frame)
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
