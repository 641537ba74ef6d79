"""Text Gantt renderer for persisted run traces.

    python -m repro_torch.obs.timeline results/SMOKE_trace.jsonl [--width N] [--run ID]

Each run record (see ``repro_torch.obs.export``) renders as one per-node Gantt of
the Alg. 2 tree walk: a bar per Coordinator / QueryAllocator /
QueryProcessor invocation on the modeled clock, with cold/warm (``C``/``W``)
and retry (``rN!``) markers, the derived issue → wire → compute → respond
phase split, and the worker-reported wall-clock sub-spans (deserialize /
compute / serialize / fetch) indented beneath the node that shipped them
back. Wall-clock sub-spans are durations, not bars — they live on the
worker's clock, which the modeled axis does not share.

Records with no stitched node spans (a trace exported with span recording
off, or a worker echo that failed verification) degrade gracefully: the
rows are synthesized from the ``run_trace`` node traces instead — same
bars, with the invoke/fetch/compute phase split coming from the modeled
timeline rather than recorded phase spans.

``--metrics`` additionally prints each record's merged fleet-metrics
summary (counters + histogram quantiles) beneath its Gantt.

The port of the JAX package's ``repro.obs.timeline``, copied as is.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.obs.export import read_jsonl
from repro_torch.obs.spans import Span

__all__ = ["render_record", "render_records", "main"]

_NODE_KINDS = ("co", "qa", "qp")


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.3f}s"
    return f"{seconds * 1e3:.1f}ms"


def _bar(t0: float, t1: float, tmax: float, width: int) -> str:
    lo = int(round(t0 / tmax * width)) if tmax > 0 else 0
    hi = int(round(t1 / tmax * width)) if tmax > 0 else 0
    lo = min(max(lo, 0), width - 1)
    hi = min(max(hi, lo + 1), width)
    return "·" * lo + "█" * (hi - lo) + "·" * (width - hi)


def _trace_rows(record: Dict, width: int, tmax: float,
                lines: List[str]) -> None:
    """Fallback rows from ``run_trace`` nodes when no node spans exist."""
    nodes = (record.get("run_trace") or {}).get("nodes") or ()
    tmax = max(tmax, max((float(n["t_end"]) for n in nodes), default=0.0))
    for n in sorted(nodes, key=lambda d: (d["t_issue"], d["node"],
                                          d.get("chunk", 0))):
        marker = "W" if n.get("warm") else "C"
        retries = int(n.get("retries", 0))
        if retries:
            marker += f" r{retries}!"
        t0, t1 = float(n["t_issue"]), float(n["t_end"])
        label = f"{n['node']}#{n.get('chunk', 0)}"
        lines.append(f"  {label:<10s} [{marker:<4s}] "
                     f"|{_bar(t0, t1, tmax, width)}| "
                     f"{_fmt_s(t0)}–{_fmt_s(t1)}")
        phases = [("invoke", n.get("invoke_s", 0.0)),
                  ("fetch", n.get("fetch_s", 0.0)),
                  ("setup", n.get("setup_s", 0.0)),
                  ("compute", n.get("compute_s", 0.0))]
        lines.append("      " + " · ".join(
            f"{name} {_fmt_s(float(dur))}"
            for name, dur in phases if dur) + "  (modeled)")


def render_record(record: Dict, width: int = 56) -> str:
    spans = [Span.from_json(d) for d in record.get("spans", ())]
    meta = record.get("meta", {})
    kids: Dict[Optional[str], List[Span]] = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)
    nodes = sorted((s for s in spans if s.attrs.get("kind") in _NODE_KINDS),
                   key=lambda s: (s.t0, s.name, s.attrs.get("chunk", 0)))
    modeled = [s for s in spans if s.attrs.get("clock") != "wall"]
    tmax = max((s.t1 for s in modeled), default=0.0)
    head = " ".join(f"{k}={meta[k]}" for k in
                    ("transport", "queries", "k") if k in meta)
    lines = [f"run {record.get('run', '?')}  {head}  "
             f"modeled={_fmt_s(float(meta.get('makespan_s', tmax)))}"
             + (f"  measured={_fmt_s(float(meta['measured_makespan_s']))}"
                if meta.get("measured_makespan_s") else "")]
    if not nodes:
        _trace_rows(record, width, tmax, lines)
        return "\n".join(lines)
    for node in nodes:
        marker = "W" if node.attrs.get("warm") else "C"
        retries = int(node.attrs.get("retries", 0))
        if retries:
            marker += f" r{retries}!"
        label = f"{node.name}#{node.attrs.get('chunk', 0)}"
        lines.append(f"  {label:<10s} [{marker:<4s}] "
                     f"|{_bar(node.t0, node.t1, tmax, width)}| "
                     f"{_fmt_s(node.t0)}–{_fmt_s(node.t1)}")
        phases = [s for s in kids.get(node.span_id, ())
                  if s.attrs.get("phase")]
        if phases:
            lines.append("      " + " · ".join(
                f"{p.name} {_fmt_s(p.duration)}"
                for p in sorted(phases, key=lambda s: s.t0)))
        workers = [s for s in kids.get(node.span_id, ())
                   if s.attrs.get("clock") == "wall"]
        if workers:
            where = ""
            pid = node.attrs.get("worker_pid")
            host = node.attrs.get("worker_host")
            if pid or host:
                where = f"  (pid {pid}" + (f" @ {host}" if host else "") + ")"
            lines.append("      worker: " + " · ".join(
                f"{w.name.removeprefix('worker.')} {_fmt_s(w.duration)}"
                for w in sorted(workers, key=lambda s: s.t0)) + where)
    return "\n".join(lines)


def render_records(records: List[Dict], width: int = 56,
                   run: Optional[str] = None,
                   metrics: bool = False) -> str:
    picked = [r for r in records if run is None or r.get("run") == run]
    parts = []
    for r in picked:
        text = render_record(r, width=width)
        if metrics and r.get("metrics"):
            from repro_torch.obs.top import render_metrics
            text += "\nfleet metrics:\n" + render_metrics(r["metrics"])
        parts.append(text)
    return "\n\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.timeline",
        description="Render a per-node text Gantt from an obs trace JSONL.")
    ap.add_argument("trace", help="JSONL trace file (repro_torch.obs.export)")
    ap.add_argument("--width", type=int, default=56, metavar="N",
                    help="bar width in characters")
    ap.add_argument("--run", default=None, metavar="ID",
                    help="render only this run id")
    ap.add_argument("--metrics", action="store_true",
                    help="also print each record's merged fleet-metrics "
                         "summary")
    args = ap.parse_args(argv)
    records = read_jsonl(args.trace)
    out = render_records(records, width=args.width, run=args.run,
                         metrics=args.metrics)
    print(out if out else f"(no matching runs in {args.trace})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
