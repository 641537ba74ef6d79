"""Reading the traced window from ``torch.profiler``'s exported trace.

The harness opens ``record_function`` ranges from its own files: one
``bench.window`` on the main thread around the measured window, and per
client thread ``bench.select``, ``bench.prep``, ``bench.stage3``,
``bench.stage4``, ``bench.stage5`` and ``bench.fetch`` one after another
for each batch. A device operation (kernel, copy, fill) belongs to the
range that was open on the thread that launched it, found through the
profiler's launch correlation. Busy time is the union of device operations
inside the window; each stretch of an idle gap is labelled by the ranges
open on the client threads during it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = ("bench.stage3", "bench.stage4", "bench.stage5")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label_gaps(gaps, spans, span_at) -> Dict[str, float]:
    """Seconds of idle device time by the set of ranges open meanwhile."""
    cuts = sorted({t for lst in spans.values() for s in lst for t in s[:2]})
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(cuts, a)
        edges = [a] + [t for t in cuts[i:bisect.bisect_left(cuts, b)]] + [b]
        for lo, hi in zip(edges, edges[1:]):
            mid = (lo + hi) / 2
            names = sorted({n for n in (span_at(t, mid) for t in spans) if n})
            out["+".join(names) or "no span"] += (hi - lo) * 1e-6
    return out


def summarize(path: str) -> dict:
    """Window, busy time, device time per stage and the breakdown (seconds)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    launches: Dict[int, Tuple[int, float]] = {}
    device = []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith("bench."):
            if name == "bench.window":
                window = (ts, ts + dur)
            else:
                spans[ev["tid"]].append((ts, ts + dur, name))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["tid"], ts)
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name,
                           ev.get("args", {}).get("correlation")))
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    starts = {}
    for tid, lst in spans.items():
        lst.sort()
        starts[tid] = [s[0] for s in lst]

    def span_at(tid, ts):
        lst = spans.get(tid)
        if not lst:
            return None
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and lst[i][0] <= ts <= lst[i][1]:
            return lst[i][2]
        return None

    stage_s = {s: 0.0 for s in STAGES}
    matched = 0
    by_name: Dict[str, float] = defaultdict(float)
    inside = []
    w0, w1 = window
    for a, b, name, corr in device:
        launch = launches.get(corr)
        span = span_at(*launch) if launch else None
        matched += span is not None
        if span in stage_s:
            stage_s[span] += (b - a) * 1e-6
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            inside.append((lo, hi))
            by_name[name] += (hi - lo) * 1e-6
    busy = _union(inside)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    by_gap = _label_gaps(gaps, spans, span_at)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "stage_device_s": {s.split(".")[1]: v for s, v in stage_s.items()},
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(by_gap)},
        "device_ops": len(device), "device_ops_in_spans": matched,
    }
