"""Rolling SLO monitors + policy gates over the live run-record stream.

The ROADMAP's million-QPS item needs "p50/p99 SLO gates ... from production
NodeTrace streams"; this module is the gate machinery. A
:class:`SloTracker` consumes finished runs — ``RunTrace`` objects straight
from the runtime (``ServerlessRuntime`` feeds its tracker on every
obs-enabled ``search``), or persisted JSONL run records
(:meth:`SloTracker.from_records`) — and maintains rolling windows:

* **latency** — exact p50/p99 over the last N runs' makespans (measured
  wall-clock when a real transport ran, modeled otherwise). Exact, not
  interpolated-bucket: the window is bounded, so sorting it is cheap and
  the tail quantile is the true order statistic.
* **retry / error budget** — worker re-invocations per invocation issued,
  and failed runs per run, over the same window.
* **cache hit rate** — §5.6 result-cache hits over lookups; runs with no
  cache activity don't dilute the ratio.

A :class:`SloPolicy` is a list of :class:`SloObjective` thresholds over
those monitors; ``policy.evaluate(tracker)`` returns an :class:`SloReport`
whose ``ok`` is the gate — the runtime exposes it for admission control and
``benchmarks/run.py --smoke`` asserts it in CI. Objectives with no data yet
report *insufficient* rather than failing: an empty window means "nothing
measured", not "SLO violated".

Everything here is plain Python over finished traces — nothing touches the
search hot path, so the obs-off bitwise-parity contract is untouched.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "RollingQuantile", "RollingRatio",
    "SloObjective", "SloPolicy", "SloReport", "SloTracker",
    "default_policy",
]


class RollingQuantile:
    """Exact quantiles over the last ``window`` observations.

    A bounded deque of samples; ``quantile(q)`` sorts the window and
    interpolates linearly between the two straddling order statistics
    (numpy's default), so a single-sample window answers every q with that
    sample and a full window gives the true windowed order statistic.
    """

    def __init__(self, window: int = 256):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.samples: Deque[float] = deque(maxlen=window)

    @property
    def window(self) -> int:
        return self.samples.maxlen

    @property
    def count(self) -> int:
        return len(self.samples)

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    def quantile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if not self.samples:
            return None
        s = sorted(self.samples)
        if len(s) == 1:
            return s[0]
        pos = q * (len(s) - 1)
        lo = math.floor(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] + (s[hi] - s[lo]) * frac

    @property
    def mean(self) -> Optional[float]:
        if not self.samples:
            return None
        return sum(self.samples) / len(self.samples)


class RollingRatio:
    """A windowed numerator/denominator ratio (retries per invocation,
    cache hits per lookup, errors per run). Each ``observe`` is one run's
    contribution; evicting a run from the window removes both sides."""

    def __init__(self, window: int = 256):
        if window < 1:
            raise ValueError("window must be >= 1")
        self._events: Deque[Tuple[float, float]] = deque(maxlen=window)

    @property
    def count(self) -> int:
        return len(self._events)

    def observe(self, num: float, den: float = 1.0) -> None:
        self._events.append((float(num), float(den)))

    @property
    def ratio(self) -> Optional[float]:
        den = sum(d for _, d in self._events)
        if den <= 0:
            return None
        return sum(n for n, _ in self._events) / den


# Monitor keys an objective can target.
_METRICS = ("latency_p50", "latency_p99", "latency_mean",
            "retry_rate", "error_rate", "cache_hit_rate")


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One thresholded objective: ``metric op threshold``.

    ``op`` is ``"<="`` (budgets: latency, retries, errors) or ``">="``
    (floors: cache hit rate).
    """

    name: str
    metric: str
    threshold: float
    op: str = "<="

    def __post_init__(self):
        if self.metric not in _METRICS:
            raise ValueError(f"unknown SLO metric {self.metric!r}; "
                             f"expected one of {_METRICS}")
        if self.op not in ("<=", ">="):
            raise ValueError(f"unknown SLO op {self.op!r}")

    def check(self, value: float) -> bool:
        return value <= self.threshold if self.op == "<=" \
            else value >= self.threshold


@dataclasses.dataclass
class SloReport:
    """One policy evaluation: per-objective verdicts + the overall gate."""

    entries: List[Dict]

    @property
    def ok(self) -> bool:
        """The gate: no objective *with data* is violated. Insufficient
        data is not a violation (but see ``conclusive``)."""
        return all(e["ok"] is not False for e in self.entries)

    @property
    def conclusive(self) -> bool:
        """Every objective had data to evaluate."""
        return all(e["ok"] is not None for e in self.entries)

    @property
    def failures(self) -> List[Dict]:
        return [e for e in self.entries if e["ok"] is False]

    def to_json(self) -> Dict:
        return {"ok": self.ok, "conclusive": self.conclusive,
                "entries": list(self.entries)}

    def summary(self) -> str:
        parts = []
        for e in self.entries:
            val = ("n/a" if e["value"] is None
                   else f"{e['value']:.6g}")
            mark = {True: "ok", False: "VIOLATED", None: "no-data"}[e["ok"]]
            parts.append(f"{e['name']}: {val} {e['op']} "
                         f"{e['threshold']:.6g} [{mark}]")
        return "; ".join(parts)


@dataclasses.dataclass
class SloPolicy:
    """A named bundle of objectives the runtime / CI can gate on."""

    objectives: List[SloObjective]
    name: str = "slo"

    def evaluate(self, tracker: "SloTracker") -> SloReport:
        entries = []
        for obj in self.objectives:
            value = tracker.value(obj.metric)
            entries.append({
                "name": obj.name, "metric": obj.metric,
                "threshold": obj.threshold, "op": obj.op,
                "value": value,
                "ok": None if value is None else obj.check(value),
            })
        return SloReport(entries)


def default_policy(p50_s: float = 30.0, p99_s: float = 120.0,
                   retry_rate: float = 0.1,
                   error_rate: float = 0.01) -> SloPolicy:
    """A permissive latency/retry/error policy: the CI smoke gate's
    defaults (wide enough for cold worker starts on a loaded runner —
    the gate pins the *machinery*, deployments tighten the numbers)."""
    return SloPolicy(name="default", objectives=[
        SloObjective("latency.p50", "latency_p50", p50_s),
        SloObjective("latency.p99", "latency_p99", p99_s),
        SloObjective("retry.budget", "retry_rate", retry_rate),
        SloObjective("error.budget", "error_rate", error_rate),
    ])


class SloTracker:
    """Rolling monitors over a stream of finished runs."""

    def __init__(self, window: int = 256):
        self.window = window
        self.latency = RollingQuantile(window)
        self.retries = RollingRatio(window)
        self.errors = RollingRatio(window)
        self.cache = RollingRatio(window)
        self.runs = 0

    # -------------------------------------------------------------- feeding

    def observe_run(self, trace) -> None:
        """Fold one finished ``RunTrace`` in (the runtime's per-search feed).

        Latency prefers the measured wall-clock (real transports); a purely
        modeled run contributes its virtual makespan — one tracker should
        watch one transport, which is how the runtime wires it.
        """
        measured = float(getattr(trace, "measured_makespan_s", 0.0) or 0.0)
        makespan = float(getattr(trace, "makespan_s", 0.0) or 0.0)
        self._observe(
            latency_s=measured if measured > 0 else makespan,
            retries=int(getattr(trace, "worker_retries", 0)),
            invocations=len(getattr(trace, "nodes", ()) or ()),
            cache_hits=int(getattr(trace, "cache_hits", 0)),
            cache_misses=int(getattr(trace, "cache_misses", 0)))

    def observe_record(self, record: Dict) -> None:
        """Fold one persisted JSONL run record in (offline/streamed form)."""
        meta = record.get("meta") or {}
        rt = record.get("run_trace") or {}
        measured = float(meta.get("measured_makespan_s")
                         or rt.get("measured_makespan_s") or 0.0)
        makespan = float(meta.get("makespan_s") or rt.get("makespan_s")
                         or 0.0)
        self._observe(
            latency_s=measured if measured > 0 else makespan,
            retries=int(rt.get("worker_retries", 0)),
            invocations=len(rt.get("nodes", ()) or ()),
            cache_hits=int(rt.get("cache_hits", 0)),
            cache_misses=int(rt.get("cache_misses", 0)))

    def observe_error(self) -> None:
        """One failed run (the error-budget numerator)."""
        self.runs += 1
        self.errors.observe(1.0)

    def _observe(self, *, latency_s: float, retries: int, invocations: int,
                 cache_hits: int, cache_misses: int) -> None:
        self.runs += 1
        self.latency.observe(latency_s)
        self.errors.observe(0.0)
        self.retries.observe(retries, max(invocations, 1))
        lookups = cache_hits + cache_misses
        if lookups > 0:
            self.cache.observe(cache_hits, lookups)

    @classmethod
    def from_records(cls, records: Iterable[Dict],
                     window: int = 256) -> "SloTracker":
        tracker = cls(window=window)
        for rec in records:
            tracker.observe_record(rec)
        return tracker

    # ------------------------------------------------------------- reading

    def value(self, metric: str) -> Optional[float]:
        if metric == "latency_p50":
            return self.latency.quantile(0.50)
        if metric == "latency_p99":
            return self.latency.quantile(0.99)
        if metric == "latency_mean":
            return self.latency.mean
        if metric == "retry_rate":
            return self.retries.ratio
        if metric == "error_rate":
            return self.errors.ratio
        if metric == "cache_hit_rate":
            return self.cache.ratio
        raise ValueError(f"unknown SLO metric {metric!r}; "
                         f"expected one of {_METRICS}")

    def snapshot(self) -> Dict:
        """JSON-able dump of every monitor (exported next to metrics)."""
        return {
            "window": self.window,
            "runs": self.runs,
            "samples": self.latency.count,
            "latency_p50_s": self.latency.quantile(0.50),
            "latency_p99_s": self.latency.quantile(0.99),
            "latency_mean_s": self.latency.mean,
            "retry_rate": self.retries.ratio,
            "error_rate": self.errors.ratio,
            "cache_hit_rate": self.cache.ratio,
        }
