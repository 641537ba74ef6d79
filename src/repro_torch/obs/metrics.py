"""Process-global metrics registry: counters, gauges, latency histograms.

The registry is **disabled by default and zero-cost when off**: every
accessor returns one shared no-op metric, so instrumented hot paths (the
transports, DRE, the single-host search path in ``core.pipeline``) pay a
dict-free method call and nothing else — ids, ``SearchStats`` and all
traces are bitwise-identical with metrics on or off. Enabling
(``REGISTRY.enable()``, or transparently via
``RuntimeConfig(obs_enabled=True)``) turns the same call sites into real
instruments.

Histograms are fixed-bucket: each observation lands in the first bucket
whose upper bound contains it (plus an implicit +inf overflow bucket), and
quantiles come out by Prometheus-style linear interpolation inside the
containing bucket — exact on distributions whose mass fills buckets
uniformly, which the tests pin. ``snapshot()`` serializes everything
(including p50/p95/p99 per histogram) into one JSON-able dict.

Metric name convention: dotted, ``<subsystem>.<object>.<event>`` —
see DESIGN.md §4 for the full table the runtime emits.

**Fleet aggregation**: every metric merges *losslessly* from a
snapshot — counters add, gauges sum, histograms add per-bucket tallies (the
fixed bounds are the reason merge loses nothing; quantiles recompute from
the merged buckets). ``REGISTRY.absorb_snapshot(snap, source=...)`` folds a
remote process's snapshot (a pipe worker's response-info delta, or a socket
host's STATS reply) into a per-source store, and ``fleet_snapshot()``
returns the three-level view::

    {"local": <this process>, "remote": {"host:port/pid:N": snap, ...},
     "merged": <local + every remote, quantiles recomputed>}

so worker-only metrics (``worker.*``, a remote host's counters) appear
in the merged view host/pid-labelled while staying absent from ``local``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_BYTES_BUCKETS",
    "bounds_from_buckets", "snapshot_delta",
]


def _geometric(lo: float, hi: float, steps: Sequence[float]) -> Tuple[float, ...]:
    out, scale = [], lo
    while scale <= hi:
        out.extend(s * scale for s in steps if s * scale <= hi)
        scale *= 10.0
    return tuple(sorted(set(round(v, 12) for v in out)))


# Latency seconds: 10 µs … 60 s in 1/2.5/5 decade steps (FaaS invocations
# span cold-start seconds down to sub-millisecond warm pipe round-trips).
DEFAULT_LATENCY_BUCKETS = _geometric(1e-5, 10.0, (1.0, 2.5, 5.0)) + (30.0, 60.0)

# Payload/frame bytes: 64 B … 64 MiB in powers of 4 (the 6 MB Lambda budget
# sits inside the top decade).
DEFAULT_BYTES_BUCKETS = tuple(float(64 * 4 ** i) for i in range(11))


class _NullMetric:
    """Shared do-nothing metric handed out while the registry is disabled."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def merge(self, snapshot) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0


_NULL = _NullMetric()


def bounds_from_buckets(buckets: Dict[str, int]) -> Tuple[float, ...]:
    """Recover a histogram's finite bounds from a snapshot's bucket keys.

    Bucket keys are ``repr(bound)`` strings (plus ``"+inf"``), and
    ``float(repr(x)) == x`` for every finite float, so the round-trip is
    exact — a merged histogram rebuilt from a snapshot has bitwise-identical
    bounds to the one that produced it.
    """
    return tuple(sorted(float(k) for k in buckets if k != "+inf"))


def snapshot_delta(cur: Dict, prev: Optional[Dict]) -> Dict:
    """Lossless difference of two cumulative registry snapshots.

    ``cur - prev`` per metric: counters subtract, histogram count/sum and
    per-bucket tallies subtract, gauges pass through at their current value
    (a gauge is instantaneous — the "delta" of a last-write-wins value is
    the value). Metrics absent from ``prev`` pass through whole. This is
    what a pipe worker echoes in its response info: each echo carries only
    what happened since the previous one, so the client can absorb every
    response without double counting.
    """
    if not prev:
        return cur
    out: Dict = {"counters": {}, "gauges": dict(cur.get("gauges", {})),
                 "histograms": {}}
    pc = prev.get("counters", {})
    for name, v in cur.get("counters", {}).items():
        d = v - pc.get(name, 0)
        if d:
            out["counters"][name] = d
    ph = prev.get("histograms", {})
    for name, h in cur.get("histograms", {}).items():
        p = ph.get(name)
        if p is None:
            out["histograms"][name] = h
            continue
        dcount = h["count"] - p["count"]
        if dcount <= 0:
            continue
        pb = p.get("buckets", {})
        buckets = {k: c - pb.get(k, 0) for k, c in h["buckets"].items()}
        dh = {"count": dcount, "sum": h["sum"] - p["sum"],
              "buckets": buckets}
        out["histograms"][name] = dh
    return out


class Counter:
    """Monotonically increasing event count."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0  # guarded-by: _lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def merge(self, snapshot_value: int) -> None:
        """Fold a remote counter's snapshot value in (lossless: counts add)."""
        with self._lock:
            self._value += int(snapshot_value)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value.

    ``inc`` is a read-modify-write, so it takes a lock like Counter does —
    the original lock-free version lost updates whenever two transport
    threads bumped the same gauge concurrently.
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0  # guarded-by: _lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def merge(self, snapshot_value: float) -> None:
        """Fold a remote gauge in. Fleet semantics are *additive*: a gauge
        like pool occupancy or inflight count sums across processes into
        the fleet total (last-write-wins only applies within one process)."""
        with self._lock:
            self._value += float(snapshot_value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated quantile extraction.

    ``buckets`` are increasing upper bounds; an implicit +inf bucket
    catches overflow. ``quantile(q)`` interpolates linearly inside the
    bucket containing rank ``q * count`` (lower edge 0 for the first
    bucket, Prometheus-style); observations past the last finite bound
    clamp to it, so quantiles never extrapolate beyond known bounds.
    """

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        if list(buckets) != sorted(buckets) or len(buckets) < 1:
            raise ValueError("histogram buckets must be increasing bounds")
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.bounds) + 1)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._sum = 0.0    # guarded-by: _lock
        self._count = 0    # guarded-by: _lock

    def observe(self, value: float) -> None:
        value = float(value)
        idx = len(self.bounds)
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def merge(self, snapshot: Dict) -> None:
        """Fold a remote histogram snapshot in — lossless by construction.

        ``snapshot`` is one ``snapshot()`` histogram entry (``count``,
        ``sum``, ``buckets``). Fixed bounds make the merge exact: per-bucket
        tallies (including ``+inf`` overflow) and the count/sum moments add,
        and quantiles recomputed from the merged buckets are identical to a
        single histogram that observed both streams. Bounds must match —
        a remote histogram with different bounds cannot merge losslessly,
        so that raises instead of silently re-binning.
        """
        buckets = snapshot["buckets"]
        if bounds_from_buckets(buckets) != self.bounds:
            raise ValueError(
                f"histogram {self.name!r}: snapshot bounds do not match "
                "(lossless merge requires identical buckets)")
        add = [buckets[repr(b)] for b in self.bounds]
        add.append(buckets.get("+inf", 0))
        with self._lock:
            for i, c in enumerate(add):
                self._counts[i] += int(c)
            self._sum += float(snapshot["sum"])
            self._count += int(snapshot["count"])

    def snapshot(self) -> Dict:
        """One registry-snapshot histogram entry — the unit :meth:`merge`
        consumes, so ``a.merge(b.snapshot())`` works on bare histograms."""
        return {"count": self.count, "sum": self.sum,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99), "buckets": self.bucket_counts()}

    def bucket_counts(self) -> Dict[str, int]:
        # Snapshot under the lock: reading _counts while observe() mutates
        # it could pair a bucket tally with a +inf tally from a different
        # instant, so the dump's buckets wouldn't sum to its count.
        with self._lock:
            counts = list(self._counts)
        out = {repr(b): c for b, c in zip(self.bounds, counts)}
        out["+inf"] = counts[-1]
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated q-quantile (q in [0, 1]); None with no observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts[:-1]):
            if cum + c >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * (rank - cum) / c
            cum += c
        return self.bounds[-1]        # mass in the +inf bucket clamps


class MetricsRegistry:
    """Named metric store; disabled instances hand out the null singleton."""

    def __init__(self, enabled: bool = False):
        self._enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}      # guarded-by: _lock
        self._gauges: Dict[str, Gauge] = {}          # guarded-by: _lock
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: _lock
        # Per-source remote aggregates (fleet telemetry): one sub-registry
        # per "host:port/pid:N" label, fed by absorb_snapshot.
        self._remote: Dict[str, "MetricsRegistry"] = {}  # guarded-by: _lock

    # ------------------------------------------------------------- switches

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Drop every metric, local and absorbed-remote (test isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._remote.clear()

    # ------------------------------------------------------------ accessors

    def counter(self, name: str) -> Counter:
        if not self._enabled:
            return _NULL
        c = self._counters.get(name)  # squash: ignore[lock-guarded-access] -- lock-free hot-path read: dict.get is atomic under the GIL; a miss falls through to the locked setdefault
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        if not self._enabled:
            return _NULL
        g = self._gauges.get(name)  # squash: ignore[lock-guarded-access] -- lock-free hot-path read: dict.get is atomic under the GIL; a miss falls through to the locked setdefault
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create; ``buckets`` only applies on first creation."""
        if not self._enabled:
            return _NULL
        h = self._histograms.get(name)  # squash: ignore[lock-guarded-access] -- lock-free hot-path read: dict.get is atomic under the GIL; a miss falls through to the locked setdefault
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, buckets or DEFAULT_LATENCY_BUCKETS))
        return h

    # ------------------------------------------------- fleet aggregation

    def merge_snapshot(self, snap: Dict, *, gauge_set: bool = False) -> None:
        """Fold one registry snapshot into *this* registry's metrics.

        Lossless per metric kind (see the individual ``merge`` docs);
        metrics the snapshot names that don't exist here yet are created —
        histograms with the bounds recovered from the snapshot's bucket
        keys, so the merge target never re-bins. ``gauge_set=True`` makes
        gauges last-write-wins instead of additive — used when absorbing
        repeated reports *from one source*, where each report carries the
        gauge's current value (adding them would inflate the aggregate).
        """
        if not self._enabled:
            return
        for name, v in (snap.get("counters") or {}).items():
            self.counter(name).merge(v)
        for name, v in (snap.get("gauges") or {}).items():
            g = self.gauge(name)
            g.set(v) if gauge_set else g.merge(v)
        for name, h in (snap.get("histograms") or {}).items():
            self.histogram(
                name, buckets=bounds_from_buckets(h["buckets"])).merge(h)

    def absorb_snapshot(self, snap: Dict, *, source: str,
                        replace: bool = False) -> None:
        """Fold a remote process's snapshot into the per-``source`` store.

        ``source`` labels where the numbers came from (``"pid:1234"`` for a
        pipe worker, ``"host:port/pid:N"`` for a socket host). With
        ``replace=False`` the snapshot is a *delta* (a pipe worker's
        response-info echo) and accumulates into the source's aggregate;
        with ``replace=True`` it is *cumulative* (a socket host's STATS
        reply — the host registry already holds the totals) and supersedes
        whatever this source reported before, so repeated pulls never
        double-count. No-op while disabled — absorbing telemetry is part of
        the obs layer's zero-cost-when-off contract.
        """
        if not self._enabled or not snap:
            return
        with self._lock:
            sub = self._remote.get(source)
            if sub is None or replace:
                sub = MetricsRegistry(enabled=True)
                self._remote[source] = sub
        sub.merge_snapshot(snap, gauge_set=True)

    def remote_sources(self) -> Tuple[str, ...]:
        """Labels of every absorbed remote source (sorted)."""
        with self._lock:
            return tuple(sorted(self._remote))

    def fleet_snapshot(self) -> Dict:
        """The merged, host/pid-labelled fleet view.

        ``local`` is this process's ``snapshot()``; ``remote`` maps each
        absorbed source label to its aggregate snapshot; ``merged`` folds
        local + every remote into one fresh registry and snapshots it — so
        merged histogram quantiles are recomputed from the *combined*
        buckets, not averaged from per-source quantiles.
        """
        local = self.snapshot()
        with self._lock:
            remote = dict(self._remote)
        remote_snaps = {src: sub.snapshot()
                        for src, sub in sorted(remote.items())}
        merged = MetricsRegistry(enabled=True)
        merged.merge_snapshot(local)
        for snap in remote_snaps.values():
            merged.merge_snapshot(snap)
        return {"local": local, "remote": remote_snaps,
                "merged": merged.snapshot()}

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> Dict:
        """JSON-able view of every metric, with p50/p95/p99 per histogram."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {
                n: {
                    "count": h.count,
                    "sum": h.sum,
                    "p50": h.quantile(0.50),
                    "p95": h.quantile(0.95),
                    "p99": h.quantile(0.99),
                    "buckets": h.bucket_counts(),
                }
                for n, h in sorted(histograms.items())
            },
        }


# The process-global registry every instrumented module shares. Disabled by
# default: the importing hot paths stay no-ops until a runtime (or a test)
# flips it on.
REGISTRY = MetricsRegistry(enabled=False)
