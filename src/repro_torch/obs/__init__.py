"""Observability layer: distributed spans, metrics, trace export.

The port of the JAX package's ``repro.obs`` (pure Python, copied as is).

* ``metrics``  — the process-global :data:`~repro_torch.obs.metrics.REGISTRY` of
  counters / gauges / fixed-bucket latency histograms (p50/p95/p99),
  disabled by default and zero-cost when off. Instrumented call sites live
  in ``serverless.transport`` / ``socket_transport`` (submits, retries,
  respawns, reconnects, heartbeats, frame bytes, invoke latency),
  ``core.dre`` (result-cache hits/misses/evictions, pool leases/warm rate)
  and ``core.pipeline``'s single-host search (``search.alg1.rows_scanned``,
  ``search.alg1.shared_scans``, ``search.upload.bytes``).
* ``spans``    — span contexts that cross the transport boundary inside the
  ``extra`` envelope (never the budgeted payload), worker-side sub-spans
  echoed back in the response ``info``, and the per-run :class:`Recorder`
  that stitches them into one tree; and :func:`profiler_range`, through
  which the single-host search opens its ``squash.*`` profiler ranges
  (the module's docstring sets the two kinds apart).
* ``export``   — JSONL persistence under ``results/`` + an in-memory
  exporter for tests.
* ``timeline`` — ``python -m repro_torch.obs.timeline <trace.jsonl>``: a
  per-node text Gantt of the Alg. 2 tree walk.
* ``slo``      — rolling p50/p99 latency, retry/error-budget and
  cache-hit monitors over the run-record stream, with the
  :class:`~repro_torch.obs.slo.SloPolicy` gate API.
* ``top``      — ``python -m repro_torch.obs.top <trace.jsonl>``: live text
  dashboard of fleet metrics, SLO status and $/query attribution.

Fleet aggregation: ``Counter``/``Gauge``/``Histogram`` merge losslessly
from snapshots; pipe workers echo registry deltas in response ``info`` and
socket hosts answer a STATS frame, so
``REGISTRY.fleet_snapshot()`` is one merged, source-labelled view of the
whole fleet.

The whole layer is opt-in via ``RuntimeConfig(obs_enabled=True,
obs_trace_path=...)``; ids, ``SearchStats`` and all traces are
bitwise-identical with it on or off (pinned by tests). This module imports
only the standard library, so ``core``/``serverless`` can instrument
freely without cycles.
"""

from repro_torch.obs.export import InMemoryExporter, JsonlExporter, read_jsonl, run_record
from repro_torch.obs.metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.slo import SloObjective, SloPolicy, SloTracker, default_policy
from repro_torch.obs.spans import Recorder, Span, SpanContext, new_run_id

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Recorder", "Span", "SpanContext", "new_run_id",
    "InMemoryExporter", "JsonlExporter", "read_jsonl", "run_record",
    "SloObjective", "SloPolicy", "SloTracker", "default_policy",
]
