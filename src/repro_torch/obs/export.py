"""Trace exporters: JSONL persistence under ``results/`` + in-memory.

One *run record* per completed ``ServerlessRuntime.search``::

    {"run": <run id>, "meta": {transport, queries, k, makespan_s, ...},
     "spans": [Span.to_json(), ...], "run_trace": RunTrace.to_json(),
     "metrics": REGISTRY.fleet_snapshot(),   # when fleet telemetry is live
     "slo": SloTracker.snapshot()}           # rolling monitors at export

``JsonlExporter`` appends one record per line (append-mode per write, so
several runtimes — or several smoke gates — can share one artifact file);
``InMemoryExporter`` keeps records on a list for tests. ``read_jsonl``
loads a file back into record dicts.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

__all__ = ["InMemoryExporter", "JsonlExporter", "run_record", "read_jsonl"]


def run_record(recorder, run_trace=None, meta: Optional[Dict] = None,
               metrics: Optional[Dict] = None,
               slo: Optional[Dict] = None) -> Dict:
    """Assemble one exportable record from a finished run's recorder.

    ``metrics`` is the fleet snapshot (local/remote/merged registries) at
    export time; ``slo`` the rolling-monitor dump. Both are optional so
    pre-telemetry records stay valid and readers treat them as absent.
    """
    rec: Dict = {
        "run": recorder.run_id,
        "meta": dict(meta or {}),
        "spans": recorder.to_json(),
    }
    if run_trace is not None:
        rec["run_trace"] = run_trace.to_json()
    if metrics is not None:
        rec["metrics"] = metrics
    if slo is not None:
        rec["slo"] = slo
    return rec


class InMemoryExporter:
    """Collects run records on a list (the test/inspection exporter)."""

    def __init__(self):
        self.records: List[Dict] = []

    def export(self, record: Dict) -> None:
        self.records.append(record)


class JsonlExporter:
    """Appends one JSON line per run record to ``path``."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def export(self, record: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record, separators=(",", ":"), default=float))
            f.write("\n")


def read_jsonl(path: str) -> List[Dict]:
    """Load every run record from a JSONL trace file (blank lines skipped)."""
    records: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
