"""Lightweight distributed spans for the serverless runtime.

The port has spans of two kinds, on two clocks:

* This module's :class:`Recorder` keeps the serverless runtime's span tree
  on the runtime's modeled clock (below). A reader gets it from the
  runtime's run records (``RuntimeConfig(obs_enabled=True)``).
* The single-host search (``SquashIndex.search``, ``select``,
  ``_search_torch`` and ``dataplane.batched_stage345``) opens
  ``torch.profiler.record_function`` ranges named ``squash.<layer>``:
  ``squash.search`` ⊃ ``squash.select`` (⊃ ``squash.filter``,
  ``squash.alg1``) and ``squash.plane`` (⊃ ``squash.densify``,
  ``squash.upload``, ``squash.stage3``–``squash.stage5``,
  ``squash.fetch``). They record only while a ``torch.profiler`` profiler
  runs, in its trace, on the clock of the kernels and copies they launch,
  so each device operation and each idle gap of the card can be put down
  to the innermost range open on the launching thread. A reader gets them
  from the profiler's trace (``export_chrome_trace``). They are opened
  through :func:`profiler_range`, which with no profiler running returns a
  context that does nothing: an idle ``record_function`` costs ~10 µs a
  range on the host CPU of an H100 machine, and a search opens eleven.

A *span* is one timed, named interval with a parent — the Alg. 2 tree walk
becomes a span tree: the run-level ``search`` span parents the Coordinator
node span, which parents its QueryAllocator children, which parent their
QueryProcessor fan-outs; each node span carries derived phase children
(issue → wire → compute → respond) on the modeled clock and, for real
transports, the worker-reported wall-clock sub-spans (deserialize /
compute / serialize / fetch) stitched back across the process or TCP
boundary.

The cross-boundary carrier is a :class:`SpanContext` — ``(run id, span
id)`` — injected into the transport ``extra`` envelope
(``payload.inject_span_context``), never into the budgeted payload bytes,
so request-byte accounting is identical with tracing on or off. The worker
echoes the context back with its sub-span offsets; the client-side
:class:`Recorder` verifies the echo and stitches the spans under the node
span it minted at submit time.

Recording is post-hoc and allocation-light: handlers compute their
timelines anyway (``NodeTrace``), so the recorder just appends finished
spans — there is no context-manager timing machinery on the hot path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys
import threading
import uuid
from typing import Dict, List, Optional

__all__ = ["Span", "SpanContext", "Recorder", "new_run_id",
           "profiler_range"]

_NO_RANGE = contextlib.nullcontext()


def profiler_range(name: str):
    """``torch.profiler.record_function(name)`` while a torch profiler
    records, else a shared context that does nothing. The test reads
    ``torch.autograd.profiler._is_profiler_enabled``, one flag for the
    process, so a thread started before the profiler opens its ranges too.

    No profiler can run before torch's profiler module is loaded, so this
    module does not import torch. Where torch has no such flag, the range
    is always opened.
    """
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", True):
        return prof.record_function(name)
    return _NO_RANGE


def new_run_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass
class Span:
    """One finished interval in a run's span tree."""

    name: str
    span_id: str
    parent_id: Optional[str]
    t0: float                 # seconds, relative to the run origin
    t1: float
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def to_json(self) -> Dict:
        return {"name": self.name, "id": self.span_id,
                "parent": self.parent_id, "t0": self.t0, "t1": self.t1,
                "attrs": dict(self.attrs)}

    @staticmethod
    def from_json(d: Dict) -> "Span":
        return Span(name=d["name"], span_id=d["id"], parent_id=d["parent"],
                    t0=float(d["t0"]), t1=float(d["t1"]),
                    attrs=dict(d.get("attrs") or {}))


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The wire-crossing identity of one span: who to stitch back to."""

    run_id: str
    span_id: str

    def to_wire(self) -> Dict[str, str]:
        """JSON/pickle-able envelope form (what ``extra['obs']`` carries)."""
        return {"run": self.run_id, "span": self.span_id}

    @staticmethod
    def from_wire(d: Optional[Dict]) -> Optional["SpanContext"]:
        if not d:
            return None
        return SpanContext(run_id=str(d["run"]), span_id=str(d["span"]))


class Recorder:
    """Span accumulator for one run (one ``ServerlessRuntime.search``)."""

    def __init__(self, run_id: Optional[str] = None):
        self.run_id = run_id or new_run_id()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.spans: List[Span] = []

    def new_span_id(self) -> str:
        """Mint an id before the span's interval is known (submit time)."""
        return f"s{next(self._ids)}"

    def context(self, span_id: str) -> SpanContext:
        return SpanContext(self.run_id, span_id)

    def record(self, name: str, t0: float, t1: float, *,
               span_id: Optional[str] = None,
               parent_id: Optional[str] = None, **attrs) -> str:
        sid = span_id or self.new_span_id()
        span = Span(name=name, span_id=sid, parent_id=parent_id,
                    t0=float(t0), t1=float(t1), attrs=attrs)
        with self._lock:
            self.spans.append(span)
        return sid

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span_id: str) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    def to_json(self) -> List[Dict]:
        return [s.to_json() for s in self.spans]
