"""The port's ``obs.timeline`` and ``obs.top`` views against the JAX
package's: the same run records give the same text.

* a hand-built record (``Recorder`` → ``run_record``), and the records a
  local runtime with observability on exports (CPU, float64), render to
  the same Gantt (``render_record`` / ``render_records``, with and without
  ``--metrics``) and the same dashboard (``render_dashboard``) in both
  packages;
* the port's analogues of ``tests/test_obs.py::test_timeline_renders_record``
  and ``tests/test_obs_fleet.py``'s dashboard and spans-less fallback tests;
* ``python -m repro_torch.obs.timeline`` and ``python -m
  repro_torch.obs.top`` print the reference CLIs' text for one JSONL file.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic as jsyn  # noqa: E402
from repro.obs import timeline as jtimeline  # noqa: E402
from repro.obs import top as jtop  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.pipeline import SquashConfig, SquashIndex  # noqa: E402
from repro_torch.obs import JsonlExporter, Recorder, run_record  # noqa: E402
from repro_torch.obs import timeline, top  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.serverless import RuntimeConfig, ServerlessRuntime  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hand_record():
    rec = Recorder(run_id="runB")
    root = rec.record("search", 0.0, 2.0, transport="local")
    sid = rec.new_span_id()
    rec.record("qp:0", 0.2, 1.8, span_id=sid, parent_id=root, kind="qp",
               warm=True, retries=0)
    rec.record("compute", 0.3, 1.5, parent_id=sid, phase=True)
    return run_record(rec, meta={"transport": "local"})


@pytest.fixture(scope="module")
def runtime_records():
    """Two run records of a small local runtime with observability on."""
    ds = jsyn.make_vector_dataset("sift1m", scale=0.003, num_queries=8,
                                  seed=7)
    preds = [Predicate(**dataclasses.asdict(p))
             for p in jsyn.default_predicates(ds.attr_cardinality)]
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        idx = SquashIndex.build(ds.vectors, ds.attributes, SquashConfig(
            num_partitions=3, kmeans_iters=4, lloyd_iters=6), seed=7)
        rt = ServerlessRuntime(idx, RuntimeConfig(
            branching=2, max_level=1, device="cpu", obs_enabled=True))
        for _ in range(2):
            rt.search(ds.queries, preds, k=10)
        return list(rt.obs_exporter.records)
    finally:
        torch.set_default_dtype(prev)
        REGISTRY.disable()
        REGISTRY.reset()


def test_timeline_renders_record():
    record = _hand_record()
    text = timeline.render_record(record)
    assert "runB" in text and "qp:0" in text
    assert timeline.render_records([record])
    assert text == jtimeline.render_record(record)


@pytest.mark.parametrize("width", [56, 20])
def test_timeline_text_equals_reference(runtime_records, width):
    for rec in runtime_records:
        assert timeline.render_record(rec, width=width) == \
            jtimeline.render_record(rec, width=width)
    for metrics in (False, True):
        assert timeline.render_records(runtime_records, width=width,
                                       metrics=metrics) == \
            jtimeline.render_records(runtime_records, width=width,
                                     metrics=metrics)
    run = runtime_records[0]["run"]
    assert timeline.render_records(runtime_records, run=run) == \
        jtimeline.render_records(runtime_records, run=run)


def test_dashboard_text_equals_reference(runtime_records):
    text = top.render_dashboard(runtime_records)
    assert text == jtop.render_dashboard(runtime_records)
    assert "fleet metrics:" in text and "slo:" in text
    assert "cost attribution" in text and "/query" in text
    assert "gate [default]: PASS" in text
    assert top.render_dashboard(runtime_records, window=1) == \
        jtop.render_dashboard(runtime_records, window=1)
    assert top.render_metrics(runtime_records[-1]["metrics"]) == \
        jtop.render_metrics(runtime_records[-1]["metrics"])
    assert "worker" not in top.render_metrics({})
    assert top.render_dashboard([]) == "(no run records yet)"


def test_timeline_spansless_fallback_and_metrics_flag(runtime_records):
    rec = runtime_records[-1]
    bare = dict(rec)
    bare["spans"] = []                        # zero stitched spans
    text = timeline.render_record(bare)
    assert "qp:" in text and "(modeled)" in text
    assert text == jtimeline.render_record(bare)
    assert "fleet metrics:" in timeline.render_records([rec], metrics=True)
    assert "fleet metrics:" not in timeline.render_records([rec])


@pytest.mark.parametrize("view,args", [("timeline", []),
                                       ("timeline", ["--metrics"]),
                                       ("top", [])])
def test_cli_prints_the_reference_text(tmp_path, runtime_records, view,
                                       args):
    path = str(tmp_path / "trace.jsonl")
    exporter = JsonlExporter(path)
    for rec in runtime_records:
        exporter.export(rec)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    outs = []
    for pkg in ("repro_torch", "repro"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.obs.{view}", path, *args],
            capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and outs[0].strip()
