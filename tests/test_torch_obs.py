"""The port's observability layer (``repro_torch.obs``) against the JAX
package's, through a local runtime with ``obs_enabled=True`` (CPU, float64,
every node's compute time pinned, so the modeled timeline is a function of
the choreography alone):

* ids, ``SearchStats`` and the makespan equal the reference runtime's, and
  equal the port's own run with observability off;
* the exporter's run records are equal: their sections, the span trees
  (names, ids, parents, kinds, and the times of every span on the modeled
  clock; the ``worker.*`` spans are on the wall clock, so only their times
  differ), the meta and the modeled ``RunTrace`` (the measured wall clock
  aside), and the SLO sections but for their measured latencies;
* the metrics registries hold the same histogram and gauge keys (and
  histogram counts) and equal counters, except the reference's
  ``dataplane.jit_compiles.q1``, a count of jax traces that torch has no
  counterpart of.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.obs.metrics import REGISTRY as JREGISTRY  # noqa: E402
from repro.serverless import RuntimeConfig as JRuntimeConfig  # noqa: E402
from repro.serverless import ServerlessRuntime as JRuntime  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.serverless import RuntimeConfig, ServerlessRuntime  # noqa: E402

CFG = dict(num_partitions=5, kmeans_iters=4, lloyd_iters=6)
TOPOLOGY = dict(branching=3, max_level=2)
PINNED = dict(co_compute_s=0.01, qa_compute_s=0.05, qp_compute_s=0.08)
JAX_ONLY_COUNTERS = {"dataplane.jit_compiles.q1"}
_MEASURED = ("wall_issue_s", "wall_start_s", "wall_end_s", "wall_compute_s",
             "worker_pid", "worker_host", "retries")


@pytest.fixture(scope="module")
def built():
    ds = jsyn.make_vector_dataset("sift1m", scale=0.004, num_queries=12,
                                  seed=7)
    jpreds = jsyn.default_predicates(ds.attr_cardinality)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**CFG), seed=7)
    preds = [Predicate(**dataclasses.asdict(p)) for p in jpreds]
    arrays = {k: np.array(v, copy=True) for k, v in
              index_to_arrays(ref).items()}
    return ds, jpreds, preds, ref, index_from_arrays(arrays,
                                                     SquashConfig(**CFG))


@pytest.fixture(scope="module")
def runs(built):
    """Two batches (cold fleet, then warm) through each package's local
    runtime with observability on; the registries are disabled and reset
    afterwards (enabling is one-way in the runtime)."""
    ds, jpreds, preds, ref, port = built
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        off = ServerlessRuntime(port, RuntimeConfig(
            device="cpu", **TOPOLOGY, **PINNED)).search(ds.queries, preds,
                                                         k=10)
        rt = ServerlessRuntime(port, RuntimeConfig(
            device="cpu", obs_enabled=True, **TOPOLOGY, **PINNED))
        jrt = JRuntime(ref, JRuntimeConfig(obs_enabled=True, **TOPOLOGY,
                                           **PINNED))
        res = [rt.search(ds.queries, preds, k=10) for _ in range(2)]
        jres = [jrt.search(ds.queries, jpreds, k=10) for _ in range(2)]
        snaps = REGISTRY.snapshot(), JREGISTRY.snapshot()
    finally:
        torch.set_default_dtype(prev)
        for reg in (REGISTRY, JREGISTRY):
            reg.disable()
            reg.reset()
    return (off, res, jres, rt.obs_exporter.records,
            jrt.obs_exporter.records, snaps)


def _modeled(trace_json):
    out = dict(trace_json)
    out.pop("measured_makespan_s")
    out["nodes"] = [{k: v for k, v in node.items() if k not in _MEASURED}
                    for node in out["nodes"]]
    return out


def test_obs_on_keeps_answers_equal_to_reference(runs):
    off, res, jres, _, _, _ = runs
    for r, jr in zip(res, jres):
        np.testing.assert_array_equal(r.ids, jr.ids)
        np.testing.assert_allclose(r.dists, jr.dists, rtol=0, atol=1e-9)
        assert r.stats.__dict__ == jr.stats.__dict__
        assert r.trace.makespan_s == jr.trace.makespan_s
    np.testing.assert_array_equal(res[0].ids, off.ids)
    np.testing.assert_array_equal(res[0].dists, off.dists)
    assert res[0].stats == off.stats
    assert res[0].trace.makespan_s == off.trace.makespan_s


def _modeled_spans(spans):
    """Spans with the times of wall-clock spans taken out."""
    return [{k: v for k, v in s.items()
             if s["attrs"].get("clock") != "wall" or k not in ("t0", "t1")}
            for s in spans]


def test_exporter_records_equal_reference(runs):
    _, _, _, recs, jrecs, _ = runs
    assert len(recs) == len(jrecs) == 2
    for rec, jrec in zip(recs, jrecs):
        assert sorted(rec) == sorted(jrec)
        assert _modeled_spans(rec["spans"]) == _modeled_spans(jrec["spans"])
        meta = {k: v for k, v in rec["meta"].items()
                if k != "measured_makespan_s"}
        jmeta = {k: v for k, v in jrec["meta"].items()
                 if k != "measured_makespan_s"}
        assert meta == jmeta
        assert _modeled(rec["run_trace"]) == _modeled(jrec["run_trace"])
        # The SLO latencies are measured (wall-clock makespans).
        assert sorted(rec["slo"]) == sorted(jrec["slo"])
        assert {k: v for k, v in rec["slo"].items()
                if not k.startswith("latency_")} == \
            {k: v for k, v in jrec["slo"].items()
             if not k.startswith("latency_")}
        assert sorted(rec["metrics"]) == sorted(jrec["metrics"])


def test_span_names_and_kinds_equal_reference(runs):
    _, _, _, recs, jrecs, _ = runs
    for rec, jrec in zip(recs, jrecs):
        names = sorted(s["name"] for s in rec["spans"])
        kinds = sorted(str(s["attrs"].get("kind")) for s in rec["spans"])
        assert names == sorted(s["name"] for s in jrec["spans"])
        assert kinds == sorted(str(s["attrs"].get("kind"))
                               for s in jrec["spans"])
        assert {"co", "qa", "qp"} <= set(kinds)


def test_metric_keys_and_counters_equal_reference(runs):
    *_, (snap, jsnap) = runs
    assert sorted(snap) == sorted(jsnap)
    assert sorted(snap["histograms"]) == sorted(jsnap["histograms"])
    for name, hist in snap["histograms"].items():
        assert hist["count"] == jsnap["histograms"][name]["count"] > 0
    assert sorted(snap["gauges"]) == sorted(jsnap["gauges"])
    jcounters = {k: v for k, v in jsnap["counters"].items()
                 if k not in JAX_ONLY_COUNTERS}
    assert snap["counters"] == jcounters
    assert snap["counters"]["transport.local.submits"] > 0
