"""The port's ProcessTransport, with QP workers on the CPU.

One module-wide fleet (P = 3 QP workers and one allocator worker, spawned)
serves every test but the last, to keep the time low:

* ids, dists and ``SearchStats`` are bitwise equal to the LocalTransport,
  to the port's torch backend and to the reference runtime (float64);
* a repeated batch is all warm on the same worker pids, with no refetch;
* a worker killed while idle is respawned cold and the search stays equal;
* a live index mutated under the runtime restarts the fleet with fresh
  bundles, and the answers stay equal to the torch backend.
"""

import copy
import dataclasses
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serverless import RuntimeConfig as JRuntimeConfig  # noqa: E402
from repro.serverless import ServerlessRuntime as JRuntime  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.live import LiveIndex  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)
from repro_torch.serverless import RuntimeConfig, ServerlessRuntime  # noqa: E402

CFG = dict(num_partitions=3, kmeans_iters=4, lloyd_iters=6)
TOPOLOGY = dict(branching=2, max_level=1)


@pytest.fixture(autouse=True)
def float64_default():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _port_of(ref):
    arrays = {k: np.array(v, copy=True) for k, v in
              index_to_arrays(ref).items()}
    return index_from_arrays(arrays, SquashConfig(**CFG))


@pytest.fixture(scope="module")
def built():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    ds = jsyn.make_vector_dataset("sift1m", scale=0.003, num_queries=8,
                                  seed=7)
    jpreds = jsyn.default_predicates(ds.attr_cardinality)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**CFG), seed=7)
    preds = [Predicate(**dataclasses.asdict(p)) for p in jpreds]
    port = _port_of(ref)
    want = port.search(ds.queries, preds, k=10, backend="torch",
                       device="cpu")
    torch.set_default_dtype(prev)
    return ds, jpreds, preds, ref, port, want


@pytest.fixture(scope="module")
def process_rt(built):
    port = built[4]
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    rt = ServerlessRuntime(port, RuntimeConfig(
        transport="process", qa_workers=1, device="cpu", **TOPOLOGY))
    torch.set_default_dtype(prev)
    yield rt
    rt.close()


def test_process_transport_bitwise_parity(built, process_rt):
    ds, jpreds, preds, ref, port, (ids_t, d_t, s_t) = built
    r_l = ServerlessRuntime(port, RuntimeConfig(
        device="cpu", **TOPOLOGY)).search(ds.queries, preds, k=10)
    r_p = process_rt.search(ds.queries, preds, k=10)
    r_j = JRuntime(ref, JRuntimeConfig(**TOPOLOGY)).search(
        ds.queries, jpreds, k=10)
    for r in (r_l, r_p):
        np.testing.assert_array_equal(r.ids, ids_t)
        np.testing.assert_array_equal(r.dists, d_t)
        assert r.stats == s_t
        np.testing.assert_array_equal(r.ids, r_j.ids)
        assert r.stats.__dict__ == r_j.stats.__dict__
    assert r_p.trace.transport == "process"
    assert r_p.trace.measured_makespan_s > 0
    worker_pids = {n.worker_pid for n in r_p.trace.nodes
                   if n.kind in ("qa", "qp")}
    assert worker_pids and os.getpid() not in worker_pids
    assert r_p.trace.cost["total"] > 0
    assert r_p.trace.invocations("qp") == r_l.trace.invocations("qp")


def test_process_transport_real_warm_reuse(built, process_rt):
    ds, _, preds, _, _, (ids_t, _, _) = built
    r1 = process_rt.search(ds.queries, preds, k=10)
    pids1 = {n.node: n.worker_pid for n in r1.trace.nodes if n.kind == "qp"}
    r2 = process_rt.search(ds.queries, preds, k=10)
    np.testing.assert_array_equal(r2.ids, ids_t)
    t = r2.trace
    assert t.dre.s3_gets == 0
    assert t.dre.dre_hits == t.dre.invocations > 0
    qp = [n for n in t.nodes if n.kind == "qp"]
    assert all(n.warm and n.dre_hit and n.fetch_s == 0.0 for n in qp)
    assert {n.node: n.worker_pid for n in qp} == pids1


def test_worker_killed_while_idle_respawns_cold(built, process_rt):
    ds, _, preds, _, _, (ids_t, _, s_t) = built
    process_rt.search(ds.queries, preds, k=10)
    pid1 = process_rt.transport.worker_pids("qp:1")[0]
    os.kill(pid1, signal.SIGKILL)
    for _ in range(50):                 # let the collector see the death
        if pid1 not in process_rt.transport.worker_pids("qp:1"):
            break
        threading.Event().wait(0.1)
    r = process_rt.search(ds.queries, preds, k=10)
    np.testing.assert_array_equal(r.ids, ids_t)
    assert r.stats == s_t
    qp1 = [n for n in r.trace.nodes if n.node == "qp:1"]
    assert qp1 and all(n.worker_pid != pid1 for n in qp1)
    assert any(not n.dre_hit for n in qp1), "the replacement fetches again"


def test_mutation_restarts_the_fleet_with_fresh_bundles(built):
    ds, _, preds, ref, _, (ids_t, _, _) = built
    port = _port_of(copy.deepcopy(ref))
    live = LiveIndex(port)
    rt = ServerlessRuntime(live, RuntimeConfig(
        transport="process", qa_workers=1, device="cpu", **TOPOLOGY))
    try:
        r0 = rt.search(ds.queries, preds, k=10)
        np.testing.assert_array_equal(r0.ids, ids_t)
        pids0 = set(rt.transport.worker_pids("qp:0"))
        live.insert(ds.vectors[:4] + 1e-3, ds.attributes[:4])
        victims = np.unique(r0.ids[:, 0][r0.ids[:, 0] >= 0])
        live.delete(victims)
        r1 = rt.search(ds.queries, preds, k=10)
        want = port.search(ds.queries, preds, k=10, backend="torch",
                           device="cpu")
        np.testing.assert_array_equal(r1.ids, want[0])
        assert r1.stats == want[2]
        assert np.intersect1d(r1.ids.ravel(), victims).size == 0
        assert not pids0 & set(rt.transport.worker_pids("qp:0"))
    finally:
        rt.close()
