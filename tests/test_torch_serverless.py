"""The port's serverless runtime against the JAX package's, on the CPU.

* the Alg. 2 invocation tree, the §3.5 cost model and the payload codec
  (``encode_message`` bytes) equal the reference's;
* ``ServerlessRuntime`` (local transport, QPs on the CPU, float64) returns
  ids and ``SearchStats`` equal to the port's torch backend and to the
  reference runtime, and, with every node's compute time pinned, the same
  modeled ``RunTrace``: nodes, invocations, payload and fetch bytes,
  makespan, DRE counters and dollars;
* payload chunking and pagination, DRE warm reuse, cache on/off parity,
  the service's ``serverless`` route, and serverless search under live
  mutation, held against the torch backend and the reference runtime.

The module uses the reference's ``built`` size: sift1m at scale 0.004
(4,000 rows), 12 queries, P = 5.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as jcost  # noqa: E402
from repro.core import invocation as jinv  # noqa: E402
from repro.core.live import LiveIndex as JLive  # noqa: E402
from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serverless import RuntimeConfig as JRuntimeConfig  # noqa: E402
from repro.serverless import ServerlessRuntime as JRuntime  # noqa: E402
from repro.serverless import payload as jpl  # noqa: E402
from repro_torch.core import cost_model, invocation  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.live import LiveIndex  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)
from repro_torch.serve import ServiceConfig, VectorSearchService  # noqa: E402
from repro_torch.serverless import (PayloadOverflowError, RuntimeConfig,  # noqa: E402
                                    ServerlessRuntime, decode_message,
                                    encode_message)
from repro_torch.serverless import payload as pl  # noqa: E402

CFG = dict(num_partitions=5, kmeans_iters=4, lloyd_iters=6)
PINNED = dict(co_compute_s=0.01, qa_compute_s=0.05, qp_compute_s=0.08)


@pytest.fixture(scope="module")
def built():
    ds = jsyn.make_vector_dataset("sift1m", scale=0.004, num_queries=12,
                                  seed=7)
    jpreds = jsyn.default_predicates(ds.attr_cardinality)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**CFG), seed=7)
    preds = [Predicate(**dataclasses.asdict(p)) for p in jpreds]
    return ds, jpreds, preds, ref, _port_of(ref)


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


def _runtime(index, **kw):
    kw.setdefault("branching", 3)
    kw.setdefault("max_level", 2)
    return ServerlessRuntime(index, RuntimeConfig(device="cpu", **kw))


def _jruntime(index, **kw):
    kw.setdefault("branching", 3)
    kw.setdefault("max_level", 2)
    return JRuntime(index, JRuntimeConfig(**kw))


def _torch_search(index, queries, preds, k=10):
    return index.search(queries, preds, k=k, backend="torch", device="cpu")


# Measured fields of a trace: wall clocks and the serving process.
_MEASURED = ("wall_issue_s", "wall_start_s", "wall_end_s", "wall_compute_s",
             "worker_pid", "worker_host", "retries")


def _modeled(trace):
    out = trace.to_json()
    out.pop("measured_makespan_s")
    for node in out["nodes"]:
        for key in _MEASURED:
            node.pop(key)
    return out


# ------------------------------------------------ pure modules: tree, cost

@pytest.mark.parametrize("f,lmax", [(1, 1), (2, 3), (3, 2), (4, 2), (5, 3)])
def test_invocation_tree_matches_reference(f, lmax):
    assert invocation.tree_size(f, lmax) == jinv.tree_size(f, lmax)
    assert invocation.build_tree(f, lmax) == jinv.build_tree(f, lmax)
    got = invocation.tree_nodes(f, lmax)
    want = jinv.tree_nodes(f, lmax)
    assert {i: dataclasses.astuple(n) for i, n in got.items()} == \
        {i: dataclasses.astuple(n) for i, n in want.items()}
    n = invocation.tree_size(f, lmax)
    for spec in got.values():
        assert spec.id_range(n) == want[spec.node_id].id_range(n)
    sim = invocation.InvocationSim(f, lmax)
    jsim = jinv.InvocationSim(f, lmax)
    assert sim.makespan() == jsim.makespan()
    assert sim.sequential_makespan() == jsim.sequential_makespan()


@pytest.mark.parametrize("fleet", [
    dict(n_qa=84, n_qp=500, t_qa_s=42.0, t_qp_s=150.0, t_co_s=1.0,
         s3_gets=584, efs_read_bytes=10_240_000),
    dict(n_qa=1, n_qp=0, t_qa_s=0.0, t_qp_s=0.0),
    dict(n_qa=13, n_qp=77, t_qa_s=0.7, t_qp_s=3.1, t_co_s=0.2, s3_gets=9,
         efs_read_bytes=123_456)])
def test_cost_model_matches_reference(fleet):
    got = cost_model.squash_query_cost(cost_model.LambdaFleet(**fleet))
    want = jcost.squash_query_cost(jcost.LambdaFleet(**fleet))
    assert got == want
    volumes = [10_000, 1_000_000, 100_000_000]
    assert cost_model.daily_cost_curve(got["total"], 1000, volumes) == \
        jcost.daily_cost_curve(want["total"], 1000, volumes)
    assert cost_model.server_baseline_cost(hours=24.0) == \
        jcost.server_baseline_cost(hours=24.0)
    assert dataclasses.asdict(cost_model.PricingConstants()) == \
        dataclasses.asdict(jcost.PricingConstants())


def _messages():
    rng = np.random.default_rng(0)
    return [
        {"qidx": np.arange(7, dtype=np.int32),
         "queries": rng.normal(size=(7, 16)),
         "rows": np.array([], dtype=np.int32), "k": 10,
         "preds": [{"attr": 0, "op": "B", "lo": 1.0, "hi": 2.0,
                    "values": [], "group": None}]},
        {"pid": np.int64(3), "keep": rng.integers(0, 9, 5).astype(np.int32),
         "dists": np.full((2, 4), np.inf), "f": np.float32(0.5),
         "ids": np.arange(8, dtype=np.int64).reshape(2, 4)[:, ::2]},
        {},
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_encode_message_bytes_match_reference(which):
    msg = _messages()[which]
    buf = encode_message(msg)
    assert buf == jpl.encode_message(msg)
    out = decode_message(buf)
    assert sorted(out) == sorted(msg)
    for key, val in msg.items():
        if isinstance(val, np.ndarray):
            assert out[key].dtype == val.dtype
            np.testing.assert_array_equal(out[key], val)
        else:
            assert out[key] == val


def test_predicates_round_trip_like_the_reference(built):
    _, jpreds, preds, _, _ = built
    wire = pl.predicates_to_json(preds)
    assert wire == jpl.predicates_to_json(jpreds)
    assert pl.predicates_from_json(wire) == preds


# ------------------------------------------------------- runtime parity

@pytest.mark.parametrize("filtered", [True, False])
def test_runtime_matches_torch_backend_and_reference(built, filtered):
    ds, jpreds, preds, ref, port = built
    jp, p = (jpreds, preds) if filtered else ([], [])
    res = _runtime(port).search(ds.queries, p, k=10)
    ids_t, d_t, s_t = _torch_search(port, ds.queries, p)
    np.testing.assert_array_equal(res.ids, ids_t)
    np.testing.assert_allclose(res.dists, d_t, rtol=0, atol=1e-9)
    assert res.stats == s_t
    jres = _jruntime(ref).search(ds.queries, jp, k=10)
    np.testing.assert_array_equal(res.ids, jres.ids)
    np.testing.assert_allclose(res.dists, jres.dists, rtol=0, atol=1e-9)
    assert res.stats.__dict__ == jres.stats.__dict__
    assert res.trace.transport == "local"


@pytest.mark.parametrize("variant", [
    dict(),
    dict(sequential=True),
    dict(branching=2, max_level=3, use_dre=False),
    dict(max_payload_bytes=4096),
    dict(cache_enabled=True),
])
def test_modeled_trace_matches_reference(built, variant):
    """With every node's compute time pinned, the modeled timeline is a
    function of the choreography alone: the port's equals the reference's
    field for field (nodes, bytes, makespan, DRE, dollars)."""
    ds, jpreds, preds, ref, port = built
    rt = _runtime(port, **PINNED, **variant)
    jrt = _jruntime(ref, **PINNED, **variant)
    for _ in range(2):                    # cold fleet, then warm (or cached)
        res = rt.search(ds.queries, preds, k=10)
        jres = jrt.search(ds.queries, jpreds, k=10)
        np.testing.assert_array_equal(res.ids, jres.ids)
        got, want = _modeled(res.trace), _modeled(jres.trace)
        assert got == want
        assert res.trace.invocations() == jres.trace.invocations()
        assert res.trace.payload_bytes == jres.trace.payload_bytes
        assert res.trace.makespan_s == jres.trace.makespan_s
        assert res.trace.cost == jres.trace.cost


def test_payload_chunking_and_error_policy(built):
    ds, _, preds, _, port = built
    ids_t, _, _ = _torch_search(port, ds.queries, preds)
    res = _runtime(port, max_payload_bytes=4096).search(ds.queries, preds)
    np.testing.assert_array_equal(res.ids, ids_t)
    base = _runtime(port).search(ds.queries, preds)
    assert len(res.trace.nodes) > len(base.trace.nodes)
    assert all(n.request_bytes <= 4096 for n in res.trace.nodes)
    with pytest.raises(PayloadOverflowError):
        _runtime(port, max_payload_bytes=4096, overflow="error").search(
            ds.queries, preds)
    with pytest.raises(PayloadOverflowError):
        _runtime(port, max_payload_bytes=256).search(ds.queries[:2], preds)


def test_response_pagination_and_large_k(built):
    ds, _, preds, _, port = built
    rt = _runtime(port, max_payload_bytes=4096)
    res = rt.search(ds.queries, preds, k=200)
    ids_t, _, _ = _torch_search(port, ds.queries, preds, k=200)
    np.testing.assert_array_equal(res.ids, ids_t)
    assert any(n.response_chunks > 1 for n in res.trace.nodes)
    for qn, k in ((1, 10), (3, 50)):
        got = _runtime(port).search(ds.queries[:qn], preds, k=k)
        np.testing.assert_array_equal(
            got.ids, _torch_search(port, ds.queries[:qn], preds, k=k)[0])


def test_dre_warm_reuse_across_batches(built):
    ds, _, preds, _, port = built
    rt = _runtime(port, warm_prob=1.0)
    r1 = rt.search(ds.queries, preds, k=10)
    r2 = rt.search(ds.queries, preds, k=10)
    assert r1.trace.dre.s3_gets > 0
    assert r2.trace.dre.s3_gets == 0
    assert r2.trace.dre.dre_hits == r2.trace.dre.invocations
    np.testing.assert_array_equal(r1.ids, r2.ids)
    off = _runtime(port, use_dre=False)
    off.search(ds.queries, preds, k=10)
    r3 = off.search(ds.queries, preds, k=10)
    assert r3.trace.dre.s3_gets == r3.trace.dre.invocations


def test_qp_slices_are_views_of_the_index_payload(built):
    ds, _, preds, _, port = built
    rt = _runtime(port)
    rt.search(ds.queries, preds, k=10)
    stacked = port.stacked(torch.float64, "cpu")
    assert rt.stacked is stacked
    for pid in range(5):
        sl = rt.processor(pid).stacked_slice
        assert sl.num_partitions == 1 and sl.n_max == stacked.n_max
        assert sl.codes.data_ptr() == stacked.codes[pid].data_ptr()
        assert sl.vectors.untyped_storage().data_ptr() == \
            stacked.vectors.untyped_storage().data_ptr()


def test_cache_on_off_parity(built):
    ds, _, preds, _, port = built
    off = _runtime(port)
    on = _runtime(port, cache_enabled=True)
    for _ in range(2):
        a = off.search(ds.queries, preds, k=10)
        b = on.search(ds.queries, preds, k=10)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    assert b.trace.cache_hits == ds.queries.shape[0]
    assert b.trace.invocations() < a.trace.invocations()
    assert b.trace.cost["total"] < a.trace.cost["total"]
    on.invalidate_cache()
    c = on.search(ds.queries, preds, k=10)
    assert c.trace.cache_hits == 0
    np.testing.assert_array_equal(c.ids, a.ids)


def test_service_serverless_route(built):
    ds, _, preds, _, port = built
    ids_t, _, _ = _torch_search(port, ds.queries, preds)
    svc = VectorSearchService(port, ServiceConfig(
        backend="serverless", device="cpu", cache_enabled=True))
    try:
        ids, _, stats = svc.query(ds.queries, preds)
        np.testing.assert_array_equal(ids, ids_t)
        assert svc.last_trace.cost["total"] > 0
        assert svc.queries_served["serverless"] == ds.queries.shape[0]
        assert svc.runtime().cfg.cache_enabled
        assert svc.runtime().cfg.device == "cpu"
        svc.query(ds.queries, preds)
        assert svc.last_trace.cache_hits == ds.queries.shape[0]
        # Swapping the index keeps the runtime and drains its state.
        rt = svc.runtime()
        other = _port_of(built[3])
        svc.swap_index(LiveIndex(other))
        assert svc.index is other and svc.runtime() is rt
        assert rt.index is other and len(svc.result_cache) == 0
        ids2, _, _ = svc.query(ds.queries, preds)
        np.testing.assert_array_equal(ids2, ids_t)
        assert svc.last_trace.cache_hits == 0
    finally:
        svc.close()
    # The socket route: a fleet of TCP hosts answers like the torch backend.
    svc = VectorSearchService(port, ServiceConfig(
        backend="serverless", device="cpu", transport="socket"))
    try:
        ids, _, stats = svc.query(ds.queries, preds)
        np.testing.assert_array_equal(ids, ids_t)
        assert stats == _torch_search(port, ds.queries, preds)[2]
        assert svc.runtime().cfg.transport == "socket"
        assert svc.last_trace.transport == "socket"
        assert svc.last_trace.worker_hosts
    finally:
        svc.close()


def test_search_under_mutation_matches_torch_and_reference(built):
    """One runtime per package tracks insert → delete → compact through
    its live index's event log; each step equals the port's torch backend
    and the reference runtime (ids, stats and the pinned modeled trace)."""
    ds, jpreds, preds, ref, _ = built
    ref = copy.deepcopy(ref)
    port = _port_of(ref)
    jlive, live = JLive(ref), LiveIndex(port)
    rt = _runtime(live, **PINNED)
    jrt = _jruntime(jlive, **PINNED)

    def check():
        res = rt.search(ds.queries, preds, k=10)
        jres = jrt.search(ds.queries, jpreds, k=10)
        ids_t, _, s_t = _torch_search(port, ds.queries, preds)
        np.testing.assert_array_equal(res.ids, ids_t)
        assert res.stats == s_t
        np.testing.assert_array_equal(res.ids, jres.ids)
        assert _modeled(res.trace) == _modeled(jres.trace)
        return res

    r0 = check()
    vecs = ds.vectors[:6] + 1e-3
    live.insert(vecs, ds.attributes[:6])
    jlive.insert(vecs, ds.attributes[:6])
    victims = np.unique(r0.ids[:, :2].ravel())
    victims = victims[victims >= 0]
    live.delete(victims)
    jlive.delete(victims)
    during = check()
    assert np.intersect1d(during.ids.ravel(), victims).size == 0
    for pid in jlive.dirty_partitions():
        live.compact(pid, requantize=False)
        jlive.compact(pid, requantize=False)
    after = check()
    np.testing.assert_array_equal(after.ids, during.ids)
    np.testing.assert_array_equal(after.dists, during.dists)
    assert after.stats == during.stats
