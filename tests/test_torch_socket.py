"""The port's socket transport (TCP host fleet) against the JAX package's.

Everything runs on the CPU in float64 (QP links bound to ``device="cpu"``),
at the reference's socket-test size: sift1m at scale 0.003, 8 queries,
P = 3, the Alg. 2 tree F = 2, l_max = 1. One module-wide fleet (two
auto-spawned loopback hosts) serves the tests that need no fleet of their
own:

* ids, dists and ``SearchStats`` equal the port's LocalTransport, its
  ProcessTransport and its torch backend, and the reference runtime's;
  with every compute time pinned, the modeled ``RunTrace`` equals the
  reference's socket runtime's (a cold batch up to the measured fetch
  times its real workers report, a warm batch field for field);
* the ports of the reference's socket tests (``tests/test_transport.py``:
  warm reuse, mid-flight disconnect → reconnect, busy worker not declared
  dead, a host started as ``python -m repro_torch.serverless.host``,
  per-frame budget; ``tests/test_obs_transport.py``: obs parity and span
  stitching, STATS pull, reconnect/retry counters;
  ``tests/test_concurrency_regressions.py``: page reassembly under the
  transport lock, atomic close, counter rebalance on timeout);
* the frame protocol's bytes equal the reference's for the same message,
  and a QP link bound to the card is refused by a host without CUDA.
"""

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serverless import RuntimeConfig as JRuntimeConfig  # noqa: E402
from repro.serverless import ServerlessRuntime as JRuntime  # noqa: E402
from repro.serverless import payload as jpl  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.serverless import (PayloadOverflowError, RuntimeConfig,  # noqa: E402
                                    ServerlessRuntime)
from repro_torch.serverless import payload as pl  # noqa: E402
from repro_torch.serverless import transport as tp  # noqa: E402
from repro_torch.serverless import workers as wk  # noqa: E402
from repro_torch.serverless.socket_transport import SocketTransport, _Link  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_partitions=3, kmeans_iters=4, lloyd_iters=6)
TOPOLOGY = dict(branching=2, max_level=1)
PINNED = dict(co_compute_s=0.01, qa_compute_s=0.05, qp_compute_s=0.08)
WORKER_SPANS = {"worker.fetch", "worker.deserialize", "worker.compute",
                "worker.serialize"}
# Fields of a trace that a real worker measures: wall clocks, the serving
# process, and (through the measured fetch of a cold worker) the modeled
# times that follow from it.
_MEASURED = ("wall_issue_s", "wall_start_s", "wall_end_s", "wall_compute_s",
             "worker_pid", "worker_host", "retries")
_FETCH_TIMED = ("t_issue", "t_start", "t_end", "fetch_s")


@pytest.fixture(autouse=True)
def float64_default():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@pytest.fixture(scope="module")
def built():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    ds = jsyn.make_vector_dataset("sift1m", scale=0.003, num_queries=8,
                                  seed=7)
    jpreds = jsyn.default_predicates(ds.attr_cardinality)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**CFG), seed=7)
    preds = [Predicate(**dataclasses.asdict(p)) for p in jpreds]
    arrays = {k: np.array(v, copy=True) for k, v in
              index_to_arrays(ref).items()}
    port = index_from_arrays(arrays, SquashConfig(**CFG))
    want = port.search(ds.queries, preds, k=10, backend="torch",
                       device="cpu")
    torch.set_default_dtype(prev)
    return ds, jpreds, preds, ref, port, want


def _cfg(**kw):
    kw = {**TOPOLOGY, "transport": "socket", "qa_workers": 1,
          "device": "cpu", **kw}
    return RuntimeConfig(**kw)


def _runtime(index, **kw):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return ServerlessRuntime(index, _cfg(**kw))
    finally:
        torch.set_default_dtype(prev)


@pytest.fixture(scope="module")
def socket_rt(built):
    rt = _runtime(built[4])
    yield rt
    rt.close()


def _modeled(trace, *, cold=False):
    out = trace.to_json()
    out.pop("measured_makespan_s")
    for node in out["nodes"]:
        for key in _MEASURED + (_FETCH_TIMED if cold else ()):
            node.pop(key)
    if cold:
        for key in ("makespan_s", "fleet", "cost", "dollars_attributed"):
            out.pop(key)
        out["dre"].pop("fetch_seconds")
    return out


# ------------------------------------------------------------------ parity

def test_socket_transport_bitwise_parity(built, socket_rt):
    """Socket = local = process = torch backend = the reference runtime."""
    ds, jpreds, preds, ref, port, (ids_t, d_t, s_t) = built
    r_s = socket_rt.search(ds.queries, preds, k=10)
    r_l = ServerlessRuntime(port, RuntimeConfig(
        device="cpu", **TOPOLOGY)).search(ds.queries, preds, k=10)
    proc = ServerlessRuntime(port, RuntimeConfig(
        transport="process", qa_workers=1, device="cpu", **TOPOLOGY))
    try:
        r_p = proc.search(ds.queries, preds, k=10)
    finally:
        proc.close()
    r_j = JRuntime(ref, JRuntimeConfig(**TOPOLOGY)).search(
        ds.queries, jpreds, k=10)
    for r in (r_s, r_l, r_p):
        np.testing.assert_array_equal(r.ids, ids_t)
        np.testing.assert_array_equal(r.dists, d_t)
        assert r.stats == s_t
        np.testing.assert_array_equal(r.ids, r_j.ids)
        assert r.stats.__dict__ == r_j.stats.__dict__
    assert r_s.trace.transport == "socket"
    assert r_s.trace.measured_makespan_s > 0
    served = [n for n in r_s.trace.nodes if n.kind in ("qa", "qp")]
    assert served and all(n.worker_host for n in served), (
        "every socket-served node records its host:port")
    assert r_s.trace.worker_hosts, "RunTrace aggregates the serving hosts"
    assert os.getpid() not in {n.worker_pid for n in served}, (
        "socket workers live in host processes, not the client")
    assert r_s.trace.invocations("qp") == r_l.trace.invocations("qp")


def test_socket_modeled_trace_matches_reference(built):
    """With every compute time pinned, the port's socket runtime models the
    reference's socket runtime's timeline: the cold batch up to the fetch
    times its real workers measure, the warm batch field for field."""
    ds, jpreds, preds, ref, port, _ = built
    rt = _runtime(port, **PINNED)
    jrt = JRuntime(ref, JRuntimeConfig(**TOPOLOGY, transport="socket",
                                       qa_workers=1, **PINNED))
    try:
        for cold in (True, False):
            res = rt.search(ds.queries, preds, k=10)
            jres = jrt.search(ds.queries, jpreds, k=10)
            np.testing.assert_array_equal(res.ids, jres.ids)
            assert _modeled(res.trace, cold=cold) == \
                _modeled(jres.trace, cold=cold)
            assert res.trace.invocations() == jres.trace.invocations()
            assert res.trace.payload_bytes == jres.trace.payload_bytes
        assert res.trace.makespan_s == jres.trace.makespan_s
        assert res.trace.cost == jres.trace.cost
    finally:
        rt.close()
        jrt.close()


def test_socket_real_warm_reuse(built, socket_rt):
    """Second batch over live TCP workers: zero rebuilds, every invocation a
    real warm start on the same hosts (retention lives in the connection)."""
    ds, _, preds, _, _, (ids_t, _, _) = built
    r1 = socket_rt.search(ds.queries, preds, k=10)
    hosts1 = {n.node: n.worker_host for n in r1.trace.nodes
              if n.kind == "qp"}
    r2 = socket_rt.search(ds.queries, preds, k=10)
    np.testing.assert_array_equal(r2.ids, ids_t)
    assert r2.trace.dre.s3_gets == 0
    qp = [n for n in r2.trace.nodes if n.kind == "qp"]
    assert all(n.warm and n.dre_hit and n.fetch_s == 0.0 for n in qp)
    assert {n.node: n.worker_host for n in qp} == hosts1, (
        "partition shards stay pinned to their hosts")
    assert socket_rt.transport.worker_hosts("qp:0") == [hosts1["qp:0"]]


def test_socket_frame_budget_enforced(socket_rt):
    """The per-frame byte budget is enforced at the socket layer itself, and
    an oversized invocation payload is rejected at submit before any byte
    hits the wire."""
    a, b = socket.socketpair()
    try:
        pl.write_frame(a, pl.FRAME_REQ, b"x" * 100, max_bytes=1000)
        kind, body = pl.read_frame(b)
        assert kind == pl.FRAME_REQ and body == b"x" * 100
        with pytest.raises(PayloadOverflowError):
            pl.write_frame(a, pl.FRAME_REQ, b"y" * 2000, max_bytes=1000)
    finally:
        a.close()
        b.close()
    transport = socket_rt.transport
    with pytest.raises(PayloadOverflowError):
        transport.submit(
            "qa", payload=b"z" * (transport.max_payload_bytes + 1),
            extra={"olo": 0, "ohi": 1})


def _frames():
    rng = np.random.default_rng(0)
    req = pl.encode_message({"qidx": np.arange(3, dtype=np.int32),
                             "queries": rng.normal(size=(3, 16)), "k": 10})
    return {
        "req": (pl.FRAME_REQ, lambda m: m.encode_message({
            "rid": 7, "extra": {"olo": 0, "ohi": 1},
            "payload": np.frombuffer(req, dtype=np.uint8)})),
        "resp": (pl.FRAME_RESP, lambda m: m.encode_message({
            "rid": 7, "ok": True, "seq": 0, "nseq": 1,
            "info": {"os_pid": 1, "served_before": 0, "fetch_s": 0.5},
            "data": np.frombuffer(req, dtype=np.uint8)})),
        "stats": (pl.FRAME_STATS, lambda m: m.encode_message({
            "os_pid": 1, "snapshot": {"counters": {"worker.requests": 3}}})),
        "init": (pl.FRAME_INIT, lambda m: m.encode_init(
            {"part_arrays": {"codes": np.arange(12, dtype=np.int32)},
             "pid": 2}, m.MAX_SYNC_PAYLOAD_BYTES)),
        "ping": (pl.FRAME_PING, lambda m: b""),
        "pong": (pl.FRAME_PONG, lambda m: b""),
        "shutdown": (pl.FRAME_SHUTDOWN, lambda m: b""),
    }


@pytest.mark.parametrize("name", sorted(_frames()))
def test_frame_bytes_match_reference(name):
    """Each frame kind's bytes on the wire equal the reference's for the
    same message (an INIT body carrying NumPy arrays, not a WorkerInit,
    whose pickle names the package's own class)."""
    kind, body_of = _frames()[name]
    assert kind == getattr(jpl, f"FRAME_{name.upper()}")
    wires = []
    for mod in (pl, jpl):
        a, b = socket.socketpair()
        try:
            mod.write_frame(a, kind, body_of(mod))
            a.shutdown(socket.SHUT_WR)
            wire = b""
            while chunk := b.recv(1 << 16):
                wire += chunk
        finally:
            a.close()
            b.close()
        wires.append(wire)
    assert wires[0] == wires[1]
    a, b = socket.socketpair()
    try:
        a.sendall(wires[0])
        assert pl.read_frame(b) == jpl.read_frame(
            _Replay(wires[0])) == (kind, body_of(pl))
    finally:
        a.close()
        b.close()
    if name == "init":
        bundle, budget = pl.decode_init(body_of(pl))
        assert budget == pl.MAX_SYNC_PAYLOAD_BYTES == jpl.MAX_SYNC_PAYLOAD_BYTES
        np.testing.assert_array_equal(bundle["part_arrays"]["codes"],
                                      np.arange(12, dtype=np.int32))


class _Replay:
    """A socket stand-in that replays recorded bytes in small pieces."""

    def __init__(self, data):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:min(n, 3)], self.data[min(n, 3):]
        return out


# ------------------------------------------------- connection loss, hosts

def test_socket_mid_flight_disconnect_reconnects(built):
    """Sever a QP link while its invocation is in flight: the transport
    reconnects with backoff, re-sends under the retry budget, and the
    search result stays bitwise-identical with the retry in the trace."""
    ds, _, preds, _, port, (ids_t, _, s_t) = built
    rt = _runtime(port, worker_sleep_s=0.6)
    try:
        rt.search(ds.queries, preds, k=10)              # warm the fleet
        dropper = threading.Timer(
            0.25, lambda: rt.transport.drop_connection("qp:0"))
        dropper.start()
        r = rt.search(ds.queries, preds, k=10)
        dropper.join()
    finally:
        rt.close()
    np.testing.assert_array_equal(r.ids, ids_t)
    assert r.stats == s_t
    assert r.trace.worker_retries >= 1
    qp0 = [n for n in r.trace.nodes if n.node == "qp:0"]
    assert any(not n.warm for n in qp0), (
        "a reconnected link is a fresh container: the re-served request "
        "must report a cold start")


def test_socket_busy_worker_not_declared_dead(built):
    """Compute far longer than the staleness window must not trip the hang
    guard: the host's receiver thread keeps answering PING while the
    compute thread is busy."""
    ds, _, preds, _, port, (ids_t, _, _) = built
    rt = _runtime(port, worker_sleep_s=1.5, heartbeat_s=0.15)
    try:
        r = rt.search(ds.queries, preds, k=10)
    finally:
        rt.close()
    np.testing.assert_array_equal(r.ids, ids_t)
    assert r.trace.worker_retries == 0, (
        "busy-but-alive links must not be torn down and retried")


def _start_host(**env_extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **env_extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serverless.host",
         "--listen", "127.0.0.1:0"],
        stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING "), f"unexpected banner: {line!r}"
    return proc, f"127.0.0.1:{int(line.split()[1])}"


def test_socket_remote_host_serves_qp_shards(built):
    """A separate server process started from the CLI entry point (port
    read from its LISTENING line) serves the whole fleet through
    ``hosts=``: parity holds, every QA/QP invocation reports the server's
    pid and address, and a dropped link reconnects with the answers
    unchanged."""
    ds, _, preds, _, port, (ids_t, _, s_t) = built
    proc, addr = _start_host()
    try:
        rt = _runtime(port, hosts=(addr,))
        try:
            r = rt.search(ds.queries, preds, k=10)
            rt.transport.drop_connection("qp:1")
            r2 = rt.search(ds.queries, preds, k=10)
        finally:
            rt.close()
        for res in (r, r2):
            np.testing.assert_array_equal(res.ids, ids_t)
            assert res.stats == s_t
            served = [n for n in res.trace.nodes if n.kind in ("qa", "qp")]
            assert {n.worker_pid for n in served} == {proc.pid}
            assert {n.worker_host for n in served} == {addr}
            assert res.trace.worker_hosts == [addr]
        qp1 = [n for n in r2.trace.nodes if n.node == "qp:1"]
        assert any(not n.warm for n in qp1), "the reconnected link is cold"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_host_without_cuda_refuses_a_card_bound_link(built):
    """A QP link bound to ``cuda`` is refused by a host without CUDA (its
    connection closes, so the deploy fails): it is never served from the
    CPU."""
    _, _, _, _, port, _ = built
    init = wk.WorkerInit(role="qp", fn="qp:0", pid=0, dtype="float64",
                         device="cuda",
                         bundle=wk.build_qp_bundle(port, 0, torch.float64))
    proc, addr = _start_host(CUDA_VISIBLE_DEVICES="")    # no card there
    try:
        with pytest.raises(tp.TransportError, match="failed to deploy"):
            SocketTransport({"qp:0": (init, 1)}, hosts=(addr,),
                            connect_timeout_s=30.0)
        assert proc.poll() is None, "the host keeps serving other links"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_service_socket_route_with_hosts(built):
    """``ServiceConfig(transport="socket", hosts=...)`` passes the fleet to
    the runtime and answers like the torch backend."""
    from repro_torch.serve import ServiceConfig, VectorSearchService

    ds, _, preds, _, port, (ids_t, _, s_t) = built
    proc, addr = _start_host()
    try:
        svc = VectorSearchService(port, ServiceConfig(
            backend="serverless", device="cpu", transport="socket",
            hosts=(addr,)))
        try:
            ids, _, stats = svc.query(ds.queries, preds)
            assert svc.runtime().cfg.hosts == (addr,)
            assert svc.last_trace.worker_hosts == [addr]
        finally:
            svc.close()
        np.testing.assert_array_equal(ids, ids_t)
        assert stats == s_t
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# --------------------------------------------------------- observability

def _assert_stitched(record):
    spans = record["spans"]
    ids = {s["id"] for s in spans}
    assert all(s["parent"] in ids for s in spans
               if s["parent"] is not None), "dangling span parents"
    kinds = {s["attrs"].get("kind") for s in spans} - {None}
    assert kinds == {"co", "qa", "qp"}
    wnames = {s["name"] for s in spans if s["name"].startswith("worker.")}
    assert WORKER_SPANS <= wnames
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] in WORKER_SPANS:
            parent = by_id[s["parent"]]
            assert parent["attrs"].get("kind") in {"qa", "qp"}
            assert s["attrs"].get("clock") == "wall"


def test_socket_obs_parity_stitching_and_fleet_aggregation(built):
    """Observability on: ids and stats unchanged, worker sub-spans stitched
    under their node spans, and the hosts' STATS replies merged into the
    fleet view (``worker.requests`` = invocations served, labelled
    ``host:port/pid:N``, never in the client-local registry)."""
    ds, _, preds, _, port, (ids_t, _, s_t) = built
    rt = _runtime(port, obs_enabled=True, invoke_timeout_s=120.0)
    try:
        r1 = rt.search(ds.queries, preds, k=10)
        r2 = rt.search(ds.queries, preds, k=10)
        for r in (r1, r2):
            np.testing.assert_array_equal(r.ids, ids_t)
            assert r.stats == s_t
        _assert_stitched(rt.obs_exporter.records[0])      # the cold run
        snap = REGISTRY.snapshot()
        assert snap["counters"].get("transport.socket.submits", 0) >= 1
        hist = snap["histograms"].get("transport.socket.invoke_s")
        assert hist is not None and hist["count"] >= 1
        assert hist["p50"] is not None and hist["p99"] >= hist["p50"]
        assert snap["histograms"]["transport.socket.frame_bytes"][
            "count"] >= 1
        fleet = REGISTRY.fleet_snapshot()
        sources = sorted(fleet["remote"])
        assert sources and all(":" in s.split("/pid:")[0] for s in sources)
        assert {s.split("/pid:")[0] for s in sources} == \
            set(r2.trace.worker_hosts)
        served = sum(1 for n in (*r1.trace.nodes, *r2.trace.nodes)
                     if n.kind != "co")
        assert fleet["merged"]["counters"].get("worker.requests") == served
        assert sum(snap_["counters"].get("worker.requests", 0)
                   for snap_ in fleet["remote"].values()) == served
        assert "worker.requests" not in fleet["local"]["counters"]
        handle = fleet["merged"]["histograms"]["worker.handle_s"]
        assert handle["count"] == served and handle["p50"] is not None
        rec = rt.obs_exporter.records[-1]
        assert rec["metrics"]["merged"]["counters"][
            "worker.requests"] == served
        assert rec["slo"]["runs"] == 2
        assert not any("host.cuda_memory" in name
                       for snap_ in fleet["remote"].values()
                       for name in snap_.get("gauges", {})), (
            "a host that never touched CUDA reports no card memory")
    finally:
        rt.close()
        REGISTRY.disable()
        REGISTRY.reset()


def test_socket_drop_increments_reconnect_metrics(built):
    ds, _, preds, _, port, (ids_t, _, _) = built
    rt = _runtime(port, obs_enabled=True, worker_sleep_s=0.6,
                  invoke_timeout_s=120.0)
    try:
        rt.search(ds.queries, preds, k=10)            # warm the fleet
        dropper = threading.Timer(
            0.25, lambda: rt.transport.drop_connection("qp:0"))
        dropper.start()
        r = rt.search(ds.queries, preds, k=10)
        dropper.join()
        np.testing.assert_array_equal(r.ids, ids_t)
        assert r.trace.worker_retries >= 1
        snap = REGISTRY.snapshot()["counters"]
        assert snap.get("transport.socket.reconnects", 0) >= 1
        assert snap.get("transport.socket.retries", 0) >= 1
    finally:
        rt.close()
        REGISTRY.disable()
        REGISTRY.reset()


# ------------------------------------------------ concurrency regressions

def _qa_transport(port, **kw):
    init = wk.WorkerInit(role="qa", fn="qa", pid=None, dtype="float64",
                         device="cpu", bundle=wk.build_qa_bundle(port))
    return SocketTransport({"qa": (init, 1)}, auto_hosts=1, **kw)


def _qa_request(ds, preds):
    """A minimal valid allocator request (one query, own slice [0, 1))."""
    return {"qidx": np.asarray([0], dtype=np.int32),
            "queries": ds.queries[:1],
            "preds": pl.predicates_to_json(preds), "k": 5}


def test_socket_timeout_rebalances_link_counters(built):
    """A timed-out invocation hands back its link's assignment and parks
    its rid, so the late response neither re-books ``done`` nor strands
    the link; the link stays usable and warm."""
    ds, _, preds, _, port, _ = built
    t = _qa_transport(port)
    req, extra = _qa_request(ds, preds), {"olo": 0, "ohi": 1}
    try:
        t.invoke("qa", request=req, extra=extra)        # warm the link
        link = t._links["qa"][0]
        t.invoke_timeout_s = 0.4
        inv = t.submit("qa", request=req, extra={**extra, "sleep_s": 1.2})
        with pytest.raises(tp.TransportError, match="timed out"):
            inv.result()
        assert link.inflight == 0, "timeout must hand back the assignment"
        assert t._timed_out, "in-flight rid parked for the late response"
        deadline = time.perf_counter() + 10.0
        while t._timed_out and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert not t._timed_out, "late response must clear the parked rid"
        assert link.inflight == 0, "late response must not re-book done"
        t.invoke_timeout_s = 180.0
        resp, info = t.invoke("qa", request=req, extra=extra)
        assert wk.unpack_plan_response(resp)["plans"]
        assert info.warm and link.inflight == 0 and info.host == link.host
    finally:
        t.close()
    assert all(not h.proc.is_alive() for h in t._owned_hosts)


def test_owned_host_respawns_at_its_port(built):
    """An auto-spawned host that dies is respawned at the same port by the
    link's reconnect, and the answer comes back from a cold container."""
    ds, _, preds, _, port, _ = built
    t = _qa_transport(port)
    req, extra = _qa_request(ds, preds), {"olo": 0, "ohi": 1}
    try:
        t.invoke("qa", request=req, extra=extra)
        host = t._owned_hosts[0]
        old_pid, address = host.proc.pid, host.address
        os.kill(old_pid, signal.SIGKILL)
        host.proc.join(timeout=10)
        resp, info = t.invoke("qa", request=req, extra=extra)
        assert wk.unpack_plan_response(resp)["plans"]
        assert host.address == address and host.proc.pid != old_pid
        assert info.os_pid == host.proc.pid and not info.warm
    finally:
        t.close()


def _stub_socket_transport():
    t = object.__new__(SocketTransport)
    t._lock = threading.Lock()
    t._pending = {}
    t._timed_out = {}
    t._closed = False
    return t


def _stub_link():
    link = object.__new__(_Link)
    link.fn = "qp:0"
    link.address = ("127.0.0.1", 1)
    link.assigned = 0
    link.done = 0
    link.dead = False
    link.generation = 0
    link.pages = {}
    return link


def _resp_body(rid, seq, nseq, data=b"x"):
    return pl.encode_message({
        "rid": rid, "ok": True, "seq": seq, "nseq": nseq,
        "info": {"os_pid": 0},
        "data": np.frombuffer(data, dtype=np.uint8),
    })


def test_on_response_reassembles_under_transport_lock():
    """Page reassembly holds the transport lock, so the failure path's
    ``pages.clear()`` can never interleave with it."""
    t = _stub_socket_transport()
    link = _stub_link()
    done = []
    with t._lock:
        th = threading.Thread(target=lambda: done.append(
            t._on_response(link, _resp_body(7, 0, 2))))
        th.start()
        th.join(timeout=0.2)
        assert not done, "_on_response touched link.pages without _lock"
    th.join(timeout=2.0)
    assert done
    assert 7 in link.pages                    # first page parked, incomplete


def test_on_response_survives_concurrent_page_clear():
    t = _stub_socket_transport()
    link = _stub_link()
    errors = []
    stop = threading.Event()

    def clear_loop():
        while not stop.is_set():
            with t._lock:
                link.pages.clear()

    clearer = threading.Thread(target=clear_loop)
    clearer.start()
    try:
        for rid in range(300):
            try:
                t._on_response(link, _resp_body(rid, 0, 2))
                t._on_response(link, _resp_body(rid, 1, 2))
            except Exception as exc:          # noqa: BLE001
                errors.append(exc)
                break
    finally:
        stop.set()
        clearer.join(timeout=10)
    assert not clearer.is_alive()
    assert not errors, f"page reassembly raced the clear: {errors[0]!r}"


class _StubSock:
    def __init__(self):
        self.frames = []
        self.closed = False

    def sendall(self, data):
        self.frames.append(bytes(data))

    def close(self):
        self.closed = True


def test_socket_close_is_atomic_under_racing_closers():
    t = _stub_socket_transport()
    links = []
    for _ in range(3):
        link = _stub_link()
        link.send_lock = threading.Lock()
        link.sock = _StubSock()
        links.append(link)
    t._links = {"qp:0": links}
    t._owned_hosts = []
    t._monitor = None
    barrier = threading.Barrier(4)

    def closer():
        barrier.wait()
        t.close()

    ts = [threading.Thread(target=closer) for _ in range(4)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in ts)
    assert t._closed
    for link in links:
        assert link.sock.closed
        shutdowns = [f for f in link.sock.frames
                     if f[:1] == pl.FRAME_SHUTDOWN]
        assert len(shutdowns) == 1, "racing close() double-sent SHUTDOWN"
