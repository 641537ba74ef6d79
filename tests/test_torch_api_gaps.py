"""Three entry points of the JAX package the port now takes as the
reference does, on the CPU.

* ``SquashIndex.search(queries, predicates, k, collect_stats, backend,
  device)`` and ``LiveIndex.search``: ``collect_stats`` in the reference's
  fourth place, accepted and unused (the stats are always counted), called
  as ``tests/test_pipeline.py`` and ``tests/test_system.py`` call the
  reference; ids, dists and ``SearchStats`` equal the reference's and the
  call without it.
* ``VectorSearchService.warmup(num_queries, k=None)``: one zero-query
  search on the torch plane, after which the next request's ids, dists and
  stats are unchanged; the service's counters take none of it.
* ``distributed_search(..., data_axes=("pod", "data"))`` on the port's
  multi-pod mesh layout ``("pod", "data", "model")``: a gloo mesh of
  (2, 1, 2) spawned CPU ranks equals the torch backend (ids and dists,
  order included) and the reference's ``distributed_search`` with the same
  ``data_axes`` on a 1 × 1 × 1 mesh of that layout (ids equal, dists within
  rtol 1e-9, float64 sums in XLA's order, as
  ``tests/test_torch_distributed.py``).
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import distributed as jdist  # noqa: E402
from repro.core.live import LiveIndex as JLive  # noqa: E402
from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.live import LiveIndex  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)
from repro_torch.serve import ServiceConfig, VectorSearchService  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_partitions=4, kmeans_iters=4, lloyd_iters=6)
K = 10
JAX_RTOL = 1e-9
POD_MESH = (2, 1, 2)
POD_AXES = ("pod", "data", "model")


@pytest.fixture(autouse=True)
def float64_default():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@pytest.fixture(scope="module")
def built():
    ds = jsyn.make_vector_dataset("sift1m", scale=0.003, num_queries=9,
                                  seed=7)
    jpreds = jsyn.default_predicates(ds.attr_cardinality)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**CFG), seed=7)
    preds = [Predicate(**dataclasses.asdict(p)) for p in jpreds]
    arrays = {k: np.array(v, copy=True) for k, v in
              index_to_arrays(ref).items()}
    return ds, jpreds, preds, ref, arrays


def _port(arrays):
    return index_from_arrays({k: v.copy() for k, v in arrays.items()},
                             SquashConfig(**CFG))


def _same(got, want, same_stats=True):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if same_stats:
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


# ------------------------------------------------------------ collect_stats

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_search_takes_collect_stats_as_the_reference(built, backend):
    ds, jpreds, preds, ref, arrays = built
    port = _port(arrays)
    dev = {"device": "cpu"} if backend == "torch" else {}
    qn = 5
    got = port.search(ds.queries[:qn], preds, k=K, collect_stats=True,
                      backend=backend, **dev)
    _same(got, port.search(ds.queries[:qn], preds, k=K, backend=backend,
                           **dev))
    # the reference's fourth place, positionally
    _same(port.search(ds.queries[:qn], preds, K, True, backend, **dev), got)
    want = ref.search(ds.queries[:qn], jpreds, k=K, collect_stats=True,
                      backend="numpy")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=JAX_RTOL, atol=0)
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert got[2].filter_pass < 0.16 * ds.n * qn     # test_pipeline's check


def test_live_search_forwards_collect_stats(built):
    ds, jpreds, preds, ref, arrays = built
    live, jlive = LiveIndex(_port(arrays)), JLive(copy.deepcopy(ref))
    doomed = np.arange(0, ds.n, 7)
    live.delete(doomed)
    jlive.delete(doomed)
    for backend, dev in (("numpy", {}), ("torch", {"device": "cpu"})):
        got = live.search(ds.queries, preds, k=K, collect_stats=True,
                          backend=backend, **dev)
        _same(got, live.search(ds.queries, preds, k=K, backend=backend,
                               **dev))
        want = jlive.search(ds.queries, jpreds, k=K, collect_stats=True,
                            backend="numpy")
        np.testing.assert_array_equal(got[0], want[0])
        assert not np.isin(got[0], doomed).any()
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


# ----------------------------------------------------------------- warmup

@pytest.mark.parametrize("k", [None, 4])
def test_service_warmup_leaves_the_next_request_unchanged(built, k):
    ds, _, preds, _, arrays = built
    cfg = ServiceConfig(backend="torch", device="cpu", default_k=7)
    cold = VectorSearchService(_port(arrays), cfg)
    warm = VectorSearchService(_port(arrays), cfg)
    searched = []
    index_search = warm.index.search
    warm.index.search = lambda q, p, **kw: (searched.append((q, p, kw)),
                                            index_search(q, p, **kw))[1]
    warm.warmup(6, k=k)
    (q, p, kw), = searched
    assert q.shape == (6, warm.index.dim) and not q.any() and list(p) == []
    # k=None takes the service's default_k
    assert kw == {"k": k or 7, "backend": "torch", "device": "cpu"}
    assert warm.requests == 0 and warm.queries_served["torch"] == 0
    assert dataclasses.asdict(warm.stats) == dataclasses.asdict(cold.stats)
    _same(warm.query(ds.queries, preds), cold.query(ds.queries, preds))
    assert dataclasses.asdict(warm.stats) == dataclasses.asdict(cold.stats)
    # the warmed plane's stack is the one the request read
    assert len(warm.index._stacked_cache) == 1


def test_service_warmup_runs_on_the_card_unless_told(monkeypatch, built):
    *_, arrays = built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = VectorSearchService(_port(arrays), ServiceConfig(backend="torch"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        svc.warmup(4)


# ------------------------------------------------------- multi-axis mesh

# One rank: rebuild the port's index, join the gloo group through a file,
# search on the (pod, data, model) mesh with data_axes (pod, data).
_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import distributed
    from repro_torch.core.attributes import Predicate
    from repro_torch.core.pipeline import SquashConfig, index_from_arrays

    spec = json.loads(sys.argv[1])
    rank = int(sys.argv[2])
    torch.set_default_dtype(torch.float64)
    with np.load(spec["arrays"]) as f:
        arrays = {name: f[name] for name in f.files}
    index = index_from_arrays(arrays, SquashConfig(**spec["config"]))
    preds = [Predicate(**p) for p in spec["preds"]]
    queries = np.load(spec["queries"])
    world = int(np.prod(spec["mesh"]))
    dist.init_process_group("gloo", init_method="file://" + spec["rendezvous"],
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", tuple(spec["mesh"]),
                                mesh_dim_names=tuple(spec["names"]))
        ids, dists = distributed.distributed_search(
            index, queries, preds, spec["k"], mesh=mesh,
            data_axes=tuple(spec["data_axes"]))
    finally:
        dist.destroy_process_group()
    np.savez(spec["out"] + f".{rank}.npz", ids=ids, dists=dists)
""")


def _run_pod_mesh(tmp_path, built):
    ds, _, preds, _, arrays = built
    np.savez(tmp_path / "index.npz", **arrays)
    np.save(tmp_path / "queries.npy", ds.queries)
    spec = {"arrays": str(tmp_path / "index.npz"),
            "queries": str(tmp_path / "queries.npy"),
            "config": CFG, "k": K, "mesh": list(POD_MESH),
            "names": list(POD_AXES), "data_axes": ["pod", "data"],
            "preds": [dataclasses.asdict(p) for p in preds],
            "rendezvous": str(tmp_path / "rendezvous"),
            "out": str(tmp_path / "answer")}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    world = int(np.prod(POD_MESH))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, json.dumps(spec), str(rank)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors[0]
    out = []
    for rank in range(world):
        with np.load(f"{spec['out']}.{rank}.npz") as f:
            out.append((f["ids"], f["dists"]))
    return out


def test_pod_mesh_equals_torch_backend_and_reference(tmp_path, built):
    ds, jpreds, preds, ref, arrays = built
    ids_t, d_t, _ = _port(arrays).search(ds.queries, preds, k=K,
                                         backend="torch", device="cpu")
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), POD_AXES)
    j_ids, j_d = (np.asarray(a) for a in jdist.distributed_search(
        ref, ds.queries, jpreds, k=K, mesh=jmesh,
        data_axes=("pod", "data")))
    answers = _run_pod_mesh(tmp_path, built)
    assert len(answers) == int(np.prod(POD_MESH))
    for ids, dists in answers:                   # every rank, whole batch
        np.testing.assert_array_equal(ids, ids_t)
        np.testing.assert_array_equal(dists, d_t)
        np.testing.assert_array_equal(ids, j_ids)
        finite = np.isfinite(j_d)
        np.testing.assert_array_equal(np.isfinite(dists), finite)
        np.testing.assert_allclose(dists[finite], j_d[finite], rtol=JAX_RTOL,
                                   atol=0)


def test_single_process_mesh_takes_the_reference_axes(built):
    """``mesh=None`` with the multi-pod names: the 1 × 1 × 1 plane, equal
    to the torch backend; axes a mesh lacks, or named twice, are refused."""
    ds, _, preds, _, arrays = built
    port = _port(arrays)
    want = port.search(ds.queries, preds, k=K, backend="torch",
                       device="cpu")
    got = distributed.distributed_search(port, ds.queries, preds, K,
                                         data_axes=("pod", "data"),
                                         device="cpu")
    _same(got, want, same_stats=False)

    class _Mesh:
        mesh_dim_names = ("data", "model")

    for axes, model in ((("pod", "data"), "model"), (("data",), "data")):
        with pytest.raises(ValueError, match="data_axes"):
            distributed.make_search_fn(_Mesh(), k=K, keep_s=4, take_s=2,
                                       data_axes=axes, model_axis=model)
