"""The port's mesh path (``repro_torch.core.distributed``) against the
torch backend and the JAX package's ``distributed_search``, on the CPU.

Each mesh runs as one gloo process group of spawned CPU ranks (one Python
process per rank, importing only torch and the port). Every rank rebuilds
the port's index from the reference index's arrays, runs
``distributed_search`` on a ``DeviceMesh`` named ("data", "model") and the
parent compares every rank's answer, in float64, with:

* the port's torch backend — ids and dists equal, order included;
* the JAX package's ``distributed_search`` on its default mesh — ids equal,
  order included; dists within rtol 1e-9, the tolerance every float64 test
  of the port against the JAX package holds (``tests/test_torch_dataplane.py``:
  XLA sums the squared differences in another order).

P = 4 partitions, so that the partition stack is padded at model = 3, and
9 queries, so that the query batch is padded at data = 2. The module also
holds the port's analogues of ``tests/test_distributed.py`` (recall, the
padded stack) and of ``tests/test_multidevice.py``'s 2 × 2 mesh search
(which compares neighbour sets; here the order is held too: no tie at the
merge changed it).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as jdist  # noqa: E402
from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_partitions=4, kmeans_iters=4, lloyd_iters=6)
K = 10
JAX_RTOL = 1e-9          # float64 sums in XLA's order vs torch's
MESHES = [(1, 1), (1, 2), (2, 2), (1, 3), (1, 4)]

# One rank: rebuild the port's index, join the gloo group through a file,
# search on the (data, model) mesh, save the answer.
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
    world = spec["mesh"][0] * spec["mesh"][1]
    dist.init_process_group("gloo", init_method="file://" + spec["rendezvous"],
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", tuple(spec["mesh"]),
                                mesh_dim_names=("data", "model"))
        ids, dists = distributed.distributed_search(
            index, queries, preds, spec["k"], mesh=mesh)
    finally:
        dist.destroy_process_group()
    np.savez(spec["out"] + f".{rank}.npz", ids=ids, dists=dists)
""")


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
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    port = index_from_arrays(arrays, SquashConfig(**CFG))
    want = port.search(ds.queries, preds, k=K, backend="torch", device="cpu")
    torch.set_default_dtype(prev)
    return ds, jpreds, preds, ref, arrays, port, want


def _run_mesh(tmp_path, built, mesh, k=K):
    """Run ``distributed_search`` on a gloo mesh of spawned CPU ranks;
    return every rank's (ids, dists)."""
    ds, _, preds, _, arrays, _, _ = built
    np.savez(tmp_path / "index.npz", **arrays)
    np.save(tmp_path / "queries.npy", ds.queries)
    spec = {"arrays": str(tmp_path / "index.npz"),
            "queries": str(tmp_path / "queries.npy"),
            "config": CFG, "k": k, "mesh": list(mesh),
            "preds": [dataclasses.asdict(p) for p in preds],
            "rendezvous": str(tmp_path / "rendezvous"),
            "out": str(tmp_path / "answer")}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    world = mesh[0] * mesh[1]
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


def _reference(built):
    ds, jpreds, _, ref, _, _, _ = built
    j_ids, j_d = jdist.distributed_search(ref, ds.queries, jpreds, k=K)
    return np.asarray(j_ids), np.asarray(j_d)


def _assert_reference(ids, dists, j_ids, j_d):
    np.testing.assert_array_equal(ids, j_ids)
    finite = np.isfinite(j_d)
    np.testing.assert_array_equal(np.isfinite(dists), finite)
    np.testing.assert_allclose(dists[finite], j_d[finite], rtol=JAX_RTOL,
                               atol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_equals_torch_backend_and_reference(tmp_path, built, mesh):
    ds, jpreds, _, ref, _, _, (ids_t, d_t, _) = built
    j_ids, j_d = _reference(built)
    answers = _run_mesh(tmp_path, built, mesh)
    assert len(answers) == mesh[0] * mesh[1]
    for ids, dists in answers:                   # every rank, whole batch
        np.testing.assert_array_equal(ids, ids_t)
        np.testing.assert_array_equal(dists, d_t)
        _assert_reference(ids, dists, j_ids, j_d)


def test_default_mesh_equals_torch_backend_and_reference(built):
    ds, jpreds, preds, ref, _, port, (ids_t, d_t, _) = built
    ids, dists = distributed.distributed_search(port, ds.queries, preds, k=K,
                                                device="cpu")
    np.testing.assert_array_equal(ids, ids_t)
    np.testing.assert_array_equal(dists, d_t)
    _assert_reference(ids, dists, *_reference(built))


def test_default_mesh_runs_on_the_card_unless_told(monkeypatch, built):
    ds, _, preds, _, _, port, _ = built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.distributed_search(port, ds.queries, preds, k=K)


def test_two_by_two_mesh_small_k_keeps_order(tmp_path, built):
    """The port's analogue of ``test_multidevice.py``'s 2 × 2 mesh search
    at k = 5: the same neighbour sets as the single-device search, and
    here the same order too."""
    ds, _, preds, _, _, port, _ = built
    ids_t, d_t, _ = port.search(ds.queries, preds, k=5, backend="torch",
                                device="cpu")
    for ids, dists in _run_mesh(tmp_path, built, (2, 2), k=5):
        for a, b in zip(ids_t, ids):
            assert set(a.tolist()) == set(b.tolist())
        np.testing.assert_array_equal(ids, ids_t)
        np.testing.assert_array_equal(dists, d_t)


def test_distributed_recall(built):
    """The port's analogue of ``test_distributed.py::test_distributed_recall``."""
    ds, _, preds, _, _, port, _ = built
    gt_ids, _ = jsyn.ground_truth(ds, built[1], k=K)
    got_ids, _ = distributed.distributed_search(port, ds.queries, preds, k=K,
                                                device="cpu")
    recalls = []
    for qi in range(ds.queries.shape[0]):
        g = set(gt_ids[qi][gt_ids[qi] >= 0].tolist())
        if g:
            recalls.append(len(g & set(got_ids[qi].tolist())) / len(g))
    assert np.mean(recalls) >= 0.9, np.mean(recalls)


@pytest.mark.parametrize("model", [3, 4])
def test_padded_stack_roundtrip(built, model):
    """The port's analogue of ``test_stacked_index_roundtrip``: the stack
    padded to a multiple of ``model`` holds every row once, and equals the
    reference's padded stack."""
    _, _, _, ref, _, port, _ = built
    st = distributed.stack_index(port, pad_to_multiple=model,
                                 dtype=torch.float64)
    assert st.num_partitions % model == 0
    valid = st.valid.numpy()
    assert int(valid.sum()) == sum(p.size for p in port.parts)
    ids = st.vector_ids.numpy()[valid]
    assert np.unique(ids).size == int(valid.sum())
    jst = jdist.stack_index(ref, pad_to_multiple=model, dtype=np.float64)
    np.testing.assert_array_equal(valid, np.asarray(jst.valid))
    np.testing.assert_array_equal(st.vectors.numpy(), np.asarray(jst.vectors))
    np.testing.assert_array_equal(st.low_packed.numpy().view(np.uint32),
                                  np.asarray(jst.low_packed))


def test_mesh_must_name_data_and_model():
    class _Mesh:
        mesh_dim_names = ("dp", "tp")

    with pytest.raises(ValueError, match="data"):
        distributed.make_search_fn(_Mesh(), k=K, keep_s=4, take_s=2)
