"""The port's live index against the JAX package's, on the CPU.

From one seed, a reference index and its port (carried across by
``index_to_arrays``) take the same inserts, deletes and compactions, each
through its own package's ``LiveIndex``. After every step:

* ids, dists and ``SearchStats`` of the port's numpy and torch backends
  equal the reference's numpy backend (float64, the parity config);
* generations, version, dirty partitions, segment blocks, events and the
  tombstone bitmap equal the reference's, and so do the partitions' arrays
  after a requantizing compaction;
* no tombstoned id comes back, on either backend, even through a full
  candidate mask, and QP bundles fold the tombstones into ``valid``;
* a drop-only compaction is bitwise invisible;
* ``index_to_arrays`` / ``index_from_arrays`` carry a mutated reference
  index's ledger, so the port searches it and goes on mutating it in step.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.live import LiveIndex as JLive  # noqa: E402
from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import dataplane  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.live import LiveIndex, SegmentBlock  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)
from repro_torch.serverless import workers as wk  # noqa: E402

CFG = dict(num_partitions=5, kmeans_iters=4, lloyd_iters=6)


@pytest.fixture(scope="module")
def pristine():
    ds = jsyn.make_vector_dataset("sift1m", scale=0.002, num_queries=6,
                                  seed=9)
    preds = jsyn.default_predicates(ds.attr_cardinality)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**CFG), seed=9)
    return ds, preds, ref


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


@pytest.fixture
def pair(pristine):
    """(ds, reference preds, port preds, reference index, port index)."""
    ds, jpreds, ref = pristine
    ref = copy.deepcopy(ref)
    preds = [Predicate(**dataclasses.asdict(p)) for p in jpreds]
    return ds, jpreds, preds, ref, _port_of(ref)


def _search_all(ref, port, queries, jpreds, preds, k=10):
    """The port's numpy and torch backends against the reference's numpy
    backend: equal ids, dists and stats. Returns the port's numpy result."""
    want = ref.search(queries, jpreds, k=k, backend="numpy")
    for backend in ("numpy", "torch"):
        got = port.search(queries, preds, k=k, backend=backend,
                          device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)
        assert got[2].__dict__ == want[2].__dict__
    return got


def _ledger_equal(jlive, live):
    assert live.generations == jlive.generations
    assert live.version == jlive.version
    assert live.dirty_partitions() == jlive.dirty_partitions()
    for pid in range(jlive.num_partitions):
        assert [dataclasses.astuple(b) for b in live.segments_of(pid)] == \
            [dataclasses.astuple(b) for b in jlive.segments_of(pid)]
    np.testing.assert_array_equal(live.base.live_mask, jlive.base.live_mask)
    np.testing.assert_array_equal(live.base.partitioning.assign,
                                  jlive.base.partitioning.assign)
    _, jev = jlive.events_since(0)
    _, ev = live.events_since(0)
    assert len(ev) == len(jev)
    for a, b in zip(ev, jev):
        assert (a.seq, a.kind, a.pids, a.ids, a.requantize) == \
            (b.seq, b.kind, b.pids, b.ids, b.requantize)
        assert (a.vectors is None) == (b.vectors is None)
        if a.vectors is not None:
            np.testing.assert_array_equal(a.vectors, b.vectors)


def _parts_equal(ref, port):
    want, got = index_to_arrays(ref), index_to_arrays(port)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# The mutation sequences each scenario runs, step by step.
SCENARIOS = {
    "insert": ("insert",),
    "delete": ("delete",),
    "insert_delete_drop": ("insert", "delete", "compact_drop"),
    "insert_delete_requantize": ("insert", "delete", "compact_requantize"),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_mutations_match_reference(pair, scenario):
    ds, jpreds, preds, ref, port = pair
    jlive, live = JLive(ref), LiveIndex(port)
    assert port.live_owner is live
    rng = np.random.default_rng(len(scenario))
    for step in SCENARIOS[scenario]:
        if step == "insert":
            src = rng.choice(ds.vectors.shape[0], size=12, replace=False)
            vecs = ds.vectors[src] + 1e-3 * rng.normal(size=(12, ref.dim))
            np.testing.assert_array_equal(
                live.insert(vecs, ds.attributes[src]),
                jlive.insert(vecs, ds.attributes[src]))
        elif step == "delete":
            first = ref.search(ds.queries, [], k=10, backend="numpy")[0]
            victims = np.unique(first[:, :2].ravel())
            assert live.delete(victims) == jlive.delete(victims)
        else:
            requantize = step == "compact_requantize"
            for pid in jlive.dirty_partitions():
                assert live.compact(pid, requantize=requantize) == \
                    jlive.compact(pid, requantize=requantize)
        _ledger_equal(jlive, live)
        _parts_equal(ref, port)
        _search_all(ref, port, ds.queries, jpreds, preds)
        _search_all(ref, port, ds.queries, [], [])


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_tombstones_never_returned(pair, backend):
    ds, _, preds, _, port = pair
    live = LiveIndex(port)
    first = port.search(ds.queries, [], k=10, backend=backend, device="cpu")
    victims = np.unique(first[0][:, :3].ravel())
    assert live.delete(victims) == victims.size
    assert live.delete(victims) == 0
    for p in ([], preds):
        ids, _, _ = port.search(ds.queries, p, k=10, backend=backend,
                                device="cpu")
        assert np.intersect1d(ids.ravel(), victims).size == 0
    # The stacked payload and the QP bundles fold the tombstones into
    # valid, so a full candidate mask cannot surface a dead row either.
    stacked = port.stacked(torch.float64, "cpu")
    q = torch.from_numpy(ds.queries)
    full = torch.ones((q.shape[0], stacked.num_partitions, stacked.n_max),
                      dtype=torch.bool)
    keep = torch.full((q.shape[0], stacked.num_partitions), 64,
                      dtype=torch.int32)
    ids, _ = dataplane.batched_stage345(
        q, stacked, full, keep, torch.full_like(keep, 20), k=10, keep_s=64,
        take_s=20)
    assert np.intersect1d(ids.numpy().ravel(), victims).size == 0
    for pid, part in enumerate(port.parts):
        live_rows = port.live_mask[part.vector_ids]
        np.testing.assert_array_equal(
            stacked.valid[pid, :part.size].numpy(), live_rows)
        bundle = wk.build_qp_bundle(port, pid, torch.float64)
        np.testing.assert_array_equal(
            bundle["part_arrays"]["valid"][:part.size], live_rows)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_drop_only_compaction_is_bitwise_invisible(pair, backend):
    ds, _, preds, _, port = pair
    live = LiveIndex(port)
    live.insert(ds.vectors[:5] + 1e-3, ds.attributes[:5])
    first = port.search(ds.queries, [], k=10, backend="numpy")
    live.delete(np.unique(first[0][:, :2].ravel()))
    during = port.search(ds.queries, preds, k=10, backend=backend,
                         device="cpu")
    for pid in live.dirty_partitions():
        assert live.compact(pid, requantize=False) is True
    assert live.dirty_partitions() == ()
    for pid in range(live.num_partitions):
        assert live.segments_of(pid) == (SegmentBlock(
            0, port.parts[pid].size, live.generations[pid]),)
    after = port.search(ds.queries, preds, k=10, backend=backend,
                        device="cpu")
    np.testing.assert_array_equal(during[0], after[0])
    np.testing.assert_array_equal(during[1], after[1])
    assert during[2] == after[2]
    assert sum(pt.size for pt in port.parts) == live.live_count()
    assert (port.partitioning.assign == live.sentinel).sum() == \
        port.partitioning.assign.shape[0] - live.live_count()


def test_wrap_twice_raises_and_clean_compact_is_noop(pair):
    _, _, _, _, port = pair
    live = LiveIndex(port)
    with pytest.raises(ValueError, match="already wrapped"):
        LiveIndex(port)
    assert live.compact(0) is False
    assert live.version == 0 and live.generations == [0] * 5


def test_mutation_drops_the_stacked_payload(pair):
    ds, _, _, _, port = pair
    live = LiveIndex(port)
    before = port.stacked(torch.float64, "cpu")
    assert port.stacked(torch.float64, "cpu") is before
    live.insert(ds.vectors[:3] + 1e-3, ds.attributes[:3])
    after = port.stacked(torch.float64, "cpu")
    assert after is not before
    assert after.n_max >= before.n_max


def test_ledger_carried_from_a_mutated_reference_index(pair):
    ds, jpreds, preds, ref, _ = pair
    jlive = JLive(ref)
    jlive.insert(ds.vectors[:7] + 1e-3, ds.attributes[:7])
    first = ref.search(ds.queries, [], k=10, backend="numpy")[0]
    jlive.delete(np.unique(first[:, :2].ravel()))
    jlive.compact(jlive.dirty_partitions()[0], requantize=True)
    port = _port_of(jlive)
    live = port.live_owner
    assert isinstance(live, LiveIndex) and live.base is port
    assert live.events_since(0) == (jlive.version, [])
    assert live.generations == jlive.generations
    assert live.version == jlive.version
    assert live.dirty_partitions() == jlive.dirty_partitions()
    for pid in range(jlive.num_partitions):
        assert [dataclasses.astuple(b) for b in live.segments_of(pid)] == \
            [dataclasses.astuple(b) for b in jlive.segments_of(pid)]
    _search_all(ref, port, ds.queries, jpreds, preds)
    # Both go on mutating in step.
    for pid in jlive.dirty_partitions():
        assert live.compact(pid, requantize=False) == \
            jlive.compact(pid, requantize=False)
    assert live.generations == jlive.generations
    _parts_equal(ref, port)
    _search_all(ref, port, ds.queries, jpreds, preds)
