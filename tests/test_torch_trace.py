"""The port's single-host search path, traced (CPU):

* ``SquashIndex.search(backend="torch")`` run on a worker thread, under a
  ``torch.profiler`` profiler recording all threads, emits every
  ``squash.*`` range, nested as ``obs/spans.py`` lists them; the split
  ``select`` + ``_search_torch(mark=...)`` path emits the same children
  inside the outer ranges a caller opens around it;
* ids, dists and ``SearchStats`` are bitwise equal with the profiler on
  and off, and with the metrics registry on and off;
* ``search.alg1.rows_scanned``, ``search.alg1.shared_scans`` and
  ``search.upload.bytes`` equal plain counts made here, and a disabled
  registry holds no ``search.*`` key;
* the ranges are opened only while a profiler records, and then also on
  a thread that was started before the profiler.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._C._profiler import _ExperimentalConfig  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch.core import partitions  # noqa: E402
from repro_torch.core.pipeline import SquashConfig, SquashIndex  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402

K = 10
PARENT = {
    "squash.select": "squash.search", "squash.plane": "squash.search",
    "squash.filter": "squash.select", "squash.alg1": "squash.select",
    "squash.densify": "squash.plane", "squash.upload": "squash.plane",
    "squash.stage3": "squash.plane", "squash.stage4": "squash.plane",
    "squash.stage5": "squash.plane", "squash.fetch": "squash.plane",
}
PLANE_ORDER = ("squash.densify", "squash.upload", "squash.stage3",
               "squash.stage4", "squash.stage5", "squash.fetch")


@pytest.fixture(scope="module")
def built():
    ds = synthetic.make_vector_dataset("sift1m", scale=0.002,
                                       num_queries=12, seed=11)
    index = SquashIndex.build(ds.vectors, ds.attributes, SquashConfig(
        num_partitions=5, kmeans_iters=4, lloyd_iters=6,
        max_bits_per_dim=5), seed=11)
    return ds, synthetic.default_predicates(), index


def _search(index, ds, preds):
    return index.search(ds.queries, preds, k=K, backend="torch",
                        device="cpu")


def _traced(fn, tmp_path):
    """Run ``fn`` on a worker thread started before the profiler, as the
    benchmark's clients are; returns its result and the ranges it opened
    as {name: [(start, end, tid)]}."""
    out, ready = {}, threading.Barrier(2)

    def work():
        ready.wait(timeout=60)
        out["res"] = fn()

    t = threading.Thread(target=work)
    t.start()
    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    try:
        ready.wait(timeout=60)
        t.join(timeout=120)
    finally:
        prof.stop()
    assert not t.is_alive()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("cat") == "user_annotation" and ev.get("ph") == "X":
            ts, dur = float(ev["ts"]), float(ev["dur"])
            ranges.setdefault(ev["name"], []).append((ts, ts + dur,
                                                      ev["tid"]))
    return out["res"], ranges


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1] \
        and inner[2] == outer[2]


def test_search_emits_every_span_nested_on_its_thread(built, tmp_path):
    ds, preds, index = built
    _, ranges = _traced(lambda: _search(index, ds, preds), tmp_path)
    names = {n for n in ranges if n.startswith("squash.")}
    assert names == set(PARENT) | {"squash.search"}
    assert all(len(ranges[n]) == 1 for n in names)
    (root,) = ranges["squash.search"]
    assert root[2] != threading.get_native_id()
    for child, parent in PARENT.items():
        assert _inside(ranges[child][0], ranges[parent][0]), child
    assert ranges["squash.filter"][0][1] <= ranges["squash.alg1"][0][0]
    assert ranges["squash.select"][0][1] <= ranges["squash.plane"][0][0]
    for a, b in zip(PLANE_ORDER, PLANE_ORDER[1:]):
        assert ranges[a][0][1] <= ranges[b][0][0], (a, b)


def test_split_path_nests_inside_the_callers_ranges(built, tmp_path):
    ds, preds, index = built
    outer = {"start": "bench.stage3", "hamming": "bench.stage4",
             "adc": "bench.stage5", "refine_merge": "bench.fetch"}

    def split():
        with record_function("bench.select"):
            q64, cands, stats = index.select(ds.queries, preds, K)
        opened = [record_function("bench.prep")]
        opened[0].__enter__()

        def mark(name):
            opened[0].__exit__(None, None, None)
            opened[0] = record_function(outer[name])
            opened[0].__enter__()

        try:
            return index._search_torch(q64, cands, K, stats,
                                       torch.device("cpu"), mark=mark)
        finally:
            opened[0].__exit__(None, None, None)

    _, ranges = _traced(split, tmp_path)
    assert "squash.search" not in ranges
    within = {"squash.filter": "bench.select", "squash.alg1": "bench.select",
              "squash.select": "bench.select",
              "squash.densify": "bench.prep", "squash.upload": "bench.prep",
              "squash.stage3": "bench.stage3",
              "squash.stage4": "bench.stage4",
              "squash.stage5": "bench.stage5",
              "squash.fetch": "bench.fetch"}
    for child, parent in within.items():
        assert _inside(ranges[child][0], ranges[parent][0]), child
    for child in PLANE_ORDER:
        assert _inside(ranges[child][0], ranges["squash.plane"][0]), child


def _answers(res):
    ids, dists, stats = res
    return ids, dists, stats.__dict__


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1].tobytes() == b[1].tobytes()
    assert a[2] == b[2]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_answers_equal_with_profiler_and_registry_on_and_off(
        built, tmp_path, backend):
    ds, preds, index = built

    def run():
        return _answers(index.search(ds.queries, preds, k=K,
                                     backend=backend, device="cpu"))

    base = run()
    traced, _ = _traced(run, tmp_path)
    _equal(base, traced)
    REGISTRY.reset()
    REGISTRY.enable()
    try:
        counted = run()
    finally:
        REGISTRY.disable()
        REGISTRY.reset()
    _equal(base, counted)


def _plain_scans(index, queries, fmask, k):
    """(query, partition) scans of Algorithm 1, listed by hand: ranked
    partitions are scanned until one past the threshold cut is reached
    with k candidates already found."""
    part = index.partitioning
    scans = []
    for qi, q in enumerate(queries):
        dist = np.sqrt(((part.centroids - q) ** 2).sum(-1))
        dmin = max(dist.min(), 1e-12)
        found = 0
        for pid in np.argsort(dist):
            if dist[pid] > part.threshold * dmin and found >= k:
                break
            scans.append((qi, pid))
            found += int((fmask & (part.assign == pid)).sum())
    return scans


def _filter_mask(attrs, preds):
    mask = np.ones(attrs.shape[0], dtype=bool)
    for p in preds:
        mask &= (attrs[:, p.attr] >= p.lo) & (attrs[:, p.attr] <= p.hi)
    return mask


def _counted(fn):
    REGISTRY.reset()
    REGISTRY.enable()
    try:
        fn()
        return REGISTRY.snapshot()["counters"]
    finally:
        REGISTRY.disable()
        REGISTRY.reset()


def test_rows_scanned_counts_each_scan_of_the_mask(built):
    # The search shares one filter row across the batch: each partition's
    # n_p rows of it are read once, however many queries scan it.
    ds, preds, index = built
    got = _counted(lambda: _search(index, ds, preds))
    n_p = np.bincount(index.partitioning.assign)
    scans = _plain_scans(index, ds.queries, _filter_mask(ds.attributes,
                                                         preds), K)
    scanned_parts = sorted({pid for _, pid in scans})
    assert got["search.alg1.rows_scanned"] == n_p[scanned_parts].sum() > 0
    assert got["search.alg1.shared_scans"] == len(scans) \
        > len(scanned_parts)


@pytest.mark.parametrize("shared", [True, False])
def test_shared_scans_count_the_shared_row(built, shared):
    ds, _, index = built
    part = index.partitioning
    n = part.assign.shape[0]
    fmask = np.ones(n, bool)
    masks = np.broadcast_to(fmask, (len(ds.queries), n)) if shared \
        else np.ones((len(ds.queries), n), bool)
    rows, reused = [0], [0]
    partitions.select_partitions(
        ds.queries, part.centroids, masks, part.assign, part.threshold, K,
        scanned=rows, shared_scans=reused)
    scans = len(_plain_scans(index, ds.queries, fmask, K))
    assert reused[0] == (scans if shared else 0)
    assert scans > 0


@pytest.mark.parametrize("balance", [False, True])
def test_rows_scanned_counts_the_balance_loop(built, balance):
    # With every row passing, each scan finds rows and becomes a visit, in
    # the main loop and in the balance loop alike: a dense mask reads n_p
    # rows a scan, a shared row n_p once for each partition scanned.
    ds, _, index = built
    part = index.partitioning
    n = part.assign.shape[0]
    n_p = np.bincount(part.assign, minlength=part.num_partitions)
    for masks in (np.ones((len(ds.queries), n), bool),
                  np.broadcast_to(np.ones(n, bool), (len(ds.queries), n))):
        box = [0]
        visit, _ = partitions.select_partitions(
            ds.queries, part.centroids, masks, part.assign, part.threshold,
            K, balance=balance, scanned=box)
        want = (visit.sum(0) * n_p).sum() if masks.strides[0] \
            else n_p[visit.any(0)].sum()
        assert box[0] == want > 0


def test_upload_bytes_are_the_uploaded_arrays(built):
    ds, preds, index = built
    q = ds.queries[:11]                      # padded to a bucket of 16
    REGISTRY.reset()
    REGISTRY.enable()
    try:
        index.search(q, preds, k=K, backend="torch", device="cpu")
        got = REGISTRY.snapshot()["counters"]["search.upload.bytes"]
    finally:
        REGISTRY.disable()
        REGISTRY.reset()
    st = index.stacked(torch.get_default_dtype(), "cpu")
    p, bucket, d = st.num_partitions, 16, q.shape[1]
    queries = np.zeros((bucket, d), np.float64)
    mask = np.zeros((bucket, p, st.n_max), bool)
    counts = np.zeros((bucket, p), np.int32)           # keep, take
    assert got == queries.nbytes + mask.nbytes + 2 * counts.nbytes


def test_a_disabled_registry_keeps_no_search_key(built):
    ds, preds, index = built
    REGISTRY.disable()
    REGISTRY.reset()
    _search(index, ds, preds)
    snap = REGISTRY.snapshot()
    assert not [k for kind in ("counters", "gauges", "histograms")
                for k in snap.get(kind, {}) if k.startswith("search.")]


def test_ranges_open_only_while_a_profiler_records(tmp_path):
    from repro_torch.obs.spans import profiler_range

    assert not isinstance(profiler_range("squash.x"), record_function)
    got, _ = _traced(lambda: isinstance(profiler_range("squash.x"),
                                        record_function), tmp_path)
    assert got
    assert not isinstance(profiler_range("squash.x"), record_function)
