"""The port's HNSW baseline (``repro_torch.core.hnsw``) against the JAX
package's, on the same vectors and seed.

The port's analogues of ``tests/test_hnsw.py`` (degree bounds, layer-0
reachability, unfiltered recall, filtered results satisfy the predicate),
plus: the same graph (levels, entry point, every layer's adjacency) as the
reference's ``HNSWIndex``, and the same ids and distances, unfiltered and
post-filtered.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.hnsw import HNSWConfig as JConfig  # noqa: E402
from repro.core.hnsw import HNSWIndex as JIndex  # noqa: E402
from repro.data.synthetic import (default_predicates, ground_truth,  # noqa: E402
                                  make_vector_dataset)
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.hnsw import HNSWConfig, HNSWIndex  # noqa: E402


@pytest.fixture(scope="module")
def ds():
    return make_vector_dataset("sift1m", scale=0.002, num_queries=12, seed=1)


@pytest.fixture(scope="module")
def pair(ds):
    kw = dict(m=12, ef_construction=64)
    port = HNSWIndex(ds.vectors, HNSWConfig(**kw), attributes=ds.attributes)
    ref = JIndex(ds.vectors, JConfig(**kw), attributes=ds.attributes)
    return port, ref


def _preds(ds):
    jpreds = default_predicates(ds.attr_cardinality)
    return jpreds, [Predicate(**dataclasses.asdict(p)) for p in jpreds]


def test_same_graph_as_reference(pair):
    port, ref = pair
    np.testing.assert_array_equal(port._levels, ref._levels)
    assert port._entry == ref._entry and port._max_level == ref._max_level
    assert port._adj == ref._adj


@pytest.mark.parametrize("ef", [16, 96])
def test_same_answers_as_reference(ds, pair, ef):
    port, ref = pair
    ids, dists = port.search(ds.queries, k=10, ef=ef)
    jids, jdists = ref.search(ds.queries, k=10, ef=ef)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(dists, jdists)


@pytest.mark.parametrize("expansion", [1, 4])
def test_same_filtered_answers_as_reference(ds, pair, expansion):
    port, ref = pair
    jpreds, preds = _preds(ds)
    ids, dists = port.search_filtered(ds.queries, preds, k=5,
                                      expansion=expansion)
    jids, jdists = ref.search_filtered(ds.queries, jpreds, k=5,
                                       expansion=expansion)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(dists, jdists)


def test_graph_degree_bounds(pair):
    index = pair[0]
    cfg = index.config
    for lvl, adj in enumerate(index._adj):
        cap = 2 * cfg.m if lvl == 0 else cfg.m
        for node, nbrs in adj.items():
            assert len(nbrs) <= cap
            assert node not in nbrs


def test_every_node_reachable_on_layer0(pair):
    index = pair[0]
    adj = index._adj[0]
    rev = {}
    for u, nbrs in adj.items():
        for v in nbrs:
            rev.setdefault(v, []).append(u)
    seen, stack = set(), [index._entry]
    while stack:                      # undirected: forward and reverse edges
        u = stack.pop()
        if u in seen:
            continue
        seen.add(u)
        stack.extend(adj.get(u, []) + rev.get(u, []))
    assert len(seen) >= 0.99 * index.vectors.shape[0], (
        "layer-0 graph must be (near) connected")


def test_unfiltered_recall(ds, pair):
    index = pair[0]
    gt, _ = ground_truth(ds, [], k=10)
    ids, dists = index.search(ds.queries, k=10, ef=96)
    hits = sum(len(set(ids[i]) & set(gt[i])) for i in range(len(ids)))
    assert hits / gt.size >= 0.85
    for row in dists:
        fin = row[np.isfinite(row)]
        assert np.all(np.diff(fin) >= -1e-6)


def test_filtered_results_satisfy_predicate(ds, pair):
    index = pair[0]
    _, preds = _preds(ds)
    ids, _ = index.search_filtered(ds.queries, preds, k=5, expansion=4)
    assert (ids >= 0).any()
    for row in ids:
        for vid in row:
            if vid >= 0:
                for p in preds:
                    assert p.eval(np.asarray([ds.attributes[vid, p.attr]]))[0]
