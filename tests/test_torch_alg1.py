"""The port's Algorithm 1 (``core/partitions.py::select_partitions``)
against the JAX package's, on the CPU:

* ``visit``, each query's ``cands`` (keys in the same order, int64 arrays
  equal) and the escalation count are equal to the reference's for a
  broadcast filter row, per-query masks, an all-pass dense mask, an empty
  filter, a sparse filter that escalates past the Eq. 1 cut, the balance
  loop, one query, and an ``assign`` carrying a compacted live index's
  sentinel ``P``;
* under a broadcast row, queries visiting one partition share one
  read-only array.
"""

import numpy as np
import pytest

from repro.core import partitions as jpart
from repro_torch.core import partitions

N, D, P, Q, K = 900, 8, 6, 24, 10


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    cent = rng.normal(scale=4.0, size=(P, D))
    x = cent[rng.integers(0, P, N)] + rng.normal(size=(N, D))
    assign = np.argmin(((x[:, None] - cent[None]) ** 2).sum(-1), axis=1)
    queries = x[rng.choice(N, Q, replace=False)] + rng.normal(size=(Q, D))
    row = rng.random(N) < 0.3
    f = np.broadcast_to(row, (Q, N))
    kw = dict(threshold=1.15, k=K, balance=False)
    if name == "per_query":
        f = rng.random((Q, N)) < 0.3
    elif name == "all_pass":
        f = np.ones((Q, N), bool)
    elif name == "empty":
        f = np.broadcast_to(np.zeros(N, bool), (Q, N))
    elif name == "escalate":
        f = np.broadcast_to(rng.random(N) < 0.02, (Q, N))
        kw["k"] = 12
    elif name == "balance":
        kw.update(threshold=1.6, balance=True)
    elif name == "one_query":
        queries, f = queries[:1], f[:1]
    elif name == "sentinel":
        assign = assign.copy()
        assign[rng.random(N) < 0.2] = P
    return queries, cent, f, assign, kw


CASES = ["broadcast", "per_query", "all_pass", "empty", "escalate",
         "balance", "one_query", "sentinel"]


@pytest.mark.parametrize("name", CASES)
def test_select_partitions_equals_reference(name):
    queries, cent, f, assign, kw = _case(name)
    got_esc, want_esc = [0], [0]
    visit, cands = partitions.select_partitions(
        queries, cent, f, assign, kw["threshold"], kw["k"],
        balance=kw["balance"], escalations=got_esc)
    want_visit, want_cands = jpart.select_partitions(
        queries, cent, f, assign, kw["threshold"], kw["k"],
        balance=kw["balance"], escalations=want_esc)
    np.testing.assert_array_equal(visit, want_visit)
    assert got_esc == want_esc
    assert len(cands) == len(want_cands)
    for got, want in zip(cands, want_cands):
        assert list(got) == list(want)
        for pid in want:
            assert got[pid].dtype == np.int64
            np.testing.assert_array_equal(got[pid], want[pid])
    if name == "escalate":
        assert want_esc[0] > 0
    if name == "empty":
        assert not visit.any()
    if name == "balance":
        plain, _ = jpart.select_partitions(queries, cent, f, assign,
                                           kw["threshold"], kw["k"])
        assert visit.sum() > plain.sum()


def test_a_shared_row_gives_shared_read_only_rows():
    queries, cent, f, assign, kw = _case("broadcast")
    _, cands = partitions.select_partitions(queries, cent, f, assign,
                                            kw["threshold"], kw["k"])
    pid = next(iter(cands[0]))
    other = next(c for c in cands[1:] if pid in c)
    assert other[pid] is cands[0][pid]
    with pytest.raises(ValueError):
        other[pid][0] = 0
