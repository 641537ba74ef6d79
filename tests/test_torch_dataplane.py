"""The port's batched query plane against the JAX package's, on one index.

One reference-built index (the ``test_backend_parity`` data: SIFT1M-shaped,
``scale=0.008``, seed 5) is carried into the port with ``index_to_arrays`` /
``index_from_arrays``. In float64, the port's ``search(backend="torch",
device="cpu")`` must return ids **equal** to the reference's
``backend="jax"`` and ``backend="numpy"`` and equal ``SearchStats``, on both
Stage 4 branches (direct gathers at the default ``max_bits_per_dim`` and the
table path at 5), without refinement, with k larger than the candidate
sets, with an empty-result predicate, and for Q ∈ {1, 3, 24}. Distances
agree at ``rtol=1e-9`` (as test_backend_parity). The query-side helpers
equal their jnp counterparts.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dataplane as jdp  # noqa: E402
from repro.core.attributes import Predicate as JPredicate  # noqa: E402
from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import dataplane  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, index_from_arrays,  # noqa: E402
                                       index_to_arrays)
from repro_torch.data import synthetic  # noqa: E402

CPU = torch.device("cpu")


def _port(ref_index):
    cfg = SquashConfig(**dataclasses.asdict(ref_index.config))
    return index_from_arrays(index_to_arrays(ref_index), cfg)


@pytest.fixture(scope="module")
def built():
    ds = jsyn.make_vector_dataset("sift1m", scale=0.008, num_queries=24,
                                  seed=5)
    cfg = JConfig(num_partitions=6, kmeans_iters=5, lloyd_iters=8)
    ref = JIndex.build(ds.vectors, ds.attributes, cfg, seed=5)
    return ds, ref, _port(ref)


@pytest.fixture(scope="module")
def built_table(built):
    ds = built[0]
    cfg = JConfig(num_partitions=4, kmeans_iters=4, lloyd_iters=6,
                  max_bits_per_dim=5)
    ref = JIndex.build(ds.vectors, ds.attributes, cfg, seed=7)
    return ds, ref, _port(ref)


@pytest.fixture(scope="module")
def built_norefine(built):
    ds = built[0]
    cfg = JConfig(num_partitions=4, enable_refine=False, kmeans_iters=4,
                  lloyd_iters=6)
    ref = JIndex.build(ds.vectors, ds.attributes, cfg, seed=6)
    return ds, ref, _port(ref)


@pytest.fixture(autouse=True)
def float64_default():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _preds(jpreds):
    return [Predicate(**dataclasses.asdict(p)) for p in jpreds]


def _check_three(ref, port, queries, jpreds, k, rtol=1e-9):
    """Reference jax + numpy vs the port's torch (CPU): ids equal, stats
    equal, distances within ``rtol``; returns the torch result."""
    ids_j, d_j, s_j = ref.search(queries, jpreds, k=k, backend="jax")
    ids_n, _, s_n = ref.search(queries, jpreds, k=k, backend="numpy")
    ids_t, d_t, s_t = port.search(queries, _preds(jpreds), k=k,
                                  backend="torch", device="cpu")
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(ids_t, ids_n)
    assert dataclasses.asdict(s_t) == dataclasses.asdict(s_j)
    assert dataclasses.asdict(s_t) == dataclasses.asdict(s_n)
    finite = np.isfinite(d_j)
    np.testing.assert_array_equal(finite, np.isfinite(d_t))
    np.testing.assert_allclose(d_t[finite], d_j[finite], rtol=rtol, atol=0)
    return ids_t, d_t, s_t


@pytest.mark.parametrize("qn", [1, 3, 24])
def test_direct_branch_selective_predicates(built, qn):
    ds, ref, port = built
    m1 = max(p.quant.boundaries.shape[0] for p in port.parts)
    assert m1 > dataplane.ADC_TABLE_MAX_M1        # the direct Stage 4
    _check_three(ref, port, ds.queries[:qn], jsyn.default_predicates(), 10)


@pytest.mark.parametrize("qn", [1, 3, 24])
def test_table_branch_selective_predicates(built_table, qn):
    ds, ref, port = built_table
    m1 = max(p.quant.boundaries.shape[0] for p in port.parts)
    assert m1 <= dataplane.ADC_TABLE_MAX_M1       # the table kernel's path
    _check_three(ref, port, ds.queries[:qn], jsyn.default_predicates(), 10)


def test_unfiltered(built):
    ds, ref, port = built
    _check_three(ref, port, ds.queries, [], 10)


def test_no_refine(built_norefine):
    """Without refinement the distances are the f32 LB sums, reduced in
    another order on each side: f32 tolerance (d terms, each ≥ 0)."""
    ds, ref, port = built_norefine
    _, _, stats = _check_three(ref, port, ds.queries[:8],
                               jsyn.default_predicates(), 10, rtol=1e-6)
    assert stats.refined == 0


@pytest.mark.parametrize("which", ["built", "built_table"])
def test_k_exceeds_candidates(which, request):
    """k larger than some visited partitions' filtered candidate sets: -1 /
    +inf padding per partition, identical placement after the merge."""
    ds, ref, port = request.getfixturevalue(which)
    narrow = [JPredicate(attr=a, op="=", lo=float(ds.attributes[0, a]))
              for a in (0, 1)]
    ids, _, _ = _check_three(ref, port, ds.queries[:6], narrow, 50)
    assert (ids == -1).any() and (ids[:, 0] >= 0).all()


def test_empty_result_predicate(built):
    ds, ref, port = built
    impossible = [JPredicate(attr=0, op="=", lo=1e9)]
    ids, d, stats = _check_three(ref, port, ds.queries[:5], impossible, 10)
    assert (ids == -1).all() and np.isinf(d).all()
    assert stats.hamming_in == 0 and stats.refined == 0


def test_float32_deployment_config_matches_numpy(built):
    ds, ref, port = built
    torch.set_default_dtype(torch.float32)
    preds = jsyn.default_predicates()
    ids_t, _, s_t = port.search(ds.queries, _preds(preds), k=10,
                                backend="torch", device="cpu")
    ids_n, _, s_n = ref.search(ds.queries, preds, k=10, backend="numpy")
    np.testing.assert_array_equal(ids_t, ids_n)
    assert dataclasses.asdict(s_t) == dataclasses.asdict(s_n)
    assert port.stacked(torch.float32, CPU).vectors.dtype == torch.float32


# ---------------------------------------------------- the plane, directly

@pytest.mark.parametrize("which", ["built", "built_table"])
def test_batched_stage345_equals_reference_plane(which, request):
    ds, ref, port = request.getfixturevalue(which)
    preds = jsyn.default_predicates()
    queries, cands, _ = port.select(ds.queries[:8], _preds(preds), 10)
    jstack = jdp.stack_index(ref, dtype=np.float64)
    stacked = dataplane.stack_index(port, dtype=torch.float64, device=CPU)
    p, n_max = stacked.num_partitions, stacked.n_max
    cand_mask, n_cand = dataplane.build_cand_arrays(cands, 8, p, n_max)
    keep, take = dataplane.stage_counts(n_cand, port.config, 10)
    keep_s, take_s = dataplane.static_counts(n_max, port.config, 10)
    ids_j, d_j = jdp.batched_stage345(
        jnp.asarray(queries), jstack, jnp.asarray(cand_mask),
        jnp.asarray(keep), jnp.asarray(take), k=10, keep_s=keep_s,
        take_s=take_s)
    marks = []
    plane = dataplane.make_plane(k=10, keep_s=keep_s, take_s=take_s)
    ids_t, d_t = plane(torch.from_numpy(queries), stacked,
                       torch.from_numpy(cand_mask), torch.from_numpy(keep),
                       torch.from_numpy(take), mark=marks.append)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-9)
    assert marks == ["start", "hamming", "adc", "refine_merge"]


def test_stack_index_matches_reference_slabs(built_table):
    _, ref, port = built_table
    jstack = jdp.stack_index(ref, dtype=np.float64, pad_to_multiple=3)
    stacked = dataplane.stack_index(port, dtype=torch.float64, device=CPU,
                                    pad_to_multiple=3)
    for field in dataclasses.fields(stacked):
        got = getattr(stacked, field.name).numpy()
        want = np.asarray(getattr(jstack, field.name))
        if field.name == "low_packed":
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, field.name
        np.testing.assert_array_equal(got, want, err_msg=field.name)
    single = dataplane.stack_single_part(dataplane.part_stack_arrays(
        port.parts[1], n_max=stacked.n_max, m1=stacked.boundaries.shape[1],
        d=port.dim, dtype=np.float64), device=CPU)
    for field in dataclasses.fields(single):
        assert torch.equal(getattr(single, field.name),
                           getattr(stacked, field.name)[1:2]), field.name


# ----------------------------------------------- query-side helpers vs jnp

def test_pack_query_bits_equals_jnp():
    rng = np.random.default_rng(7)
    z = rng.normal(size=(3, 4, 70))
    z[0, 0, :] = 1.0                                    # all bits set
    want = np.asarray(jdp.pack_query_bits(jnp.asarray(z)))
    got = dataplane.pack_query_bits(torch.from_numpy(z))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_query_cells_and_adc_tables_equal_jnp(built):
    _, ref, port = built
    rng = np.random.default_rng(8)
    jstack = jdp.stack_index(ref, dtype=np.float64)
    stacked = dataplane.stack_index(port, dtype=torch.float64, device=CPU)
    qt = rng.normal(size=(5, stacked.num_partitions, port.dim)) * 3.0
    want_cells = np.asarray(jdp.query_cells(jnp.asarray(qt),
                                            jstack.boundaries))
    got_cells = dataplane.query_cells(torch.from_numpy(qt), stacked.boundaries)
    np.testing.assert_array_equal(got_cells.numpy(), want_cells)
    want_t = np.asarray(jdp.adc_table_batch(
        jnp.asarray(qt), jstack.boundaries[None], jstack.cells[None]))
    got_t = dataplane.adc_table_batch(torch.from_numpy(qt),
                                      stacked.boundaries[None],
                                      stacked.cells[None])
    np.testing.assert_array_equal(got_t.numpy(), want_t)


def test_stage_counts_equal_reference(built):
    _, ref, port = built
    n_cand = np.array([[0, 1, 7, 64, 65, 500, 3000]], dtype=np.int32)
    for k in (5, 10, 50):
        want = jdp.stage_counts(n_cand, ref.config, k)
        got = dataplane.stage_counts(n_cand, port.config, k)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert dataplane.static_counts(3000, port.config, k) == \
            jdp.static_counts(3000, ref.config, k)


def test_pow2_bucketing_keeps_ids(built):
    """Q=5 pads to the Q=8 bucket: padded rows are dead and sliced off."""
    ds, _, port = built
    preds = _preds(jsyn.default_predicates())
    ids5, _, _ = port.search(ds.queries[:5], preds, k=10, backend="torch",
                             device="cpu")
    ids8, _, _ = port.search(ds.queries[:8], preds, k=10, backend="torch",
                             device="cpu")
    np.testing.assert_array_equal(ids5, ids8[:5])


def test_synthetic_predicates_match_reference():
    assert _preds(jsyn.default_predicates()) == synthetic.default_predicates()
