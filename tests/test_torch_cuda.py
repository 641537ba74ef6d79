"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). The file imports neither jax nor the JAX package, so it
also runs where those are not installed; on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: Hamming exact (integer sums); ADC ``rtol=1e-5, atol=0`` — f32
sums of ≤ d non-negative terms added in another order (the kernels add over
ascending d, ``torch.sum`` in its own order), as ``chip_smoke.py`` states.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dataplane  # noqa: E402
from repro_torch.core.pipeline import SquashConfig, SquashIndex  # noqa: E402
from repro_torch.kernels import adc_lookup, hamming, ops, ref  # noqa: E402

ADC_RTOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, shape, device):
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[0] = 0xFFFFFFFF                       # high bit set
    return torch.from_numpy(w.view(np.int32)).to(device)


def _direct_inputs(rng, qn, p, n_max, s, d, m1, dtype):
    """Quantizer-shaped boundaries (+inf padded), codes within each dim's
    cells, survivors ``sel`` per (query, partition) pair."""
    cells = rng.integers(1, m1, size=(p, d))
    bnd = np.full((p, m1, d), np.inf)
    for pi in range(p):
        for j in range(d):
            c = cells[pi, j]
            bnd[pi, 0, j] = -np.inf
            bnd[pi, 1:c, j] = np.sort(rng.normal(size=c - 1))
    codes = (rng.random((p, n_max, d)) * cells[:, None, :]).astype(np.int32)
    qt = rng.normal(size=(qn, p, d)).astype(dtype)
    sel = np.stack([np.stack([rng.choice(n_max, size=s, replace=False)
                              for _ in range(p)]) for _ in range(qn)])
    return qt, bnd.astype(dtype), codes, sel.astype(np.int64)


@pytest.mark.parametrize("qn,p,n,g", [(3, 2, 37, 4), (17, 3, 1000, 4),
                                      (5, 2, 300, 3), (64, 1, 257, 30)])
def test_hamming_kernel_equals_plain(cuda, qn, p, n, g):
    rng = np.random.default_rng(n)
    q, db = _words(rng, (qn, p, g), cuda), _words(rng, (p, n, g), cuda)
    before = hamming.launches
    got = ops.hamming_stacked(q, db)
    assert hamming.launches == before + 1
    assert torch.equal(got, ref.hamming_stacked_ref(q, db))
    assert torch.equal(ops.hamming_distances(q[0, 0], db[0]),
                       ref.hamming_ref(q[0, 0], db[0]))


@pytest.mark.parametrize("b,m1,n,d", [(3, 9, 37, 20), (4, 33, 700, 128),
                                      (2, 129, 300, 128), (2, 257, 50, 128)])
def test_adc_table_kernel_equals_plain(cuda, b, m1, n, d):
    rng = np.random.default_rng(m1 + n)
    tables = rng.exponential(size=(b, m1, d)).astype(np.float32)
    tables = torch.from_numpy(tables).to(cuda)
    codes = torch.from_numpy(
        rng.integers(0, m1, size=(b, n, d)).astype(np.int32)).to(cuda)
    before = adc_lookup.batch_launches
    for sqrt in (True, False):
        torch.testing.assert_close(
            ops.adc_batch(tables, codes, sqrt=sqrt),
            ref.adc_lb_batch_ref(tables, codes, sqrt=sqrt),
            rtol=ADC_RTOL, atol=0)
    assert adc_lookup.batch_launches == before + 2
    torch.testing.assert_close(
        ops.adc_distances(tables[0], codes[0]),
        ref.adc_lb_ref(tables[0], codes[0]), rtol=ADC_RTOL, atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d", [128, 10])
def test_adc_direct_kernel_equals_plain(cuda, dtype, d):
    rng = np.random.default_rng(d)
    qt, bnd, codes, sel = _direct_inputs(rng, qn=5, p=3, n_max=400, s=150,
                                         d=d, m1=257, dtype=dtype)
    qt, bnd, codes, sel = (torch.from_numpy(a).to(cuda)
                           for a in (qt, bnd, codes, sel))
    qcell = dataplane.query_cells(qt, bnd)
    before = adc_lookup.direct_launches
    got = ops.adc_direct(qt, qcell, bnd, codes, sel)
    assert adc_lookup.direct_launches == before + 1
    torch.testing.assert_close(
        got, ref.adc_direct_ref(qt, qcell, bnd, codes, sel),
        rtol=ADC_RTOL, atol=0)


def test_wrappers_reject_malformed_input(cuda):
    q = torch.zeros((2, 1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        hamming.hamming_stacked(q.to(torch.int64), q)
    with pytest.raises(ValueError, match="contiguous"):
        hamming.hamming_stacked(q, torch.zeros((1, 8, 4), dtype=torch.int32,
                                               device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="shape mismatch"):
        adc_lookup.adc_batch(torch.zeros((2, 3, 4), device=cuda),
                             torch.zeros((1, 5, 4), dtype=torch.int32,
                                         device=cuda))


@pytest.mark.parametrize("max_bits", [8, 5])
def test_search_on_card_equals_numpy(cuda, max_bits):
    """The whole plane on the card: f64 ids equal the numpy backend's, and
    the search went through the kernels of its Stage 4 branch."""
    rng = np.random.default_rng(max_bits)
    centers = rng.normal(0, 5, size=(8, 32))
    vecs = centers[rng.integers(0, 8, 4000)] + rng.normal(size=(4000, 32))
    attrs = rng.integers(0, 4, size=(4000, 2)).astype(np.float64)
    index = SquashIndex.build(vecs, attrs, SquashConfig(
        num_partitions=4, kmeans_iters=3, lloyd_iters=4,
        max_bits_per_dim=max_bits))
    queries = vecs[:20] + rng.normal(scale=0.1, size=(20, 32))
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ops.reset_launch_counts()
        ids_t, _, s_t = index.search(queries, [], k=10, backend="torch")
        counts = ops.launch_counts()
    finally:
        torch.set_default_dtype(prev)
    ids_n, _, s_n = index.search(queries, [], k=10, backend="numpy")
    np.testing.assert_array_equal(ids_t, ids_n)
    assert s_t == s_n
    m1 = max(p.quant.boundaries.shape[0] for p in index.parts)
    table = m1 <= dataplane.ADC_TABLE_MAX_M1
    assert counts["hamming_stacked"] == 1
    assert counts["adc_batch" if table else "adc_direct"] == 1
