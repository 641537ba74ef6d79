"""The port's kernel twins against the JAX package's kernels.

Inputs come from numpy with a seed and go through both packages. The JAX
side runs its Pallas kernels in interpret mode and its jnp oracles; the
torch side runs the plain versions that ``kernels.ops`` dispatches CPU
tensors to. Tolerances: Hamming exact (integer sums); ADC ``rtol=1e-6``
(f32 sums of ≤ d non-negative terms, in another order). The CUDA kernels
themselves are held against these plain versions in
``tests/test_torch_cuda.py`` (on a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dataplane as jdp  # noqa: E402
from repro.kernels import adc_lookup as jadc  # noqa: E402
from repro.kernels import hamming as jham  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dataplane  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ADC_RTOL_JAX = 1e-6


def _words(rng, shape):
    """Random uint32 words, high bit included, as numpy uint32."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[0] = 0xFFFFFFFF
    return w


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _tables(rng, b, m1, d):
    t = rng.exponential(size=(b, m1, d)).astype(np.float32)
    t[:, 0, :] = 0.0
    return t


def _direct_inputs(rng, qn, p, n_max, s, d, m1, dtype=np.float64):
    """Quantizer-shaped boundaries (+inf padded) and codes within each dim's
    cells, queries inside the data range, survivors ``sel`` per pair."""
    cells = rng.integers(1, m1, size=(p, d))
    bnd = np.full((p, m1, d), np.inf)
    for pi in range(p):
        for j in range(d):
            c = cells[pi, j]
            inner = np.sort(rng.normal(size=c - 1))
            bnd[pi, 0, j] = -np.inf
            bnd[pi, 1:c, j] = inner
            bnd[pi, c, j] = np.inf
    codes = (rng.random((p, n_max, d)) * cells[:, None, :]).astype(np.int32)
    qt = rng.normal(size=(qn, p, d)).astype(dtype)
    sel = np.stack([np.stack([rng.choice(n_max, size=s, replace=False)
                              for _ in range(p)]) for _ in range(qn)])
    return qt, bnd.astype(dtype), codes, sel.astype(np.int64)


# ------------------------------------------------------------ Hamming (1, 3)

@pytest.mark.parametrize("qn,p,n,g", [(3, 2, 37, 4), (9, 1, 513, 1),
                                      (5, 3, 100, 3)])
def test_hamming_stacked_ref_equals_jax(qn, p, n, g):
    rng = np.random.default_rng(qn * 100 + n)
    q, db = _words(rng, (qn, p, g)), _words(rng, (p, n, g))
    want = np.asarray(jham.packed_hamming_stacked(
        jnp.asarray(q), jnp.asarray(db), interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jref.hamming_stacked_ref(jnp.asarray(q),
                                                  jnp.asarray(db))))
    got = ref.hamming_stacked_ref(_t(q), _t(db))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.hamming_stacked(_t(q), _t(db)).numpy(),
                                  want)


def test_hamming_single_query_view_equals_jax():
    rng = np.random.default_rng(3)
    q, db = _words(rng, (4,)), _words(rng, (77, 4))
    want = np.asarray(jham.packed_hamming(jnp.asarray(q), jnp.asarray(db),
                                          interpret=True))
    np.testing.assert_array_equal(ref.hamming_ref(_t(q), _t(db)).numpy(), want)
    np.testing.assert_array_equal(
        ops.hamming_distances(_t(q), _t(db)).numpy(), want)


def test_popcount32_all_bit_patterns():
    vals = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xF0F0F0F0,
                     0x7FFFFFFF, 0x12345678], dtype=np.uint32)
    want = [bin(int(v)).count("1") for v in vals]
    assert ref.popcount32(_t(vals)).tolist() == want


# ---------------------------------------------------------------- ADC (2, 4)

@pytest.mark.parametrize("sqrt", [True, False])
@pytest.mark.parametrize("b,m1,n,d", [(3, 9, 37, 20), (2, 33, 300, 128),
                                      (1, 5, 1, 3)])
def test_adc_batch_ref_equals_jax(b, m1, n, d, sqrt):
    rng = np.random.default_rng(b * 1000 + n + d)
    tables = _tables(rng, b, m1, d)
    codes = rng.integers(0, m1, size=(b, n, d)).astype(np.int32)
    want = np.asarray(jadc.adc_lb_distances_batch(
        jnp.asarray(tables), jnp.asarray(codes), interpret=True, sqrt=sqrt))
    got = ref.adc_lb_batch_ref(torch.from_numpy(tables),
                               torch.from_numpy(codes), sqrt=sqrt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=ADC_RTOL_JAX, atol=0)
    via_ops = ops.adc_batch(torch.from_numpy(tables), torch.from_numpy(codes),
                            sqrt=sqrt)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


@pytest.mark.parametrize("sqrt", [True, False])
def test_adc_single_table_view_equals_jax(sqrt):
    rng = np.random.default_rng(11)
    table = _tables(rng, 1, 17, 24)[0]
    codes = rng.integers(0, 17, size=(45, 24)).astype(np.int32)
    want = np.asarray(jadc.adc_lb_distances(
        jnp.asarray(table), jnp.asarray(codes), interpret=True, sqrt=sqrt))
    np.testing.assert_allclose(
        ref.adc_lb_ref(torch.from_numpy(table), torch.from_numpy(codes),
                       sqrt=sqrt).numpy(), want, rtol=ADC_RTOL_JAX, atol=0)
    np.testing.assert_allclose(
        ops.adc_distances(torch.from_numpy(table), torch.from_numpy(codes),
                          sqrt=sqrt).numpy(), want, rtol=ADC_RTOL_JAX, atol=0)


# ------------------------------------------------------------- ADC direct (2b)

def _keep(rng, qn, p, s, pattern):
    """Live counts per (query, partition): random in [0, S] with some pairs
    dead (keep = 0) and some whole (keep = S), or all of one kind."""
    if pattern == "dead":
        return np.zeros((qn, p), np.int32)
    if pattern == "whole":
        return np.full((qn, p), s, np.int32)
    keep = rng.integers(0, s + 1, size=(qn, p)).astype(np.int32)
    keep[0, 0], keep[-1, -1] = 0, s
    return keep


@pytest.mark.parametrize("pattern", ["mixed", "dead", "whole"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_adc_direct_ref_equals_jax(dtype, pattern):
    """Live slots equal the JAX package's ``adc_lb_direct``; dead slots
    (s ≥ keep) are +inf."""
    _check_direct_ref(dtype, pattern, d=10)


@pytest.mark.parametrize("pattern", ["mixed", "dead", "whole"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_adc_direct_ref_equals_jax_at_embedding_width(dtype, pattern):
    """The same at d = 3,072, an LM embedding's width (the RAG index's),
    where the CUDA kernel's shared memory once outgrew a block."""
    _check_direct_ref(dtype, pattern, d=3072)


def _check_direct_ref(dtype, pattern, d):
    rng = np.random.default_rng(21)
    qt, bnd, codes, sel = _direct_inputs(rng, qn=4, p=3, n_max=50, s=12,
                                         d=d, m1=17, dtype=dtype)
    keep = _keep(rng, 4, 3, 12, pattern)
    qcell = np.asarray(jdp.query_cells(jnp.asarray(qt), jnp.asarray(bnd)))
    kept = codes[np.arange(3)[None, :, None], sel]          # (Q, P, S, d)
    want = np.asarray(jdp.adc_lb_direct(jnp.asarray(qt), jnp.asarray(qcell),
                                        jnp.asarray(bnd), jnp.asarray(kept)))
    tq, tb = torch.from_numpy(qt), torch.from_numpy(bnd)
    tcell = dataplane.query_cells(tq, tb)
    np.testing.assert_array_equal(tcell.numpy(), qcell)
    args = (tq, tcell, tb, torch.from_numpy(codes), torch.from_numpy(sel),
            torch.from_numpy(keep))
    got = ref.adc_direct_ref(*args)
    assert got.dtype == torch.float32
    live = np.arange(12)[None, None, :] < keep[:, :, None]
    np.testing.assert_allclose(got.numpy()[live], want[live],
                               rtol=ADC_RTOL_JAX, atol=0)
    assert np.all(np.isposinf(got.numpy()[~live]))
    twin = dataplane.adc_lb_direct(tq, tcell, tb, torch.from_numpy(kept))
    np.testing.assert_array_equal(twin.numpy()[live], got.numpy()[live])
    np.testing.assert_array_equal(ops.adc_direct(*args).numpy(), got.numpy())


def test_cpu_dispatch_launches_no_kernel():
    rng = np.random.default_rng(5)
    before = ops.launch_counts()
    q, db = _words(rng, (2, 2, 4)), _words(rng, (2, 9, 4))
    ops.hamming_stacked(_t(q), _t(db))
    tables = _tables(rng, 2, 5, 4)
    ops.adc_batch(torch.from_numpy(tables),
                  torch.zeros((2, 3, 4), dtype=torch.int32))
    ops.adc_table(torch.from_numpy(tables).reshape(1, 2, 5, 4),
                  torch.zeros((2, 7, 4), dtype=torch.int32),
                  torch.zeros((1, 2, 3), dtype=torch.int64),
                  torch.tensor([[1, 3]], dtype=torch.int32))
    assert ops.launch_counts() == before


def test_adc_direct_shared_memory_guard_names_the_sizes():
    """Kernel 2b's wrapper refuses, before the launch, a size whose block
    would need more shared memory than an H100 block has; it names d,
    M+1 and the limit. (What the card's library asks for at each size is
    held on the card: its rows are staged a chunk at a time, so it does
    not grow with d.)"""
    from repro_torch.kernels import adc_lookup

    adc_lookup.check_direct_smem(adc_lookup.SMEM_LIMIT, 257, 3072)
    with pytest.raises(ValueError, match=r"d=3072, M\+1=257.*232448"):
        adc_lookup.check_direct_smem(adc_lookup.SMEM_LIMIT + 1, 257, 3072)
