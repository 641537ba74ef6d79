"""The port's index build, host modules, dataset and service against the
JAX package.

* ``SquashIndex.build`` on the same data and seed gives arrays **equal** to
  the reference's, array for array (partitioning, KLT, quantizers, codes,
  packed segments, low-bit index, attribute index), at the default
  ``max_bits_per_dim`` and at 5;
* the port's numpy backend equals the reference's numpy backend;
* the torch versions of the reference's jnp helpers (segment extraction,
  Hamming distances and prune, filter mask, ADC lookups) equal them;
* the autotune profile equals the reference's, and the torch plane under it
  equals the numpy plane;
* the chunked ``make_vector_dataset`` equals the reference's bit for bit;
* the service routes ``numpy | torch | serverless | auto`` and rejects
  unknown backends.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import adc as jadc  # noqa: E402
from repro.core import attributes as jattr  # noqa: E402
from repro.core import autotune as jauto  # noqa: E402
from repro.core import lowbit as jlow  # noqa: E402
from repro.core import segments as jseg  # noqa: E402
from repro.core.pipeline import SquashConfig as JConfig  # noqa: E402
from repro.core.pipeline import SquashIndex as JIndex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import adc, attributes, autotune, lowbit, segments  # noqa: E402
from repro_torch.core.attributes import Predicate  # noqa: E402
from repro_torch.core.pipeline import (SquashConfig, SquashIndex,  # noqa: E402
                                       index_from_arrays, index_to_arrays)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serve import ServiceConfig, VectorSearchService  # noqa: E402

BUILDS = {
    "bits5": dict(scale=0.008, cfg=dict(num_partitions=6, kmeans_iters=4,
                                        lloyd_iters=6, max_bits_per_dim=5)),
    "default": dict(scale=0.002, cfg=dict(num_partitions=4, kmeans_iters=3,
                                          lloyd_iters=4)),
}


@pytest.fixture(scope="module")
def data():
    ds = jsyn.make_vector_dataset("sift1m", scale=0.008, num_queries=16,
                                  seed=5)
    return ds, jsyn.default_predicates()


@pytest.fixture(scope="module", params=sorted(BUILDS))
def both_builds(request):
    spec = BUILDS[request.param]
    ds = jsyn.make_vector_dataset("sift1m", scale=spec["scale"],
                                  num_queries=8, seed=3)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**spec["cfg"]),
                       seed=3)
    port = SquashIndex.build(ds.vectors, ds.attributes,
                             SquashConfig(**spec["cfg"]), seed=3)
    return ds, ref, port


@pytest.fixture(scope="module")
def carried(data):
    ds, _ = data
    cfg = dict(num_partitions=5, kmeans_iters=4, lloyd_iters=6,
               max_bits_per_dim=6)
    ref = JIndex.build(ds.vectors, ds.attributes, JConfig(**cfg), seed=9)
    return ref, index_from_arrays(index_to_arrays(ref), SquashConfig(**cfg))


def _preds(jpreds):
    return [Predicate(**dataclasses.asdict(p)) for p in jpreds]


# ------------------------------------------------------------------- build

def test_build_equals_reference_array_for_array(both_builds):
    _, ref, port = both_builds
    want, got = index_to_arrays(ref), index_to_arrays(port)
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for pr, pp in zip(ref.parts, port.parts):
        assert pp.layout.plans == tuple(
            tuple(segments.Piece(**dataclasses.asdict(pc)) for pc in plan)
            for plan in pr.layout.plans)
    assert port.index_bytes() == ref.index_bytes()


def test_build_numpy_backend_equals_reference(both_builds):
    ds, ref, port = both_builds
    preds = jsyn.default_predicates()
    ids_r, d_r, s_r = ref.search(ds.queries, preds, k=10, backend="numpy")
    ids_p, d_p, s_p = port.search(ds.queries, _preds(preds), k=10,
                                  backend="numpy")
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(d_p, d_r)
    assert dataclasses.asdict(s_p) == dataclasses.asdict(s_r)


def test_arrays_round_trip(carried):
    _, port = carried
    again = index_to_arrays(index_from_arrays(index_to_arrays(port),
                                              port.config))
    for name, arr in index_to_arrays(port).items():
        np.testing.assert_array_equal(again[name], arr, err_msg=name)


# -------------------------------------------- torch twins of jnp helpers

def test_segments_extract_equals_reference(carried):
    ref, port = carried
    for pr, pp in zip(ref.parts, port.parts):
        want = np.asarray(jseg.extract_all(pr.packed, pr.layout))
        got = segments.extract_all(pp.packed, pp.layout)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), pp.codes)
        j = int(np.argmax(pp.quant.bits))
        np.testing.assert_array_equal(
            segments.extract_dim(torch.from_numpy(pp.packed), pp.layout,
                                 j).numpy(),
            np.asarray(jseg.extract_dim(pr.packed, pr.layout, j)))


@pytest.mark.parametrize("seg_bits", [16, 32])
def test_segments_wide_words_equal_reference(seg_bits):
    rng = np.random.default_rng(seg_bits)
    bits = rng.integers(0, 13, size=24)
    layout = segments.build_layout(bits, seg_bits=seg_bits)
    codes = (rng.random((50, 24)) * (1 << bits)).astype(np.int64)
    packed = segments.pack_codes(layout, codes)
    jlayout = jseg.build_layout(bits, seg_bits=seg_bits)
    np.testing.assert_array_equal(packed, jseg.pack_codes(jlayout, codes))
    want = np.asarray(jseg.extract_all(packed, jlayout))
    np.testing.assert_array_equal(
        segments.extract_all(packed, layout).numpy(), want)
    if seg_bits == 32:                  # int32 bit patterns of uint32 words
        as_int = torch.from_numpy(packed.view(np.int32))
        np.testing.assert_array_equal(
            segments.extract_all(as_int, layout).numpy(), want)


def test_lowbit_hamming_and_prune_equal_reference(carried):
    ref, port = carried
    pr, pp = ref.parts[0], port.parts[0]
    q = pr.low.encode_queries(pr.vectors[:1] - pr.mean + 0.01)[0]
    want = np.asarray(jlow.hamming_distances(jnp.asarray(q),
                                             jnp.asarray(pr.low.packed)))
    got = lowbit.hamming_distances(q, pp.low.packed)
    np.testing.assert_array_equal(got.numpy(), want)
    mask = np.arange(pp.size) % 3 != 0
    keep = 25
    want_idx, want_d = jlow.hamming_prune(jnp.asarray(q),
                                          jnp.asarray(pr.low.packed),
                                          jnp.asarray(mask), keep)
    got_idx, got_d = lowbit.hamming_prune(q, pp.low.packed, mask, keep)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_filter_mask_equals_reference(carried, data):
    ref, port = carried
    _, jpreds = data
    r = jattr.build_r_lookup(ref.attr_index, jpreds)
    np.testing.assert_array_equal(
        attributes.build_r_lookup(port.attr_index, _preds(jpreds)), r)
    want = np.asarray(jattr.filter_mask(r, ref.attr_index.codes))
    got = attributes.filter_mask(r, port.attr_index.codes)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_adc_lookups_equal_reference(carried):
    ref, port = carried
    pr, pp = ref.parts[1], port.parts[1]
    qt = pr.transform(pr.vectors[3] + 0.05)
    table = jadc.build_adc_table(qt, pr.quant.boundaries, pr.quant.cells)
    np.testing.assert_array_equal(
        adc.build_adc_table(qt, pp.quant.boundaries, pp.quant.cells), table)
    safe = np.where(np.isfinite(table), table, 0.0)
    codes = pp.codes[:40]
    want = np.asarray(jadc.lb_distances(jnp.asarray(safe), jnp.asarray(codes)))
    np.testing.assert_allclose(adc.lb_distances(safe, codes).numpy(), want,
                               rtol=1e-6)
    want1 = np.asarray(jadc.lb_distances_onehot(jnp.asarray(table),
                                                jnp.asarray(codes)))
    np.testing.assert_allclose(adc.lb_distances_onehot(table, codes).numpy(),
                               want1, rtol=1e-6)


# ---------------------------------------------------------------- autotune

def test_autotune_profile_equals_reference(carried, data):
    ref, port = carried
    ds, jpreds = data
    want = jauto.calibrate(ref, sample=12, seed=4)
    got = autotune.calibrate(port, sample=12, seed=4)
    assert got.to_dict() == want.to_dict()
    port.set_profile(got)
    try:
        torch.set_default_dtype(torch.float64)
        ids_t, _, s_t = port.search(ds.queries, _preds(jpreds), k=10,
                                    backend="torch", device="cpu")
        ids_n, _, s_n = port.search(ds.queries, _preds(jpreds), k=10,
                                    backend="numpy")
    finally:
        torch.set_default_dtype(torch.float32)
        port.set_profile(None)
    np.testing.assert_array_equal(ids_t, ids_n)
    assert s_t == s_n


# ------------------------------------------------------------------ dataset

def test_chunked_dataset_equals_reference(monkeypatch):
    monkeypatch.setattr(synthetic, "_ROW_CHUNK", 700)     # several chunks
    got = synthetic.make_vector_dataset("sift1m", scale=0.002,
                                        num_queries=30, seed=2)
    want = jsyn.make_vector_dataset("sift1m", scale=0.002, num_queries=30,
                                    seed=2)
    for field in ("vectors", "attributes", "queries"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=field)
    gt_got = synthetic.ground_truth(got, synthetic.default_predicates(), k=5)
    gt_want = jsyn.ground_truth(want, jsyn.default_predicates(), k=5)
    np.testing.assert_array_equal(gt_got[0], gt_want[0])


# ------------------------------------------------------------------ service

def test_service_routes_and_rejects(carried, data):
    _, port = carried
    ds, jpreds = data
    preds = _preds(jpreds)
    svc = VectorSearchService(port, ServiceConfig(backend="auto",
                                                  device="cpu"))
    assert svc.resolve_backend(1) == "numpy"
    assert svc.resolve_backend(64) == "torch"
    ids_b, _, _ = svc.query(ds.queries[:8], preds)            # auto → torch
    ids_1, _, _ = svc.query(ds.queries[:1], preds)            # auto → numpy
    assert svc.queries_served == {"numpy": 1, "torch": 8, "serverless": 0}
    ids_ref, _, _ = port.search(ds.queries[:8], preds, k=10, backend="numpy")
    np.testing.assert_array_equal(ids_b, ids_ref)
    np.testing.assert_array_equal(ids_1, ids_ref[:1])
    ids_t, _, _ = svc.query(ds.queries[:2], preds, backend="torch")
    np.testing.assert_array_equal(ids_t, ids_ref[:2])
    assert svc.stats.queries == 11 and svc.requests == 3
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        svc.query(ds.queries[:2], preds, backend="jax")
    ids_s, _, _ = svc.query(ds.queries[:2], preds, backend="serverless")
    np.testing.assert_array_equal(ids_s, ids_ref[:2])
    assert svc.requests == 4 and svc.queries_served["serverless"] == 2
    svc.close()
    with pytest.raises(ValueError):
        VectorSearchService(port, ServiceConfig(backend="jax"))
