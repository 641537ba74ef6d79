"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). The file imports neither jax nor the JAX package, so it
also runs where those are not installed; on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: Hamming and segment extraction exact (integer arithmetic);
ADC ``rtol=1e-5, atol=0`` (and +inf exactly on the dead slots of the
kernels that take ``keep``) — f32 sums of ≤ d non-negative terms added in
another order (the kernels add over ascending d, ``torch.sum`` in its own
order), as ``chip_smoke.py`` states; SSD intra-chunk ``rtol=1e-4`` and
``atol=1e-5 · max |y|`` — f32 sums of up to lc · N products and of
cumulative sums taken in another order than the plain version's einsums.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dataplane, distributed  # noqa: E402
from repro_torch.core.pipeline import SquashConfig, SquashIndex  # noqa: E402
from repro_torch.core import segments  # noqa: E402
from repro_torch.kernels import adc_lookup, bitpack, hamming, ops, ref, ssd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serverless import RuntimeConfig, ServerlessRuntime  # noqa: E402

ADC_RTOL = 1e-5
SSD_RTOL, SSD_ATOL_SCALE = 1e-4, 1e-5

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
                                      (2, 129, 300, 128), (2, 257, 50, 128),
                                      # a table past shared memory: via L2
                                      (2, 257, 60, 256)])
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


def _keep(rng, qn, p, s, pattern):
    """Live counts per pair: random in [0, S] with dead pairs (keep = 0)
    and whole ones (keep = S), or all of one kind."""
    if pattern == "dead":
        return np.zeros((qn, p), np.int32)
    if pattern == "whole":
        return np.full((qn, p), s, np.int32)
    keep = rng.integers(0, s + 1, size=(qn, p)).astype(np.int32)
    keep[0, :], keep[-1, -1] = 0, s
    return keep


@pytest.mark.parametrize("pattern", ["mixed", "dead", "whole"])
@pytest.mark.parametrize("m1", [9, 33, 129])
@pytest.mark.parametrize("d", [10, 128, 160])
def test_adc_table_sel_kernel_equals_plain(cuda, m1, d, pattern):
    """Kernel 2 reading survivors through sel from the stacked codes:
    live slots within rtol 1e-5 of the plain version, +inf exactly on the
    dead ones (d = 10: the scalar code path; codes past [0, M] clamp)."""
    rng = np.random.default_rng(m1 + d)
    qn, p, n_max, s = 5, 3, 400, 150
    tables = rng.exponential(size=(qn, p, m1, d)).astype(np.float32)
    codes = rng.integers(0, m1, size=(p, n_max, d)).astype(np.int32)
    sel = np.stack([np.stack([rng.choice(n_max, size=s, replace=False)
                              for _ in range(p)]) for _ in range(qn)])
    keep = _keep(rng, qn, p, s, pattern)
    tables, codes, sel, keep = (torch.from_numpy(a).to(cuda) for a in (
        tables, codes, sel.astype(np.int64), keep))
    before = adc_lookup.batch_launches
    dead = torch.arange(s, device=cuda)[None, None, :] >= keep[:, :, None]
    for sqrt in (True, False):
        got = ops.adc_table(tables, codes, sel, keep, sqrt=sqrt)
        assert torch.equal(torch.isposinf(got), dead)
        torch.testing.assert_close(
            got, ref.adc_table_ref(tables, codes, sel, keep, sqrt=sqrt),
            rtol=ADC_RTOL, atol=0)
    assert adc_lookup.batch_launches == before + 2
    wide = codes.clone()
    wide[0, :, 0] = m1 + 5                      # codes outside [0, M] read
    wide[1, :, -1] = -3                         # the nearest table row
    clamped = wide.clamp(0, m1 - 1)
    torch.testing.assert_close(
        ops.adc_table(tables, wide, sel, keep),
        ref.adc_table_ref(tables, clamped, sel, keep), rtol=ADC_RTOL, atol=0)


@pytest.mark.parametrize("pattern", ["mixed", "dead", "whole"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
# d = 160: f32 boundaries too large for shared memory (read through L2)
@pytest.mark.parametrize("d", [128, 10, 160])
def test_adc_direct_kernel_equals_plain(cuda, dtype, d, pattern):
    rng = np.random.default_rng(d)
    qt, bnd, codes, sel = _direct_inputs(rng, qn=5, p=3, n_max=400, s=150,
                                         d=d, m1=257, dtype=dtype)
    keep = _keep(rng, 5, 3, 150, pattern)
    qt, bnd, codes, sel, keep = (torch.from_numpy(a).to(cuda)
                                 for a in (qt, bnd, codes, sel, keep))
    qcell = dataplane.query_cells(qt, bnd)
    before = adc_lookup.direct_launches
    got = ops.adc_direct(qt, qcell, bnd, codes, sel, keep)
    assert adc_lookup.direct_launches == before + 1
    want = ref.adc_direct_ref(qt, qcell, bnd, codes, sel, keep)
    dead = torch.arange(150, device=cuda)[None, None, :] >= keep[:, :, None]
    assert torch.equal(torch.isposinf(got), dead)
    torch.testing.assert_close(got, want, rtol=ADC_RTOL, atol=0)


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
    c = torch.zeros((1, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="unit stride"):
        ssd.ssd_intra(c[..., ::2], c[..., ::2], torch.zeros((1, 2, 8), device=cuda),
                      torch.zeros((1, 2, 8, 4), device=cuda))


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


@pytest.mark.parametrize("max_bits", [8, 5])
def test_serverless_runtime_on_card_equals_cpu(cuda, max_bits):
    """A local serverless runtime with its QPs on the card: f64 ids, stats
    and pinned modeled makespan equal the same runtime on the CPU, and each
    QP invocation went through the kernels of its Stage 4 branch."""
    rng = np.random.default_rng(max_bits + 1)
    centers = rng.normal(0, 5, size=(8, 32))
    vecs = centers[rng.integers(0, 8, 4000)] + rng.normal(size=(4000, 32))
    attrs = rng.integers(0, 4, size=(4000, 2)).astype(np.float64)
    index = SquashIndex.build(vecs, attrs, SquashConfig(
        num_partitions=4, kmeans_iters=3, lloyd_iters=4,
        max_bits_per_dim=max_bits))
    queries = vecs[:20] + rng.normal(scale=0.1, size=(20, 32))
    kw = dict(branching=2, max_level=2, qa_compute_s=0.05, qp_compute_s=0.05,
              co_compute_s=0.01)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ops.reset_launch_counts()
        card = ServerlessRuntime(index, RuntimeConfig(**kw)).search(
            queries, [], k=10)
        counts = ops.launch_counts()
        cpu = ServerlessRuntime(index, RuntimeConfig(device="cpu", **kw)
                                ).search(queries, [], k=10)
    finally:
        torch.set_default_dtype(prev)
    np.testing.assert_array_equal(card.ids, cpu.ids)
    assert card.stats == cpu.stats
    assert card.trace.makespan_s == cpu.trace.makespan_s
    n_qp = card.trace.invocations("qp")
    m1 = max(p.quant.boundaries.shape[0] for p in index.parts)
    table = m1 <= dataplane.ADC_TABLE_MAX_M1
    assert n_qp > 0 and counts["hamming_stacked"] == n_qp
    assert counts["adc_batch" if table else "adc_direct"] == n_qp


def _small_index(seed, max_bits, parts):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, size=(8, 32))
    vecs = centers[rng.integers(0, 8, 4000)] + rng.normal(size=(4000, 32))
    attrs = rng.integers(0, 4, size=(4000, 2)).astype(np.float64)
    index = SquashIndex.build(vecs, attrs, SquashConfig(
        num_partitions=parts, kmeans_iters=3, lloyd_iters=4,
        max_bits_per_dim=max_bits))
    return index, vecs[:20] + rng.normal(scale=0.1, size=(20, 32))


def test_socket_fleet_on_card_equals_local(cuda):
    """Two QP links on the card behind auto-spawned loopback hosts: f64 ids
    and stats equal the local runtime's on the card, every QP node names
    its host, and the warm batch fetches nothing."""
    index, queries = _small_index(7, 8, 2)
    kw = dict(branching=2, max_level=1, qa_workers=1)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        local = ServerlessRuntime(index, RuntimeConfig(**kw)).search(
            queries, [], k=10)
        rt = ServerlessRuntime(index, RuntimeConfig(transport="socket", **kw))
        try:
            cold = rt.search(queries, [], k=10)
            warm = rt.search(queries, [], k=10)
        finally:
            rt.close()
    finally:
        torch.set_default_dtype(prev)
    for res in (cold, warm):
        np.testing.assert_array_equal(res.ids, local.ids)
        assert res.stats == local.stats
        assert all(n.worker_host for n in res.trace.nodes if n.kind == "qp")
    assert warm.trace.dre.s3_gets == 0


def test_mesh_one_by_one_nccl_equals_torch_backend(cuda):
    """``distributed_search`` on a 1 × 1 NCCL mesh: f64 ids and dists equal
    the torch backend's, through kernels 1 and 2b (M+1 = 257)."""
    from torch.distributed.device_mesh import init_device_mesh

    index, queries = _small_index(8, 8, 3)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        ops.reset_launch_counts()
        ids, dists = distributed.distributed_search(index, queries, [], 10,
                                                    mesh=mesh)
        counts = ops.launch_counts()
        ids_t, d_t, _ = index.search(queries, [], k=10, backend="torch")
    finally:
        torch.set_default_dtype(prev)
        torch.distributed.destroy_process_group()
    np.testing.assert_array_equal(ids, ids_t)
    np.testing.assert_array_equal(dists, d_t)
    assert counts["hamming_stacked"] == 1 and counts["adc_direct"] == 1


@pytest.mark.parametrize("seg_bits,bits,n", [
    (8, [4] * 128, 3000),                  # the index's shape: b = 4d, S = 8
    (8, [3, 9, 1, 7, 12, 0, 5], 777),
    (16, [12, 16, 2, 9, 0, 11], 1000),
    (32, [16, 16, 31, 1, 7, 32], 513),     # words with the top bit set
    (8, [4] * 128, 1),                     # one row
    (8, [5, 3] * 64, 1000),                # rows not a multiple of the tile
    (8, [2] + [12] * 127, 300),            # 3 pieces in a dim (registers)
    (8, [1] + [32] * 40, 200),             # 5 pieces: the plan in shared memory
    (8, [3, 9, 1, 7, 12, 0, 5, 4, 6, 9], 901),  # G = 7: rows not 16-B aligned
    (16, [7] * 1100, 97),                  # d > 1024: plan in shared memory
])
def test_extract_kernel_equals_plain(cuda, seg_bits, bits, n):
    rng = np.random.default_rng(n)
    codes = np.stack([rng.integers(0, 1 << b, size=n) if b
                      else np.zeros(n, np.int64) for b in bits], axis=1)
    layout = segments.build_layout(bits, seg_bits=seg_bits)
    packed = segments.pack_codes(layout, codes)
    if packed.dtype == np.uint32:
        packed = packed.view(np.int32)
    seg = torch.from_numpy(packed).to(cuda)
    before = bitpack.launches
    got = ops.extract_codes(seg, layout)
    assert bitpack.launches == before + 1
    assert torch.equal(got, ref.extract_ref(seg, layout))
    # int32 out, as the TPU kernel: a 32-bit code keeps its bit pattern.
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  codes.astype(np.uint32).view(np.int32))


def _ssd_inputs(rng, g, h, lc, n, p, da_scale, device):
    arrays = (rng.normal(size=(g, lc, n)), rng.normal(size=(g, lc, n)),
              -da_scale * rng.exponential(size=(g, h, lc)),
              rng.normal(size=(g, h, lc, p)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def _far_tiles(c_mat, b_mat, da, x, tile=64):
    """The plain output's part from s-tiles two or more tiles behind the
    l-tile: what a kernel that skipped them would miss."""
    lc = da.shape[-1]
    t = torch.arange(lc, device=da.device) // tile
    far = (t[:, None] - t[None, :]) >= 2
    cs = torch.cumsum(da, dim=-1)
    decay = torch.exp(torch.where(far, cs[..., :, None] - cs[..., None, :], 0))
    decay = torch.where(far, decay, 0)
    scores = torch.einsum("gln,gsn->gls", c_mat, b_mat)
    return torch.einsum("gls,ghls,ghsp->ghlp", scores, decay, x)


@pytest.mark.parametrize("g,h,lc,n,p,da_scale", [
    (2, 2, 16, 8, 8, 1.0), (1, 4, 32, 16, 8, 1.0), (3, 1, 64, 128, 64, 1.0),
    (2, 3, 8, 4, 4, 1.0),
    (2, 5, 256, 128, 64, 1.0),             # mamba2-370m's chunk; 5 heads
    (1, 3, 200, 24, 80, 1.0),              # ragged row and column tiles
    (2, 9, 70, 6, 10, 1.0),                # N, P not multiples of 4
    # The LM serve prefill's shape with slow decay (small dt, as trained
    # models run): every s-tile behind an l-tile carries weight.
    (64, 32, 256, 128, 64, 1e-3),
])
def test_ssd_intra_kernel_equals_plain(cuda, g, h, lc, n, p, da_scale):
    args = _ssd_inputs(np.random.default_rng(lc + n), g, h, lc, n, p,
                       da_scale, cuda)
    before = ssd.launches
    got = ops.ssd_intra(*args)
    assert ssd.launches == before + 1
    want = ref.ssd_intra_ref(*args)
    assert torch.isfinite(got).all()
    atol = SSD_ATOL_SCALE * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=SSD_RTOL, atol=atol)
    if da_scale < 1:
        assert float(_far_tiles(*args).abs().max()) > 1e3 * atol


@pytest.mark.parametrize("g,h,lc,n,p", [(4, 32, 256, 128, 64),
                                         (3, 5, 200, 24, 64)])
@pytest.mark.parametrize("da_scale", [1.0, 1e-3])
def test_ssd_intra_kernel_on_strided_views_equals_plain(cuda, g, h, lc, n, p,
                                                        da_scale):
    """The model's layout: C and B slices of one conv stream, da and x with
    the heads innermost; the output's storage is (G, lc, H, P)."""
    rng = np.random.default_rng(lc + h)
    d_inner = h * p
    conv = torch.from_numpy(rng.normal(size=(g, lc, d_inner + 2 * n))
                            .astype(np.float32)).to(cuda)
    da = torch.from_numpy((-da_scale * rng.exponential(size=(g, lc, h)))
                          .astype(np.float32)).to(cuda).transpose(1, 2)
    x = torch.from_numpy(rng.normal(size=(g, lc, h, p)).astype(np.float32)
                         ).to(cuda).transpose(1, 2)
    args = (conv[..., d_inner + n:], conv[..., d_inner:d_inner + n], da, x)
    before = ssd.launches
    got = ops.ssd_intra(*args)
    assert ssd.launches == before + 1
    assert got.transpose(1, 2).is_contiguous()
    want = ref.ssd_intra_ref(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=SSD_RTOL,
                               atol=SSD_ATOL_SCALE * float(want.abs().max()))
    contiguous = [t.contiguous() for t in args]
    torch.testing.assert_close(ops.ssd_intra(*contiguous), got, rtol=0,
                               atol=0)


def test_ssd_chunked_on_card_equals_cpu(cuda):
    """The chunked scan with the kernel equals the scan on the CPU."""
    rng = np.random.default_rng(7)
    bsz, s, h, p, n, lc = 2, 300, 4, 16, 32, 128
    arrays = [rng.normal(size=(bsz, s, h, p)),
              np.abs(rng.normal(size=(bsz, s, h))) + 0.1,
              -np.abs(rng.normal(size=(h,))) - 0.1,
              rng.normal(size=(bsz, s, n)), rng.normal(size=(bsz, s, n))]
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    before = ssd.launches
    y_c, st_c = ssm.ssd_chunked(*[t.to(cuda) for t in cpu], lc)
    assert ssd.launches == before + 1
    y, st = ssm.ssd_chunked(*cpu, lc)
    torch.testing.assert_close(y_c.cpu(), y, rtol=SSD_RTOL,
                               atol=SSD_ATOL_SCALE * float(y.abs().max()))
    torch.testing.assert_close(st_c.cpu(), st, rtol=SSD_RTOL,
                               atol=SSD_ATOL_SCALE * float(st.abs().max()))
