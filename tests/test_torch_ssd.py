"""The port's SSD intra-chunk plain version and chunked scan against the JAX
package's, on the CPU.

* ``kernels.ref.ssd_intra_ref`` against the Pallas kernel
  ``ops.ssd_intra(..., interpret=True)`` and ``ref.ssd_intra_ref`` on the
  shapes of ``tests/test_ssd_kernel.py``;
* ``models.ssm.ssd_chunked`` (intra-chunk term through ``ops.ssd_intra``)
  against the reference ``ssd_chunked``: several chunks, S not a multiple
  of the chunk, a non-zero initial state;
* the strided views ``ssd_chunked`` hands to ``ops.ssd_intra`` (B and C
  slices of one conv stream, da and x with the heads innermost): the plain
  version on them against the Pallas kernel on contiguous copies, and
  ``kernels.ssd.kernel_strides`` on them;
* kernel 6's gradient (``ssd.SsdIntraFunction``, the plain forward
  injected): its backward ``ref.ssd_intra_vjp`` against ``jax.vjp`` of the
  reference's ``ssd_intra_ref``, and the whole scan's gradients through it
  against plain autograd (tolerances at the tests).

Tolerances: for the intra-chunk block ``rtol = 1e-5`` and ``atol = 4e-6 ·
max |y|`` — float32 sums of up to lc · N products taken in another order,
whose rounding grows with the outputs' magnitude (|y| reaches ~60 at
N = 128); ``rtol = atol = 1e-4`` for the whole scan, as the reference's
scan-vs-kernel test (the inter-chunk einsums and cumulative sums add
reordered float32 sums).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402

from repro_torch.kernels import ops, ref, ssd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SHAPES = [(2, 2, 16, 8, 8), (1, 4, 32, 16, 8), (3, 1, 64, 128, 64),
          (2, 3, 8, 4, 4)]


def _intra_inputs(g, h, lc, n, p):
    rng = np.random.default_rng(g * 1000 + h)
    c = rng.normal(size=(g, lc, n)).astype(np.float32)
    b = rng.normal(size=(g, lc, n)).astype(np.float32)
    da = (-np.abs(rng.normal(size=(g, h, lc)))).astype(np.float32)
    x = rng.normal(size=(g, h, lc, p)).astype(np.float32)
    return c, b, da, x


@pytest.mark.parametrize("g,h,lc,n,p", SHAPES)
@pytest.mark.parametrize("reference", ["pallas_interpret", "jnp_ref"])
def test_ssd_intra_ref_matches_jax(g, h, lc, n, p, reference):
    arrays = _intra_inputs(g, h, lc, n, p)
    if reference == "pallas_interpret":
        want = jax_ops.ssd_intra(*map(jnp.asarray, arrays), interpret=True)
    else:
        want = jax_ref.ssd_intra_ref(*map(jnp.asarray, arrays))
    got = ref.ssd_intra_ref(*map(torch.from_numpy, arrays))
    assert got.shape == (g, h, lc, p) and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=4e-6 * np.abs(want).max())


def test_ops_ssd_intra_takes_the_plain_version_on_cpu():
    tensors = [torch.from_numpy(a) for a in _intra_inputs(2, 3, 8, 4, 4)]
    before = ops.launch_counts()["ssd_intra"]
    assert torch.equal(ops.ssd_intra(*tensors), ref.ssd_intra_ref(*tensors))
    assert ops.launch_counts()["ssd_intra"] == before


def _scan_inputs(seed, bsz, s, h, p, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bsz, s, h, p)).astype(np.float32),
            (np.abs(rng.normal(size=(bsz, s, h))) + 0.1).astype(np.float32),
            (-np.abs(rng.normal(size=(h,))) - 0.1).astype(np.float32),
            rng.normal(size=(bsz, s, n)).astype(np.float32),
            rng.normal(size=(bsz, s, n)).astype(np.float32))


@pytest.mark.parametrize("s,lc,with_state", [
    (48, 16, False),      # three chunks
    (37, 16, False),      # S not a multiple of the chunk (padded)
    (40, 16, True),       # non-zero initial state
    (12, 64, False),      # one chunk shorter than the chunk length
])
def test_ssd_chunked_matches_jax(s, lc, with_state):
    bsz, h, p, n = 2, 3, 8, 16
    arrays = _scan_inputs(s + lc, bsz, s, h, p, n)
    init = (np.random.default_rng(1).normal(size=(bsz, h, p, n))
            .astype(np.float32) if with_state else None)
    want_y, want_st = jax_ssm.ssd_chunked(
        *map(jnp.asarray, arrays), lc,
        init_state=None if init is None else jnp.asarray(init))
    got_y, got_st = ssm.ssd_chunked(
        *map(torch.from_numpy, arrays), lc,
        init_state=None if init is None else torch.from_numpy(init))
    assert got_y.shape == (bsz, s, h, p) and got_st.shape == (bsz, h, p, n)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               rtol=1e-4, atol=1e-4)


def _chunked_intra_args(monkeypatch, s, lc):
    """The arguments ``ssd_chunked`` hands to ``ops.ssd_intra`` when its B
    and C are slices of one (B, S, d_inner + 2N) conv stream, as in
    ``Mamba2Mixer._mix``; also returns that stream."""
    bsz, h, p, n = 2, 3, 8, 16
    d_inner = h * p
    rng = np.random.default_rng(s + lc)
    xbc = torch.from_numpy(
        rng.normal(size=(bsz, s, d_inner + 2 * n)).astype(np.float32))
    x = xbc[..., :d_inner].reshape(bsz, s, h, p)
    dt = torch.from_numpy(
        (np.abs(rng.normal(size=(bsz, s, h))) + 0.1).astype(np.float32))
    a = torch.from_numpy((-np.abs(rng.normal(size=(h,))) - 0.1)
                         .astype(np.float32))
    seen = []
    plain = ops.ssd_intra

    def spy(*args):
        seen.append(args)
        return plain(*args)

    monkeypatch.setattr(ops, "ssd_intra", spy)
    ssm.ssd_chunked(x, dt, a, xbc[..., d_inner:d_inner + n],
                    xbc[..., d_inner + n:], lc)
    assert len(seen) == 1
    return seen[0], xbc


@pytest.mark.parametrize("s,lc", [(32, 16), (48, 16), (64, 64)])
def test_ssd_intra_ref_on_chunked_views_matches_pallas(monkeypatch, s, lc):
    args, xbc = _chunked_intra_args(monkeypatch, s, lc)
    c_mat, b_mat, da, x = args
    # Views, not copies: C and B read the conv stream itself.
    assert c_mat.data_ptr() == xbc.data_ptr() + 4 * (xbc.shape[-1] - 16)
    assert b_mat.data_ptr() == xbc.data_ptr() + 4 * (xbc.shape[-1] - 32)
    for t in (c_mat, b_mat, da, x):
        assert not t.is_contiguous()
    want = np.asarray(jax_ops.ssd_intra(
        *(jnp.asarray(np.ascontiguousarray(t.numpy())) for t in args),
        interpret=True))
    got = ref.ssd_intra_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=4e-6 * np.abs(want).max())


def test_kernel_strides_of_chunked_views(monkeypatch):
    (c_mat, b_mat, da, x), xbc = _chunked_intra_args(monkeypatch, 48, 16)
    g, h, lc, p = x.shape
    row = xbc.shape[-1]                     # conv channels per position
    out = torch.empty((g, lc, h, p)).transpose(1, 2)   # the wrapper's output
    assert ssd.kernel_strides(c_mat, b_mat, da, x, out) == (
        lc * row, row,                      # C (g, l)
        lc * row, row,                      # B (g, l)
        lc * h, 1, h,                       # da (g, h, l): heads innermost
        lc * h * p, p, h * p,               # x (g, h, l)
        lc * h * p, p, h * p)               # out (g, h, l): (B, S, H, P)


@pytest.mark.parametrize("which", ["c_mat", "b_mat", "x", "out"])
def test_kernel_strides_refuse_non_unit_last_stride(monkeypatch, which):
    args, _ = _chunked_intra_args(monkeypatch, 32, 16)
    named = dict(zip(("c_mat", "b_mat", "da", "x"), args))
    g, h, lc, p = named["x"].shape
    named["out"] = torch.empty((g, lc, h, p)).transpose(1, 2)
    t = named[which]
    named[which] = torch.empty(t.shape[:-1] + (2 * t.shape[-1],))[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        ssd.kernel_strides(**named)


# ------------------------------------------------ the gradient of kernel 6
#
# On the card ``ops.ssd_intra`` runs ``ssd.SsdIntraFunction``: the kernel
# forward, the plain VJP ``ref.ssd_intra_vjp`` backward. Here the Function
# runs with the plain forward injected. Gradient tolerance: rtol 1e-5 and
# atol 1e-5 · the gradient's largest magnitude — float32 sums of up to
# lc · max(N, P) products in another order than jax's, and d(da) a reverse
# cumulative sum of row-less-column sums that cancel.

GRAD_RTOL, GRAD_ATOL_SCALE = 1e-5, 1e-5


@pytest.mark.parametrize("g,h,lc,n,p", SHAPES)
def test_ssd_intra_function_backward_matches_jax_vjp(g, h, lc, n, p):
    arrays = _intra_inputs(g, h, lc, n, p)
    dy = np.random.default_rng(7).normal(size=(g, h, lc, p)).astype(
        np.float32)
    _, vjp = jax.vjp(jax_ref.ssd_intra_ref, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y = ssd.ssd_intra_autograd(*inputs, forward=ref.ssd_intra_ref)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    for name, gt, w in zip(("dC", "dB", "d(da)", "dx"), got, want):
        w = np.asarray(w)
        assert gt.shape == w.shape and gt.dtype == torch.float32
        np.testing.assert_allclose(gt.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * np.abs(w).max(),
                                   err_msg=name)


def test_ssd_intra_function_saves_nothing_under_no_grad():
    tensors = [torch.from_numpy(a).requires_grad_()
               for a in _intra_inputs(2, 3, 8, 4, 4)]
    with torch.no_grad():
        y = ssd.ssd_intra_autograd(*tensors, forward=ref.ssd_intra_ref)
    assert y.grad_fn is None and not y.requires_grad
    assert torch.equal(y, ref.ssd_intra_ref(*tensors).detach())


@pytest.mark.parametrize("s,lc", [(48, 16), (37, 16)])
def test_ssd_chunked_grads_through_the_function(monkeypatch, s, lc):
    """The whole scan's gradients with the intra-chunk term through the
    Function on the strided views ``ssd_chunked`` passes (as on the card)
    equal plain autograd's."""
    bsz, h, p, n = 2, 3, 8, 16
    arrays = _scan_inputs(s + lc, bsz, s, h, p, n)
    dy = np.random.default_rng(3).normal(size=(bsz, s, h, p)).astype(
        np.float32)

    def grads():
        inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
        y, state = ssm.ssd_chunked(*inputs, lc)
        loss = (y * torch.from_numpy(dy)).sum() + state.square().sum()
        return torch.autograd.grad(loss, inputs)

    want = grads()
    plain = ops.ssd_intra
    monkeypatch.setattr(ops, "ssd_intra", lambda *a: ssd.ssd_intra_autograd(
        *a, forward=plain))
    got = grads()
    for name, gt, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        torch.testing.assert_close(
            gt, w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SCALE * float(w.abs().max()), msg=name)
