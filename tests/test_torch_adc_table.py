"""The table Stage 4 of the port (plain version of kernel 2 with ``sel``
and ``keep``) against the JAX package, on the CPU.

The port's ``ops.adc_table`` reads each (query, partition) pair's
survivors through ``sel`` from the stacked codes and returns +inf at the
slots past the pair's ``keep``. The JAX plane computes the same function
as three steps (``repro/core/dataplane.py``): it gathers the survivors'
codes, runs ``ops.adc_batch`` (here the Pallas kernel in interpret mode,
as ``tests/test_kernels.py`` runs it) and masks the dead slots with
``jnp.where``. Inputs come from numpy with a seed. Tolerance: rtol 1e-6,
atol 0 on live slots (f32 sums of ≤ d non-negative terms, in another
order); dead slots must be +inf exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ADC_RTOL_JAX = 1e-6
QN, P, N_MAX, S = 3, 2, 60, 24


def _keep(rng, pattern):
    """Live counts: random in [0, S] with a dead pair and a whole one, or
    every pair dead, or every pair whole."""
    if pattern == "dead":
        return np.zeros((QN, P), np.int32)
    if pattern == "whole":
        return np.full((QN, P), S, np.int32)
    keep = rng.integers(1, S, size=(QN, P)).astype(np.int32)
    keep[0, 0], keep[-1, -1] = 0, S
    return keep


def _inputs(rng, m1, d, pattern):
    tables = rng.exponential(size=(QN, P, m1, d)).astype(np.float32)
    tables[:, :, 0, :] = 0.0
    codes = rng.integers(0, m1, size=(P, N_MAX, d)).astype(np.int32)
    sel = np.stack([np.stack([rng.choice(N_MAX, size=S, replace=False)
                              for _ in range(P)]) for _ in range(QN)])
    return tables, codes, sel.astype(np.int64), _keep(rng, pattern)


def _jax_plane(tables, codes, sel, keep, sqrt):
    """The JAX plane's table branch: gather, Pallas kernel, dead mask."""
    m1, d = tables.shape[2:]
    kept = codes[np.arange(P)[None, :, None], sel]              # (Q, P, S, d)
    lb = jax_ops.adc_batch(
        jnp.asarray(tables.reshape(QN * P, m1, d)),
        jnp.asarray(kept.reshape(QN * P, S, d)), sqrt=sqrt,
        use_pallas=True, interpret=True).reshape(QN, P, S)
    alive = jnp.arange(S)[None, None, :] < jnp.asarray(keep)[:, :, None]
    return np.asarray(jnp.where(alive, lb, jnp.inf))


@pytest.mark.parametrize("d", [128, 13])
@pytest.mark.parametrize("m1", [9, 33, 129])
@pytest.mark.parametrize("sqrt", [True, False])
@pytest.mark.parametrize("pattern", ["mixed", "dead", "whole"])
def test_adc_table_ref_equals_jax(pattern, sqrt, m1, d):
    rng = np.random.default_rng(m1 * 1000 + d)
    tables, codes, sel, keep = _inputs(rng, m1, d, pattern)
    want = _jax_plane(tables, codes, sel, keep, sqrt)
    args = [torch.from_numpy(a) for a in (tables, codes, sel, keep)]
    got = ref.adc_table_ref(*args, sqrt=sqrt)
    assert got.dtype == torch.float32 and got.shape == (QN, P, S)
    live = np.arange(S)[None, None, :] < keep[:, :, None]
    assert np.array_equal(np.isposinf(got.numpy()), ~live)
    assert np.array_equal(np.isposinf(want), ~live)
    np.testing.assert_allclose(got.numpy()[live], want[live],
                               rtol=ADC_RTOL_JAX, atol=0)
    via_ops = ops.adc_table(*args, sqrt=sqrt)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_adc_table_ref_is_the_batch_ref_on_gathered_codes():
    """The (B, N, d) contract is the case Q = 1, P = B, sel the identity,
    keep = N: both plain versions give the same bits."""
    rng = np.random.default_rng(4)
    tables = torch.from_numpy(
        rng.exponential(size=(5, 17, 12)).astype(np.float32))
    codes = torch.from_numpy(
        rng.integers(0, 17, size=(5, 40, 12)).astype(np.int32))
    sel = torch.arange(40, dtype=torch.int64).expand(1, 5, 40).contiguous()
    keep = torch.full((1, 5), 40, dtype=torch.int32)
    got = ref.adc_table_ref(tables[None], codes, sel, keep)[0]
    assert torch.equal(got, ref.adc_lb_batch_ref(tables, codes))
