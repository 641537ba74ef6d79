"""Training in the port against the JAX package's, on the CPU.

Each of the ten configs at its reduced size (gemma3 and zamba2 at
``num_layers=7``: one local:global unit or one hybrid unit and a tail of
one, as ``tests/test_torch_archs.py`` runs them), started from one
reference init carried across by ``from_jax_params`` (and, for the
optimizer, ``from_jax_opt_state``), on seeded numpy batches:

* ``loss_fn``'s loss, ``ce`` and ``aux``, and every parameter's gradient,
  against ``jax.value_and_grad`` of the reference's ``loss_fn``;
* the gradients with ``remat`` on and off (equal: the recompute repeats
  the same CPU arithmetic);
* (``tests/test_torch_train_steps.py``) two ``make_train_step`` steps.

Tolerance: ``rtol = atol = 2e-4`` of each leaf's largest magnitude, f32 on
both sides (as ``tests/test_torch_archs.py``: products and sums reduced in
another order, carried through up to 8 residual layers and their
backward).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.train import loss_fn as jax_loss_fn  # noqa: E402

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import loss_fn  # noqa: E402

TOL = 2e-4
ARCHS = list_configs()
BATCH, SEQ, STEPS = 2, 16, 2
ONE_UNIT = {"gemma3-4b": 7, "zamba2-7b": 7}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want: np.ndarray, name: str) -> None:
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * scale, err_msg=name)


class Case:
    """One reduced config: the reference init and seeded batches;
    :meth:`reference_grads` the reference's loss and gradients on the
    first batch."""

    def __init__(self, name):
        layers = ONE_UNIT.get(name)
        kw = {"num_layers": layers} if layers else {}
        self.cfg = get_config(name).reduced(**kw)
        self.jcfg = jax_get_config(name).reduced(**kw)
        # Jitted: a third of the eager init's time (other draws, but one
        # init serves both packages).
        self.params = _np_tree(jax.jit(lambda k: jax_T.init_params(
            k, self.jcfg))(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(0)
        shape = ((BATCH, self.cfg.num_codebooks, SEQ + 1)
                 if self.cfg.num_codebooks else (BATCH, SEQ + 1))
        self.batches = []
        for _ in range(STEPS):
            b = {"tokens": rng.integers(0, self.cfg.vocab_size, shape,
                                        dtype=np.int32)}
            if self.cfg.mrope:
                b["embeds"] = rng.normal(size=(
                    BATCH, self.cfg.vlm_num_patches,
                    self.cfg.d_model)).astype(np.float32)
            self.batches.append(b)

    def reference_grads(self):
        """(loss, {"ce", "aux"}, gradients by ``state_dict`` name)."""
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: jax_loss_fn(p, b, self.jcfg), has_aux=True))
        (loss, parts), grads = grad_fn(self.params, self.jax_batch(0))
        return (float(loss), {k: float(v) for k, v in parts.items()},
                T._state_from_jax(_np_tree(grads), self.cfg))

    def jax_batch(self, i):
        return {k: jnp.asarray(v) for k, v in self.batches[i].items()}

    def torch_batch(self, i):
        return {k: torch.from_numpy(v) for k, v in self.batches[i].items()}

    def model(self, params=None):
        return T.from_jax_params(_np_tree(params or self.params), self.cfg,
                                 device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def _grads(model, batch, cfg, remat):
    model.zero_grad(set_to_none=True)
    loss, parts = loss_fn(model, batch, cfg, remat=remat)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, {k: (torch.zeros_like(p) if p.grad is None
                             else p.grad.clone())
                         for k, p in model.named_parameters()}


def test_loss_and_grads_equal_reference(case):
    want_loss, want_parts, want_grads = case.reference_grads()
    model = case.model()
    loss, parts, grads = _grads(model, case.torch_batch(0), case.cfg, True)
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL, atol=TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[key]), want_parts[key],
                                   rtol=TOL, atol=TOL)
    assert grads.keys() == want_grads.keys()
    for name, want in want_grads.items():
        _close(grads[name], want.numpy(), name)


def test_remat_leaves_grads_unchanged(case):
    model = case.model()
    batch = case.torch_batch(0)
    loss_r, _, with_remat = _grads(model, batch, case.cfg, True)
    loss_n, _, without = _grads(model, batch, case.cfg, False)
    assert float(loss_r) == float(loss_n)
    for name, g in with_remat.items():
        assert torch.equal(g, without[name]), name
