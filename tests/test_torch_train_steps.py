"""Two ``make_train_step`` steps of the port against the JAX package's, on
the CPU.

Each of the ten configs reduced as in ``tests/test_torch_train.py`` (its
``Case``: one reference init, seeded numpy batches), at ``accum_steps`` 1
here and 2 in ``tests/test_torch_train_accum.py``, against the reference's jitted ``make_train_step`` under the same
cosine schedule: the metrics (loss, ce, aux, grad norm, lr), the AdamW
step and moments, and the updated parameters, at steps 1 and 2.

Each step starts from the reference's parameters and optimizer state
(``from_jax_params``, ``from_jax_opt_state``). Adam normalizes every
element's step, ``lr · m̂/(√v̂ + eps)`` with ``|m̂/√v̂| ≤ 1`` at steps 1
and 2 (b1 = 0.9, b2 = 0.95): an element whose gradient is zero up to
rounding may move by up to ``2 · lr`` more in one framework than in the
other, and a second step from there would take its gradients at another
point. So the updated parameters are held within ``2 · lr`` of the
reference's, and the moments, continuous in the gradient, at the
gradients' tolerance: ``rtol = atol = 2e-4`` of each leaf's largest
magnitude (f32 on both sides, sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

from test_torch_train import ARCHS, STEPS, TOL, Case, _close, _np_tree  # noqa: E402

LR = 1e-3


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def test_train_steps_equal_reference(case):
    check_train_steps(case, accum=1)


def check_train_steps(case, accum):
    """Two steps of both packages at ``accum_steps=accum``."""
    jopt = JaxAdamWConfig(lr=LR)
    jstep = jax.jit(jax_make_train_step(case.jcfg, jopt,
                                        jax_cosine(LR, 1, 4),
                                        accum_steps=accum))
    step = make_train_step(case.cfg, AdamWConfig(lr=LR),
                           cosine_schedule(LR, 1, 4), accum_steps=accum)
    params = jax.tree_util.tree_map(jnp.asarray, case.params)
    jstate = jax_adamw_init(params, jopt)
    for i in range(STEPS):
        model = case.model(params)
        state = T.from_jax_opt_state(_np_tree(jstate), case.cfg,
                                     device="cpu")
        params, jstate, jm = jstep(params, jstate, case.jax_batch(i))
        m = step(model, state, case.torch_batch(i))
        assert m.keys() == jm.keys()
        for key, val in jm.items():
            np.testing.assert_allclose(float(m[key]), float(val), rtol=TOL,
                                       atol=TOL, err_msg=key)
        want = T.from_jax_opt_state(_np_tree(jstate), case.cfg, device="cpu")
        assert int(state["step"]) == int(want["step"]) == i + 1
        for part in ("m", "v"):
            for name, w in want[part].items():
                _close(state[part][name], w.numpy(), f"{part}.{name}")
        want_p = T._state_from_jax(_np_tree(params), case.cfg)
        for name, p in model.named_parameters():
            err = float((p.detach() - want_p[name]).abs().max())
            assert err <= 2 * LR, (name, err)
