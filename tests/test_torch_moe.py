"""The port's MoE FFN against the JAX package's ``moe_ffn``, on the CPU.

Reduced DeepSeek-V2-Lite (4 experts, top-2, one shared expert) and Arctic
(4 experts, top-2, the parallel dense FFN) with the reference's random
weights from ``init_moe``, inputs from a numpy seed: ``y`` and the Switch
aux loss at a prefill's token count and at a decode step's (T = B, where
the capacity floor is ``top_k``); a capacity factor small enough that
tokens drop; and router logits that tie (a zero router, where every expert
ties, and duplicated router columns, where pairs tie), where
``lax.top_k`` keeps the lower expert index first.

Tolerances: ``rtol = atol = 2e-5`` on ``y`` and ``aux`` — float32 on both
sides, the router, expert and combine sums reduced in another order by
each framework (a few ulps each); the routing itself (experts chosen,
slots kept) must be identical, which the equal outputs at tokens that
drop show.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_M  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", torch.tensor(np.asarray(val))


def _pair(name, seed=0, **overrides):
    cfg = dataclasses.replace(get_config(name).reduced(), **overrides)
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **overrides)
    params = jax.tree_util.tree_map(
        np.asarray, jax_M.init_moe(jax.random.PRNGKey(seed), jcfg))
    return cfg, jcfg, params


def _run(cfg, jcfg, params, x):
    want_y, want_aux = jax_M.moe_ffn(params, jnp.asarray(x), jcfg)
    mod = M.MoE(cfg)
    mod.load_state_dict(dict(_flat(params)), strict=True)
    with torch.no_grad():
        got_y, got_aux = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    return got_y


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "arctic-480b"])
@pytest.mark.parametrize("b,s", [(2, 24), (3, 1)])
def test_moe_matches_reference(name, b, s):
    cfg, jcfg, params = _pair(name)
    assert ("shared" in params) == (name.startswith("deepseek"))
    assert ("dense" in params) == (name.startswith("arctic"))
    _run(cfg, jcfg, params, _x(cfg, b, s, seed=b * s))


def _kept_slots(cfg, probs):
    """Tokens · k entries that keep a capacity slot, by the reference's
    rule (stable sort by expert, rank < capacity)."""
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.top_k]
    c = M.capacity(cfg, probs.shape[0])
    counts = np.bincount(top_e.reshape(-1), minlength=cfg.num_experts)
    return int(np.minimum(counts, c).sum()), top_e.size


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_moe_drops_tokens_at_capacity_like_reference(name):
    cfg, jcfg, params = _pair(name, seed=1, capacity_factor=0.5)
    x = _x(cfg, 2, 16, seed=7)
    logits = x.reshape(-1, cfg.d_model) @ params["router"]["w"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    kept, total = _kept_slots(cfg, probs / probs.sum(-1, keepdims=True))
    assert kept < total                     # some entries do drop
    _run(cfg, jcfg, params, x)


def test_moe_capacity_recomputed_per_call():
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    assert M.capacity(cfg, 48) == int(1.25 * 48 * 2 / 4) == 30
    assert M.capacity(cfg, 1) == cfg.top_k             # the floor at decode
    assert M.capacity(cfg, 3) == max(int(1.25 * 3 * 2 / 4), 2)


@pytest.mark.parametrize("tie", ["zero_router", "duplicate_columns"])
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_moe_tied_router_logits_pick_lower_expert_first(name, tie):
    cfg, jcfg, params = _pair(name, seed=2)
    w = params["router"]["w"]
    if tie == "zero_router":
        # Every expert ties: top-k is experts 0..k-1 for every token, so
        # capacity drops most entries.
        w = np.zeros_like(w)
    else:
        w = w.copy()
        w[:, 1] = w[:, 0]                   # experts 0 and 1 tie
        w[:, 3] = w[:, 2]                   # experts 2 and 3 tie
    params = {**params, "router": {"w": w}}
    x = _x(cfg, 2, 12, seed=3)
    _run(cfg, jcfg, params, x)
    mod = M.MoE(cfg)
    mod.load_state_dict(dict(_flat(params)), strict=True)
    probs = torch.softmax(mod.router(torch.from_numpy(x).reshape(-1, cfg.d_model)),
                          dim=-1)
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if tie == "zero_router":
        assert (idx[:, :cfg.top_k] == torch.arange(cfg.top_k)).all()
    else:
        first = idx[:, 0]
        second = idx[:, 1]
        pairs = first // 2 == second // 2
        assert pairs.all() and (first < second).all()
