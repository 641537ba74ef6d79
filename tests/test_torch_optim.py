"""The port's optimizer and schedules against the JAX package's, on the CPU.

* ``cosine_schedule`` / ``linear_schedule`` at every step 0…N (int32 step
  tensors, float32 arithmetic on both sides; rtol 1e-6: ``cos`` may differ
  in the last bit between XLA and PyTorch);
* ``global_norm``, ``clip_by_global_norm`` and ``adamw_update`` over a
  random tree (numpy, seeded) for one and three steps, with and without a
  schedule and clipping, and with ``state_dtype=bfloat16`` (rtol 1e-6,
  atol 1e-7 on parameters and float32 moments: the same float32 formulas,
  ``sqrt``/``pow`` rounded by each framework; bf16 moments within one bf16
  ulp, 2⁻⁸ relative, as a last-bit difference before the cast may round
  to the neighbouring bf16);
* the reference's own optimizer tests (``tests/test_substrate.py``)
  restated for the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jax_optim  # noqa: E402

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_schedule,
                               global_norm, linear_schedule)

SCHED_RTOL = 1e-6
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["cosine", "linear"])
@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 10, 100), (1.0, 0, 7),
                                               (2.5e-3, 5, 5)])
def test_schedule_equals_reference(kind, peak, warmup, total):
    ours = {"cosine": cosine_schedule, "linear": linear_schedule}[kind](
        peak, warmup, total)
    ref = {"cosine": jax_optim.cosine_schedule,
           "linear": jax_optim.linear_schedule}[kind](peak, warmup, total)
    steps = np.arange(total + 3, dtype=np.int32)
    got = ours(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(steps))),
                               rtol=SCHED_RTOL, atol=0)


def _tree(rng):
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32),
                  "d": (3 * rng.normal(size=(2, 3, 4))).astype(np.float32)}}


def _flat(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in _flat(tree)}


def test_global_norm_and_clip_equal_reference():
    rng = np.random.default_rng(0)
    g = _tree(rng)
    want_g, want_n = jax_optim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    got_g, got_n = clip_by_global_norm(_torch(g), 1.0)
    np.testing.assert_allclose(float(got_n), float(want_n), **TOL)
    np.testing.assert_allclose(float(global_norm(_torch(g))), float(want_n),
                               **TOL)
    for k, v in _flat(want_g):
        np.testing.assert_allclose(got_g[k].numpy(), v, **TOL, err_msg=k)


def test_clip_scale_is_the_reference_formula():
    """min(1, max_norm / max(norm, 1e-12)), not clip_grad_norm_'s
    max_norm / (norm + 1e-6): a norm of 3 clipped to 1 scales by 1/3."""
    g = {"a": torch.full((9,), 1.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == 3.0
    assert torch.equal(clipped["a"], torch.full((9,), 1.0) * (1.0 / 3.0))
    same, _ = clip_by_global_norm(g, 5.0)
    assert torch.equal(same["a"], g["a"])


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("sched", [None, "cosine"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_equals_reference(steps, sched, clip):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=clip)
    jcfg = jax_optim.AdamWConfig(**kw)
    cfg = AdamWConfig(**kw)
    jsched = (jax_optim.cosine_schedule(3e-3, 2, 5) if sched else None)
    tsched = (cosine_schedule(3e-3, 2, 5) if sched else None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_optim.adamw_init(jp, jcfg)
    tp = _torch(params)
    tstate = adamw_init(tp, cfg)
    for g in grads:
        jp, jstate, jm = jax_optim.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), jstate, jcfg, jsched)
        tm = adamw_update(tp, _torch(g), tstate, cfg, tsched)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL)
    assert int(tstate["step"]) == int(jstate["step"]) == steps
    assert tstate["step"].dtype == torch.int32
    for name, want in (("params", jp), ("m", jstate["m"]),
                       ("v", jstate["v"])):
        got = tp if name == "params" else tstate[name]
        for k, v in _flat(want):
            np.testing.assert_allclose(got[k].numpy(), v, **TOL,
                                       err_msg=f"{name}.{k}")


def test_adamw_bf16_state_equals_reference():
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jcfg = jax_optim.AdamWConfig(state_dtype=jnp.bfloat16)
    cfg = AdamWConfig(state_dtype=torch.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_optim.adamw_init(jp, jcfg)
    tp = _torch(params)
    tstate = adamw_init(tp, cfg)
    assert all(v.dtype == torch.bfloat16 for v in tstate["m"].values())
    for g in grads:
        jp, jstate, _ = jax_optim.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), jstate, jcfg)
        adamw_update(tp, _torch(g), tstate, cfg)
    for k, v in _flat(jp):
        np.testing.assert_allclose(tp[k].numpy(), v, **TOL, err_msg=k)
    for part in ("m", "v"):
        assert all(t.dtype == torch.bfloat16 for t in tstate[part].values())
        for k, v in _flat(jstate[part]):
            np.testing.assert_allclose(
                tstate[part][k].to(torch.float32).numpy(),
                np.asarray(v, dtype=np.float32), rtol=2 ** -8, atol=0,
                err_msg=f"{part}.{k}")


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        adamw_update(params, {"w": 2 * (params["w"] - target)}, state, cfg)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)


def test_weight_decay_decouples():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=0.0)
    params = {"w": torch.tensor([10.0])}
    state = adamw_init(params, cfg)
    adamw_update(params, {"w": torch.tensor([0.0])}, state, cfg)
    assert float(params["w"][0]) < 10.0, "decay shrinks params w/o gradient"
