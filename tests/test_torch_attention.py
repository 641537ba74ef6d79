"""The port's attention against the JAX package's, on the CPU.

``attention._attend`` on random tensors (sliding window, invalid slots with
``k_pos < 0``, pad rows from query chunks that do not divide the length);
RoPE and M-RoPE; GQA prefill (full buffer and a ring that wraps) and decode
(past the ring's end); MLA prefill and the absorbed decode — each module
loaded with the reference's random weights from ``init_gqa``/``init_mla``
at a reduced config, inputs from a numpy seed.

Tolerances: ``rtol = atol = 2e-5`` — float32 on both sides, one layer's
products and softmax sums reduced in another order by each framework (a
few ulps each); RoPE ``1e-5``: ``cos``/``sin`` of angles up to a few
hundred radians differ by ulps between the two libraries' f32 routines.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_A  # noqa: E402
from repro.models import layers as jax_L  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", torch.tensor(np.asarray(val))


def _load(module, tree):
    module.load_state_dict(dict(_flat(tree)), strict=True)
    return module


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("window,q_chunk,sq", [
    (0, 0, 12), (5, 4, 10), (0, 3, 11), (7, 16, 9), (3, 1, 6)])
def test_attend_matches_reference(window, q_chunk, sq):
    """GQA groups of 3, invalid key slots, pad query rows."""
    rng = np.random.default_rng(sq + window)
    b, sk, h, kv, hd = 2, 14, 6, 2, 8
    q, k, v = (_normal(rng, b, sq, h, hd), _normal(rng, b, sk, kv, hd),
               _normal(rng, b, sk, kv, hd))
    q_pos = np.tile(np.arange(sk - sq, sk, dtype=np.int32), (b, 1))
    q_pos[1, 0] = -1                                      # a pad row
    k_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    k_pos[0, 3] = k_pos[1, 7] = -1                        # invalid slots
    want = jax_A._attend(*map(jnp.asarray, (q, k, v, q_pos, k_pos)), window,
                         q_chunk=q_chunk)
    got = A._attend(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)), window,
                    q_chunk=q_chunk)
    assert got.shape == (b, sq, h, hd)
    _close(got, want)


def test_attend_chunks_at_q_chunk_by_default(monkeypatch):
    """Above ``Q_CHUNK`` queries the score block is (chunk × S)."""
    rng = np.random.default_rng(0)
    q, k = _normal(rng, 1, 10, 2, 4), _normal(rng, 1, 10, 1, 4)
    pos = torch.arange(10)[None]
    whole = A._attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(k), pos, pos, 0)
    monkeypatch.setattr(A, "Q_CHUNK", 4)
    chunked = A._attend(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(k), pos, pos, 0)
    _close(chunked, whole, rtol=1e-6, atol=1e-6)


def test_rope_and_mrope_match_reference():
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 300, 3, 32)
    pos = np.tile(np.arange(300, dtype=np.int32), (2, 1))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5),
           jax_L.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5),
           rtol=1e-5, atol=1e-5)
    pos3 = T.vlm_positions_3d(2, 300, 64)
    want3 = jax_T.vlm_positions_3d(2, 300, 64)
    np.testing.assert_array_equal(pos3.numpy(), np.asarray(want3))
    _close(L.apply_mrope(torch.from_numpy(x), pos3),
           jax_L.apply_mrope(jnp.asarray(x), want3), rtol=1e-5, atol=1e-5)
    # Text positions (t = h = w) make M-RoPE 1-D RoPE.
    text = torch.from_numpy(pos)[None].expand(3, 2, 300)
    _close(L.apply_mrope(torch.from_numpy(x), text),
           L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
           rtol=0, atol=0)


def _gqa(name, seed=0):
    cfg = get_config(name).reduced()
    params = _np(jax_A.init_gqa(jax.random.PRNGKey(seed),
                                jax_get_config(name).reduced()))
    return cfg, params, _load(A.GQA(cfg), params)


@pytest.mark.parametrize("name,window,buf_len", [
    ("llama3-8b", 0, 20),          # full buffer
    ("granite-20b", 0, 24),        # MQA (one kv head)
    ("gemma3-4b", 16, 16),         # a ring of 16 that prefill wraps
    ("gemma3-4b", 6, 6),           # a short ring, wrapped again in decode
])
def test_gqa_prefill_and_decode_match_reference(name, window, buf_len):
    cfg, params, mod = _gqa(name)
    jcfg = jax_get_config(name).reduced()
    rng = np.random.default_rng(2)
    b, s = 2, 17 if buf_len < 20 else 14
    x = _normal(rng, b, s, cfg.d_model)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want_y, want_c = jax_A.gqa_prefill(params, jnp.asarray(x),
                                       jnp.asarray(pos), jcfg, buf_len,
                                       window)
    with torch.no_grad():
        got_y, got_c = mod.prefill(torch.from_numpy(x), torch.from_numpy(pos),
                                   buf_len, window)
    _close(got_y, want_y)
    for key in ("k", "v"):
        assert got_c[key].shape == (b, buf_len, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
        _close(got_c[key], want_c[key])
    for i in range(5):
        xt = _normal(rng, b, 1, cfg.d_model)
        want_y, want_c = jax_A.gqa_decode(params, jnp.asarray(xt), want_c,
                                          s + i, jcfg, window)
        with torch.no_grad():
            got_y = mod.decode(torch.from_numpy(xt), got_c, s + i, window)
        _close(got_y, want_y)
        for key in ("k", "v"):
            _close(got_c[key], want_c[key])


def test_gqa_prefill_with_mrope_matches_reference():
    cfg, params, mod = _gqa("qwen2-vl-2b")
    jcfg = jax_get_config("qwen2-vl-2b").reduced()
    rng = np.random.default_rng(3)
    b, s = 2, 20
    x = _normal(rng, b, s, cfg.d_model)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos3 = jax_T.vlm_positions_3d(b, s, cfg.vlm_num_patches)
    want_y, want_c = jax_A.gqa_prefill(params, jnp.asarray(x),
                                       jnp.asarray(pos), jcfg, s + 2,
                                       positions_3d=pos3)
    with torch.no_grad():
        got_y, got_c = mod.prefill(
            torch.from_numpy(x), torch.from_numpy(pos), s + 2,
            positions_3d=T.vlm_positions_3d(b, s, cfg.vlm_num_patches))
    _close(got_y, want_y)
    _close(got_c["k"], want_c["k"])
    # Decode rotates with 1-D RoPE, as the reference does.
    xt = _normal(rng, b, 1, cfg.d_model)
    want_y, _ = jax_A.gqa_decode(params, jnp.asarray(xt), want_c, s, jcfg)
    with torch.no_grad():
        _close(mod.decode(torch.from_numpy(xt), got_c, s), want_y)


def test_mla_prefill_and_absorbed_decode_match_reference():
    name = "deepseek-v2-lite-16b"
    cfg = get_config(name).reduced()
    jcfg = jax_get_config(name).reduced()
    params = _np(jax_A.init_mla(jax.random.PRNGKey(4), jcfg))
    mod = _load(A.MLA(cfg), params)
    rng = np.random.default_rng(4)
    b, s, buf = 2, 13, 20
    x = _normal(rng, b, s, cfg.d_model)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want_y, want_c = jax_A.mla_prefill(params, jnp.asarray(x),
                                       jnp.asarray(pos), jcfg, buf)
    with torch.no_grad():
        got_y, got_c = mod.prefill(torch.from_numpy(x), torch.from_numpy(pos),
                                   buf)
    _close(got_y, want_y)
    assert got_c["latent"].shape == (b, buf, cfg.kv_lora_rank)
    assert got_c["k_rope"].shape == (b, buf, cfg.qk_rope_dim)
    for key in ("latent", "k_rope"):
        _close(got_c[key], want_c[key])
    for i in range(4):
        xt = _normal(rng, b, 1, cfg.d_model)
        want_y, want_c = jax_A.mla_decode(params, jnp.asarray(xt), want_c,
                                          s + i, jcfg)
        with torch.no_grad():
            got_y = mod.decode(torch.from_numpy(xt), got_c, s + i)
        _close(got_y, want_y)
        for key in ("latent", "k_rope"):
            _close(got_c[key], want_c[key])


def test_absorbed_decode_equals_the_expanded_form():
    """The absorbed decode's output is the prefill's last row: scores in the
    latent space equal scores on the per-head keys built from it."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    mod = A.MLA(cfg)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_normal(np.random.default_rng(5), 1, 9,
                                 cfg.d_model))
    pos = torch.arange(9)[None]
    with torch.no_grad():
        y_full, _ = mod.prefill(x, pos, 9)
        _, cache = mod.prefill(x[:, :8], pos[:, :8], 9)
        y_step = mod.decode(x[:, 8:], cache, 8)
    _close(y_step[:, 0], y_full[:, 8], rtol=1e-4, atol=1e-5)
