"""The port's OSQ-packed KV cache against ``repro.serve.kv_quant``, on the
CPU.

``quantize_leaf``'s packed words must equal the reference's **bitwise**
(int32 words of uint32 code packing) for 2, 4, 8 and 16 bits along several
axes, buffers that the words do not divide included; ``quantize_caches``
must pick the same leaves of real prefill caches (k/v, MLA's latent and
k_rope, the hybrid's attention but not its Mamba2 conv/state, no buffer
shorter than 16 slots, no integer leaf) and ``cache_bytes`` must agree;
the non-uniform pair must choose the same channels and pack the same
words. Inputs come from a numpy seed.

Tolerance of the dequantized values: ``rtol = 0, atol = 1e-6 · max |x|`` —
the same codes times the same f32 scale plus lo on both sides, where one
framework may fuse the multiply-add and the other round twice.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.serve import kv_quant as jax_kv  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import kv_quant as kv  # noqa: E402


def _close(got, want, x):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(x).max()))


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("shape,axis", [
    ((2, 37, 3, 8), 1),           # k/v layout, 37 slots: a ragged last word
    ((4, 2, 32, 5), -2),          # layer-stacked, buffer from the end
    ((48, 6), 0),
    ((3, 5, 20), 2),              # the buffer innermost
])
def test_quantize_leaf_words_bitwise_equal(bits, shape, axis):
    rng = np.random.default_rng(bits + len(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.1, 5, size=shape[-1])
         ).astype(np.float32)
    x.reshape(-1)[:3] = 0.0                     # exact zeros, as past a prompt
    want, want_meta = jax_kv.quantize_leaf(jnp.asarray(x), bits, axis)
    got, meta = kv.quantize_leaf(torch.from_numpy(x), bits, axis)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in (0, 1):                            # lo, scale
        np.testing.assert_array_equal(meta[i].numpy(), np.asarray(want_meta[i]))
    assert meta[2:3] == want_meta[2:3] and meta[4:] == want_meta[4:]
    _close(kv.dequantize_leaf(got, meta),
           jax_kv.dequantize_leaf(want, want_meta), x)


def test_quantize_leaf_constant_channel_and_bits():
    """A constant channel (scale 0 → 1) packs to zero codes; bits that do
    not divide 32 are refused."""
    x = np.ones((20, 3), np.float32)
    x[:, 1] = np.arange(20)
    want, _ = jax_kv.quantize_leaf(jnp.asarray(x), 4, 0)
    got, meta = kv.quantize_leaf(torch.from_numpy(x), 4, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(kv.dequantize_leaf(got, meta)[:, 0].numpy(),
                                  x[:, 0])
    with pytest.raises(ValueError, match="divide 32"):
        kv.quantize_leaf(torch.from_numpy(x), 3, 0)


@functools.lru_cache(maxsize=None)
def _prefill_caches(name, buf_len, layers=None):
    """The reference's caches of a reduced config, and the same caches as
    torch tensors (one prefill per config and buffer)."""
    overrides = {"num_layers": layers} if layers else {}
    jcfg = jax_get_config(name).reduced(**overrides)
    params = jax_T.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    shape = (2, jcfg.num_codebooks, 10) if jcfg.num_codebooks else (2, 10)
    tokens = rng.integers(0, jcfg.vocab_size, shape, dtype=np.int32)
    _, caches = jax_T.prefill(params, jnp.asarray(tokens), jcfg,
                              buf_len=buf_len)
    caches = jax.tree_util.tree_map(np.asarray, caches)
    return caches, jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), caches)


@pytest.mark.parametrize("name,buf_len,layers", [
    ("llama3-8b", 24, None),
    ("deepseek-v2-lite-16b", 20, None),        # latent, k_rope
    ("zamba2-7b", 21, 7),                      # attn k/v; conv/state kept
    ("gemma3-4b", 40, 7),                      # 16-slot rings and globals
    ("llama3-8b", 12, None),                   # shorter than 16: kept
])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_caches_picks_the_same_leaves(name, buf_len, layers, bits):
    want_c, caches = _prefill_caches(name, buf_len, layers)
    want_q, want_meta = jax_kv.quantize_caches(want_c, bits)
    got_q, meta = kv.quantize_caches(caches, bits)
    want_q = dict(_leaves(want_q))
    got_leaves = dict(_leaves(got_q))
    assert got_leaves.keys() == want_q.keys()
    packed = {k for k, v in got_leaves.items() if v.dtype == torch.int32}
    want_packed = {k for k, v in want_q.items() if v.dtype == np.int32}
    assert packed == want_packed
    assert all(k.split(".")[-1] in ("k", "v", "latent", "k_rope")
               for k in packed)
    assert bool(packed) == (buf_len >= 16)
    for key, val in got_leaves.items():
        np.testing.assert_array_equal(val.numpy(), np.asarray(want_q[key]),
                                      err_msg=key)
    assert kv.cache_bytes(got_q) == jax_kv.cache_bytes(want_q)
    assert kv.cache_bytes(caches) == jax_kv.cache_bytes(want_c)
    back = dict(_leaves(kv.dequantize_caches(got_q, meta)))
    want_back = dict(_leaves(jax_kv.dequantize_caches(
        jax_kv.quantize_caches(want_c, bits)[0], want_meta)))
    for key, val in back.items():
        _close(val, want_back[key], np.asarray(want_back[key]))


def test_quantize_caches_keeps_integer_leaves():
    caches = {"k": torch.arange(2 * 20 * 3, dtype=torch.int32).reshape(
        2, 20, 3, 1), "blocks": {"v": torch.zeros(1, 2, 20, 3, 4)}}
    q, meta = kv.quantize_caches(caches, 8)
    assert q["k"] is caches["k"] and meta["k"] is None
    assert q["blocks"]["v"].shape == (1, 2, 5, 3, 4)


def test_cache_bytes_of_a_model_layout():
    """The packed llama3 layout: the buffer axis shrinks by 32 / bits."""
    cfg = get_config("llama3-8b").reduced()
    caches = T.init_params(cfg, device="cpu").init_decode_caches(2, 32)
    fp = kv.cache_bytes(caches)
    assert fp == 2 * cfg.num_layers * 2 * 32 * cfg.num_kv_heads * 64 * 4
    for bits in (4, 8, 16):
        assert kv.cache_bytes(kv.quantize_caches(caches, bits)[0]) == \
            fp * bits // 32


@pytest.mark.parametrize("hi_frac", [0.5, 0.25, 1.0])
def test_nonuniform_pair_matches_reference(hi_frac):
    rng = np.random.default_rng(int(hi_frac * 8))
    # Channels with distinct spreads, so the variance order is unambiguous.
    spread = np.linspace(0.2, 4.0, 12)
    rng.shuffle(spread)
    x = (rng.normal(size=(2, 33, 3, 4)) * spread.reshape(3, 4)
         ).astype(np.float32)
    (wh, wl), wmeta = jax_kv.quantize_leaf_nonuniform(
        jnp.asarray(x), 1, hi_frac=hi_frac)
    (gh, gl), meta = kv.quantize_leaf_nonuniform(
        torch.from_numpy(x), 1, hi_frac=hi_frac)
    np.testing.assert_array_equal(meta[2].numpy(), np.asarray(wmeta[2]))
    np.testing.assert_array_equal(meta[3].numpy(), np.asarray(wmeta[3]))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    assert (gl is None) == (wl is None)
    if gl is not None:
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    got = kv.dequantize_leaf_nonuniform((gh, gl), meta)
    assert got.shape == x.shape
    _close(got, jax_kv.dequantize_leaf_nonuniform((wh, wl), wmeta), x)
