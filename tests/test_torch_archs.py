"""Every LM family of the port against the JAX package's, on the CPU.

Each of the ten configs at its reduced size (``ArchConfig.reduced()``; the
gemma3 and zamba2 schedules at ``num_layers=7``, one 5+1 local:global unit
or one unit of 6 Mamba2 blocks + the shared attention block, and a tail of
one — the default reduced depth of 4 builds no unit) with the reference's
random weights carried across by ``from_jax_params``: prefill logits and
every cache leaf, 4 decode steps, and greedy ``Engine.generate`` at
``kv_bits`` 0 and 8 must match the JAX package (audio with (B, K, S)
prompts, the VLM with patch embeddings; gemma3's 16-slot ring wraps during
prefill and decode).

Tolerances: ``rtol = atol = 2e-4`` on logits and caches — float32 on both
sides, matrix products, softmax sums and cumulative sums reduced in another
order by each framework (about 1e-6 relative per product, carried through
up to 8 residual layers). Greedy tokens must be equal: argmax returns the
first maximum in both frameworks, and at this seed no two logits of a step
lie within the tolerance of each other.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_configs as jax_list_configs  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch.configs import INPUT_SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = list_configs()
BATCH, PROMPT, NEW = 2, 21, 5
ONE_UNIT = {"gemma3-4b": 7, "zamba2-7b": 7}


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


class Case:
    """One reduced config: both models, inputs and the reference engine."""

    def __init__(self, name):
        layers = ONE_UNIT.get(name)
        kw = {"num_layers": layers} if layers else {}
        self.name = name
        self.cfg = get_config(name).reduced(**kw)
        self.jcfg = jax_get_config(name).reduced(**kw)
        self.params = jax.tree_util.tree_map(
            np.asarray, jax_T.init_params(jax.random.PRNGKey(0), self.jcfg))
        self.model = T.from_jax_params(self.params, self.cfg, device="cpu")
        rng = np.random.default_rng(0)
        shape = ((BATCH, self.cfg.num_codebooks, PROMPT)
                 if self.cfg.num_codebooks else (BATCH, PROMPT))
        self.tokens = rng.integers(0, self.cfg.vocab_size, shape,
                                   dtype=np.int32)
        self.embeds = (rng.normal(size=(BATCH, self.cfg.vlm_num_patches,
                                        self.cfg.d_model)).astype(np.float32)
                       if self.cfg.mrope else None)
        self.prefix = self.cfg.vlm_num_patches if self.cfg.mrope else 0
        self.buf_len = self.prefix + PROMPT + NEW
        # Its jitted prefill and decode serve every test of the config.
        self.engine = JaxEngine(self.jcfg, self.params,
                                JaxServeConfig(max_new_tokens=NEW))

    def jax_prefill(self):
        emb = None if self.embeds is None else jnp.asarray(self.embeds)
        return self.engine._prefill(self.params, jnp.asarray(self.tokens),
                                    buf_len=self.buf_len, embeds=emb)

    def port_prefill(self):
        emb = None if self.embeds is None else torch.from_numpy(self.embeds)
        return self.model.prefill(torch.from_numpy(self.tokens).long(),
                                  buf_len=self.buf_len, embeds=emb)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def _close_caches(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_registry_and_input_shapes_equal_reference():
    assert ARCHS == jax_list_configs()
    assert len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_INPUT_SHAPES.items()}


def test_config_equals_reference(case):
    full = get_config(case.name)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config(case.name))
    assert dataclasses.asdict(case.cfg) == dataclasses.asdict(case.jcfg)
    assert full.source and full.source == jax_get_config(case.name).source


def _reference_slot(key):
    """(reference leaf name, index into its stacking axes) of a port
    ``state_dict`` key: ``blocks.<i>.x`` → (``blocks.x``, (i,)),
    ``units.<u>.local.<j>.x`` → (``units.local.x``, (u, j)),
    ``units.<u>.global.x`` → (``units.global.x``, (u,)), the hybrid's
    ``units.<u>.<j>.x`` → (``units.x``, (u, j)); others unstacked."""
    parts = key.split(".")
    if parts[0] in ("blocks", "tail"):
        return f"{parts[0]}.{'.'.join(parts[2:])}", (int(parts[1]),)
    if parts[0] == "units":
        u = int(parts[1])
        if parts[2] == "local":
            return f"units.local.{'.'.join(parts[4:])}", (u, int(parts[3]))
        if parts[2] == "global":
            return f"units.global.{'.'.join(parts[3:])}", (u,)
        return f"units.{'.'.join(parts[3:])}", (u, int(parts[2]))
    return key, ()


def test_from_jax_params_carries_every_weight(case):
    sd = case.model.state_dict()
    want = dict(_leaves(case.params))
    assert sum(t.numel() for t in sd.values()) == sum(
        a.size for a in want.values())
    seen = set()
    for key, val in sd.items():
        name, idx = _reference_slot(key)
        np.testing.assert_array_equal(val.numpy(), want[name][idx],
                                      err_msg=key)
        seen.add(name)
    assert seen == {name for name, arr in want.items() if arr.size}


def test_prefill_matches_reference(case):
    want_logits, want_caches = case.jax_prefill()
    got_logits, got_caches = case.port_prefill()
    v = case.cfg.vocab_size
    k = case.cfg.num_codebooks
    assert got_logits.shape == ((BATCH, 1, k, v) if k else (BATCH, 1, v))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    _close_caches(got_caches, jax.tree_util.tree_map(np.asarray, want_caches))
    template = case.model.init_decode_caches(BATCH, case.buf_len)
    want_template = jax_T.init_decode_caches(case.jcfg, BATCH, case.buf_len)
    assert {k: tuple(v.shape) for k, v in _leaves(template)} == {
        k: v.shape for k, v in _leaves(want_template)} == {
        k: v.shape for k, v in _leaves(got_caches)}


def test_decode_steps_match_reference(case):
    """4 steps from the prefill, both fed the reference's greedy tokens."""
    want_logits, want_caches = case.jax_prefill()
    _, got_caches = case.port_prefill()
    audio = bool(case.cfg.num_codebooks)
    tok = np.asarray(jnp.argmax(want_logits[:, 0], axis=-1)).astype(np.int32)
    for i in range(4):
        step = tok[:, :, None] if audio else tok[:, None]
        pos = case.prefix + PROMPT + i
        want_logits, want_caches = case.engine._decode(
            case.params, jnp.asarray(step), want_caches, pos)
        got_logits, got_caches = case.model.decode_step(
            torch.from_numpy(step).long(), got_caches, pos)
        np.testing.assert_allclose(got_logits.numpy(),
                                   np.asarray(want_logits), **TOL)
        tok = np.asarray(jnp.argmax(want_logits[:, 0], axis=-1)).astype(
            np.int32)
    _close_caches(got_caches, jax.tree_util.tree_map(np.asarray, want_caches))


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_engine_greedy_tokens_equal_reference(case, kv_bits):
    sc = dict(max_new_tokens=NEW, kv_bits=kv_bits)
    case.engine.serve_cfg = JaxServeConfig(**sc)
    want = case.engine.generate(case.tokens, embeds=case.embeds)
    eng = Engine(case.cfg, case.model, ServeConfig(**sc), device="cpu")
    got = eng.generate(case.tokens, embeds=case.embeds)
    k = case.cfg.num_codebooks
    assert got.dtype == np.int32
    assert got.shape == ((BATCH, k, NEW) if k else (BATCH, NEW))
    np.testing.assert_array_equal(got, want)
    sizes = eng.last_cache_bytes
    assert sizes["fp"] > 0
    if kv_bits:
        attention_free = case.cfg.family == "ssm"
        assert (sizes["packed"] == sizes["fp"]) == attention_free
    else:
        assert sizes["packed"] is None


def test_vlm_without_embeds_keeps_the_reference_positions():
    """No patch embeddings: the buffers still hold the prefix's slots and
    decode runs at ``prefix + S + i``, as in the reference."""
    case = Case("qwen2-vl-2b")
    want = case.engine.generate(case.tokens)
    got = Engine(case.cfg, case.model, ServeConfig(max_new_tokens=NEW),
                 device="cpu").generate(case.tokens)
    np.testing.assert_array_equal(got, want)


def test_zamba2_shared_block_is_one_module():
    """Two units: the shared attention+MLP block's weights appear once in
    ``state_dict()``, and prefill and decode apply that one module at each
    unit."""
    cfg = get_config("zamba2-7b").reduced(num_layers=13)
    model = T.init_params(cfg, seed=0, device="cpu")
    sd = model.state_dict()
    shared = [k for k in sd if "attn." in k]
    assert shared and all(k.startswith("shared_attn.") for k in shared)
    assert len(shared) == len(T.Block(cfg, "gqa").state_dict())
    calls = {"prefill": 0, "decode": 0}
    blk = model.shared_attn
    pre, dec = blk.block_prefill, blk.block_decode

    def count_prefill(*a, **kw):
        calls["prefill"] += 1
        return pre(*a, **kw)

    def count_decode(*a, **kw):
        calls["decode"] += 1
        return dec(*a, **kw)

    blk.block_prefill, blk.block_decode = count_prefill, count_decode
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 9))).long()
    _, caches = model.prefill(tokens, buf_len=12)
    model.decode_step(tokens[:, :1], caches, 9)
    assert calls == {"prefill": 2, "decode": 2}
    assert tuple(caches["units"]["attn"]["k"].shape[:1]) == (2,)
